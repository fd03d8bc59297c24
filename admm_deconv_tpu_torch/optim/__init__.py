"""Optimizers and schedules: AdaBelief (optax's, by hand) and
reduce-LR-on-plateau."""

from admm_deconv_tpu_torch.optim.adabelief import AdaBelief
from admm_deconv_tpu_torch.optim.plateau import ReduceLROnPlateau

__all__ = ["AdaBelief", "ReduceLROnPlateau"]
