"""Peak signal-to-noise ratio.

Counterpart of ``admm_deconv_tpu/metrics/psnr.py``: per-image MSE over the
spatial+channel axes, then the batch mean of ``20*log10(peak/sqrt(mse))``,
with zero MSE guarded by the dtype's smallest normal number.
"""

from __future__ import annotations

import torch

from admm_deconv_tpu_torch.utils.arrays import as_tensor_pair


def peak_snr(x: torch.Tensor, y: torch.Tensor, peak_val: float = 1.0) -> torch.Tensor:
    """Mean PSNR over the batch; inputs NHWC (or any layout with batch first).
    Tensors or numpy arrays (:func:`~admm_deconv_tpu_torch.utils.arrays.as_tensor_pair`)."""
    x, y = as_tensor_pair(x, y)
    err = (y - x) ** 2
    mse = torch.mean(err, dim=tuple(range(1, x.ndim))) if x.ndim > 1 else err
    mse = torch.clamp(mse, min=torch.finfo(x.dtype).tiny)
    return torch.mean(20.0 * torch.log10(peak_val / torch.sqrt(mse)))


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error over every element (the trainer's mse loss)."""
    x, y = as_tensor_pair(x, y)
    return torch.mean((x - y) ** 2)
