"""Utilities: array helpers, 3-D differences, profiling, debug flags, solver
state and parameter carriers, the fp32 convolution guard."""

from admm_deconv_tpu_torch.utils.arrays import expand_dims, fftn_matlike
from admm_deconv_tpu_torch.utils.debug import deterministic_mode, enable_nan_checks
from admm_deconv_tpu_torch.utils.diff3d import divergence3d, forward_diff3d
from admm_deconv_tpu_torch.utils.profiling import IterationTimer, trace_annotation
from admm_deconv_tpu_torch.utils.state_io import load_solver_state, save_solver_state

__all__ = [
    "save_solver_state",
    "load_solver_state",
    "expand_dims",
    "fftn_matlike",
    "forward_diff3d",
    "divergence3d",
    "IterationTimer",
    "trace_annotation",
    "enable_nan_checks",
    "deterministic_mode",
]
