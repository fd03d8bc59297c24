"""PyTorch/CUDA port of the ADMM TV-deconvolution framework.

The JAX package ``admm_deconv_tpu`` is the reference; this package mirrors
its module layout and public API (NHWC at the API) on PyTorch, with its
TPU kernels rewritten by hand in CUDA for Hopper (``csrc/``).  It never
imports JAX.  Kernels build at their first launch on a CUDA tensor; CPU
tensors take the kernels' plain-torch versions.
"""

from admm_deconv_tpu_torch.metrics import gmsd, gmsd_loss, peak_snr, ssim, ssim_loss
from admm_deconv_tpu_torch.ops import prox
from admm_deconv_tpu_torch.ops.composite import (
    composite_tv_deconvolve,
    composite_tv_deconvolve_adaptive,
)
from admm_deconv_tpu_torch.ops.implicit import tv_deconvolve_implicit
from admm_deconv_tpu_torch.ops.solver import (
    ADMMDiagnostics,
    ADMMState,
    anderson_history_bytes,
    solve_auto,
    tv_deconvolve,
    tv_deconvolve_adaptive,
    tv_deconvolve_anderson,
    tv_objective,
)

__version__ = "0.1.0"

__all__ = [
    "solve_auto",
    "tv_deconvolve",
    "tv_deconvolve_adaptive",
    "anderson_history_bytes",
    "tv_deconvolve_anderson",
    "tv_objective",
    "composite_tv_deconvolve",
    "composite_tv_deconvolve_adaptive",
    "tv_deconvolve_implicit",
    "ADMMState",
    "ADMMDiagnostics",
    "prox",
    "peak_snr",
    "ssim",
    "ssim_loss",
    "gmsd",
    "gmsd_loss",
]
