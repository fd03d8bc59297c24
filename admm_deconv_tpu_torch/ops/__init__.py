"""Solver core: FFT precompute, difference stencils, prox library, ADMM loops."""

from admm_deconv_tpu_torch.ops import prox
from admm_deconv_tpu_torch.ops.composite import (
    composite_tv_deconvolve,
    composite_tv_deconvolve_adaptive,
)
from admm_deconv_tpu_torch.ops.diff import grad2d, grad2d_adjoint
from admm_deconv_tpu_torch.ops.fft import laplacian_spectrum, psf_to_otf, psf_to_otf_full
from admm_deconv_tpu_torch.ops.implicit import tv_deconvolve_implicit
from admm_deconv_tpu_torch.ops.solver import (
    anderson_history_bytes,
    solve_auto,
    tv_deconvolve,
    tv_deconvolve_adaptive,
    tv_deconvolve_anderson,
    tv_objective,
)

__all__ = [
    "psf_to_otf",
    "psf_to_otf_full",
    "laplacian_spectrum",
    "grad2d",
    "grad2d_adjoint",
    "prox",
    "solve_auto",
    "tv_deconvolve",
    "tv_deconvolve_adaptive",
    "anderson_history_bytes",
    "tv_deconvolve_anderson",
    "tv_deconvolve_implicit",
    "tv_objective",
    "composite_tv_deconvolve",
    "composite_tv_deconvolve_adaptive",
]
