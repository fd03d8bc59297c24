"""Debug flags: NaN checks and deterministic execution.

Counterpart of ``admm_deconv_tpu/utils/debug.py``, with what PyTorch has in
place of JAX's flags, which is less on one side and more on the other:

* JAX's ``jax_debug_nans`` checks the result of *every* jitted computation.
  ``torch.autograd.set_detect_anomaly(True, check_nan=True)`` checks only
  the gradients that a **backward** pass produces (and records a traceback
  of the forward op that made them); a NaN in a forward-only solve passes
  unnoticed.  Check a solve's output with ``torch.isfinite`` yourself.
* :func:`deterministic_mode` also turns on
  ``torch.use_deterministic_algorithms(True)``, which JAX's context does not
  have.  PyTorch documents that cuBLAS matrix products (``torch.bmm``,
  ``einsum``, ``nn.Linear``) then raise on the card unless the environment
  variable ``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8`` or ``:16:8``) was set
  before the process's first cuBLAS call; this module does not set it and
  does not catch the error.  Measured on an H100 (torch 2.11, CUDA 12.8,
  the variable unset, ``chip_smoke.py``'s utils phase): every solver path
  ran under the flag (``tv_deconvolve`` forward and backward, the adaptive
  and composite solvers, the implicit forward and backward, and the
  Anderson solver with its ``torch.bmm`` and ``linalg.solve_ex``); none
  raised.  The hand-written kernels use no atomics and are deterministic
  with or without the flag.
"""

from __future__ import annotations

import contextlib

import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Globally raise when a backward pass produces a NaN
    (``torch.autograd.set_detect_anomaly(enable, check_nan=True)``).  Slows
    execution; use while debugging a diverging training run."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


@contextlib.contextmanager
def deterministic_mode():
    """Context with deterministic algorithms and backward NaN checks on, for
    bit-reproducible debugging runs; restores the settings it found
    (anomaly mode and its NaN check, deterministic algorithms and their
    warn-only flag)."""
    prev_anomaly = torch.is_anomaly_enabled()
    prev_check_nan = torch.is_anomaly_check_nan_enabled()
    prev_det = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev_det, warn_only=prev_warn)
        torch.autograd.set_detect_anomaly(prev_anomaly, check_nan=prev_check_nan)
