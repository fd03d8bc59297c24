"""The x-update's complex right-hand side ``C (B + rho F)`` as one pass.

Between the two cuFFT calls of the closed-form x-update
(``ops/solver.py::_solve_spectral``),

    x = irfft2(C * (B + rho * rfft2(q)))

torch runs three complex64 passes over the ``(N, H, W//2+1)`` spectrum,
each reading and writing a whole spectrum (56 B a bin).
:func:`spectral_rhs` does the same arithmetic in one: on a CUDA tensor it
launches the hand-written kernel ``csrc/spectral_rhs.cu`` (built at first
use, see ``_build.py``), which reads ``F = rfft2(q)`` and ``B`` once and
writes the result into ``F`` (24 B a bin); on a CPU tensor it runs
:func:`_spectral_rhs_plain`, the composition itself, and copies it into
``F``.  No TPU kernel stands behind it: the JAX package's x-update is jnp.

``C`` and ``rho`` are real, and torch multiplies a complex by a real
promoted to ``(a, 0)``, which gives ``round(a x)`` in each part; the kernel
rounds after every operation in the composition's order, so its output
equals the composition's for finite inputs (``torch.equal``; the sign of
an exact zero may differ).

It has no backward: an operand that requires grad while grad is enabled
raises, and the solver keeps the composition wherever autograd records a
graph.  Nothing falls back: a build or launch failure raises, and so does
an operand of the wrong dtype, layout or shape (no copy is made to mend
it).  Kernel launches are counted in ``spectral_rhs.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import _launch, _load_kernel


def _spectral_rhs_plain(f, b, c, rho):
    """Plain-torch twin of the kernel: the solver's composition."""
    return c * (b + rho * f)


@functools.cache
def _kernel_fn():
    return _load_kernel("spectral_rhs", "admm_spectral_rhs", 4,
                        (ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int))


def _check_operands(f, b, c, rho) -> tuple[bool, bool]:
    """Raise unless the operands are what the kernel takes; return whether
    C and rho hold one entry a plane."""
    for name, t in (("F", f), ("B", b)):
        if t.dtype != torch.complex64:
            raise ValueError(f"spectral_rhs takes complex64 {name}, got {t.dtype}")
        if t.ndim != 3 or not t.is_contiguous() or t.is_conj() or t.is_neg():
            raise ValueError(f"spectral_rhs takes a contiguous, resolved (N, H, Wf) {name}, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}, conj {t.is_conj()}")
    for name, t in (("C", c), ("rho", rho)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise ValueError(f"spectral_rhs takes a float32 tensor {name}, got "
                             f"{getattr(t, 'dtype', type(t).__name__)}")
        if not t.is_contiguous():
            raise ValueError(f"spectral_rhs takes a contiguous {name}, strides {t.stride()}")
    if b.shape != f.shape:
        raise ValueError(f"B {tuple(b.shape)} differs from F {tuple(f.shape)}")
    n, h, wf = f.shape
    if f.numel() == 0:
        raise ValueError(f"empty spectrum {tuple(f.shape)}")
    if tuple(c.shape) not in ((h, wf), (n, h, wf)):
        raise ValueError(f"C {tuple(c.shape)} is neither ({h}, {wf}) nor ({n}, {h}, {wf})")
    if rho.ndim != 0 and tuple(rho.shape) != (n, 1, 1):
        raise ValueError(f"rho {tuple(rho.shape)} is neither 0-d nor ({n}, 1, 1)")
    if any(t.device != f.device for t in (b, c, rho)):
        raise ValueError("F, B, C and rho must lie on one device: "
                         f"{[str(t.device) for t in (f, b, c, rho)]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (f, b, c, rho)):
        raise ValueError("spectral_rhs has no backward: call it where no graph is recorded "
                         "(the solver keeps the composition there)")
    return c.ndim == 3, rho.ndim == 3


def spectral_rhs(f: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 rho: torch.Tensor) -> torch.Tensor:
    """``C * (B + rho * F)``, written into ``F``; returns ``F``.

    ``F`` (the fresh output of ``rfft2(q)``, owned by the caller) and ``B``
    are contiguous complex64 ``(N, H, Wf)``; ``C`` is float32 ``(H, Wf)``
    or ``(N, H, Wf)``; ``rho`` a float32 tensor, 0-d or ``(N, 1, 1)``.  All
    on one device: a CUDA tensor launches the kernel, a CPU tensor takes
    the plain composition.  No operand may require grad where grad is
    enabled.
    """
    c_per_plane, rho_per_plane = _check_operands(f, b, c, rho)
    if f.device.type == "cpu":
        return f.copy_(_spectral_rhs_plain(f, b, c, rho))
    if f.device.type != "cuda":
        raise ValueError(f"no spectral-rhs kernel for device {f.device}")
    n, h, wf = f.shape
    _launch(_kernel_fn, "spectral_rhs", f.device, f.data_ptr(), b.data_ptr(), c.data_ptr(),
            rho.data_ptr(), f.numel(), h * wf, int(c_per_plane), int(rho_per_plane))
    spectral_rhs.launches += 1
    return f


spectral_rhs.launches = 0
