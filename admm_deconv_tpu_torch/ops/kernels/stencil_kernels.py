"""Fused whole-stencil ADMM step: D, prox, dual ascent and D^T in one pass.

Counterpart of ``admm_deconv_tpu/ops/pallas/stencil_kernels.py``
(``fused_admm_stencil`` and ``fused_admm_stencil_mixed``).  Per plane,

    dx = D x;  v = dx + u;  z = prox(v, tau);  u' = v - z;  q = D^T (z - u')

returning ``(q, ux', uy')``.  ``z`` never reaches device memory: with plain
ADMM the solver's loop state is ``(q, u)`` alone.

On a CUDA tensor each wrapper launches the hand-written kernel
``csrc/stencil_fwd.cu`` (built at first use, see ``_build.py``); on a CPU
tensor it runs :func:`_stencil_plain`, the same arithmetic in plain torch.
Nothing falls back: a build or launch failure raises.  The kernel has no
backward yet, so a CUDA call that needs gradients raises
``NotImplementedError``; the plain version is differentiable by autograd.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES, prox_apply

_MODE_ID = {m: i for i, m in enumerate(MODES)}
_DUAL_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1


def _stencil_plain(x, ux, uy, tau, mode):
    """Plain-torch twin of the kernel.  ``tau`` is 0-d or ``(N,)``.

    Computes in ``x``'s dtype (the duals are cast up) and returns the
    outputs in the duals' dtype.
    """
    f = x.dtype
    t = tau if tau.ndim == 0 else tau[:, None, None]
    dxx = x - torch.roll(x, 1, dims=-1)
    dxy = x - torch.roll(x, 1, dims=-2)
    vx = dxx + ux.to(f)
    vy = dxy + uy.to(f)
    zx, zy = prox_apply(mode, vx, vy, t)
    ux_new = vx - zx
    uy_new = vy - zy
    wx = zx - ux_new  # = 2 z - v
    wy = zy - uy_new
    q = (wx - torch.roll(wx, -1, dims=-1)) + (wy - torch.roll(wy, -1, dims=-2))
    out = ux.dtype
    return q.to(out), ux_new.to(out), uy_new.to(out)


def _tau_plane_vector(tau, n: int, dtype, device) -> torch.Tensor | None:
    """Canonicalize tau to 0-d or ``(N,)``; None if not representable."""
    tau = torch.as_tensor(tau, dtype=dtype, device=device)
    if tau.ndim == 0:
        return tau
    flat = tau.reshape(-1)
    if flat.shape[0] == 1:
        return flat[0]
    if flat.shape[0] == n:
        return flat
    return None


@functools.cache
def _kernel_fn():
    from admm_deconv_tpu_torch.ops.kernels import _build

    lib = _build.load("stencil_fwd")
    fn = lib.admm_stencil_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.admm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.admm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.admm_cuda_error_string


def _stencil_cuda(x, ux, uy, tau, mode):
    """Check the operands and launch ``csrc/stencil_fwd.cu`` on the current
    stream.  Outputs are fresh buffers (never aliased onto ``ux``/``uy``)."""
    if x.device.type != "cuda":
        raise ValueError(f"no stencil kernel for device {x.device}")
    if any(t.requires_grad for t in (x, ux, uy, tau)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "the CUDA stencil kernel has no backward yet (the backward stencil "
            "kernel, ROADMAP Queue 2 item 2); run the solve under "
            "torch.no_grad() or on CPU tensors"
        )
    if x.dtype != torch.float32:
        raise ValueError(f"the CUDA stencil takes float32 x, got {x.dtype}")
    if ux.dtype not in _DUAL_DTYPES:
        raise ValueError(f"the CUDA stencil takes float32 or bfloat16 duals, got {ux.dtype}")
    n, h, w = x.shape
    if n * h == 0 or w == 0:
        raise ValueError(f"empty plane stack {tuple(x.shape)}")
    if n * h > _INT32_MAX or w > _INT32_MAX:
        raise ValueError(f"plane stack {tuple(x.shape)} too large for the kernel grid")
    x, ux, uy = x.contiguous(), ux.contiguous(), uy.contiguous()
    tau_n = tau.to(torch.float32).expand(n).contiguous()
    q = torch.empty_like(ux)
    ux_new = torch.empty_like(ux)
    uy_new = torch.empty_like(ux)
    fn, err_str = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), ux.data_ptr(), uy.data_ptr(), tau_n.data_ptr(),
            q.data_ptr(), ux_new.data_ptr(), uy_new.data_ptr(),
            n, h, w, _MODE_ID[mode], int(ux.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"stencil_fwd launch failed: {err_str(err).decode()} (cudaError {err})"
        )
    return q, ux_new, uy_new


def _check(x, ux, uy, tau, mode, tau_dtype):
    """The counterpart's checks; returns tau as 0-d or ``(N,)``."""
    if x.ndim != 3:
        raise ValueError(f"expected (N, H, W), got {tuple(x.shape)}")
    if mode not in MODES:
        raise ValueError(f"unknown prox mode {mode!r}; expected one of {MODES}")
    if ux.dtype != uy.dtype:
        raise ValueError(f"ux/uy dtypes differ: {ux.dtype} vs {uy.dtype}")
    if ux.shape != x.shape or uy.shape != x.shape:
        raise ValueError(
            f"x/ux/uy shapes differ: {tuple(x.shape)}/{tuple(ux.shape)}/{tuple(uy.shape)}"
        )
    if ux.device != x.device or uy.device != x.device:
        raise ValueError(
            f"x/ux/uy devices differ: {x.device}/{ux.device}/{uy.device}"
        )
    tau_c = _tau_plane_vector(tau, x.shape[0], tau_dtype, x.device)
    if tau_c is None:
        raise ValueError(
            f"tau shape {tuple(torch.as_tensor(tau).shape)} not scalar or "
            f"per-plane ({x.shape[0]},)"
        )
    return tau_c


def fused_admm_stencil(
    x: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    tau,
    mode: str = "aniso",
    interpret: bool | None = None,
):
    """One-pass D -> prox -> dual -> D^T over ``(N, H, W)`` planes.

    Semantically identical to::

        dxx, dxy = grad2d(x)
        zx, zy, ux2, uy2 = prox_dual_step(dxx, dxy, ux, uy, tau, prox)
        q = grad2d_adjoint(zx - ux2, zy - uy2)
        return q, ux2, uy2

    ``tau`` is a scalar or a per-plane ``(N,)`` / ``(N,1,1)`` vector.  Unlike
    the TPU kernel there is no row-block constraint on H or W.
    ``interpret`` is accepted for call compatibility and has no effect:
    a CPU tensor always takes the plain version.

    Returns ``(q, ux_new, uy_new)``.
    """
    tau_c = _check(x, ux, uy, tau, mode, x.dtype)
    if x.device.type == "cpu":
        return _stencil_plain(x, ux, uy, tau_c, mode)
    out = _stencil_cuda(x, ux, uy, tau_c, mode)
    fused_admm_stencil.launches += 1
    return out


fused_admm_stencil.launches = 0


def fused_admm_stencil_mixed(
    x: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    tau,
    mode: str = "aniso",
    interpret: bool | None = None,
    impl: str = "dma",
):
    """Mixed-precision-storage variant of :func:`fused_admm_stencil`.

    ``x`` stays fp32; the carried duals ``ux``/``uy`` — and the emitted
    ``(q, ux', uy')`` — live in a narrower storage dtype (bfloat16).  All
    arithmetic runs in fp32; only the device-memory state narrows.
    ``impl`` ("dma" | "blocked") named the TPU kernel's two forms; both map
    to the one CUDA kernel, and ``interpret`` has no effect.
    """
    if impl not in ("dma", "blocked"):
        raise ValueError(f"impl must be dma|blocked, got {impl!r}")
    tau_c = _check(x, ux, uy, tau, mode, torch.float32)
    if x.device.type == "cpu":
        return _stencil_plain(x, ux, uy, tau_c, mode)
    out = _stencil_cuda(x, ux, uy, tau_c, mode)
    fused_admm_stencil_mixed.launches += 1
    return out


fused_admm_stencil_mixed.launches = 0
