"""Fused whole-stencil ADMM step: D, prox, dual ascent and D^T in one pass,
and its backward.

Counterpart of ``admm_deconv_tpu/ops/pallas/stencil_kernels.py``
(``fused_admm_stencil`` and ``fused_admm_stencil_mixed``).  Per plane,

    dx = D x;  v = dx + u;  z = prox(v, tau);  u' = v - z;  q = D^T (z - u')

returning ``(q, ux', uy')``.  ``z`` never reaches device memory: with plain
ADMM the solver's loop state is ``(q, u)`` alone.

Both wrappers go through one ``torch.autograd.Function`` (the counterpart
of the JAX package's ``jax.custom_vjp``).  On a CUDA tensor its forward
launches the hand-written kernel ``csrc/stencil_fwd.cu`` and its backward
``csrc/stencil_bwd.cu`` (built at first use, see ``_build.py``); on a CPU
tensor they run :func:`_stencil_plain` and :func:`_bwd_plain`, the same
arithmetic in plain torch.  So the CPU path computes the same analytic
gradient as the card and as JAX's custom VJP.  Nothing falls back: a build
or launch failure raises.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from admm_deconv_tpu_torch.ops.diff import grad2d, grad2d_adjoint
from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES, prox_apply, prox_vjp

_MODE_ID = {m: i for i, m in enumerate(MODES)}
_DUAL_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1
# Threads per block of both kernels; a block covers one row segment.
_THREADS = 256


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


def _bwd_plain(x, ux, uy, tau, gq, gux, guy, mode):
    """Plain-torch twin of the backward kernel (JAX's ``_bwd_jnp``).

    With residuals ``(x, ux, uy, tau)`` and cotangents ``(gq, gux, guy)``:
    ``wb = D gq``, ``zb = 2 wb - gu``, ``vb = gu - wb + J_prox^T zb``,
    ``xbar = D^T vb``, ``ubar = vb`` and ``taub`` the per-plane sum of
    ``(dz/dtau) zb``.  Narrow (bf16) duals and cotangents are cast up and
    everything is computed in ``x``'s dtype; ``ubar`` is cast back to the
    duals' dtype.  Returns ``(xbar, uxbar, uybar, taub)`` with ``taub`` of
    shape ``(N,)`` in ``x``'s dtype.
    """
    f = x.dtype
    t = tau if tau.ndim == 0 else tau[:, None, None]
    dxx, dxy = grad2d(x)
    vx, vy = dxx + ux.to(f), dxy + uy.to(f)
    wbx, wby = grad2d(gq.to(f))
    gux, guy = gux.to(f), guy.to(f)
    zbx = 2.0 * wbx - gux
    zby = 2.0 * wby - guy
    pvx, pvy, taub = prox_vjp(mode, vx, vy, t, zbx, zby)
    vbx = gux - wbx + pvx
    vby = guy - wby + pvy
    xbar = grad2d_adjoint(vbx, vby)
    return xbar, vbx.to(ux.dtype), vby.to(ux.dtype), torch.sum(taub, dim=(-2, -1))


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


def _load_kernel(name: str, entry: str, n_ptrs: int):
    from admm_deconv_tpu_torch.ops.kernels import _build

    lib = _build.load(name)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.admm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.admm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.admm_cuda_error_string


@functools.cache
def _kernel_fn():
    return _load_kernel("stencil_fwd", "admm_stencil_fwd", 7)


@functools.cache
def _bwd_kernel_fn():
    return _load_kernel("stencil_bwd", "admm_stencil_bwd", 11)


def _check_cuda_operands(x, ux):
    """What both kernels take: fp32 x, fp32 or bf16 duals, a grid that fits."""
    if x.device.type != "cuda":
        raise ValueError(f"no stencil kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"the CUDA stencil takes float32 x, got {x.dtype}")
    if ux.dtype not in _DUAL_DTYPES:
        raise ValueError(f"the CUDA stencil takes float32 or bfloat16 duals, got {ux.dtype}")
    n, h, w = x.shape
    if n * h == 0 or w == 0:
        raise ValueError(f"empty plane stack {tuple(x.shape)}")
    if n * h > _INT32_MAX or w > _INT32_MAX:
        raise ValueError(f"plane stack {tuple(x.shape)} too large for the kernel grid")


def _launch(kernel_fn, name, x, args, n, h, w, mode, bf16):
    fn, err_str = kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, n, h, w, _MODE_ID[mode], int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(err).decode()} (cudaError {err})")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stencil_cuda(x, ux, uy, tau, mode):
    """Check the operands and launch ``csrc/stencil_fwd.cu`` on the current
    stream.  Outputs are fresh buffers (never aliased onto ``ux``/``uy``)."""
    _check_cuda_operands(x, ux)
    n, h, w = x.shape
    x, ux, uy = x.contiguous(), ux.contiguous(), uy.contiguous()
    tau_n = tau.to(torch.float32).expand(n).contiguous()
    q = torch.empty_like(ux)
    ux_new = torch.empty_like(ux)
    uy_new = torch.empty_like(ux)
    _launch(
        _kernel_fn, "stencil_fwd", x,
        [_ptr(a) for a in (x, ux, uy, tau_n, q, ux_new, uy_new)],
        n, h, w, mode, ux.dtype == torch.bfloat16,
    )
    return q, ux_new, uy_new


def _stencil_bwd_cuda(x, ux, uy, tau, gq, gux, guy, mode, need_x=True, need_u=True,
                      need_tau=True):
    """Check the operands and launch ``csrc/stencil_bwd.cu`` on the current
    stream, counted in ``fused_admm_stencil_bwd.launches``.  Outputs nobody
    needs come back as None, are not allocated and not written (the kernel
    skips a null pointer).  ``taub`` comes back as the ``(N,)`` sum of the
    kernel's per-block partials, in a fixed order."""
    _check_cuda_operands(x, ux)
    n, h, w = x.shape
    if not (gq.dtype == gux.dtype == guy.dtype == ux.dtype):
        raise ValueError(
            f"cotangent dtypes {gq.dtype}/{gux.dtype}/{guy.dtype} differ from the "
            f"duals' {ux.dtype}"
        )
    x, ux, uy, gq, gux, guy = (a.contiguous() for a in (x, ux, uy, gq, gux, guy))
    tau_n = tau.to(torch.float32).expand(n).contiguous()
    xbar = torch.empty_like(x) if need_x else None
    uxbar = torch.empty_like(ux) if need_u else None
    uybar = torch.empty_like(ux) if need_u else None
    col_blocks = (w + _THREADS - 1) // _THREADS
    partials = (
        torch.empty((n, h * col_blocks), dtype=torch.float32, device=x.device)
        if need_tau else None
    )
    _launch(
        _bwd_kernel_fn, "stencil_bwd", x,
        [_ptr(a) for a in (x, ux, uy, tau_n, gq, gux, guy, xbar, uxbar, uybar, partials)],
        n, h, w, mode, ux.dtype == torch.bfloat16,
    )
    fused_admm_stencil_bwd.launches += 1
    taub = None if partials is None else torch.sum(partials, dim=1)
    return xbar, uxbar, uybar, taub


def fused_admm_stencil_bwd(x, ux, uy, tau, gq, gux, guy, mode):
    """Backward of the fused stencil (the counterpart of JAX's ``_bwd_pallas``).

    ``tau`` is 0-d or ``(N,)``.  On a CUDA tensor it launches
    ``csrc/stencil_bwd.cu``; on a CPU tensor it runs :func:`_bwd_plain`.
    Returns ``(xbar, uxbar, uybar, taub)`` on both: ``xbar`` fp32, the dual
    cotangents in the duals' dtype, ``taub`` the per-plane ``(N,)`` sums.
    """
    if x.device.type == "cpu":
        return _bwd_plain(x, ux, uy, tau, gq, gux, guy, mode)
    return _stencil_bwd_cuda(x, ux, uy, tau, gq, gux, guy, mode)


fused_admm_stencil_bwd.launches = 0


class _FusedStencil(torch.autograd.Function):
    """The forward kernel (its plain version on a CPU tensor) with the
    analytic backward of :func:`fused_admm_stencil_bwd`.  Saves the
    residuals ``(x, ux, uy, tau)``; ``v`` is recomputed in the backward.  On
    a CUDA tensor the backward kernel skips the gradients nobody asked for."""

    @staticmethod
    def forward(ctx, x, ux, uy, tau, mode, wrapper):
        ctx.mode = mode
        ctx.save_for_backward(x, ux, uy, tau)
        if x.device.type == "cpu":
            return _stencil_plain(x, ux, uy, tau, mode)
        out = _stencil_cuda(x, ux, uy, tau, mode)
        wrapper.launches += 1
        return out

    @staticmethod
    def backward(ctx, gq, gux, guy):
        x, ux, uy, tau = ctx.saved_tensors
        need_x, need_ux, need_uy, need_tau = ctx.needs_input_grad[:4]
        if x.device.type == "cpu":
            xbar, uxbar, uybar, taub = _bwd_plain(x, ux, uy, tau, gq, gux, guy, ctx.mode)
        else:
            xbar, uxbar, uybar, taub = _stencil_bwd_cuda(
                x, ux, uy, tau, gq, gux, guy, ctx.mode,
                need_x=need_x, need_u=need_ux or need_uy, need_tau=need_tau,
            )
        if need_tau:
            taub = (taub.sum() if tau.ndim == 0 else taub).to(tau.dtype)
        return (
            xbar if need_x else None,
            uxbar if need_ux else None,
            uybar if need_uy else None,
            taub if need_tau else None,
            None,
            None,
        )


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

    ``tau`` is a scalar or a per-plane ``(N,)`` / ``(N,1,1)`` vector.
    Differentiable in ``(x, ux, uy, tau)`` through the fused backward.
    Unlike the TPU kernel there is no row-block constraint on H or W.
    ``interpret`` is accepted for call compatibility and has no effect:
    a CPU tensor always takes the plain version.

    Returns ``(q, ux_new, uy_new)``.
    """
    tau_c = _check(x, ux, uy, tau, mode, x.dtype)
    return _FusedStencil.apply(x, ux, uy, tau_c, mode, fused_admm_stencil)


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
    arithmetic runs in fp32; only the device-memory state narrows.  The
    backward takes bf16 cotangents, computes in fp32 and returns the dual
    cotangents in bf16 (``xbar`` stays fp32).
    ``impl`` ("dma" | "blocked") named the TPU kernel's two forms; both map
    to the one CUDA kernel, and ``interpret`` has no effect.
    """
    if impl not in ("dma", "blocked"):
        raise ValueError(f"impl must be dma|blocked, got {impl!r}")
    tau_c = _check(x, ux, uy, tau, mode, torch.float32)
    return _FusedStencil.apply(x, ux, uy, tau_c, mode, fused_admm_stencil_mixed)


fused_admm_stencil_mixed.launches = 0
