"""Fused z-update + dual ascent over the gradient pair: one elementwise pass.

Counterpart of ``admm_deconv_tpu/ops/pallas/prox_kernels.py``.  The ADMM
iteration's non-FFT tail outside the fused stencil,

    v = d + u;  z = prox(v, tau);  u' = v - z

over both gradient components (4 arrays in, 4 out; the isotropic prox
couples the pair through the per-pixel magnitude), returning
``(zx, zy, ux', uy')``.  The solver runs it where the full state
``(x, z, u)`` is needed: the reference-shaped loop (diagnostics, state
output), over-relaxation and the adaptive solver's residual-check
iterations.

:func:`fused_prox_dual` goes through one ``torch.autograd.Function``.  On a
CUDA tensor its forward launches the hand-written kernel
``csrc/prox_dual.cu`` (built at first use, see ``_build.py``); on a CPU
tensor it runs :func:`_prox_dual_plain`, the same arithmetic in plain
torch.  The backward is the analytic VJP of the JAX package's custom VJP,
in plain torch on both devices (the JAX backward is jnp, not a kernel), so
an isotropic flat region gets the same finite gradient as JAX.  Nothing
falls back: a build or launch failure raises.

Kernel launches are counted in ``fused_prox_dual.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES, prox_apply, prox_vjp
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
    _MODE_ID,
    _launch,
    _load_kernel,
    _tau_plane_vector,
)

# gridDim.y carries the plane: at most 65535 per-plane taus.
_MAX_PLANES = 65535


def _tau_b(tau, ndim: int):
    """tau (0-d or ``(N,)``) shaped to broadcast against an ``ndim`` array
    that leads with the plane axis."""
    return tau if tau.ndim == 0 else tau.reshape((-1,) + (1,) * (ndim - 1))


def _prox_dual_plain(dxx, dxy, ux, uy, tau, mode):
    """Plain-torch twin of the kernel.  ``tau`` is 0-d or ``(N,)``."""
    t = _tau_b(tau, dxx.ndim)
    vx = dxx + ux
    vy = dxy + uy
    zx, zy = prox_apply(mode, vx, vy, t)
    return zx, zy, vx - zx, vy - zy


@functools.cache
def _kernel_fn():
    return _load_kernel("prox_dual", "admm_prox_dual", 9,
                        (ctypes.c_int64, ctypes.c_int64, ctypes.c_int))


def _prox_dual_cuda(dxx, dxy, ux, uy, tau, mode):
    """Check the operands and launch ``csrc/prox_dual.cu`` on the current
    stream.  Outputs are fresh buffers."""
    if dxx.device.type != "cuda":
        raise ValueError(f"no prox-dual kernel for device {dxx.device}")
    if dxx.dtype != torch.float32:
        raise ValueError(f"the CUDA prox-dual kernel takes float32, got {dxx.dtype}: pass a "
                         "float32 tensor, or a numpy array (it goes to the card as float32)")
    total = dxx.numel()
    if total == 0:
        raise ValueError(f"empty operands {tuple(dxx.shape)}")
    n_planes = 1 if tau.ndim == 0 else tau.shape[0]
    if n_planes > _MAX_PLANES:
        raise ValueError(f"{n_planes} per-plane taus; the kernel takes at most {_MAX_PLANES}")
    dxx, dxy, ux, uy = (a.contiguous() for a in (dxx, dxy, ux, uy))
    tau_n = tau.to(torch.float32).reshape(n_planes).contiguous()
    outs = [torch.empty_like(dxx) for _ in range(4)]
    _launch(
        _kernel_fn, "prox_dual", dxx.device,
        *(a.data_ptr() for a in (dxx, dxy, ux, uy, tau_n, *outs)),
        n_planes, total // n_planes, _MODE_ID[mode],
    )
    return tuple(outs)


class _FusedProxDual(torch.autograd.Function):
    """The kernel (its plain twin on a CPU tensor) with JAX's analytic VJP."""

    @staticmethod
    def forward(ctx, dxx, dxy, ux, uy, tau, mode):
        ctx.mode = mode
        ctx.save_for_backward(dxx, dxy, ux, uy, tau)
        if dxx.device.type == "cpu":
            return _prox_dual_plain(dxx, dxy, ux, uy, tau, mode)
        out = _prox_dual_cuda(dxx, dxy, ux, uy, tau, mode)
        fused_prox_dual.launches += 1
        return out

    @staticmethod
    def backward(ctx, gzx, gzy, gux, guy):
        dxx, dxy, ux, uy, tau = ctx.saved_tensors
        vx, vy = dxx + ux, dxy + uy
        # z gets -gu through u' = v - z; v gets +gu directly.
        pvx, pvy, taub = prox_vjp(ctx.mode, vx, vy, _tau_b(tau, dxx.ndim),
                                  gzx - gux, gzy - guy)
        vbx = gux + pvx
        vby = guy + pvy
        taub = taub.sum() if tau.ndim == 0 else taub.reshape(tau.shape[0], -1).sum(dim=1)
        # v = d + u: d and u get the same cotangent.
        return vbx, vby, vbx, vby, taub.to(tau.dtype), None


def fused_prox_dual(
    dxx: torch.Tensor,
    dxy: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    tau,
    mode: str = "aniso",
    interpret: bool | None = None,
):
    """One-pass fused prox + dual ascent (differentiable).

    Semantically identical to :func:`admm_deconv_tpu_torch.ops.prox.prox_dual_step`
    with the matching operator.  ``tau`` is a scalar (the arrays may have any
    shape) or per-plane ``(N,)`` / ``(N,1,1)`` (the arrays then lead with the
    plane axis).  The four arrays share one shape, dtype and device; the
    kernel takes float32.  ``interpret`` is accepted for call compatibility
    and has no effect: a CPU tensor always takes the plain version.

    Returns ``(zx, zy, ux_new, uy_new)``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown prox mode {mode!r}; expected one of {MODES}")
    for name, a in (("dxy", dxy), ("ux", ux), ("uy", uy)):
        if a.shape != dxx.shape or a.dtype != dxx.dtype or a.device != dxx.device:
            raise ValueError(
                f"{name} {tuple(a.shape)} {a.dtype} {a.device} differs from dxx "
                f"{tuple(dxx.shape)} {dxx.dtype} {dxx.device}"
            )
    n = dxx.shape[0] if dxx.ndim else 1
    tau_c = _tau_plane_vector(tau, n, dxx.dtype, dxx.device)
    if tau_c is None:
        raise ValueError(
            f"tau shape {tuple(torch.as_tensor(tau).shape)} not scalar or per-plane ({n},)"
        )
    return _FusedProxDual.apply(dxx, dxy, ux, uy, tau_c, mode)


fused_prox_dual.launches = 0
