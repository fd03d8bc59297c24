"""ADMM TV deconvolution solver — PyTorch counterpart of
``admm_deconv_tpu/ops/solver.py::tv_deconvolve``.

Problem: given blurred/noisy ``y`` and PSF ``h``, solve

    min_x  0.5 * ||H x - y||^2 + lam * ||D x||

with the anisotropic l1 or isotropic l2,1 norm of the circular image
gradient ``D``, split as ``z = D x`` with scaled dual ``u``, penalty ``rho``
and threshold ``tau = lam / rho``.  Each iteration is

    x   = irfft2( C * (B_f + rho * rfft2(q)) )          # closed-form x-update
    q   = D^T (z - u)  after  z, u = prox/dual(D x + u)  # one stencil pass

The default loop carries ``(q, u)`` only (the *q-carry* form): neither ``z``
nor ``x`` is stored between iterations, and the output image is one extra
spectral solve after the loop.  Its stencil pass is the hand-written CUDA
kernel on a CUDA tensor (``ops/kernels/stencil_kernels.py``), and its
gradient the hand-written backward kernel.  The
reference-shaped loop over the full state ``(x, z, u)`` serves diagnostics,
warm-start state requests and over-relaxation with state output.

Every ``fft_mode`` of the JAX package is accepted and computed the same way:
``torch.fft`` at the input's precision (cuFFT on the card).  The TPU's
matmul DFT variants exist there for speed alone.

Layout: the public API is NHWC ``(B, H, W, C)`` (also ``(H, W)`` and
``(H, W, C)``); inside, channels fold into the batch as ``(B*C, H, W)``
planes.  Everything runs on ``y``'s device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from admm_deconv_tpu_torch.ops import prox as prox_lib
from admm_deconv_tpu_torch.ops.diff import grad2d, grad2d_adjoint
from admm_deconv_tpu_torch.ops.fft import laplacian_spectrum, psf_to_otf
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
    fused_admm_stencil,
    fused_admm_stencil_mixed,
)

# The JAX package's FFT mode names; all compute the same exact transform here.
_FFT_MODES = (
    "xla", "mxu", "mxu_precise", "fold", "fold1", "fold_precise", "pack",
    "pack_precise",
)
# "auto" and "pallas" take the fused stencil kernel (its plain version on a
# CPU tensor); "xla" the plain prox_dual_step composition.
_PROX_IMPLS = ("auto", "pallas", "xla")

# Canonical prox-mode names for the fused stencil kernel.
_KERNEL_PROX_MODES = {
    "aniso": "aniso",
    "soft": "aniso",
    "iso": "iso",
    "block": "iso",
    "hard": "hard",
    "gauss": "gauss",
}


class ADMMState(NamedTuple):
    """Solver iterate: primal image, split gradient pair, scaled duals,
    each ``(B*C, H, W)``."""

    x: torch.Tensor
    zx: torch.Tensor
    zy: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor


class ADMMDiagnostics(NamedTuple):
    """Per-plane primal/dual residual norms of the last iteration, the
    iteration count and the per-plane penalty."""

    r_norm: torch.Tensor
    s_norm: torch.Tensor
    iterations: torch.Tensor
    rho: torch.Tensor


def _normalize_input(y: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Promote ``(H,W)``/``(H,W,C)``/``(B,H,W,C)`` to ``(B,H,W,C)``."""
    orig_shape = tuple(y.shape)
    if y.ndim == 2:
        y = y[None, :, :, None]
    elif y.ndim == 3:
        y = y[None]
    elif y.ndim != 4:
        raise ValueError(f"expected 2/3/4-dim input, got shape {orig_shape}")
    return y, orig_shape


def _fold(y: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) -> (B*C, H, W): channels ride the batch dim."""
    b, h, w, c = y.shape
    return y.permute(0, 3, 1, 2).reshape(b * c, h, w)


def _unfold(x: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """(B*C, H, W) -> (B,H,W,C)."""
    _, h, w = x.shape
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _fold_param(p, b: int, c: int, dtype, device) -> torch.Tensor:
    """Broadcast a scalar / (1,) / (B,) / (B,C) parameter to 0-d or (B*C, 1, 1)."""
    p = torch.as_tensor(p, dtype=dtype, device=device)
    if p.ndim == 0 or p.numel() == 1:
        return p.reshape(())
    if tuple(p.shape) == (b,):
        p = p.repeat_interleave(c)
    elif tuple(p.shape) == (b, c):
        p = p.reshape(b * c)
    else:
        raise ValueError(
            f"parameter shape {tuple(p.shape)} not broadcastable over "
            f"batch={b}, channels={c}"
        )
    return p[:, None, None]


def _prepare(y, psf, lam, rho):
    """Shared precompute: folding, OTF, spectra, and the cached rhs
    ``b_f = conj(otf) * rfft2(y)``.  ``psf=None`` (or empty) is pure TV
    denoising, H = identity."""
    y4, _ = _normalize_input(y)
    b, h, w, c = y4.shape
    dtype, device = y4.dtype, y4.device
    y_f = _fold(y4)
    lam_f = _fold_param(lam, b, c, dtype, device)
    rho_f = _fold_param(rho, b, c, dtype, device)

    lap = laplacian_spectrum((h, w), dtype=dtype, device=device)
    y_hat = torch.fft.rfft2(y_f)
    if psf is None or torch.as_tensor(psf).numel() == 0:
        denom_h = torch.ones((), dtype=dtype, device=device)
        b_f = y_hat
    else:
        psf = torch.as_tensor(psf, dtype=dtype, device=device)
        if psf.ndim != 2:
            psf = psf.reshape(psf.shape[0], psf.shape[1])
        otf = psf_to_otf(psf, (h, w))
        denom_h = torch.abs(otf) ** 2
        b_f = torch.conj(otf) * y_hat
    return y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c)


def _form_cspec(denom_h, lap, rho):
    """Normal-equation inverse ``1/(|Sigma|^2 + rho |Lambda|^2)``: ``(H, Wf)``,
    or ``(N, H, Wf)`` for per-plane rho."""
    return 1.0 / (denom_h + rho * lap)


def _solve_spectral(b_f, c_spec, rho, q, h, w):
    """Closed-form normal-equation solve ``irfft2(c_spec * (B + rho * rfft2(q)))``.

    A narrow (bf16) ``q`` is cast up first: cuFFT and pocketfft take no bf16.
    """
    q = q.to(c_spec.dtype)
    return torch.fft.irfft2(c_spec * (b_f + rho * torch.fft.rfft2(q)), s=(h, w))


def _as_dtype(state_dtype) -> torch.dtype | None:
    if state_dtype is None or isinstance(state_dtype, torch.dtype):
        return state_dtype
    dt = getattr(torch, str(state_dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown state_dtype {state_dtype!r}")
    return dt


def tv_deconvolve(
    y: torch.Tensor,
    psf: torch.Tensor | None = None,
    lam=0.1,
    rho=1.0,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    return_diagnostics: bool = False,
    remat: bool = False,
    fft_mode: str = "auto",
    prox_impl: str = "auto",
    alpha: float = 1.0,
    init_state: ADMMState | None = None,
    return_state: bool = False,
    state_dtype: str | torch.dtype | None = None,
):
    """Fixed-iteration ADMM TV deconvolution.

    Args:
      y: degraded image(s), ``(B,H,W,C)`` (or 2-D/3-D variants), float32;
        the solve runs on ``y``'s device.
      psf: blur kernel ``(kh,kw)`` or None for pure TV denoising.
      lam: TV weight — scalar or per-image ``(B,)`` / per-channel ``(B,C)``.
      rho: ADMM penalty, same broadcast rules.
      iters: number of ADMM iterations.
      prox: z-update operator name or callable.
      x_bounds: optional box constraint projected in the x-update.
      return_diagnostics: also return the last iteration's residual norms.
      remat: recompute each iteration in the backward pass
        (``torch.utils.checkpoint``) instead of storing its activations.
      fft_mode: any JAX mode name or "auto"; all compute ``torch.fft``.
      prox_impl: "auto"/"pallas" = fused stencil kernel on a CUDA tensor
        (its plain version on a CPU tensor); "xla" = the plain composition.
        The kernel serves the q-carry loop (alpha=1, named prox); other
        loops run the plain composition, as the prox-dual kernel of the
        JAX package is not ported yet.
      alpha: over-relaxation factor; 1.0 = plain ADMM.
      init_state: warm-start iterate from a ``return_state=True`` solve.
      return_state: also return the final :class:`ADMMState`.
      state_dtype: narrower storage dtype ("bfloat16") for the loop carry
        ``(q, ux, uy)``; arithmetic stays fp32.  Needs the fast kernel path:
        alpha=1, a named prox, prox_impl "auto"/"pallas", no diagnostics or
        state request.

    Differentiable in ``y``, ``psf``, ``lam`` and ``rho`` (scalar or
    per-image) on either device: the kernel path's stencil carries an
    analytic backward (the backward kernel on a CUDA tensor), the plain
    path goes through autograd.  With ``remat`` each iteration's forward,
    stencil kernel included, runs again in the backward pass.

    Returns:
      Restored image(s) with the input's shape; with flags set, a tuple
      ``(x[, diagnostics][, state])`` in that order.
    """
    if fft_mode != "auto" and fft_mode not in _FFT_MODES:
        raise ValueError(f"fft_mode must be 'auto' or one of {_FFT_MODES}, got {fft_mode!r}")
    if prox_impl not in _PROX_IMPLS:
        raise ValueError(f"prox_impl must be one of {_PROX_IMPLS}, got {prox_impl!r}")
    y = torch.as_tensor(y)
    _, orig_shape = _normalize_input(y)
    y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c) = _prepare(y, psf, lam, rho)
    tau = lam_f / rho_f
    c_spec = _form_cspec(denom_h, lap, rho_f)
    n = b * c
    if state_dtype is not None and (return_diagnostics or return_state or iters < 1):
        raise ValueError(
            "state_dtype requires the fast q-carry path: no "
            "return_diagnostics/return_state, iters >= 1"
        )

    def solve(q):
        x = _solve_spectral(b_f, c_spec, rho_f, q, h, w)
        if x_bounds is not None:
            x = torch.clamp(x, x_bounds[0], x_bounds[1])
        return x

    def step(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    if not return_diagnostics and not return_state and iters >= 1:
        x = _fast_loop(
            solve, step, y_f, tau, iters, prox, prox_impl, alpha, init_state,
            _as_dtype(state_dtype),
        )
        return _unfold(x, b, c).reshape(orig_shape)

    if return_diagnostics and iters < 1:
        raise ValueError("return_diagnostics requires iters >= 1")
    if init_state is not None:
        state = ADMMState(*init_state)
    else:
        zeros = torch.zeros((n, h, w), dtype=y_f.dtype, device=y_f.device)
        state = ADMMState(zeros, zeros, zeros, zeros, zeros)
    prox_fn = prox_lib.resolve(prox)

    def body(x, zx, zy, ux, uy, diag):
        x_new = solve(grad2d_adjoint(zx - ux, zy - uy))
        dxx, dxy = grad2d(x_new)
        if alpha != 1.0:
            # Over-relaxation: blend D x with the previous z (Boyd sec. 3.4.3).
            rxx = alpha * dxx + (1.0 - alpha) * zx
            rxy = alpha * dxy + (1.0 - alpha) * zy
        else:
            rxx, rxy = dxx, dxy
        zx_new, zy_new, ux_new, uy_new = prox_lib.prox_dual_step(
            rxx, rxy, ux, uy, tau, prox_fn
        )
        out = (x_new, zx_new, zy_new, ux_new, uy_new)
        if diag:
            r = torch.sqrt(
                torch.sum((dxx - zx_new) ** 2 + (dxy - zy_new) ** 2, dim=(-2, -1))
            )
            dz = grad2d_adjoint(zx_new - zx, zy_new - zy)
            rho_n = rho_f[:, 0, 0] if rho_f.ndim else rho_f
            s = rho_n * torch.sqrt(torch.sum(dz**2, dim=(-2, -1)))
            out = out + (r, s)
        return out

    for i in range(iters):
        out = step(body, *state, return_diagnostics and i == iters - 1)
        state = ADMMState(*out[:5])
    x = _unfold(state.x, b, c).reshape(orig_shape)

    result = (x,)
    if return_diagnostics:
        r, s = out[5:]
        result += (
            ADMMDiagnostics(
                r_norm=r,
                s_norm=s,
                iterations=torch.tensor(iters, device=y_f.device),
                rho=torch.broadcast_to(rho_f.reshape(-1), (n,)),
            ),
        )
    if return_state:
        result += (state,)
    return result if len(result) > 1 else x


def _fast_loop(solve, step, y_f, tau, iters, prox, prox_impl, alpha, init_state,
               state_dtype):
    """The q-carry loop: ``iters - 1`` steps of spectral solve + stencil,
    then the final solve, which gives the output planes."""
    use_kernel = (
        prox_impl in ("auto", "pallas")
        and alpha == 1.0
        and isinstance(prox, str)
        and prox in _KERNEL_PROX_MODES
    )
    narrow = state_dtype is not None and state_dtype != y_f.dtype
    if narrow and not use_kernel:
        raise ValueError(
            "state_dtype requires the fast q-carry kernel path: plain ADMM "
            "(alpha=1), a named prox mode, and prox_impl 'auto' or 'pallas'"
        )

    if init_state is not None:
        zx0, zy0, ux0, uy0 = init_state[1:]
        q0 = grad2d_adjoint(zx0 - ux0, zy0 - uy0)
    else:
        q0 = zx0 = zy0 = ux0 = uy0 = torch.zeros_like(y_f)
    if narrow:
        q0, ux0, uy0 = q0.to(state_dtype), ux0.to(state_dtype), uy0.to(state_dtype)

    if use_kernel:
        mode = _KERNEL_PROX_MODES[prox]
        stencil = fused_admm_stencil_mixed if narrow else fused_admm_stencil

        def body(q, ux, uy):
            return stencil(solve(q), ux, uy, tau, mode=mode)

        carry = (q0, ux0, uy0)
    else:
        prox_fn = prox_lib.resolve(prox)

        def body(q, ux, uy, zx_prev=None, zy_prev=None):
            dxx, dxy = grad2d(solve(q))
            if alpha != 1.0:
                dxx = alpha * dxx + (1.0 - alpha) * zx_prev
                dxy = alpha * dxy + (1.0 - alpha) * zy_prev
            zx, zy, ux, uy = prox_lib.prox_dual_step(dxx, dxy, ux, uy, tau, prox_fn)
            q = grad2d_adjoint(zx - ux, zy - uy)
            return (q, ux, uy) if alpha == 1.0 else (q, ux, uy, zx, zy)

        carry = (q0, ux0, uy0) if alpha == 1.0 else (q0, ux0, uy0, zx0, zy0)

    for _ in range(iters - 1):
        carry = step(body, *carry)
    return solve(carry[0])
