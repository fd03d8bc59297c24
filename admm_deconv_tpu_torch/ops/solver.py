"""ADMM TV deconvolution solvers — PyTorch counterpart of
``admm_deconv_tpu/ops/solver.py``: the fixed-iteration ``tv_deconvolve``,
the residual-balanced ``tv_deconvolve_adaptive``, the Anderson-accelerated
``tv_deconvolve_anderson``, ``solve_auto`` and ``tv_objective``.

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
gradient the hand-written backward kernel; the x-update's complex
right-hand side is one hand-written pass (``ops/kernels/spectral_kernels.py``)
wherever autograd records no graph.  The
reference-shaped loop over the full state ``(x, z, u)`` serves diagnostics,
warm-start state requests and over-relaxation with state output; its
prox + dual step is the hand-written prox-dual kernel
(``ops/kernels/prox_kernels.py``) under ``prox_impl`` "auto"/"pallas".

Every ``fft_mode`` of the JAX package is accepted and computed the same way:
``torch.fft`` at the input's precision (cuFFT on the card).  The TPU's
matmul DFT variants exist there for speed alone.

Layout: the public API is NHWC ``(B, H, W, C)`` (also ``(H, W)`` and
``(H, W, C)``); inside, channels fold into the batch as ``(B*C, H, W)``
planes.  Everything runs on ``y``'s device: a ``torch.Tensor`` stays where
it is, anything else (a numpy array) goes to the card, as JAX puts a numpy
array on its default device.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from admm_deconv_tpu_torch.ops import prox as prox_lib
from admm_deconv_tpu_torch.ops.diff import grad2d, grad2d_adjoint
from admm_deconv_tpu_torch.ops.fft import laplacian_spectrum, psf_to_otf
from admm_deconv_tpu_torch.ops.kernels.prox_kernels import fused_prox_dual
from admm_deconv_tpu_torch.ops.kernels.spectral_kernels import spectral_rhs
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
    fused_admm_stencil,
    fused_admm_stencil_mixed,
)
from admm_deconv_tpu_torch.ops.policy import policy
from admm_deconv_tpu_torch.utils import arrays
from admm_deconv_tpu_torch.utils.precision import fp32_matmuls
from admm_deconv_tpu_torch.utils.profiling import trace_annotation

# The JAX package's FFT mode names; all compute the same exact transform here.
_FFT_MODES = (
    "xla", "mxu", "mxu_precise", "fold", "fold1", "fold_precise", "pack",
    "pack_precise",
)
# "pallas" takes the fused kernels (their plain versions on a CPU tensor),
# "xla" the plain prox_dual_step composition; "auto" resolves through the
# policy (:func:`resolve_prox_impl`).
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


def resolve_prox_impl(prox_impl: str) -> str:
    """Resolve ``"auto"`` to ``policy().prox_impl_accel`` ("pallas" by
    default: the kernels on a CUDA tensor, their plain twins on a CPU one)."""
    return policy().prox_impl_accel if prox_impl == "auto" else prox_impl


def _check_modes(fft_mode: str, prox_impl: str) -> str:
    """Validate the mode names; return the resolved ``prox_impl``."""
    if fft_mode != "auto" and fft_mode not in _FFT_MODES:
        raise ValueError(f"fft_mode must be 'auto' or one of {_FFT_MODES}, got {fft_mode!r}")
    if prox_impl not in _PROX_IMPLS:
        raise ValueError(f"prox_impl must be one of {_PROX_IMPLS}, got {prox_impl!r}")
    return resolve_prox_impl(prox_impl)


def _kernel_mode(prox, prox_impl: str) -> str | None:
    """The kernels' mode name when this request takes the kernels (a named
    prox under the resolved ``prox_impl="pallas"``), else None."""
    if prox_impl == "pallas" and isinstance(prox, str):
        return _KERNEL_PROX_MODES.get(prox)
    return None


def _tau_for_kernel(tau):
    """Canonicalize tau for the kernels: 0-d stays, a per-plane ``(N,1,1)``
    becomes ``(N,)``; None if the shape is not kernel-representable."""
    if tau.ndim == 0:
        return tau
    if tau.ndim == 3 and tuple(tau.shape[1:]) == (1, 1):
        return tau[:, 0, 0]
    return None


def _make_prox_step(prox, prox_impl):
    """Return a ``(dxx, dxy, ux, uy, tau) -> (zx, zy, ux', uy')`` step.

    ``prox_impl="pallas"`` with a named prox takes :func:`fused_prox_dual`
    (the prox-dual kernel on a CUDA tensor, its plain twin on a CPU one);
    anything else is the plain composition.  Both are differentiable.  The
    solvers' tau is 0-d or per-plane ``(N,1,1)``, which the kernel takes.
    """
    mode = _kernel_mode(prox, prox_impl)
    if mode is not None:

        def step(dxx, dxy, ux, uy, tau):
            return fused_prox_dual(dxx, dxy, ux, uy, tau, mode=mode)

        return step
    prox_fn = prox_lib.resolve(prox)

    def step(dxx, dxy, ux, uy, tau):
        return prox_lib.prox_dual_step(dxx, dxy, ux, uy, tau, prox_fn)

    return step


def _input_tensor(y) -> torch.Tensor:
    """A ``torch.Tensor`` stays on its device and in its dtype; anything else
    (a numpy array) goes to the card, a floating one as float32
    (:func:`~admm_deconv_tpu_torch.utils.arrays.as_tensor`): numpy's float64
    solves to float32, as in JAX.  A float64 tensor takes the plain path on
    the CPU; on the card the kernels raise."""
    return arrays.as_tensor(y)


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
    y4, _ = _normalize_input(_input_tensor(y))
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
        # cuFFT returns a 2-D rfft2 with its rows fastest; the spectra built
        # from it (b_f, and C through denom_h) are read by the complex-rhs
        # pass as flat (N, H, Wf) arrays, so they take the standard layout
        # here, once a solve.  The values are the same in either layout.
        otf = psf_to_otf(psf, (h, w)).contiguous()
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
    Where autograd records no graph, the complex right-hand side is one pass
    (:func:`spectral_rhs`, written into the fresh ``rfft2(q)``); a solve that
    records one, or runs in another precision than complex64, keeps the
    composition, whose values the pass equals.
    """
    q = q.to(c_spec.dtype)
    f = torch.fft.rfft2(q)
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in (b_f, c_spec, rho, q))
    if records or f.dtype != torch.complex64 or b_f.dtype != torch.complex64:
        return torch.fft.irfft2(c_spec * (b_f + rho * f), s=(h, w))
    return torch.fft.irfft2(spectral_rhs(f, b_f, c_spec, rho), s=(h, w))


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
        the solve runs on a tensor's device, and on the card for a numpy
        array.
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
      prox_impl: "pallas" = the fused kernels on a CUDA tensor (their
        plain versions on a CPU tensor); "xla" = the plain composition;
        "auto" = the policy's choice ("pallas").  The stencil kernel serves
        the q-carry loop (alpha=1, named prox), the prox-dual kernel the
        reference-shaped loop and the over-relaxed fast loop.
      alpha: over-relaxation factor; 1.0 = plain ADMM.
      init_state: warm-start iterate from a ``return_state=True`` solve.
      return_state: also return the final :class:`ADMMState`.
      state_dtype: narrower storage dtype ("bfloat16") for the loop carry
        ``(q, ux, uy)``; arithmetic stays fp32.  Needs the fast kernel path:
        alpha=1, a named prox, prox_impl "auto"/"pallas", no diagnostics or
        state request.

    Differentiable in ``y``, ``psf``, ``lam`` and ``rho`` (scalar or
    per-image) on either device: the kernel paths carry analytic
    backwards (the stencil's backward kernel on a CUDA tensor, the
    prox-dual step's plain VJP), the plain path goes through autograd.
    With ``remat`` each iteration's forward, kernels included, runs again
    in the backward pass.

    Returns:
      Restored image(s) with the input's shape; with flags set, a tuple
      ``(x[, diagnostics][, state])`` in that order.
    """
    prox_impl = _check_modes(fft_mode, prox_impl)
    y = _input_tensor(y)
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
    prox_step = _make_prox_step(prox, prox_impl)

    def body(x, zx, zy, ux, uy, diag):
        x_new = solve(grad2d_adjoint(zx - ux, zy - uy))
        dxx, dxy = grad2d(x_new)
        if alpha != 1.0:
            # Over-relaxation: blend D x with the previous z (Boyd sec. 3.4.3).
            rxx = alpha * dxx + (1.0 - alpha) * zx
            rxy = alpha * dxy + (1.0 - alpha) * zy
        else:
            rxx, rxy = dxx, dxy
        zx_new, zy_new, ux_new, uy_new = prox_step(rxx, rxy, ux, uy, tau)
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
    mode = _kernel_mode(prox, prox_impl)
    use_kernel = mode is not None and alpha == 1.0
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
        stencil = fused_admm_stencil_mixed if narrow else fused_admm_stencil

        def body(q, ux, uy):
            return stencil(solve(q), ux, uy, tau, mode=mode)

        carry = (q0, ux0, uy0)
    else:
        prox_step = _make_prox_step(prox, prox_impl)

        def body(q, ux, uy, zx_prev=None, zy_prev=None):
            dxx, dxy = grad2d(solve(q))
            if alpha != 1.0:
                dxx = alpha * dxx + (1.0 - alpha) * zx_prev
                dxy = alpha * dxy + (1.0 - alpha) * zy_prev
            zx, zy, ux, uy = prox_step(dxx, dxy, ux, uy, tau)
            q = grad2d_adjoint(zx - ux, zy - uy)
            return (q, ux, uy) if alpha == 1.0 else (q, ux, uy, zx, zy)

        carry = (q0, ux0, uy0) if alpha == 1.0 else (q0, ux0, uy0, zx0, zy0)

    for _ in range(iters - 1):
        carry = step(body, *carry)
    return solve(carry[0])


def tv_deconvolve_adaptive(
    y: torch.Tensor,
    psf: torch.Tensor | None = None,
    lam=0.1,
    rho=1.0,
    max_iters: int = 200,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    adapt_rho: bool = True,
    mu: float = 10.0,
    tau_scale: float = 2.0,
    check_every: int = 1,
    fft_mode: str = "auto",
    prox_impl: str = "auto",
    alpha: float = 1.0,
    init_state: ADMMState | None = None,
    return_state: bool = False,
    state_dtype: str | torch.dtype | None = None,
):
    """ADMM with per-image residual-balanced rho and early stopping.

    Boyd-style stopping (``r <= eps_pri`` and ``s <= eps_dual`` per plane)
    and penalty adaptation (``rho *= tau_scale`` when ``r > mu*s``, ``/=``
    when ``s > mu*r``, with the scaled duals rescaled by the same factor).
    ``C`` is re-formed per block from the cached spectra.

    Residuals, stopping and adaptation run every ``check_every``-th
    iteration (``max_iters`` must be a multiple).  With ``check_every > 1``,
    alpha=1, a named prox and prox_impl "pallas"/"auto", the block's first
    ``check_every - 2`` iterations run the q-carry loop through the fused
    stencil kernel (rho is fixed between checks), and its last two the
    full-state form through the prox-dual kernel, so the check sees the
    true ``z_prev``/``z`` pair.  At ``check_every=2`` the q-carry part is
    empty.  ``state_dtype="bfloat16"`` narrows the q-carry part's
    ``(q, ux, uy)`` storage (block-boundary state and residual decisions
    stay fp32) and needs that fast part.

    The JAX package's fold1 machinery collapses here, as every solve is an
    exact ``torch.fft`` one: there is no per-block delta-form re-hoist, no
    HIGH-precision check iteration, and no final re-solve (it re-solves
    from the same q and gives ``state.x``).  The loop reads ``done`` on the
    host once per block: one sync per ``check_every`` iterations.

    An inference path (early stopping): an input that requires a gradient
    raises, as JAX's ``while_loop`` does under ``jax.grad``; use
    :func:`tv_deconvolve` as the learned-layer path.

    Returns ``(x, ADMMDiagnostics)`` with the true final residual norms of
    the last check (``iterations`` a tensor), plus the final
    :class:`ADMMState` when ``return_state``.
    """
    prox_impl = _check_modes(fft_mode, prox_impl)
    if check_every < 1 or max_iters < check_every or max_iters % check_every != 0:
        raise ValueError(
            f"check_every ({check_every}) must be >= 1 and divide "
            f"max_iters ({max_iters}), with max_iters >= check_every"
        )
    prox_step = _make_prox_step(prox, prox_impl)
    y = _input_tensor(y)
    _refuse_grad("tv_deconvolve_adaptive", y, psf, lam, rho)
    _, orig_shape = _normalize_input(y)
    y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c) = _prepare(y, psf, lam, rho)
    n = b * c
    dtype, device = y_f.dtype, y_f.device
    ones = torch.ones((n, 1, 1), dtype=dtype, device=device)
    rho_cur = ones * rho_f
    lam0 = ones * lam_f
    sqrt_n = torch.sqrt(torch.tensor(2.0 * h * w, dtype=dtype, device=device))

    mode = _kernel_mode(prox, prox_impl)
    use_fast_mid = mode is not None and check_every > 1 and alpha == 1.0
    sdt = _as_dtype(state_dtype)
    narrow = sdt is not None and sdt != dtype
    if narrow and not use_fast_mid:
        raise ValueError(
            "state_dtype requires the fast mid-loop: check_every > 1, plain "
            "ADMM (alpha=1), a named prox mode, and prox_impl 'auto' or 'pallas'"
        )
    if use_fast_mid:
        stencil = fused_admm_stencil_mixed if narrow else fused_admm_stencil

    def solve(c_spec, q):
        x = _solve_spectral(b_f, c_spec, rho_cur, q, h, w)
        if x_bounds is not None:
            x = torch.clamp(x, x_bounds[0], x_bounds[1])
        return x

    def one_iter(state, tau, c_spec):
        x = solve(c_spec, grad2d_adjoint(state.zx - state.ux, state.zy - state.uy))
        dxx, dxy = grad2d(x)
        if alpha != 1.0:
            rxx = alpha * dxx + (1.0 - alpha) * state.zx
            rxy = alpha * dxy + (1.0 - alpha) * state.zy
        else:
            rxx, rxy = dxx, dxy
        zx, zy, ux, uy = prox_step(rxx, rxy, state.ux, state.uy, tau)
        return ADMMState(x, zx, zy, ux, uy), dxx, dxy

    if init_state is not None:
        state = ADMMState(*init_state)
    else:
        zeros = torch.zeros((n, h, w), dtype=dtype, device=device)
        state = ADMMState(zeros, zeros, zeros, zeros, zeros)
    it = 0
    while True:
        tau = lam0 / rho_cur
        c_spec = _form_cspec(denom_h, lap, rho_cur)
        if use_fast_mid:
            # q-carry through the stencil kernel, then the check iteration's
            # first half: x, D x and the prox-dual step give z_prev.
            q = grad2d_adjoint(state.zx - state.ux, state.zy - state.uy)
            ux, uy = state.ux, state.uy
            if narrow:
                q, ux, uy = q.to(sdt), ux.to(sdt), uy.to(sdt)
            for _ in range(check_every - 2):
                q, ux, uy = stencil(solve(c_spec, q), ux, uy, tau[:, 0, 0], mode=mode)
            x = solve(c_spec, q)
            dxx, dxy = grad2d(x)
            zx, zy, ux, uy = prox_step(dxx, dxy, ux.to(dtype), uy.to(dtype), tau)
            state = ADMMState(x, zx, zy, ux, uy)
        else:
            for _ in range(check_every - 1):
                state, _, _ = one_iter(state, tau, c_spec)
        z_prev_x, z_prev_y = state.zx, state.zy
        state, dxx, dxy = one_iter(state, tau, c_spec)
        x, zx, zy, ux, uy = state

        # Per-plane residual norms and thresholds.
        r_norm = torch.sqrt(torch.sum((dxx - zx) ** 2 + (dxy - zy) ** 2, dim=(-2, -1)))
        dz = grad2d_adjoint(zx - z_prev_x, zy - z_prev_y)
        rho_v = rho_cur[:, 0, 0]
        s_norm = rho_v * torch.sqrt(torch.sum(dz * dz, dim=(-2, -1)))
        dx_norm = torch.sqrt(torch.sum(dxx * dxx + dxy * dxy, dim=(-2, -1)))
        z_norm = torch.sqrt(torch.sum(zx * zx + zy * zy, dim=(-2, -1)))
        dual = grad2d_adjoint(ux, uy)
        dual_norm = rho_v * torch.sqrt(torch.sum(dual * dual, dim=(-2, -1)))
        eps_pri = sqrt_n * eps_abs + eps_rel * torch.maximum(dx_norm, z_norm)
        eps_dual = sqrt_n * eps_abs + eps_rel * dual_norm
        done = (r_norm <= eps_pri) & (s_norm <= eps_dual)

        if adapt_rho:
            grow = r_norm > mu * s_norm
            shrink = s_norm > mu * r_norm
            factor = torch.where(grow, tau_scale, torch.where(shrink, 1.0 / tau_scale, 1.0))
            factor = torch.where(done, 1.0, factor).to(dtype)[:, None, None]
            rho_cur = rho_cur * factor
            # Rescaling rho rescales the scaled dual u = (1/rho) * dual.
            state = ADMMState(x, zx, zy, ux / factor, uy / factor)
        it += check_every
        if it >= max_iters or bool(done.all()):
            break

    diags = ADMMDiagnostics(
        r_norm=r_norm,
        s_norm=s_norm,
        iterations=torch.tensor(it, device=device),
        rho=rho_cur[:, 0, 0],
    )
    x = _unfold(state.x, b, c).reshape(orig_shape)
    if return_state:
        return x, diags, state
    return x, diags


def anderson_history_bytes(
    shape: tuple[int, ...], m: int = 5, itemsize: int = 4
) -> int:
    """Device-memory footprint of Anderson's history state — two
    ``(m, N, 4*H*W)`` difference rings (``dF`` and ``dSF``) plus two
    ``(N, 4*H*W)`` snapshot buffers (previous map output / previous
    residual), ``2*(m+1)*N*4*H*W`` floats in all — for an input of the given
    NHWC (or HW/HWC) shape.  Budget ``m`` with this before solving large
    frames.  Where it does not fit, use
    :func:`admm_deconv_tpu_torch.parallel.tiled_tv_deconvolve_anderson`,
    which splits the rings over the tile mesh axis, or let
    ``tv_deconvolve_anderson(m="auto")`` size the window from the device's
    memory.
    """
    if len(shape) == 2:
        n, h, w = 1, *shape
    elif len(shape) == 3:
        n, (h, w) = shape[2], shape[:2]
    else:
        n, h, w = shape[0] * shape[3], shape[1], shape[2]
    return 2 * (m + 1) * n * 4 * h * w * itemsize


def _resolve_anderson_m(m, shape, device: torch.device | None = None) -> int:
    """Resolve ``m="auto"``: the largest window in [2, 5] whose history
    state (:func:`anderson_history_bytes`) fits in a quarter of ``device``'s
    memory.  A CPU tensor (or no device) reports no limit and takes the JAX
    package's fallback of 16 GiB, so both packages pick the same window
    there."""
    if m != "auto":
        return m
    if device is not None and device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
    else:
        limit = 16 << 30
    mm = 5
    while mm > 2 and anderson_history_bytes(shape, mm) > limit // 4:
        mm -= 1
    return mm


class _AndersonMixer:
    """Windowed type-II Anderson extrapolation of a fixed-point map on
    per-image flat states ``(N, D)``, with the per-image decay safeguard.

    The two ``(m, N, D)`` difference rings are written **in place** at slot
    ``(k-1) mod m``; nothing ever shifts or copies a ring.  The
    least-squares mixing problem does not depend on column order, so
    validity is tracked by slot *age* against the per-image count ``cnt`` of
    non-stale pairs (stale = from before a restart, or never written).
    Staleness is masked on the small ``(N, m, m)`` Gram and ``(N, m)`` rhs,
    not on the rings: a zeroed Gram row and column decouples the slot from
    the solve, whose regularisation diagonal then gives it an exact zero
    coefficient, so the raw rings feed the correction contraction.

    Ring traffic is the whole cost of Anderson at large frames, so:

    * the second ring stores the sum ``dSF = dS + dF``, which the
      correction ``(dS + dF) . gamma`` needs; since ``s + f = T(s)`` its
      slot is the difference of consecutive map outputs ``t_k - t_{k-1}``;
    * the Gram is carried and refreshed rank-1: only slot ``idx`` changed,
      so one ``(m, D) x (D, 2)`` contraction of the ``dF`` ring against the
      probe ``[dF_new, f]`` gives the new Gram row/column and the whole rhs
      ``dF . f`` in one pass.

    The contractions are plain cuBLAS products on strided views of the
    rings (no copy) at full fp32; the probe contraction is split over
    ``chunks`` pieces of D (:meth:`_probe_ring` says why).  ``reduce`` (the
    H-tiled solver's sum over the tile group, in place on an ``(N, 2m+1)``
    tensor) makes the Gram row, the rhs and the squared residual global in
    ONE collective, so every tile solves the same mixing problem and takes
    the same safeguard decision.
    """

    def __init__(self, n, d, m, aa_reg, safeguard_factor, dtype, device, *, chunks: int,
                 reduce=None):
        self.m, self.aa_reg, self.safeguard_factor = m, aa_reg, safeguard_factor
        self.reduce = reduce
        self.chunks = chunks  # split of D in the probe contraction: a divisor of D
        self.dSF = torch.zeros((m, n, d), dtype=dtype, device=device)
        self.dF = torch.zeros((m, n, d), dtype=dtype, device=device)
        self.gram = torch.zeros((n, m, m), dtype=dtype, device=device)
        self.t_prev = torch.zeros((n, d), dtype=dtype, device=device)
        self.f_prev = torch.zeros((n, d), dtype=dtype, device=device)
        self.cnt = torch.zeros((n,), dtype=torch.int32, device=device)
        self.k_acc = torch.zeros((n,), dtype=dtype, device=device)
        self.res0 = None  # the first iteration's residual norm
        self.eye = torch.eye(m, dtype=dtype, device=device)
        slot = torch.arange(m, device=device)
        # ages[idx, j]: the age of slot j (1 = newest) when slot idx was
        # written last, ``(k - 1 - j) mod m + 1``.
        self.ages = (slot[:, None] - slot[None, :]) % m + 1

    def _probe_ring(self, probe: torch.Tensor) -> torch.Tensor:
        """``einsum("knd,njd->nkj", dF, probe)``: the ``dF`` ring against the
        ``(N, 2, D)`` probe, ``(N, m, 2)``.

        As one batched product per image this is N tall-skinny
        ``(m x D) . (D x 2)`` problems, which cuBLAS runs on N thread blocks
        (44 ms a call for 12 images of D = 8.3 M on an H100, fifty times the
        ring's read time; 1.1 ms split over H chunks: ``chip_smoke.py``'s
        probe-contraction line).  So D is cut into ``chunks`` pieces that join the
        batch axis (strided views of the ring, no copy) and the partial
        products are summed: the same contraction, summed in another order.
        """
        m, n, d = self.dF.shape
        c = self.chunks
        ring = self.dF.view(m, n * c, d // c).permute(1, 0, 2)  # (N*c, m, D/c)
        cols = probe.view(2, n * c, d // c).permute(1, 2, 0)  # (N*c, D/c, 2)
        return torch.bmm(ring, cols).view(n, c, m, 2).sum(dim=1)

    def mix(self, k: int, s_flat: torch.Tensor, t_flat: torch.Tensor):
        """The ``k``-th outer step: from the state ``s`` and its map output
        ``t = G(s)`` return ``(s_next, res)``: the extrapolated (or, where
        the safeguard refuses, the plain) next state and the per-image
        fixed-point residual norm ``||t - s||``."""
        m = self.m
        idx = (k - 1) % m  # at k = 0 slot m-1 gets garbage that is never valid
        with trace_annotation("admm/aa_ring"):
            f = t_flat - s_flat
            torch.sub(t_flat, self.t_prev, out=self.dSF[idx])
            new_df = torch.sub(f, self.f_prev, out=self.dF[idx])
        if k >= 1:
            self.cnt = torch.clamp(self.cnt + 1, max=m)
        valid = self.ages[idx][None, :] <= self.cnt[:, None]  # (N, m)
        with trace_annotation("admm/aa_mix"), fp32_matmuls():
            probe = torch.stack([new_df, f])  # (2, N, D)
            red = torch.empty((f.shape[0], 2 * m + 1), dtype=f.dtype, device=f.device)
            red[:, :2 * m] = self._probe_ring(probe).flatten(1)
            red[:, 2 * m] = torch.linalg.vector_norm(f, dim=-1) ** 2
            if self.reduce is not None:
                self.reduce(red)
            rv = red[:, :2 * m].unflatten(1, (m, 2))
            res = torch.sqrt(red[:, 2 * m])
            if self.res0 is None:
                self.res0 = res
            row = rv[:, :, 0]  # dF . dF[idx]: the refreshed Gram row/column
            self.gram[:, idx, :] = row
            self.gram[:, :, idx] = row
            g = torch.where(valid[:, :, None] & valid[:, None, :], self.gram, 0.0)
            trace = g.diagonal(dim1=-2, dim2=-1).sum(-1)
            g = g + self.aa_reg * (trace[:, None, None] + 1.0) * self.eye
            rhs = torch.where(valid, rv[:, :, 1], 0.0)
            # solve_ex: no error check, so no host sync (as jnp.linalg.solve,
            # which does not raise either; the diagonal keeps g regular).
            gamma = torch.linalg.solve_ex(g, rhs[..., None])[0][..., 0]  # (N, m)
            s_aa = t_flat - torch.bmm(
                gamma[:, None, :], self.dSF.permute(1, 0, 2)
            )[:, 0]  # "knd,nk->nd"

        # Per-image decay safeguard (no extra map evaluations): extrapolate
        # while the residuals keep decaying; an image that blows up takes
        # its plain step and restarts its window (cnt = 0).
        bound = self.safeguard_factor * self.res0 * (self.k_acc + 1.0) ** -(1.0 + 1e-6)
        take = (self.cnt >= 1) & (res <= bound)
        self.k_acc = torch.where(take, self.k_acc + 1.0, self.k_acc)
        self.cnt = torch.where(take, self.cnt, 0)
        self.t_prev, self.f_prev = t_flat, f
        return torch.where(take[:, None], s_aa, t_flat), res


def _refuse_grad(name, *args):
    """The inference paths (Anderson, the adaptive and tiled solvers) stop
    early, write in place or run collectives, and carry no gradient, as the
    JAX package's raise under ``jax.grad``: refuse an input that asks for
    one instead of silently returning a constant or recording a graph over
    every iteration."""
    if torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args
    ):
        raise ValueError(
            f"{name} is an inference path and is not differentiable: detach the "
            f"inputs (or call it under torch.no_grad()), and use tv_deconvolve or "
            f"tv_deconvolve_implicit where a gradient is needed"
        )


def _inference_only(fn):
    """Run ``fn`` under ``no_grad`` after :func:`_refuse_grad` has checked
    every tensor argument."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _refuse_grad(fn.__name__, *args, *kwargs.values())
        with torch.no_grad():
            return fn(*args, **kwargs)

    return wrapper


def _check_anderson_args(name, m, iters, aa_interval):
    if m < 1:
        raise ValueError(f"Anderson window m must be >= 1, got {m}")
    if iters < 2:
        raise ValueError(f"{name} needs iters >= 2")
    if aa_interval < 1 or (iters - 1) % aa_interval != 0:
        raise ValueError(
            f"aa_interval ({aa_interval}) must be >= 1 and divide "
            f"iters - 1 ({iters - 1})"
        )


def tv_deconvolve_anderson(
    y: torch.Tensor,
    psf: torch.Tensor | None = None,
    lam=0.1,
    rho=1.0,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    m: int | str = 5,
    aa_reg: float = 1e-10,
    safeguard_factor: float = 1e6,
    early_stop: bool = False,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    aa_interval: int = 1,
    fft_mode: str = "auto",
    prox_impl: str = "auto",
):
    """ADMM with type-II Anderson acceleration of the (z, u) fixed point.

    The ADMM iteration is a fixed-point map ``s -> T(s)`` on
    ``s = (zx, zy, ux, uy)`` (equivalent to Douglas-Rachford splitting), and
    Anderson extrapolation over a window of the last ``m`` residual
    differences reaches a given residual in fewer iterations.  Mixing
    coefficients are solved **per image** (batched ``(m, m)`` least
    squares), so images stay independent exactly as in the plain solver.

    Safeguarding costs no extra map evaluations: an extrapolated candidate
    is taken only while the per-image residual norm stays below
    ``safeguard_factor * ||f_0|| * (k_acc + 1)^-(1+1e-6)`` (the decay
    condition of Zhang-O'Donoghue-Boyd type-I safeguarding); a violating
    image falls back to its plain ADMM step and restarts its window.

    ``early_stop=True`` adds Boyd-style per-image stopping (``eps_abs`` /
    ``eps_rel``, the criteria of :func:`tv_deconvolve_adaptive`) with
    ``iters`` as the cap; the host reads the count of unfinished images once
    per outer step.

    ``aa_interval=k > 1`` applies the extrapolation to ``G = T^k``: one
    ring write, rank-1 Gram refresh and mixing per k ADMM iterations.  With
    ``k > 2``, a named prox and ``prox_impl`` "auto"/"pallas", the ``k - 2``
    leading iterations of each block run the q-carry loop through the fused
    stencil kernel (rho is fixed, so it is exact), and the last two the
    full-state form, so the dual residual sees a true consecutive-z pair.
    ``iters - 1`` must divide by ``aa_interval``.

    ``m`` is the window, or "auto" for the largest of 2..5 whose history
    (:func:`anderson_history_bytes`) fits a quarter of the device's memory.
    ``rho`` is fixed for the whole solve.  Every ``fft_mode`` name computes
    the exact ``torch.fft`` path.  ``prox_impl`` "auto"/"pallas" with a
    named prox runs each map step's prox + dual update as the prox-dual
    kernel on a CUDA tensor.  An inference path: an input that requires a
    gradient raises.

    Returns ``(x, ADMMDiagnostics)``: ``s_norm`` is the fixed-point residual
    norm ``||T(s) - s||``, ``r_norm`` the primal residual, both of the last
    outer step; ``iterations`` is ``iters``, or
    ``outer_steps * aa_interval + 1`` under ``early_stop``.
    """
    prox_impl = _check_modes(fft_mode, prox_impl)
    y = _input_tensor(y)
    m = _resolve_anderson_m(m, tuple(y.shape), y.device)
    _check_anderson_args("tv_deconvolve_anderson", m, iters, aa_interval)
    _refuse_grad("tv_deconvolve_anderson", y, psf, lam, rho)
    with torch.no_grad():
        return _anderson_solve(
            y, psf, lam, rho, iters, prox, x_bounds, m, aa_reg, safeguard_factor,
            early_stop, eps_abs, eps_rel, aa_interval, prox_impl,
        )


def _anderson_solve(y, psf, lam, rho, iters, prox, x_bounds, m, aa_reg, safeguard_factor,
                    early_stop, eps_abs, eps_rel, aa_interval, prox_impl):
    _, orig_shape = _normalize_input(y)
    y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c) = _prepare(y, psf, lam, rho)
    dtype, device = y_f.dtype, y_f.device
    tau = lam_f / rho_f
    prox_step = _make_prox_step(prox, prox_impl)
    c_spec = _form_cspec(denom_h, lap, rho_f)
    n = b * c
    d = 4 * h * w  # per-image state: the (zx, zy, ux, uy) planes

    def solve(q):
        x = _solve_spectral(b_f, c_spec, rho_f, q, h, w)
        if x_bounds is not None:
            x = torch.clamp(x, x_bounds[0], x_bounds[1])
        return x

    def one_step(zx, zy, ux, uy):
        dxx, dxy = grad2d(solve(grad2d_adjoint(zx - ux, zy - uy)))
        return (*prox_step(dxx, dxy, ux, uy, tau), dxx, dxy)

    # The fused stencil serves the leading aa_interval - 2 steps of a block.
    # The JAX gate also asks whether its kernel has a row block for (h, w);
    # the CUDA kernel takes every shape, so the request alone decides.
    mode = _kernel_mode(prox, prox_impl)
    tau_kernel = _tau_for_kernel(tau)
    use_fast_inner = aa_interval > 2 and mode is not None and tau_kernel is not None

    def g_map(s):
        """``G(s) = T^aa_interval(s)`` on ``s = (N, 4, H, W)``: returns
        ``(G(s), r_norm of the last step, the z pair before it)``."""
        zx, zy, ux, uy = s.unbind(1)
        if use_fast_inner:
            q = grad2d_adjoint(zx - ux, zy - uy)
            for _ in range(aa_interval - 2):
                q, ux, uy = fused_admm_stencil(solve(q), ux, uy, tau_kernel, mode=mode)
            # One full-state step from the (q, u) carry brings z back.
            dxx, dxy = grad2d(solve(q))
            zx, zy, ux, uy = prox_step(dxx, dxy, ux, uy, tau)
        else:
            for _ in range(aa_interval - 1):
                zx, zy, ux, uy = one_step(zx, zy, ux, uy)[:4]
        zpx, zpy = zx, zy
        zx, zy, ux, uy, dxx, dxy = one_step(zx, zy, ux, uy)
        r = torch.sqrt(torch.sum((dxx - zx) ** 2 + (dxy - zy) ** 2, dim=(-2, -1)))
        return torch.stack([zx, zy, ux, uy], dim=1), r, zpx, zpy

    mixer = _AndersonMixer(n, d, m, aa_reg, safeguard_factor, dtype, device, chunks=h)
    s = torch.zeros((n, 4, h, w), dtype=dtype, device=device)
    rho_v = torch.broadcast_to(rho_f.reshape(-1), (n,))
    sqrt_dim = torch.sqrt(torch.tensor(2.0 * h * w, dtype=dtype, device=device))
    outer_cap = (iters - 1) // aa_interval
    k = 0
    while k < outer_cap:
        with trace_annotation("admm/aa_map"):
            t, r_norm, zpx, zpy = g_map(s)
        s_next, fp_res = mixer.mix(k, s.reshape(n, d), t.reshape(n, d))
        s = s_next.reshape(n, 4, h, w)
        k += 1
        if early_stop:
            # Boyd stopping on the map's own output t, exactly as in
            # tv_deconvolve_adaptive: consecutive z's for the dual residual.
            tzx, tzy, tux, tuy = t.unbind(1)
            dz = grad2d_adjoint(tzx - zpx, tzy - zpy)
            s_norm = rho_v * torch.sqrt(torch.sum(dz * dz, dim=(-2, -1)))
            z_norm = torch.sqrt(torch.sum(tzx ** 2 + tzy ** 2, dim=(-2, -1)))
            dual = grad2d_adjoint(tux, tuy)
            dual_norm = rho_v * torch.sqrt(torch.sum(dual * dual, dim=(-2, -1)))
            eps_pri = sqrt_dim * eps_abs + eps_rel * z_norm
            eps_dual = sqrt_dim * eps_abs + eps_rel * dual_norm
            done = (r_norm <= eps_pri) & (s_norm <= eps_dual)
            if int(torch.sum(~done)) == 0:  # the loop's one host read
                break
    iters_run = k * aa_interval + 1 if early_stop else iters
    # One final solve gives the output image from the accelerated state: the
    # same count of solves as tv_deconvolve (iters - 1 in the loop, plus 1).
    zx, zy, ux, uy = s.unbind(1)
    x = solve(grad2d_adjoint(zx - ux, zy - uy))
    diags = ADMMDiagnostics(
        r_norm=r_norm,
        s_norm=fp_res,
        iterations=torch.tensor(iters_run, device=device),
        rho=rho_v,
    )
    return _unfold(x, b, c).reshape(orig_shape), diags


SOLVE_AUTO_MAX_ITERS = 400  # solve_auto's default max_iters


def _auto_check_every(max_iters: int) -> int:
    """The check_every of solve_auto's tolerance branch: the policy's where
    it divides ``max_iters``, else 1 (JAX's rule)."""
    k = policy().solve_auto_check_every
    return k if max_iters % k == 0 and max_iters >= k else 1


def solve_auto(
    y: torch.Tensor,
    psf: torch.Tensor | None = None,
    lam=0.1,
    rho=1.0,
    *,
    iters: int | None = None,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    max_iters: int = SOLVE_AUTO_MAX_ITERS,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
):
    """Solve with the solver the policy (``ops/policy.py``) picks for the
    request; the same decision as the JAX package's ``solve_auto``.

      * ``iters`` given (a fixed budget): the whole budget runs as ONE
        ``check_every=iters`` block of :func:`tv_deconvolve_adaptive`: the
        q-carry stencil loop with true final residuals from the single
        end-of-run check, the carry stored bf16 on a CUDA tensor when
        ``policy().bf16_state_on_tpu`` (False by default: on the H100 bf16
        storage was no faster than fp32; ``ops/policy.py``).  Without the
        fast mid-loop (a callable prox, ``iters <= 1``, prox "auto"
        resolving to "xla") it is :func:`tv_deconvolve` with diagnostics.
      * a tolerance (default): :func:`tv_deconvolve_adaptive` with
        residual-balanced rho and ``check_every=policy().solve_auto_check_every``
        (1 when it does not divide ``max_iters``; 8, measured on the
        H100); bf16 storage as above, except at deep tolerances
        (``eps_abs < policy().deep_eps_abs``).

    On a CPU tensor the fast mid-loop runs the kernels' plain twins, so
    this takes the adaptive branch where the JAX package on its CPU
    backend takes ``tv_deconvolve``; both compute the same iterates.

    An inference path: an input that requires a gradient raises.

    Returns ``(x, ADMMDiagnostics)`` for every branch.
    """
    y = _input_tensor(y)
    _refuse_grad("solve_auto", y, psf, lam, rho)

    def fast_mid_ok(check_every):
        return check_every > 1 and _kernel_mode(prox, resolve_prox_impl("auto")) is not None

    def bf16_state_ok(check_every):
        return (
            policy().bf16_state_on_tpu
            and y.device.type == "cuda"
            and fast_mid_ok(check_every)
        )

    if iters is not None:
        if not fast_mid_ok(iters):
            return tv_deconvolve(
                y, psf, lam, rho, iters=iters, prox=prox, x_bounds=x_bounds,
                return_diagnostics=True,
            )
        return tv_deconvolve_adaptive(
            y, psf, lam, rho, max_iters=iters, prox=prox, x_bounds=x_bounds,
            eps_abs=0.0, eps_rel=0.0, adapt_rho=False, check_every=iters,
            state_dtype="bfloat16" if bf16_state_ok(iters) else None,
        )
    deep = eps_abs < policy().deep_eps_abs
    check_every = _auto_check_every(max_iters)
    narrow = not deep and bf16_state_ok(check_every)
    return tv_deconvolve_adaptive(
        y, psf, lam, rho, max_iters=max_iters, prox=prox, x_bounds=x_bounds,
        eps_abs=eps_abs, eps_rel=eps_rel, adapt_rho=True,
        check_every=check_every,
        state_dtype="bfloat16" if narrow else None,
    )


def tv_objective(
    x: torch.Tensor,
    y: torch.Tensor,
    psf: torch.Tensor | None,
    lam,
    isotropic: bool = False,
) -> torch.Tensor:
    """TV-regularized objective ``0.5||Hx - y||^2 + lam * ||Dx||``, the
    function the solvers minimise, for logging and validation."""
    x4, _ = _normalize_input(_input_tensor(x))
    y4, _ = _normalize_input(_input_tensor(y))
    xf, yf = _fold(x4), _fold(y4)
    h, w = xf.shape[-2:]
    if psf is None:
        hx = xf
    else:
        otf = psf_to_otf(torch.as_tensor(psf, dtype=xf.dtype, device=xf.device), (h, w))
        hx = torch.fft.irfft2(otf * torch.fft.rfft2(xf), s=(h, w))
    data = 0.5 * torch.sum((hx - yf) ** 2)
    dxx, dxy = grad2d(xf)
    if isotropic:
        tv = torch.sum(torch.sqrt(dxx * dxx + dxy * dxy))
    else:
        tv = torch.sum(torch.abs(dxx) + torch.abs(dxy))
    return data + lam * tv
