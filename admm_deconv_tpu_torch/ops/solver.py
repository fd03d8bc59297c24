"""ADMM TV deconvolution solvers — PyTorch counterpart of
``admm_deconv_tpu/ops/solver.py``: the fixed-iteration ``tv_deconvolve``,
the residual-balanced ``tv_deconvolve_adaptive``, ``solve_auto`` and
``tv_objective``.

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

from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from admm_deconv_tpu_torch.ops import prox as prox_lib
from admm_deconv_tpu_torch.ops.diff import grad2d, grad2d_adjoint
from admm_deconv_tpu_torch.ops.fft import laplacian_spectrum, psf_to_otf
from admm_deconv_tpu_torch.ops.kernels.prox_kernels import fused_prox_dual
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
    fused_admm_stencil,
    fused_admm_stencil_mixed,
)
from admm_deconv_tpu_torch.ops.policy import policy

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
    """A ``torch.Tensor`` stays on its device; anything else (a numpy array)
    goes to the card, as JAX puts a numpy array on its default device."""
    if isinstance(y, torch.Tensor):
        return y
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a non-tensor input goes to the CUDA device and none is available; "
            "pass a CPU torch.Tensor to solve on the CPU"
        )
    return torch.as_tensor(y, device="cuda")


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

    Not differentiable as a whole (early stopping); use
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


def solve_auto(
    y: torch.Tensor,
    psf: torch.Tensor | None = None,
    lam=0.1,
    rho=1.0,
    *,
    iters: int | None = None,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    max_iters: int = 400,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
):
    """Solve with the solver the policy (``ops/policy.py``) picks for the
    request; the same decision as the JAX package's ``solve_auto``.

      * ``iters`` given (a fixed budget): the whole budget runs as ONE
        ``check_every=iters`` block of :func:`tv_deconvolve_adaptive`: the
        q-carry stencil loop with true final residuals from the single
        end-of-run check, the carry stored bf16 on a CUDA tensor when
        ``policy().bf16_state_on_tpu``.  Without the fast mid-loop (a
        callable prox, ``iters <= 1``, prox "auto" resolving to "xla") it
        is :func:`tv_deconvolve` with diagnostics.
      * a tolerance (default): :func:`tv_deconvolve_adaptive` with
        residual-balanced rho and ``check_every=policy().solve_auto_check_every``
        (1 when it does not divide ``max_iters``); bf16 storage as above,
        except at deep tolerances (``eps_abs < policy().deep_eps_abs``).

    On a CPU tensor the fast mid-loop runs the kernels' plain twins, so
    this takes the adaptive branch where the JAX package on its CPU
    backend takes ``tv_deconvolve``; both compute the same iterates.

    Returns ``(x, ADMMDiagnostics)`` for every branch.
    """
    y = _input_tensor(y)

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
    k = policy().solve_auto_check_every
    check_every = k if max_iters % k == 0 and max_iters >= k else 1
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
