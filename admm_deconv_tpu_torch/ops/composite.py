"""Composite-prior ADMM deconvolution: TV + L1 + box (two splittings).

Counterpart of ``admm_deconv_tpu/ops/composite.py``.  Solves

    min_x  0.5*||H x - y||^2 + lam_tv*||D x||  + lam_l1*||x||_1
                                              (+ indicator of [lo, hi])

by ADMM with ``z1 = D x`` (the TV prox of the core solver) and ``z2 = x``
(the prox of ``lam_l1*|.|_1 + box``, exactly ``clip(soft(v, lam_l1/rho2),
lo, hi)``).  The x-update stays one closed-form rFFT division with
denominator ``|Sigma|^2 + rho1*|Lambda|^2 + rho2``.

Returns the feasible iterate ``z2``: it lies in the box exactly and
carries the L1 shrinkage; at convergence ``x == z2``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from admm_deconv_tpu_torch.ops import prox as prox_lib
from admm_deconv_tpu_torch.ops.diff import grad2d, grad2d_adjoint
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import fused_admm_stencil_composite
from admm_deconv_tpu_torch.ops.solver import (
    ADMMDiagnostics,
    _as_dtype,
    _check_modes,
    _input_tensor,
    _kernel_mode,
    _normalize_input,
    _prepare,
    _refuse_grad,
    _solve_spectral,
    _tau_for_kernel,
    _unfold,
)


def _l1_box(v, tau_l1, x_bounds):
    """The identity split's prox: ``clip(sign(v) * max(|v| - tau_l1, 0))``."""
    z2 = torch.sign(v) * torch.clamp(torch.abs(v) - tau_l1, min=0.0)
    if x_bounds is not None:
        z2 = torch.clamp(z2, x_bounds[0], x_bounds[1])
    return z2


def composite_tv_deconvolve(
    y: torch.Tensor,
    psf: torch.Tensor | None = None,
    lam_tv=0.01,
    lam_l1=0.0,
    rho1=0.1,
    rho2=0.1,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    fft_mode: str = "auto",
    remat: bool = False,
    prox_impl: str = "auto",
    state_dtype: str | torch.dtype | None = None,
):
    """ADMM with a TV + L1 + box composite prior.

    Args:
      y: degraded image(s), NHWC (or 2-D/3-D variants); the solve runs on a
        tensor's device, and on the card for a numpy array.
      psf: blur kernel or None for denoising.
      lam_tv: TV weight (scalar or per-image); ``prox`` selects the TV prox.
      lam_l1: elementwise sparsity weight (0 keeps only the box projection).
      rho1 / rho2: penalties of the gradient and identity splittings.
      x_bounds: exact box constraint enforced through the z2 prox.
      fft_mode: any JAX mode name or "auto"; all compute ``torch.fft``.
      remat: recompute each plain-path iteration in the backward pass.
      prox_impl: "pallas"/"auto" = the q-carry fast loop whose whole
        non-FFT section is one pass of the composite stencil kernel
        (``fused_admm_stencil_composite``; its plain twin on a CPU tensor),
        forward-only as in JAX; "xla" = the plain, differentiable loop.
      state_dtype: bf16 storage of the fast loop's carry
        ``(q, u1x, u1y, u2)``, fp32 arithmetic.  Needs the fast loop.

    Returns the restored image(s): the feasible ``z2`` iterate.
    """
    prox_impl = _check_modes(fft_mode, prox_impl)
    tv_prox = prox_lib.resolve(prox)
    y = _input_tensor(y)
    _, orig_shape = _normalize_input(y)
    y_f, b_f, denom_h, lap, lam_f, rho1_f, (b, h, w, c) = _prepare(y, psf, lam_tv, rho1)
    dtype, device = y_f.dtype, y_f.device
    rho2_f = torch.as_tensor(rho2, dtype=dtype, device=device)
    tau_tv = lam_f / rho1_f
    tau_l1 = torch.as_tensor(lam_l1, dtype=dtype, device=device) / rho2_f
    ratio = rho2_f / rho1_f
    # The identity split adds rho2 to the Wiener denominator.
    c_spec = 1.0 / (denom_h + rho1_f * lap + rho2_f)
    zeros = torch.zeros((b * c, h, w), dtype=dtype, device=device)

    def solve(q):
        return _solve_spectral(b_f, c_spec, rho1_f, q, h, w)

    table = [_tau_for_kernel(t) for t in (tau_tv, tau_l1, ratio)]
    mode = _kernel_mode(prox, prox_impl)
    use_fast = mode is not None and iters >= 1 and all(t is not None for t in table)
    sdt = _as_dtype(state_dtype)
    narrow = sdt is not None and sdt != dtype
    if narrow and not use_fast:
        raise ValueError(
            "state_dtype requires the fused composite fast path "
            "(prox_impl 'auto' or 'pallas', a named prox, iters >= 1)"
        )

    if use_fast:
        z0 = zeros.to(sdt) if narrow else zeros
        q, ux, uy, u2 = z0, z0, z0, z0
        for _ in range(iters - 1):
            q, ux, uy, u2 = fused_admm_stencil_composite(
                solve(q), ux, uy, u2, *table, x_bounds, mode
            )
        x = solve(q)
        z2 = _l1_box(x + u2.to(dtype), tau_l1, x_bounds)
        return _unfold(z2, b, c).reshape(orig_shape)

    def body(z1x, z1y, u1x, u1y, z2, u2):
        # x solves (H^T H + rho1 D^T D + rho2 I) x = H^T y + rho1 D^T(z1-u1)
        # + rho2 (z2-u2): the identity term rides q as ratio * (z2 - u2).
        x = solve(grad2d_adjoint(z1x - u1x, z1y - u1y) + ratio * (z2 - u2))
        dxx, dxy = grad2d(x)
        z1x_n, z1y_n, u1x_n, u1y_n = prox_lib.prox_dual_step(
            dxx, dxy, u1x, u1y, tau_tv, tv_prox
        )
        v = x + u2
        z2_n = _l1_box(v, tau_l1, x_bounds)
        return z1x_n, z1y_n, u1x_n, u1y_n, z2_n, v - z2_n

    carry = (zeros,) * 6
    for _ in range(iters - 1):
        carry = checkpoint(body, *carry, use_reentrant=False) if remat else body(*carry)
    z1x, z1y, u1x, u1y, z2, u2 = carry
    x = solve(grad2d_adjoint(z1x - u1x, z1y - u1y) + ratio * (z2 - u2))
    z2 = _l1_box(x + u2, tau_l1, x_bounds)
    return _unfold(z2, b, c).reshape(orig_shape)


def composite_tv_deconvolve_adaptive(
    y: torch.Tensor,
    psf: torch.Tensor | None = None,
    lam_tv=0.01,
    lam_l1=0.0,
    rho1=0.1,
    rho2=0.1,
    max_iters: int = 200,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    adapt_rho: bool = True,
    mu: float = 10.0,
    tau_scale: float = 2.0,
    fft_mode: str = "auto",
):
    """Composite-prior ADMM with residual balancing and early stopping.

    The two-split analogue of
    :func:`~admm_deconv_tpu_torch.ops.solver.tv_deconvolve_adaptive`:
    stopping on the stacked primal residual ``(D x - z1, x - z2)`` and the
    dual residual ``rho1 D^T(z1 - z1') + rho2 (z2 - z2')``, checked every
    iteration (one host sync each), with a common per-image factor on both
    penalties (their ratio is kept) and on both scaled duals.  Plain torch
    on both devices, as in JAX: it runs no kernel.  An inference path: an
    input that requires a gradient raises, as JAX's ``while_loop`` does
    under ``jax.grad``.

    ``fft_mode`` "fold1", "pack" and "pack_precise" are rejected, as in JAX
    (a hoisted x_B or a scalar rho would not survive per-image
    adaptation), although every mode computes ``torch.fft`` here.

    Returns ``(z2, ADMMDiagnostics)``: the feasible iterate, the final
    residual norms, the iteration count (a tensor) and the per-image final
    ``rho1`` (``rho2 = rho1 * rho2_0 / rho1_0``).
    """
    _check_modes(fft_mode, "xla")
    if fft_mode == "fold1":
        raise ValueError(
            "fft_mode='fold1' hoists x_B out of the loop, which requires the "
            "penalties fixed for the whole solve; use 'fold' here"
        )
    if fft_mode in ("pack", "pack_precise"):
        raise ValueError(
            "fft_mode='pack' requires a scalar rho; the adaptive composite "
            "solver re-balances per-image rho — use 'mxu' or 'fold'"
        )
    tv_prox = prox_lib.resolve(prox)
    y = _input_tensor(y)
    _refuse_grad("composite_tv_deconvolve_adaptive", y, psf, lam_tv, lam_l1, rho1, rho2)
    _, orig_shape = _normalize_input(y)
    y_f, b_f, denom_h, lap, lam_f, rho1_f, (b, h, w, c) = _prepare(y, psf, lam_tv, rho1)
    n = b * c
    dtype, device = y_f.dtype, y_f.device
    rho2_f = torch.as_tensor(rho2, dtype=dtype, device=device)
    lam_l1_f = torch.as_tensor(lam_l1, dtype=dtype, device=device)
    ones = torch.ones((n, 1, 1), dtype=dtype, device=device)
    rho1_cur = ones * rho1_f
    lam0 = ones * lam_f
    ratio = ones * (rho2_f / rho1_f)
    zeros = torch.zeros((n, h, w), dtype=dtype, device=device)
    # A = [D; I] maps the image into 3 planes (2 gradient + 1 identity).
    sqrt_pri = torch.sqrt(torch.tensor(3.0 * h * w, dtype=dtype, device=device))
    sqrt_dual = torch.sqrt(torch.tensor(1.0 * h * w, dtype=dtype, device=device))

    def sums(t):
        return torch.sum(t, dim=(-2, -1))

    z1x, z1y, u1x, u1y, z2, u2 = (zeros,) * 6
    r_norm = s_norm = torch.full((n,), float("inf"), dtype=dtype, device=device)
    it = 0
    while it < max_iters:
        rho2_cur = ratio * rho1_cur
        tau_tv = lam0 / rho1_cur
        tau_l1 = lam_l1_f / rho2_cur
        c_spec = 1.0 / (denom_h + rho1_cur * lap + rho2_cur)
        q = grad2d_adjoint(z1x - u1x, z1y - u1y) + ratio * (z2 - u2)
        x = _solve_spectral(b_f, c_spec, rho1_cur, q, h, w)
        dxx, dxy = grad2d(x)
        z1x_n, z1y_n, u1x_n, u1y_n = prox_lib.prox_dual_step(
            dxx, dxy, u1x, u1y, tau_tv, tv_prox
        )
        v = x + u2
        z2_n = _l1_box(v, tau_l1, x_bounds)
        u2_n = v - z2_n

        # Stacked primal residual; the dual residual's two terms land in the
        # same image space and sum before the norm.
        r_norm = torch.sqrt(sums((dxx - z1x_n) ** 2 + (dxy - z1y_n) ** 2) + sums((x - z2_n) ** 2))
        dz = rho1_cur * grad2d_adjoint(z1x_n - z1x, z1y_n - z1y) + rho2_cur * (z2_n - z2)
        s_norm = torch.sqrt(sums(dz * dz))
        ax_norm = torch.sqrt(sums(dxx * dxx + dxy * dxy) + sums(x * x))
        z_norm = torch.sqrt(sums(z1x_n**2 + z1y_n**2) + sums(z2_n**2))
        dual = rho1_cur * grad2d_adjoint(u1x_n, u1y_n) + rho2_cur * u2_n
        dual_norm = torch.sqrt(sums(dual * dual))
        eps_pri = sqrt_pri * eps_abs + eps_rel * torch.maximum(ax_norm, z_norm)
        eps_dual = sqrt_dual * eps_abs + eps_rel * dual_norm
        done = (r_norm <= eps_pri) & (s_norm <= eps_dual)

        if adapt_rho:
            grow = r_norm > mu * s_norm
            shrink = s_norm > mu * r_norm
            factor = torch.where(grow, tau_scale, torch.where(shrink, 1.0 / tau_scale, 1.0))
            factor = torch.where(done, 1.0, factor).to(dtype)[:, None, None]
            rho1_cur = rho1_cur * factor
            u1x_n, u1y_n, u2_n = u1x_n / factor, u1y_n / factor, u2_n / factor
        z1x, z1y, u1x, u1y, z2, u2 = z1x_n, z1y_n, u1x_n, u1y_n, z2_n, u2_n
        it += 1
        if bool(done.all()):
            break

    diags = ADMMDiagnostics(
        r_norm=r_norm,
        s_norm=s_norm,
        iterations=torch.tensor(it, device=device),
        rho=rho1_cur[:, 0, 0],
    )
    return _unfold(z2, b, c).reshape(orig_shape), diags
