"""Implicit-function-theorem gradients through the ADMM fixed point.

Counterpart of ``admm_deconv_tpu/ops/implicit.py``.  Backpropagating
through the unrolled loop pays O(iters) activation memory (or, with
``remat``, a second forward).  This module treats the converged iterate as
a fixed point ``s* = F(s*, theta)`` and differentiates with the implicit
function theorem,

    dx*/dtheta = dX/ds (I - dF/ds)^-1 dF/dtheta + dX/dtheta

the inverse applied by a truncated Neumann series (the standard
deep-equilibrium adjoint):

    w_{k+1} = (dF/ds)^T w_k + (dX/ds)^T xbar
    theta_bar = (dF/dtheta)^T w_K + (dX/dtheta)^T xbar

Against the unrolled gradient:

* O(1) memory: the forward runs under ``no_grad`` and saves the final state
  only; the backward builds the autograd graph of ONE iteration and walks it
  ``bwd_iters + 1`` times;
* the backward's cost is ``bwd_iters`` VJPs of one iteration, whatever the
  forward's iteration count;
* exact in the limit of a converged forward and a converged series; for a
  loosely converged forward it is an approximation (the unrolled gradient is
  then the exact gradient of the approximate solver).

ADMM's fixed-point map is nonexpansive rather than strictly contractive, so
the series is truncated at ``bwd_iters``.  At the exact fixed point the
solution does not depend on the penalty ``rho`` at all, so the implicit
``rho`` gradient is ~0 by construction, while the unrolled path reports how
``rho`` moves the iterate after exactly ``iters`` steps; for a layer that
learns ``rho`` keep ``diff_mode="unroll"``.

State convention: the fixed point lives in ``s = (zx, zy, ux, uy)`` (folded
planes); the output image is ``x* = X(s*, theta)``, one spectral solve.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from admm_deconv_tpu_torch.ops import prox as prox_lib
from admm_deconv_tpu_torch.ops.diff import grad2d, grad2d_adjoint
from admm_deconv_tpu_torch.ops.solver import (
    _fold,
    _form_cspec,
    _input_tensor,
    _normalize_input,
    _prepare,
    _solve_spectral,
    tv_deconvolve,
)


def _step(s, y, psf, lam, rho, prox_name, x_bounds):
    """One ADMM iteration as a pure function of (state, theta), in the
    plain composition (autograd differentiates it).

    Returns ``(s_next, x)``: the image ``x`` is the iteration's primal
    update and, at the fixed point, the solver's output (folded planes).
    """
    zx, zy, ux, uy = s
    _, b_f, denom_h, lap, lam_f, rho_f, (_, h, w, _) = _prepare(y, psf, lam, rho)
    c_spec = _form_cspec(denom_h, lap, rho_f)
    x = _solve_spectral(b_f, c_spec, rho_f, grad2d_adjoint(zx - ux, zy - uy), h, w)
    if x_bounds is not None:
        x = torch.clamp(x, x_bounds[0], x_bounds[1])
    dxx, dxy = grad2d(x)
    s_next = prox_lib.prox_dual_step(
        dxx, dxy, ux, uy, lam_f / rho_f, prox_lib.resolve(prox_name)
    )
    return s_next, x


class _ImplicitSolve(torch.autograd.Function):
    """Forward: the solver under ``no_grad``, saving the final ``(z, u)``
    and theta.  Backward: the Neumann adjoint on one iteration's graph."""

    @staticmethod
    def forward(ctx, y, psf, lam, rho, iters, prox, bwd_iters, fft_mode, x_bounds):
        x, state = tv_deconvolve(
            y, psf=psf, lam=lam, rho=rho, iters=iters, prox=prox, x_bounds=x_bounds,
            fft_mode=fft_mode, return_state=True,
        )
        ctx.save_for_backward(state.zx, state.zy, state.ux, state.uy, y, psf, lam, rho)
        ctx.prox, ctx.bwd_iters, ctx.x_bounds = prox, bwd_iters, x_bounds
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, xbar):
        *s, y, psf, lam, rho = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        y4, _ = _normalize_input(y)
        # The output is the unfolded image and _step's x the folded planes:
        # the cotangent is folded likewise (the fold is a transpose and a
        # reshape, whose adjoint is the fold itself).
        xbar_f = _fold(xbar.reshape(y4.shape))
        with torch.enable_grad():
            s = tuple(a.detach().requires_grad_() for a in s)
            theta = tuple(
                None if a is None else a.detach().requires_grad_(need)
                for a, need in zip((y, psf, lam, rho), needs)
            )
            s_next, x = _step(s, *theta, ctx.prox, ctx.x_bounds)
        outs = (*s_next, x)
        w = tuple(torch.zeros_like(a) for a in s)
        for _ in range(ctx.bwd_iters):
            w = torch.autograd.grad(outs, s, grad_outputs=(*w, xbar_f), retain_graph=True)
        wanted = [a for a in theta if a is not None and a.requires_grad]
        grads = iter(
            torch.autograd.grad(outs, wanted, grad_outputs=(*w, xbar_f), allow_unused=True)
            if wanted else ()
        )
        theta_bar = tuple(
            next(grads) if a is not None and a.requires_grad else None for a in theta
        )
        return (*theta_bar, None, None, None, None, None)


def tv_deconvolve_implicit(
    y: torch.Tensor,
    psf: torch.Tensor | None = None,
    lam=0.1,
    rho=1.0,
    iters: int = 100,
    prox: str = "aniso",
    bwd_iters: int = 30,
    fft_mode: str = "auto",
    x_bounds: tuple[float, float] | None = None,
):
    """ADMM TV deconvolution with implicit (fixed-point) differentiation.

    The forward is :func:`~admm_deconv_tpu_torch.ops.solver.tv_deconvolve`
    (its reference-shaped loop, whose prox + dual step is the prox-dual
    kernel on a CUDA tensor); the backward applies the implicit function
    theorem at the final state with a ``bwd_iters``-term Neumann adjoint
    instead of backpropagating through the iterations.  Use it when
    ``iters`` is large (memory) or when forward and backward depth should
    be decoupled.

    ``psf=None`` or an empty PSF is pure TV denoising.  ``prox`` must be a
    name.  Every ``fft_mode`` name computes the exact ``torch.fft`` path.

    Differentiable in ``y``, ``psf``, ``lam`` and ``rho`` (each gets a
    gradient only if it requires one).
    """
    if callable(prox):
        raise ValueError("implicit mode requires a named prox operator")
    y = _input_tensor(y)
    lam = torch.as_tensor(lam, dtype=y.dtype, device=y.device)
    rho = torch.as_tensor(rho, dtype=y.dtype, device=y.device)
    if psf is not None:
        psf = torch.as_tensor(psf, dtype=y.dtype, device=y.device)
        if psf.numel() == 0:
            psf = None
    return _ImplicitSolve.apply(y, psf, lam, rho, iters, prox, bwd_iters, fft_mode, x_bounds)
