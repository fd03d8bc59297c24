"""Differentiable unrolled-ADMM deconvolution layer.

Counterpart of ``admm_deconv_tpu/layers/deconv.py``: one module with a
``trainable`` mask stands for the reference's four layer types
(``ADMMDeconv``/``F1``/``F2``/``F3``).  A frozen parameter is stored like
any other and ``.detach()``-ed in the forward pass (JAX's
``stop_gradient``), so it gets no gradient.

Forward: project lam/rho onto ``[creg, inf)`` (rho also onto
``[_RHO_FLOOR, inf)``) and the PSF onto ``[0, 1]`` — pure projections,
gradients flow through their subgradients — run the unrolled solver, add
the bias, apply the activation.  Gradients flow through the unrolled
iterations (``remat`` recomputes each one in the backward pass), on the
card through the fused stencil's forward and backward kernels; or, with
``diff_mode="implicit"``, through the fixed point at O(1) memory
(``ops/implicit.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn

from admm_deconv_tpu_torch.ops.implicit import tv_deconvolve_implicit
from admm_deconv_tpu_torch.ops.solver import tv_deconvolve

# Guard against rho -> 0 (tau = lam/rho and C = 1/(...rho...) both blow up).
_RHO_FLOOR = 1e-8

_PARAM_NAMES = ("weight", "bias", "lam", "rho")


def _identity(x):
    return x


def _floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``max(x, lo)`` with JAX's tie rule (a tie splits the gradient)."""
    return torch.maximum(x, x.new_full((), lo))


def _uniform_(t: torch.Tensor, limit: float, generator: torch.Generator | None) -> torch.Tensor:
    """Fill ``t`` with U(-limit, limit) drawn on the CPU (so a CPU generator
    serves a parameter on any device); returns the draw."""
    draw = nn.init.uniform_(torch.empty(t.shape), -limit, limit, generator=generator)
    with torch.no_grad():
        t.copy_(draw)
    return draw


def _glorot_scalar_(t: torch.Tensor, generator: torch.Generator | None) -> None:
    """|glorot_uniform| on a length-1 vector, as the reference initialises
    lam/rho: fan_in = fan_out = 1 gives limit sqrt(3); abs folds to
    [0, sqrt(3))."""
    draw = _uniform_(t, math.sqrt(3.0), generator)
    with torch.no_grad():
        t.copy_(draw.abs())


class ADMMDeconv(nn.Module):
    """Unrolled ADMM TV-deconvolution as a trainable layer.

    Args (as the JAX package's flax attributes):
      kernel_shape: PSF shape ``(kh, kw)``, or ``()`` for kernel-less pure
        TV denoising.
      iters: number of unrolled ADMM iterations.
      activation: output nonlinearity.
      iso: isotropic TV (block prox) vs anisotropic (soft prox).
      use_bias: add a scalar bias.
      creg: feasibility clamp floor for lam/rho.
      lam_init / rho_init: fixed initial values; None -> |glorot| init.
      trainable: subset of {"weight", "bias", "lam", "rho"} that receive
        gradients; the rest are detached (frozen).
      remat: recompute each unrolled iteration in the backward pass.
      fft_mode, prox_impl, state_dtype: passed to ``tv_deconvolve``.
      diff_mode: "unroll" backpropagates through the iterations (the exact
        gradient of the truncated solver; needed for a trainable rho);
        "implicit" differentiates the converged fixed point with the
        implicit function theorem at O(1) memory
        (:func:`~admm_deconv_tpu_torch.ops.implicit.tv_deconvolve_implicit`;
        ``remat``, ``prox_impl`` and ``state_dtype`` do not apply to it).
      bwd_iters: depth of the Neumann adjoint for ``diff_mode="implicit"``.
    """

    def __init__(
        self,
        kernel_shape: Sequence[int] = (),
        iters: int = 50,
        activation: Callable = _identity,
        iso: bool = False,
        use_bias: bool = False,
        creg: float = 0.0,
        lam_init: float | None = None,
        rho_init: float | None = None,
        trainable: Sequence[str] = _PARAM_NAMES,
        remat: bool = False,
        fft_mode: str = "auto",
        prox_impl: str = "auto",
        state_dtype: str | None = None,
        diff_mode: str = "unroll",
        bwd_iters: int = 30,
    ):
        super().__init__()
        if diff_mode not in ("unroll", "implicit"):
            raise ValueError(f"diff_mode must be 'unroll' or 'implicit', got {diff_mode!r}")
        kernel_shape = tuple(kernel_shape)
        if len(kernel_shape) not in (0, 2):
            raise ValueError(f"kernel_shape must be () or (kh, kw), got {kernel_shape}")
        unknown = set(trainable) - set(_PARAM_NAMES)
        if unknown:
            raise ValueError(f"unknown trainable parameters {sorted(unknown)}")
        self.kernel_shape = kernel_shape
        self.iters = iters
        self.activation = activation
        self.iso = iso
        self.use_bias = use_bias
        self.creg = creg
        self.lam_init = lam_init
        self.rho_init = rho_init
        self.trainable = tuple(trainable)
        self.remat = remat
        self.fft_mode = fft_mode
        self.prox_impl = prox_impl
        self.state_dtype = state_dtype
        self.diff_mode = diff_mode
        self.bwd_iters = bwd_iters

        self.lam = nn.Parameter(torch.empty(1))
        self.rho = nn.Parameter(torch.empty(1))
        if kernel_shape:
            self.weight = nn.Parameter(torch.empty(*kernel_shape, 1, 1))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(1))
        self.reset_parameters_from(None)

    def reset_parameters_from(self, generator: torch.Generator | None) -> None:
        """The flax initialisers: fixed or |glorot| lam/rho, a glorot-uniform
        PSF (fan_in = fan_out = kh*kw), a zero bias."""
        with torch.no_grad():
            for p, init in ((self.lam, self.lam_init), (self.rho, self.rho_init)):
                if init is None:
                    _glorot_scalar_(p, generator)
                else:
                    p.fill_(init)
            if self.kernel_shape:
                kh, kw = self.kernel_shape
                _uniform_(self.weight, math.sqrt(6.0 / (2 * kh * kw)), generator)
            if self.use_bias:
                self.bias.zero_()

    def _param(self, name: str) -> torch.Tensor:
        p = getattr(self, name)
        return p if name in self.trainable else p.detach()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        psf = None
        if self.kernel_shape:
            w = self._param("weight")[..., 0, 0]
            psf = torch.minimum(_floor(w, 0.0), w.new_ones(()))
        lam = _floor(self._param("lam"), self.creg)[0]
        rho = _floor(_floor(self._param("rho"), self.creg), _RHO_FLOOR)[0]

        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        prox = "iso" if self.iso else "aniso"
        if self.diff_mode == "implicit":
            out = tv_deconvolve_implicit(
                x, psf=psf, lam=lam, rho=rho, iters=self.iters, prox=prox,
                bwd_iters=self.bwd_iters, fft_mode=self.fft_mode,
            )
        else:
            out = tv_deconvolve(
                x,
                psf=psf,
                lam=lam,
                rho=rho,
                iters=self.iters,
                prox=prox,
                remat=self.remat,
                fft_mode=self.fft_mode,
                prox_impl=self.prox_impl,
                state_dtype=self.state_dtype,
            )
        if self.use_bias:
            out = out + self._param("bias")[0]
        out = self.activation(out)
        return out[0] if squeeze else out


def ADMMDeconvF1(kernel_shape, iters: int, lam: float, activation: Callable = _identity,
                 **kw) -> ADMMDeconv:
    """Fixed lam; trainable weight/bias/rho.  ``kw``: iso, use_bias, creg,
    remat, fft_mode, prox_impl, state_dtype, diff_mode, bwd_iters."""
    if lam <= 0:
        raise ValueError("Parameter lam must be greater than 0")
    return ADMMDeconv(kernel_shape, iters, activation, lam_init=lam, rho_init=None,
                      trainable=("weight", "bias", "rho"), **kw)


def ADMMDeconvF2(kernel_shape, iters: int, rho: float, activation: Callable = _identity,
                 **kw) -> ADMMDeconv:
    """Fixed rho; trainable weight/bias/lam."""
    if rho <= 0:
        raise ValueError("Parameter rho must be greater than 0")
    return ADMMDeconv(kernel_shape, iters, activation, lam_init=None, rho_init=rho,
                      trainable=("weight", "bias", "lam"), **kw)


def ADMMDeconvF3(kernel_shape, iters: int, lam: float, rho: float,
                 activation: Callable = _identity, **kw) -> ADMMDeconv:
    """Fixed lam and rho; trainable weight/bias only."""
    if lam <= 0:
        raise ValueError("Parameter lam must be greater than 0")
    if rho <= 0:
        raise ValueError("Parameter rho must be greater than 0")
    return ADMMDeconv(kernel_shape, iters, activation, lam_init=lam, rho_init=rho,
                      trainable=("weight", "bias"), **kw)
