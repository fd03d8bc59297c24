"""Building blocks for the model zoo.

Counterpart of ``admm_deconv_tpu/models/blocks.py``: channel-concat
parallel branches, skip connections, ConvTranspose -> Conv up/down blocks
with per-image normalisation, and stride-1 same-size max-pool variants.

Layout: NHWC at every module's API, as in the JAX package; inside, the
convolutions take contiguous NCHW.  The convolutions run at full fp32
(:func:`admm_deconv_tpu_torch.utils.precision.fp32_convs`).

Ownership follows flax: a module built inside another module's
constructor belongs to that module and carries flax's scope name
(``Conv_0``, ``UpDownBlock_1``, ...), so a flax parameter tree loads by
name (``utils/params_io.py``).  The combinators (:class:`Chain`,
:class:`Parallel`, :class:`SkipConnection` and the inner chain of
:class:`UpDownResidualBlock`) hold their parts without owning them: the
module that builds the parts registers them.

Initialisation draws as the JAX package's flax modules do: orthogonal
kernels (drawn in flax's ``(kh, kw, in, out)`` layout) and zero biases;
:func:`init_parameters` redraws a whole model from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from admm_deconv_tpu_torch.utils.params_io import conv_kernel_from_flax
from admm_deconv_tpu_torch.utils.precision import fp32_convs


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``min(max(x, 0), 6)``; a tie splits its gradient as JAX's does."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))


def relu1(x: torch.Tensor) -> torch.Tensor:
    """``min(relu(x), 1)`` (reference ``net_build.jl:8``)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def chcat(*xs: torch.Tensor) -> torch.Tensor:
    """Channel-axis concat (NHWC)."""
    return torch.cat(xs, dim=-1)


def normalise(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-image standardisation over (H, W, C), no learned affine:
    subtract the mean and divide by the uncorrected std plus ``eps``."""
    dims = tuple(range(1, x.ndim))
    mu = torch.mean(x, dim=dims, keepdim=True)
    sigma = torch.sqrt(torch.var(x, dim=dims, keepdim=True, correction=0)) + eps
    return (x - mu) / sigma


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    # Contiguous NCHW: with channels-last input, the CPU backward of the
    # large transposed convolutions takes a path ~100x slower.
    with fp32_convs():
        return conv(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


def _max_pool_same(x: torch.Tensor, window: tuple[int, int]) -> torch.Tensor:
    """Flax ``max_pool(x, window, strides=(1, 1), padding="SAME")`` for odd
    windows: the border pads with -inf, as ``MaxPool2d``'s padding does."""
    if any(k % 2 == 0 for k in window):
        raise ValueError(f"SAME stride-1 max pool needs odd windows, got {window}")
    out = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride=1,
                       padding=(window[0] // 2, window[1] // 2))
    return out.permute(0, 2, 3, 1)


def _ortho_init_(conv: nn.Module, generator: torch.Generator | None = None) -> None:
    """Flax's orthogonal kernel init, drawn in flax's layout; zero bias."""
    w = conv.weight
    cin, cout = (w.shape[0], w.shape[1]) if isinstance(conv, nn.ConvTranspose2d) else (
        w.shape[1], w.shape[0])
    kh, kw = w.shape[2], w.shape[3]
    flat = torch.empty(kh * kw * cin, cout)
    nn.init.orthogonal_(flat, generator=generator)
    with torch.no_grad():
        w.copy_(conv_kernel_from_flax(conv, flat.reshape(kh, kw, cin, cout)))
        conv.bias.zero_()


def init_parameters(model: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Redraw every parameter of ``model`` from ``generator``, in module
    order, with the initialisers of the JAX package's flax twins."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            _ortho_init_(m, generator)
        elif hasattr(m, "reset_parameters_from"):
            m.reset_parameters_from(generator)
    return model


class Activation(nn.Module):
    """Elementwise activation wrapper."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class Chain(nn.Module):
    """Sequential composition (Flux ``Chain``); holds, does not own, its layers."""

    def __init__(self, layers: Sequence[Any]):
        super().__init__()
        self.layers = tuple(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Parallel(nn.Module):
    """Apply branches to the same input and merge (Flux ``Parallel``)."""

    def __init__(self, branches: Sequence[Any], merge: Callable = chcat):
        super().__init__()
        self.branches = tuple(branches)
        self.merge = merge

    def forward(self, x):
        return self.merge(*[branch(x) for branch in self.branches])


class SkipConnection(nn.Module):
    """``merge(inner(x), x)`` (Flux ``SkipConnection``)."""

    def __init__(self, inner: Any, merge: Callable = chcat):
        super().__init__()
        self.parts = (inner,)  # a tuple: held, not registered
        self.merge = merge

    def forward(self, x):
        return self.merge(self.parts[0](x), x)


class UpDownBlock(nn.Module):
    """ConvTranspose(valid) -> Conv(valid) -> normalise -> relu6; size
    preserving when both kernels match."""

    def __init__(self, up_kernel, down_kernel, up_features: int, down_features: int,
                 *, in_features: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_features, up_features, tuple(up_kernel))
        self.Conv_0 = nn.Conv2d(up_features, down_features, tuple(down_kernel))
        self.out_features = down_features
        _ortho_init_(self.ConvTranspose_0)
        _ortho_init_(self.Conv_0)

    def forward(self, x):
        x = _conv_nhwc(self.Conv_0, _conv_nhwc(self.ConvTranspose_0, x))
        return relu6(normalise(x))


class DownBlock(nn.Module):
    """Conv(valid) -> normalise -> max pool(same, stride 1) -> relu6."""

    def __init__(self, kernel, features: int, pool_window, *, in_features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, tuple(kernel))
        self.pool_window = tuple(pool_window)
        self.out_features = features
        _ortho_init_(self.Conv_0)

    def forward(self, x):
        x = normalise(_conv_nhwc(self.Conv_0, x))
        return relu6(_max_pool_same(x, self.pool_window))


class UpBlock(nn.Module):
    """ConvTranspose(valid) -> normalise -> max pool(same, stride 1) -> relu6."""

    def __init__(self, kernel, features: int, pool_window, *, in_features: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_features, features, tuple(kernel))
        self.pool_window = tuple(pool_window)
        self.out_features = features
        _ortho_init_(self.ConvTranspose_0)

    def forward(self, x):
        x = normalise(_conv_nhwc(self.ConvTranspose_0, x))
        return relu6(_max_pool_same(x, self.pool_window))


class UpDownResidualBlock(nn.Module):
    """``chcat(inner(x), UpDownBlock(UpDownBlock(x)))``: the recursive
    residual assembly of the autoencoder.  Owns its two up/down blocks;
    holds the inner chain, whose last part sets ``inner_features``."""

    def __init__(self, inner: Sequence[Any], up_kernel, down_kernel, up_features: int,
                 down_features: int, *, in_features: int, inner_features: int):
        super().__init__()
        self.inner = tuple(inner)
        self.UpDownBlock_0 = UpDownBlock(up_kernel, down_kernel, up_features, down_features,
                                         in_features=in_features)
        self.UpDownBlock_1 = UpDownBlock(up_kernel, down_kernel, down_features,
                                         down_features, in_features=down_features)
        self.out_features = inner_features + down_features

    def forward(self, x):
        fwd = x
        for layer in self.inner:
            fwd = layer(fwd)
        return chcat(fwd, self.UpDownBlock_1(self.UpDownBlock_0(x)))
