"""Building blocks for the model zoo.

Counterpart of ``admm_deconv_tpu/models/blocks.py``: channel-concat
parallel branches, skip connections, ConvTranspose -> Conv up/down blocks
with per-image normalisation, and stride-1 same-size max-pool variants.

Layout: NHWC at every module's API, as in the JAX package; inside, the
convolutions take contiguous NCHW.  The convolutions run at full fp32
(:func:`admm_deconv_tpu_torch.utils.precision.fp32_convs`).  They are
:class:`Conv2d` and :class:`ConvTranspose2d`, whose passes on the card
(:class:`_Convolution`) take cuDNN's deterministic algorithms and keep the
weight gradients of 5x5 kernels off cuDNN's Winograd path.

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

import contextlib
from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from admm_deconv_tpu_torch.utils.params_io import conv_kernel_from_flax
from admm_deconv_tpu_torch.utils.precision import cudnn_flags, fp32_convs, fp32_matmuls


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


# Kernel sizes whose weight gradient runs on torch's own CUDA convolution
# instead of cuDNN.  cuDNN 9.22 on an H100 takes its nonfused Winograd
# kernels for the weight gradient of the flagship's 5x5 convolutions: they
# read 1e-5 to 8e-4 from float64, where every other pass of every
# convolution of the model reads under 5e-6 on cuDNN and torch's own reads
# under 6e-7 (PERF.md, Findings).  Summed over the 5x5 layers they held the
# flagship step's whole gradient some 4e-4 from float64, up to 2.5e-3.
_OWN_WEIGHT_GRAD = {(5, 5)}


def _on_torch_own(conv_pass: str, kernel_size) -> bool:
    """Whether ``conv_pass`` (``"forward"``, ``"data"`` or ``"weight"``, the
    weight gradient with the bias's) of a convolution with ``kernel_size``
    runs on torch's own CUDA convolution rather than on cuDNN."""
    return conv_pass == "weight" and tuple(kernel_size) in _OWN_WEIGHT_GRAD


def _conv_pass(own: bool = False):
    """The flags of one pass of a :class:`_Convolution`: cuDNN's
    deterministic algorithms at full fp32, whatever the caller set (and
    cuDNN itself only where the caller leaves it on); with ``own``, torch's
    own convolution at full fp32 instead."""
    if not own:
        return cudnn_flags(deterministic=True, allow_tf32=False)
    stack = contextlib.ExitStack()
    stack.enter_context(cudnn_flags(enabled=False))
    stack.enter_context(fp32_matmuls())  # torch's own convolution is a GEMM
    return stack


def _conv_forward(x, weight, bias, ctx):
    """``aten::convolution`` of a :class:`_Convolution`."""
    return torch.ops.aten.convolution(x, weight, bias, *ctx.geometry)


def _conv_backward(g, x, weight, ctx, mask):
    """``aten::convolution_backward`` of a :class:`_Convolution` for the
    gradients ``mask`` asks for (input, weight, bias)."""
    return torch.ops.aten.convolution_backward(g, x, weight, ctx.bias_sizes, *ctx.geometry,
                                               list(mask))


class _Convolution(torch.autograd.Function):
    """A convolution module's pass on the card, with its backward.  Each
    pass runs on cuDNN's deterministic algorithms at full fp32 whatever
    flags the caller set (so the step's gradient is the same bits when
    computed again, and a backward run outside :func:`fp32_convs` is still
    full fp32), with cuDNN only where the caller leaves it on; the weight
    and bias gradients of the kernel sizes of ``_OWN_WEIGHT_GRAD`` on
    torch's own convolution instead (:func:`_on_torch_own`).

    The flags are process-global (``torch.backends.cudnn``'s ``enabled``,
    ``deterministic`` and ``allow_tf32``, and the matrix products' TF32
    flag): each pass sets them and puts the caller's back after, in the
    forward and in autograd's backward thread.  So convolutions of the
    model must not run in two threads at once: one thread's pass could
    restore the flags under the other's."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv):
        transposed = isinstance(conv, nn.ConvTranspose2d)
        ctx.geometry = (list(conv.stride), list(conv.padding), list(conv.dilation), transposed,
                        list(conv.output_padding), conv.groups)
        ctx.bias_sizes = None if bias is None else [bias.shape[0]]
        ctx.kernel_size = tuple(conv.kernel_size)
        ctx.save_for_backward(x, weight)
        with _conv_pass(_on_torch_own("forward", ctx.kernel_size)):
            return _conv_forward(x, weight, bias, ctx)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gx = gw = gb = None
        if need_x:
            with _conv_pass(_on_torch_own("data", ctx.kernel_size)):
                gx = _conv_backward(g, x, weight, ctx, (True, False, False))[0]
        if need_w or need_b:
            with _conv_pass(_on_torch_own("weight", ctx.kernel_size)):
                _, gw, gb = _conv_backward(g, x, weight, ctx, (False, need_w, need_b))
        return gx, gw, gb, None


class _CardConv:
    """A convolution module whose passes on the card are a
    :class:`_Convolution`; on the CPU it is the torch module it extends."""

    def forward(self, x):
        if not x.is_cuda:
            return super().forward(x)
        return _Convolution.apply(x, self.weight, self.bias, self)


class Conv2d(_CardConv, nn.Conv2d):
    """``nn.Conv2d`` with :class:`_CardConv`'s passes on the card."""


class ConvTranspose2d(_CardConv, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with :class:`_CardConv`'s passes on the card."""


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
        self.ConvTranspose_0 = ConvTranspose2d(in_features, up_features, tuple(up_kernel))
        self.Conv_0 = Conv2d(up_features, down_features, tuple(down_kernel))
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
        self.Conv_0 = Conv2d(in_features, features, tuple(kernel))
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
        self.ConvTranspose_0 = ConvTranspose2d(in_features, features, tuple(kernel))
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
