"""The model's convolutions on the card (``models/blocks.py``'s
``Conv2d``/``ConvTranspose2d`` and their ``_Convolution``), on the CPU.

On a CUDA tensor every convolution of the model zoo goes through
``_Convolution``: cuDNN's deterministic algorithms at full fp32 for the
forward and the data gradient, the weight gradient of 5x5 kernels on
torch's own convolution (cuDNN's Winograd weight gradient there read up to
8e-4 from float64 on an H100).  The card is needed to see cuDNN's rounding; here
the Function's arithmetic is held to the module it stands for, and each
pass to the backend and flags it must run under, whatever the caller set.
The on-card check is ``chip_smoke.py``'s recompute detector.
"""

import pytest
import torch
from torch import nn

from admm_deconv_tpu_torch.models import blocks

torch.set_num_threads(2)

KINDS = [blocks.Conv2d, blocks.ConvTranspose2d]


def _module(kind, kernel):
    torch.manual_seed(0)
    return kind(5, 4, kernel).double()


@pytest.mark.parametrize("input_grad", [True, False], ids=["input_grad", "no_input_grad"])
@pytest.mark.parametrize("kernel", [(5, 5), (3, 3)], ids=["5x5", "3x3"])
@pytest.mark.parametrize("kind", KINDS, ids=["conv", "transposed"])
def test_convolution_function_is_the_module(kind, kernel, input_grad):
    """The Function's output and its gradients are the module's and
    autograd's through it: the same aten ops, the backward one gradient at
    a time (float64, equal to 1e-12 of each); with an input that needs no
    gradient (the model's first convolution) it skips the data pass."""
    m = _module(kind, kernel)
    x = torch.randn(2, 5, 9, 11, dtype=torch.float64, requires_grad=input_grad)
    wrt = [x, m.weight, m.bias] if input_grad else [m.weight, m.bias]
    want = m(x)  # the CPU: the torch module's own forward and autograd
    g = torch.randn_like(want)
    want_grads = torch.autograd.grad((want * g).sum(), wrt)
    got = blocks._Convolution.apply(x, m.weight, m.bias, m)
    got_grads = torch.autograd.grad((got * g).sum(), wrt)
    torch.testing.assert_close(got, want.detach(), rtol=1e-12, atol=0)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _flags():
    cudnn = torch.backends.cudnn
    return {"enabled": cudnn.enabled, "deterministic": cudnn.deterministic,
            "cudnn_tf32": cudnn.allow_tf32, "matmul_tf32": torch.backends.cuda.matmul.allow_tf32}


@pytest.mark.parametrize("caller_cudnn", [True, False], ids=["cudnn_on", "cudnn_off"])
@pytest.mark.parametrize("kernel", [(5, 5), (3, 3)], ids=["5x5", "3x3"])
@pytest.mark.parametrize("kind", KINDS, ids=["conv", "transposed"])
def test_each_pass_runs_under_its_backend(monkeypatch, kind, kernel, caller_cudnn):
    """Whatever the caller set (TF32 on, cuDNN nondeterministic): the
    forward and the data gradient run on cuDNN's deterministic algorithms
    without TF32, cuDNN on only where the caller has it on; the weight and
    bias gradients the same way, but for 5x5 kernels on torch's own
    convolution with TF32 off in its matrix products; and the caller's
    flags come back after each pass."""
    seen = []
    forward, backward = blocks._conv_forward, blocks._conv_backward

    def spy_forward(*args):
        seen.append(("forward", _flags()))
        return forward(*args)

    def spy_backward(g, x, weight, ctx, mask):
        seen.append(("data" if mask[0] else "weight", _flags()))
        return backward(g, x, weight, ctx, mask)

    monkeypatch.setattr(blocks, "_conv_forward", spy_forward)
    monkeypatch.setattr(blocks, "_conv_backward", spy_backward)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    monkeypatch.setattr(cudnn, "enabled", caller_cudnn)
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(matmul, "allow_tf32", True)
    caller = _flags()
    x = torch.randn(2, 5, 9, 11, dtype=torch.float64, requires_grad=True)
    m = _module(kind, kernel)
    blocks._Convolution.apply(x, m.weight, m.bias, m).sum().backward()
    assert _flags() == caller
    cudnn_pass = {"enabled": caller_cudnn, "deterministic": True, "cudnn_tf32": False,
                  "matmul_tf32": True}
    own_pass = {"enabled": False, "deterministic": False, "cudnn_tf32": True,
                "matmul_tf32": False}
    assert seen == [("forward", cudnn_pass), ("data", cudnn_pass),
                    ("weight", own_pass if kernel == (5, 5) else cudnn_pass)]


def test_every_convolution_of_the_flagship_is_a_card_convolution():
    """Every convolution of the flagship (the down, up and up/down blocks')
    is a card convolution, and only the 5x5 kernels take their weight
    gradient on torch's own convolution: no forward and no data gradient
    leaves cuDNN."""
    from admm_deconv_tpu_torch.models import AdmmDenoiser

    convs = [m for m in AdmmDenoiser(denoiser_iters=2).modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    assert len(convs) == 40 and all(isinstance(m, blocks._CardConv) for m in convs)
    sizes = {tuple(m.kernel_size) for m in convs}
    assert (5, 5) in sizes and len(sizes) > 1
    for size in sizes:
        assert not blocks._on_torch_own("forward", size)
        assert not blocks._on_torch_own("data", size)
        assert blocks._on_torch_own("weight", size) == (size == (5, 5))


def test_the_card_path_keeps_the_module_hooks(monkeypatch):
    """On a CUDA tensor the module still runs its forward hooks (the
    benchmark counts the convolutions' work by them) and hands the
    Function itself, its weight and its bias."""
    handed, hooked = [], []
    monkeypatch.setattr(blocks._Convolution, "apply",
                        lambda x, w, b, conv: handed.append((w, b, conv)) or x)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    m = _module(blocks.Conv2d, (3, 3))
    m.register_forward_hook(lambda mod, args, out: hooked.append(mod))
    m(torch.randn(1, 5, 7, 7, dtype=torch.float64))
    assert hooked == [m] and handed == [(m.weight, m.bias, m)]
