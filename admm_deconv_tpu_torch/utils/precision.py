"""Full-fp32 convolutions and matrix products on the card.

cuDNN runs float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits: the variance terms of SSIM then cancel badly (SSIM > 1, the
GPU form of the TPU's bf16-conv trap), and the model would no longer match
its CPU run.  The port's convolutions run inside :func:`fp32_convs`, which
turns TF32 off for the block and restores the caller's setting after, so no
process-wide flag leaks into a user's code.

A convolution's backward reads the flag when it runs, not when its forward
ran: code that differentiates the port's models on the card runs the
backward inside :func:`fp32_convs` too, as the trainer does.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def cudnn_flags(**flags):
    """Set attributes of ``torch.backends.cudnn`` (``enabled``,
    ``deterministic``, ``allow_tf32``, ...) inside the block, and restore
    the caller's settings after.  Unlike ``torch.backends.cudnn.flags``,
    which sets every flag (its defaults turn cuDNN off) and whose flags
    differ between torch releases, it touches only the flags it is given."""
    cudnn = torch.backends.cudnn
    before = {name: getattr(cudnn, name) for name in flags}
    for name, value in flags.items():
        setattr(cudnn, name, value)
    try:
        yield
    finally:
        for name, value in before.items():
            setattr(cudnn, name, value)


def fp32_convs():
    """Run cuDNN convolutions at full fp32 (no TF32) inside the block."""
    return cudnn_flags(allow_tf32=False)


@contextlib.contextmanager
def fp32_matmuls():
    """Run cuBLAS matrix products (``torch.bmm``, ``einsum``) at full fp32
    (no TF32) inside the block, whatever the caller has set; the Anderson
    solvers' Gram and correction contractions are differences of nearly
    equal vectors and lose their mixing coefficients at TF32's ten bits."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = before
