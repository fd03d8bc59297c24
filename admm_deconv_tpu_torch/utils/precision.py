"""Full-fp32 convolutions on the card.

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
def fp32_convs():
    """Run cuDNN convolutions at full fp32 (no TF32) inside the block."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before
