"""Image-gradient utilities for IQA metrics.

Counterpart of ``admm_deconv_tpu/metrics/iqa.py``: the Sobel and Prewitt
kernel pairs, :func:`imgrads` (per-channel gradients over circularly padded
NHWC input) and :func:`gradientsmag` (with the reference's 1e-16).  The
convolutions run at full fp32 (``utils/precision.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from admm_deconv_tpu_torch.utils.precision import fp32_convs

# Rows [1 2 1; 0 0 0; -1 -2 -1]/8 — the reference's SOBEL_KERNEL_X; "_Y" is
# its transpose.
SOBEL_X = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=np.float64) / 8.0
SOBEL_Y = SOBEL_X.T

# Prewitt pair: rows [1 1 1; 0 0 0; -1 -1 -1]/3.
PREWITT_X = np.array([[1, 1, 1], [0, 0, 0], [-1, -1, -1]], dtype=np.float64) / 3.0
PREWITT_Y = PREWITT_X.T

KERNELS = {
    "sobel": (SOBEL_X, SOBEL_Y),
    "prewitt": (PREWITT_X, PREWITT_Y),
}


def depthwise_conv(x: torch.Tensor, kernel) -> torch.Tensor:
    """Per-channel valid cross-correlation of NHWC ``x`` with one 2-D
    ``(kh, kw)`` kernel, at full fp32."""
    c = x.shape[-1]
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    weight = k.reshape(1, 1, *k.shape[-2:]).expand(c, 1, -1, -1)
    with fp32_convs():
        out = F.conv2d(x.permute(0, 3, 1, 2), weight, groups=c)
    return out.permute(0, 2, 3, 1)


def imgrads(x: torch.Tensor, kernel: str = "sobel") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (x, y) gradient responses with circular padding, NHWC."""
    kx, ky = KERNELS[kernel]
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="circular").permute(0, 2, 3, 1)
    return depthwise_conv(xp, kx), depthwise_conv(xp, ky)


def gradientsmag(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude with the reference's 1e-16 epsilon."""
    return torch.sqrt(gx * gx + gy * gy + 1e-16)
