"""Structural similarity (SSIM) metric and loss.

Counterpart of ``admm_deconv_tpu/metrics/ssim.py``: the reference's 11-tap
sigma=1.5 Gaussian window, outer-producted to 2-D and applied per channel;
``C1, C2 = (0.01, 0.03)^2 * peakval^2``; ``crop=True`` -> valid
convolution, ``crop=False`` -> symmetric padding; the map averaged per
image, then over the batch.  NHWC.  The convolutions run at full fp32:
TF32 would let the ``E[x^2] - mu^2`` variance terms cancel badly
(SSIM > 1).
"""

from __future__ import annotations

import numpy as np
import torch

from admm_deconv_tpu_torch.metrics.iqa import depthwise_conv
from admm_deconv_tpu_torch.utils.arrays import as_tensor_pair

# Gaussian kernel std=1.5, length=11 — the reference's values.
SSIM_KERNEL_1D = np.array(
    [
        0.00102838008447911,
        0.007598758135239185,
        0.03600077212843083,
        0.10936068950970002,
        0.2130055377112537,
        0.26601172486179436,
        0.2130055377112537,
        0.10936068950970002,
        0.03600077212843083,
        0.007598758135239185,
        0.00102838008447911,
    ],
    dtype=np.float64,
)


def ssim_kernel(dtype=torch.float32) -> torch.Tensor:
    """2-D 11x11 Gaussian window, shape ``(11, 11, 1, 1)`` (HWIO, as the
    JAX package gives it)."""
    k2d = np.outer(SSIM_KERNEL_1D, SSIM_KERNEL_1D)
    return torch.as_tensor(k2d[:, :, None, None], dtype=dtype)


def _symmetric_pad(x: torch.Tensor, ph: tuple[int, int], pw: tuple[int, int]) -> torch.Tensor:
    """numpy's ``mode="symmetric"`` (edge repeated) over H and W of NHWC."""

    def index(n, lo, hi):
        return torch.cat([torch.arange(lo - 1, -1, -1), torch.arange(n),
                          torch.arange(n - 1, n - 1 - hi, -1)]).to(x.device)

    x = x.index_select(1, index(x.shape[1], *ph))
    return x.index_select(2, index(x.shape[2], *pw))


def ssim(x: torch.Tensor, y: torch.Tensor, kernel: torch.Tensor | None = None,
         peakval: float = 1.0, crop: bool = True) -> torch.Tensor:
    """SSIM between NHWC image batches (scalar, batch-averaged).  ``kernel``
    is ``(kh, kw, 1, 1)`` or ``(kh, kw)``.  Tensors or numpy arrays
    (:func:`~admm_deconv_tpu_torch.utils.arrays.as_tensor_pair`)."""
    x, y = as_tensor_pair(x, y)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} vs {tuple(y.shape)}")
    if x.ndim == 3:
        x, y = x[None], y[None]
    if kernel is None:
        kernel = ssim_kernel(x.dtype)
    k = torch.as_tensor(kernel, dtype=x.dtype)
    k = k.reshape(k.shape[0], k.shape[1])

    c1 = (0.01 * peakval) ** 2
    c2 = (0.03 * peakval) ** 2

    if not crop:
        kh, kw = k.shape
        # Flux calc_padding split: ceil on the leading side.
        ph = (-(-(kh - 1) // 2), (kh - 1) // 2)
        pw = (-(-(kw - 1) // 2), (kw - 1) // 2)
        x = _symmetric_pad(x, ph, pw)
        y = _symmetric_pad(y, ph, pw)

    mu_x = depthwise_conv(x, k)
    mu_y = depthwise_conv(y, k)
    mu_x2 = mu_x * mu_x
    mu_y2 = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x2 = depthwise_conv(x * x, k) - mu_x2
    sigma_y2 = depthwise_conv(y * y, k) - mu_y2
    sigma_xy = depthwise_conv(x * y, k) - mu_xy

    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2)
    )
    return torch.mean(torch.mean(ssim_map, dim=(1, 2, 3)))


def ssim_loss(x: torch.Tensor, y: torch.Tensor, **kwargs) -> torch.Tensor:
    """``1 - ssim(x, y)``."""
    return 1.0 - ssim(x, y, **kwargs)


def ssim_loss_fast(x: torch.Tensor, y: torch.Tensor, kernel_length: int = 5,
                   **kwargs) -> torch.Tensor:
    """SSIM loss with a normalised box window."""
    x, y = as_tensor_pair(x, y)
    k = torch.ones((kernel_length, kernel_length, 1, 1), dtype=x.dtype)
    k = k / (kernel_length * kernel_length)
    return ssim_loss(x, y, kernel=k, **kwargs)
