"""Gradient Magnitude Similarity Deviation (GMSD) metric / training loss.

Counterpart of ``admm_deconv_tpu/metrics/gmsd.py``: Sobel gradients over
circular padding, gradient magnitude with 1e-16, similarity map with
``t=0.0026``, ``alpha=0``, score = batch mean of the per-image standard
deviation of the map.
"""

from __future__ import annotations

import torch

from admm_deconv_tpu_torch.metrics.iqa import gradientsmag, imgrads


def gmsd(x: torch.Tensor, y: torch.Tensor, t: float = 0.0026,
         alpha: float = 0.0) -> torch.Tensor:
    """GMSD score between NHWC batches (lower is better; scalar)."""
    if x.ndim == 3:
        x, y = x[None], y[None]
    map_x = gradientsmag(*imgrads(x))
    map_y = gradientsmag(*imgrads(y))
    num = 2.0 * map_x * map_y - alpha * map_x * map_y + t
    den = map_x * map_x + map_y * map_y - alpha * map_x * map_y + t
    gms = num / den
    mean_gms = torch.mean(gms, dim=(1, 2, 3), keepdim=True)
    score = torch.mean((gms - mean_gms) ** 2, dim=(1, 2, 3))
    return torch.mean(torch.sqrt(score))


def gmsd_loss(x: torch.Tensor, y: torch.Tensor, **kwargs) -> torch.Tensor:
    """Alias of :func:`gmsd`."""
    return gmsd(x, y, **kwargs)
