"""Circular first-difference stencils D / D^T as roll-based ops.

PyTorch counterpart of ``admm_deconv_tpu/ops/diff.py``, same convention:
    (D_x x)[i, j] = x[i, j] - x[i, j-1]   (circular, along W, last axis)
    (D_y x)[i, j] = x[i, j] - x[i-1, j]   (circular, along H, second-to-last)
with exact adjoints
    (D_x^T z)[i, j] = z[i, j] - z[i, j+1]
    (D_y^T z)[i, j] = z[i, j] - z[i+1, j]
"""

from __future__ import annotations

import torch


def grad2d(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Circular backward differences ``(D_x x, D_y x)`` over the last 2 axes."""
    dx = x - torch.roll(x, 1, dims=-1)
    dy = x - torch.roll(x, 1, dims=-2)
    return dx, dy


def grad2d_adjoint(zx: torch.Tensor, zy: torch.Tensor) -> torch.Tensor:
    """Exact adjoint ``D^T z = D_x^T z_x + D_y^T z_y`` (negative divergence)."""
    return (zx - torch.roll(zx, -1, dims=-1)) + (zy - torch.roll(zy, -1, dims=-2))
