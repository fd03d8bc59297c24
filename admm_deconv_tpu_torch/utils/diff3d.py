"""Circular 3-D forward differences and their divergence.

Counterpart of ``admm_deconv_tpu/utils/diff3d.py``: the divergence is the
exact negative adjoint of the forward difference,

    <forward_diff3d(u), (x, y, z)> == -<u, divergence3d(x, y, z)>

for equal ``beta``.
"""

from __future__ import annotations

import torch


def _fwd(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Circular forward difference: ``out[i] = x[i+1] - x[i]`` (wrapping)."""
    return torch.roll(x, -1, dims=axis) - x


def _fwd_adjoint(z: torch.Tensor, axis: int) -> torch.Tensor:
    """Adjoint of :func:`_fwd`: ``out[i] = z[i-1] - z[i]`` (wrapping)."""
    return torch.roll(z, 1, dims=axis) - z


def forward_diff3d(
    data: torch.Tensor, beta: tuple[float, float, float] = (1.0, 1.0, 1.0)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scaled circular forward differences along the first three axes."""
    if len(beta) != 3:
        raise ValueError("beta param. must have 3 elements")
    return (
        beta[0] * _fwd(data, 0),
        beta[1] * _fwd(data, 1),
        beta[2] * _fwd(data, 2),
    )


def divergence3d(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    beta: tuple[float, float, float] = (1.0, 1.0, 0.0),
) -> torch.Tensor:
    """Negative adjoint (divergence) of :func:`forward_diff3d`."""
    if len(beta) != 3:
        raise ValueError("beta param. must have 3 elements")
    return -(
        beta[0] * _fwd_adjoint(x, 0)
        + beta[1] * _fwd_adjoint(y, 1)
        + beta[2] * _fwd_adjoint(z, 2)
    )
