"""Proximal / shrinkage operator library for the ADMM z-update.

PyTorch counterpart of ``admm_deconv_tpu/ops/prox.py``: soft (anisotropic
TV), block (isotropic TV), hard and Gaussian thresholding of the gradient
pair ``(vx, vy)``.  The isotropic norm is the per-pixel, per-channel 2-norm
of ``(dx, dy)`` — deliberately not the reference's batch-coupled
``pixelnorm`` (``docs/PARITY.md``) — so results are batch-size invariant.

``tau`` is a Python number or a tensor that broadcasts against ``v``
(a 0-d tensor, or ``(N, 1, 1)`` per plane).
"""

from __future__ import annotations

from typing import Callable

import torch

ProxFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]
]

_EPS = 1e-12


def soft(vx: torch.Tensor, vy: torch.Tensor, tau) -> tuple[torch.Tensor, torch.Tensor]:
    """Anisotropic (elementwise) soft-thresholding — reference ``ST``."""
    zx = torch.sign(vx) * torch.clamp(torch.abs(vx) - tau, min=0.0)
    zy = torch.sign(vy) * torch.clamp(torch.abs(vy) - tau, min=0.0)
    return zx, zy


def block(vx: torch.Tensor, vy: torch.Tensor, tau) -> tuple[torch.Tensor, torch.Tensor]:
    """Isotropic block (group) soft-thresholding — reference ``BT``.

    Shrinks the per-pixel gradient magnitude ``r = sqrt(vx^2 + vy^2)``.
    """
    r = torch.sqrt(vx * vx + vy * vy)
    scale = torch.clamp(1.0 - tau / torch.clamp(r, min=_EPS), min=0.0)
    return scale * vx, scale * vy


def hard(vx: torch.Tensor, vy: torch.Tensor, tau) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise hard-thresholding — reference ``HT``."""
    zx = vx * (torch.abs(vx) > tau)
    zy = vy * (torch.abs(vy) > tau)
    return zx, zy


def gauss(vx: torch.Tensor, vy: torch.Tensor, tau) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian shrinkage on the gradient magnitude — reference ``GT``:
    ``scale = 0.5 - 0.5 * exp(-r^2 / (2 tau^2))``."""
    r2 = vx * vx + vy * vy
    scale = 0.5 - 0.5 * torch.exp(-r2 / (2.0 * tau * tau))
    return scale * vx, scale * vy


PROX_FNS: dict[str, ProxFn] = {
    "aniso": soft,
    "soft": soft,
    "iso": block,
    "block": block,
    "hard": hard,
    "gauss": gauss,
}


def resolve(prox: str | ProxFn) -> ProxFn:
    """Look up a prox operator by name, or pass a callable through."""
    if callable(prox):
        return prox
    try:
        return PROX_FNS[prox]
    except KeyError:
        raise ValueError(
            f"Unknown prox {prox!r}; expected one of {sorted(PROX_FNS)} or a callable"
        ) from None


def prox_dual_step(
    dxx: torch.Tensor,
    dxy: torch.Tensor,
    ux: torch.Tensor,
    uy: torch.Tensor,
    tau,
    prox_fn: ProxFn,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused z-update + scaled dual ascent: ``v = Dx + u``,
    ``z = prox(v, tau)``, ``u_new = v - z``.

    Returns ``(zx, zy, ux_new, uy_new)``.
    """
    vx = dxx + ux
    vy = dxy + uy
    zx, zy = prox_fn(vx, vy, tau)
    return zx, zy, vx - zx, vy - zy
