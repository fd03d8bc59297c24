"""AdaBelief, written to match ``optax.adabelief`` step for step.

PyTorch has no AdaBelief.  This one follows optax's
``scale_by_belief`` + ``scale_by_learning_rate`` in the same order of
operations, in the parameters' dtype:

    mu  = (1 - b1) g + b1 mu
    nu  = (1 - b2) (g - mu)^2 + b2 nu + eps_root   # error against the *updated* mu
    k  += 1
    p  += -lr * (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps)

``eps_root`` is added to ``nu`` every step and stays in the state; ``eps``
goes outside the square root; the bias corrections use the step count,
computed in float32 as optax computes them.  Each product is rounded
before the sum it feeds (no fused multiply-add), as in optax.
"""

from __future__ import annotations

import numpy as np
import torch


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32."""
    return float(np.float32(1) - np.float32(decay) ** int(count))


class AdaBelief(torch.optim.Optimizer):
    """``optax.adabelief(lr, b1, b2, eps, eps_root)`` as a torch optimizer."""

    def __init__(self, params, lr: float, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-16, eps_root: float = 1e-16):
        if lr <= 0:
            raise ValueError(f"lr must be > 0, got {lr}")
        super().__init__(params, {"lr": lr, "betas": tuple(betas), "eps": eps,
                                  "eps_root": eps_root})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, eps_root = group["lr"], group["eps"], group["eps_root"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_(g * (1 - b1))
                err = g - mu
                nu.mul_(b2).add_(err * err * (1 - b2)).add_(eps_root)
                state["step"] += 1
                k = state["step"]
                mu_hat = mu / bias_correction(b1, k)
                nu_hat = nu / bias_correction(b2, k)
                p.add_(mu_hat / (torch.sqrt(nu_hat) + eps) * (-lr))
        return loss
