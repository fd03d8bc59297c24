"""Reduce-learning-rate-on-plateau schedule.

Counterpart of ``admm_deconv_tpu/optim/plateau.py``: after ``patience``
consecutive epochs without sufficient improvement, scale the LR by
``(1 - factor)``.  "Improved" means ``loss < best - tolerance * |best|``
(with an absolute floor near zero), the JAX package's fix of the
reference's sign-fragile test.  Host-side; the trainer writes the LR into
the optimizer's ``param_groups``.
"""

from __future__ import annotations

import math


class ReduceLROnPlateau:
    """Host-side plateau tracker; call :meth:`step` once per epoch."""

    def __init__(
        self,
        initial_lr: float,
        patience: int = 10,
        factor: float = 0.01,
        tolerance: float = 0.03,
        min_lr: float = 0.0,
    ):
        if not 0.0 < factor < 1.0:
            raise ValueError("factor must be in (0, 1)")
        self.lr = float(initial_lr)
        self.patience = int(patience)
        self.factor = float(factor)
        self.tolerance = float(tolerance)
        self.min_lr = float(min_lr)
        self.best = math.inf
        self.counter = 0

    def step(self, loss_val: float) -> float:
        """Record an epoch's validation loss; returns the (possibly reduced)
        learning rate to use next."""
        if math.isinf(self.best):
            improved = True
        else:
            improved = loss_val < self.best - self.tolerance * max(abs(self.best), 1e-12)
        if improved:
            self.best = float(loss_val)
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.lr = max(self.lr * (1.0 - self.factor), self.min_lr)
                self.counter = 0
                self.best = float(loss_val)
        return self.lr
