"""Carry a solver warm-start state between the JAX package and this port.

An :class:`ADMMState` is five ``(B*C, H, W)`` plane stacks with the same
meaning in both packages, so numpy arrays carry it across: a JAX
``return_state=True`` result (or the ``.npz`` written by the JAX package's
``save_solver_state``) goes in through :func:`state_from_numpy`, and
:func:`state_to_numpy` gives back the field-name -> array mapping that
``np.savez`` and the JAX ``ADMMState(**arrays)`` take.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from admm_deconv_tpu_torch.ops.solver import ADMMState


def state_from_numpy(arrays, device: torch.device | str = "cpu") -> ADMMState:
    """Build an :class:`ADMMState` on ``device`` from a mapping of field name
    to array (e.g. an ``np.load`` result) or a 5-tuple in field order
    ``(x, zx, zy, ux, uy)``, such as the JAX package's own ``ADMMState``."""
    if not isinstance(arrays, Mapping):
        arrays = dict(zip(ADMMState._fields, arrays, strict=True))
    return ADMMState(
        *(torch.tensor(np.asarray(arrays[f]), device=device) for f in ADMMState._fields)
    )


def state_to_numpy(state: ADMMState) -> dict[str, np.ndarray]:
    """Field name -> host numpy array for every plane stack of ``state``."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in ADMMState._fields}
