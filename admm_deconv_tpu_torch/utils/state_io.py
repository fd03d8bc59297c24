"""Solver warm-start state: persistence, and carrying it between the JAX
package and this port.

:func:`save_solver_state` / :func:`load_solver_state` write and read the
JAX package's ``.npz`` (one array per :class:`ADMMState` field name), so a
file written by either package loads in the other.

An :class:`ADMMState` is five ``(B*C, H, W)`` plane stacks with the same
meaning in both packages, so numpy arrays carry it across: a JAX
``return_state=True`` result (or the ``.npz`` written by the JAX package's
``save_solver_state``) goes in through :func:`state_from_numpy`, and
:func:`state_to_numpy` gives back the field-name -> array mapping that
``np.savez`` and the JAX ``ADMMState(**arrays)`` take.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from admm_deconv_tpu_torch.ops.solver import ADMMState


def state_from_numpy(arrays, device: torch.device | str = "cuda") -> ADMMState:
    """Build an :class:`ADMMState` on ``device`` (the card unless the caller
    asks for another, as the solvers put a numpy input on the card) from a
    mapping of field name to array (e.g. an ``np.load`` result) or a 5-tuple
    in field order ``(x, zx, zy, ux, uy)``, such as the JAX package's own
    ``ADMMState``."""
    if not isinstance(arrays, Mapping):
        arrays = dict(zip(ADMMState._fields, arrays, strict=True))
    return ADMMState(
        *(torch.tensor(np.asarray(arrays[f]), device=device) for f in ADMMState._fields)
    )


def state_to_numpy(state: ADMMState) -> dict[str, np.ndarray]:
    """Field name -> host numpy array for every plane stack of ``state``."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in ADMMState._fields}


def save_solver_state(path: str, state: ADMMState) -> None:
    """Persist an :class:`ADMMState` to an ``.npz`` file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **state_to_numpy(state))


def load_solver_state(path: str, device: torch.device | str = "cuda") -> ADMMState:
    """Load an :class:`ADMMState` saved by :func:`save_solver_state` (of
    either package) onto ``device``, the card by default."""
    with np.load(path) as data:
        return state_from_numpy(data, device=device)
