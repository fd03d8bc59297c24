"""Prox math shared by the stencil kernel's plain version.

Counterpart of ``admm_deconv_tpu/ops/pallas/prox_math.py``.  The four modes
are the reference's threshold operators: aniso = ST, iso = BT, hard = HT,
gauss = GT.  The CUDA kernel (``csrc/stencil_fwd.cu``) carries the same
formulas as ``__device__`` functions; here they are the plain-torch
operators of :mod:`admm_deconv_tpu_torch.ops.prox`, so the two stay one
definition on the host side.
"""

from __future__ import annotations

from admm_deconv_tpu_torch.ops.prox import block, gauss, hard, soft

MODES = ("aniso", "iso", "hard", "gauss")

_MODE_FNS = {"aniso": soft, "iso": block, "hard": hard, "gauss": gauss}


def prox_apply(mode: str, vx, vy, tau):
    """z = prox(v, tau) over the gradient pair; tau broadcastable to v."""
    try:
        fn = _MODE_FNS[mode]
    except KeyError:
        raise ValueError(f"unknown prox mode {mode!r}; expected one of {MODES}") from None
    return fn(vx, vy, tau)
