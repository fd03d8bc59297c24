"""Prox math shared by the stencil kernels' plain versions.

Counterpart of ``admm_deconv_tpu/ops/pallas/prox_math.py``.  The four modes
are the reference's threshold operators: aniso = ST, iso = BT, hard = HT,
gauss = GT.  The CUDA kernels carry the same formulas as ``__device__``
functions (``csrc/prox_math.cuh``); here the forward is the plain-torch
operators of :mod:`admm_deconv_tpu_torch.ops.prox`, so the two stay one
definition on the host side, and :func:`prox_vjp` is the analytic backward.
"""

from __future__ import annotations

import torch

from admm_deconv_tpu_torch.ops.prox import _EPS, block, gauss, hard, soft

MODES = ("aniso", "iso", "hard", "gauss")

_MODE_FNS = {"aniso": soft, "iso": block, "hard": hard, "gauss": gauss}


def prox_apply(mode: str, vx, vy, tau):
    """z = prox(v, tau) over the gradient pair; tau broadcastable to v."""
    try:
        fn = _MODE_FNS[mode]
    except KeyError:
        raise ValueError(f"unknown prox mode {mode!r}; expected one of {MODES}") from None
    return fn(vx, vy, tau)


def prox_vjp(mode: str, vx, vy, tau, zbx, zby):
    """VJP of ``z = prox(v, tau)``: given cotangents ``(zbx, zby)`` return
    ``(vbx, vby, taub_map)``, where ``taub_map`` is the *elementwise* tau
    cotangent (the caller sums it over the pixel axes).

    The exact almost-everywhere gradients, with the masks of the JAX
    package's ``prox_vjp``: where a threshold is not passed the gradient is
    zero, so iso at ``v = 0`` (a flat region under zero duals) is finite,
    where autograd through ``sqrt`` would give ``0 * inf``.
    """
    if mode == "aniso":
        mx = (torch.abs(vx) > tau).to(vx.dtype)
        my = (torch.abs(vy) > tau).to(vy.dtype)
        vbx = mx * zbx
        vby = my * zby
        taub = -(torch.sign(vx) * vbx + torch.sign(vy) * vby)
    elif mode == "iso":
        r = torch.sqrt(vx * vx + vy * vy)
        rs = torch.clamp(r, min=_EPS)
        active = (r > tau).to(vx.dtype)
        dot = vx * zbx + vy * zby
        scale = 1.0 - tau / rs
        vbx = active * (scale * zbx + tau * dot * vx / (rs * rs * rs))
        vby = active * (scale * zby + tau * dot * vy / (rs * rs * rs))
        taub = -active * dot / rs
    elif mode == "hard":
        vbx = (torch.abs(vx) > tau).to(vx.dtype) * zbx
        vby = (torch.abs(vy) > tau).to(vy.dtype) * zby
        taub = torch.zeros_like(vx)
    elif mode == "gauss":
        r2 = vx * vx + vy * vy
        e = torch.exp(-r2 / (2.0 * tau * tau))
        scale = 0.5 - 0.5 * e
        ds_dr2 = e / (4.0 * tau * tau)
        dot = vx * zbx + vy * zby
        vbx = scale * zbx + 2.0 * ds_dr2 * dot * vx
        vby = scale * zby + 2.0 * ds_dr2 * dot * vy
        taub = -(0.5 * e * r2 / (tau * tau * tau)) * dot
    else:
        raise ValueError(f"unknown prox mode {mode!r}; expected one of {MODES}")
    return vbx, vby, taub
