"""Auto-mode policy: the thresholds behind every ``"auto"`` decision.

Counterpart of ``admm_deconv_tpu/ops/policy.py``, with those of its fields
that the port reads, the same defaults and the same override surface, so
that one override acts on both packages and
:func:`~admm_deconv_tpu_torch.ops.solver.solve_auto` makes the same
decision on the same request:

* environment: ``ADMM_TPU_<FIELD>=value`` (read at import and on
  :func:`refresh`), e.g. ``ADMM_TPU_DEEP_EPS_ABS=1e-5``;
* runtime: :func:`set_policy` (``set_policy(deep_eps_abs=1e-5)``), or the
  :func:`overrides` context manager for scoped tuning and tests.

Every default copies the JAX package's value, which was tuned on another
accelerator; none is measured on the H100 yet.  The JAX policy's four FFT
fields (:data:`_JAX_ONLY_FIELDS`) have no counterpart, because every
``fft_mode`` computes ``torch.fft`` here: :func:`set_policy` and
:func:`overrides` accept those names and ignore them, and their
``ADMM_TPU_*`` variables are not read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os


@dataclasses.dataclass
class AutoPolicy:
    """The constants behind every ``"auto"`` decision (JAX's defaults)."""

    # solve_auto: an eps_abs below this keeps fp32 loop state (a bf16
    # iterate noise floor would sit above deeper stopping thresholds).
    # JAX default 1e-4; not yet measured on the H100.
    deep_eps_abs: float = 1e-4

    # What prox_impl="auto" resolves to: "pallas" = the fused kernels (their
    # plain twins on a CPU tensor), "xla" = the plain composition.  JAX
    # default "pallas"; not yet measured on the H100.
    prox_impl_accel: str = "pallas"

    # Whether solve_auto stores the fast mid-loop's carry in bf16, read for
    # a CUDA tensor only.  JAX default True; not yet measured on the H100.
    bf16_state_on_tpu: bool = True

    # solve_auto's residual-check block length (tolerance branch).  JAX
    # default 8; not yet measured on the H100.
    solve_auto_check_every: int = 8


_FIELDS = {f.name: f for f in dataclasses.fields(AutoPolicy)}
# The JAX policy's FFT fields: accepted by set_policy/overrides, ignored.
_JAX_ONLY_FIELDS = (
    "fft_mode_tpu", "fft_mode_tpu_adaptive", "adaptive_fold1_min_check_every",
    "precompute_fft_mxu",
)


def _from_env() -> AutoPolicy:
    kw = {}
    for name, f in _FIELDS.items():
        raw = os.environ.get(f"ADMM_TPU_{name.upper()}")
        if raw is None:
            continue
        if f.type in ("int", int):
            kw[name] = int(raw)
        elif f.type in ("float", float):
            kw[name] = float(raw)
        elif f.type in ("bool", bool):
            kw[name] = raw.strip().lower() in ("1", "true", "yes", "on")
        else:
            kw[name] = raw
    return AutoPolicy(**kw)


_policy = _from_env()


def policy() -> AutoPolicy:
    """The active auto-mode policy (env overrides applied)."""
    return _policy


def refresh() -> AutoPolicy:
    """Re-read ``ADMM_TPU_*`` environment overrides (drops set_policy)."""
    global _policy
    _policy = _from_env()
    return _policy


def set_policy(**kwargs) -> AutoPolicy:
    """Override policy fields at runtime.  The JAX-only names are ignored;
    unknown fields raise."""
    global _policy
    unknown = set(kwargs) - set(_FIELDS) - set(_JAX_ONLY_FIELDS)
    if unknown:
        raise ValueError(f"unknown policy fields: {sorted(unknown)}")
    kept = {k: v for k, v in kwargs.items() if k in _FIELDS}
    _policy = dataclasses.replace(_policy, **kept)
    return _policy


@contextlib.contextmanager
def overrides(**kwargs):
    """Scoped policy override (tests, A/B tuning)."""
    global _policy
    prev = _policy
    try:
        set_policy(**kwargs)
        yield _policy
    finally:
        _policy = prev
