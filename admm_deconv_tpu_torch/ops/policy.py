"""Auto-mode policy: the thresholds behind every ``"auto"`` decision.

Counterpart of ``admm_deconv_tpu/ops/policy.py``, with those of its fields
that the port reads, their JAX names and the same override surface, so that
one override acts on both packages and
:func:`~admm_deconv_tpu_torch.ops.solver.solve_auto` makes the same decision
on the same request and the same policy:

* environment: ``ADMM_TPU_<FIELD>=value`` (read at import and on
  :func:`refresh`), e.g. ``ADMM_TPU_DEEP_EPS_ABS=1e-5``;
* runtime: :func:`set_policy` (``set_policy(deep_eps_abs=1e-5)``), or the
  :func:`overrides` context manager for scoped tuning and tests.

The defaults are measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power
limit by ``python3 chip_times.py --policy`` (A/B pairs in turns; three
runs, the "policy runs 1-3" below; the decision rules and every row are in
PERF.md, section 6).  Each field's
comment gives its numbers and the JAX package's default.  They differ in
one place: solve_auto keeps its loop state in fp32 on the card, where the
JAX package stores it in bf16 on a TPU.  A CPU tensor never takes bf16
state, whatever the policy says.  The JAX policy's four FFT
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
    """The constants behind every ``"auto"`` decision, measured on the H100."""

    # solve_auto: an eps_abs below this keeps fp32 loop state (a bf16
    # iterate noise floor would sit above deeper stopping thresholds).  It
    # acts on the card only through bf16_state_on_tpu, so while that is
    # False it has no effect there (runs 1-3 of the policy rows: bf16 state
    # lost, so the eps_abs sweep did not run).  JAX's default, 1e-4, kept.
    deep_eps_abs: float = 1e-4

    # What prox_impl="auto" resolves to: "pallas" = the fused kernels (their
    # plain twins on a CPU tensor), "xla" = the plain composition.  H100
    # 80GB HBM3, 700.00 W, the port's first card runs (PERF.md): the 1080p
    # batch-4 solve at 50 iterations ran 604.05 and 616.57 it/s through the
    # kernels, 269.11 through the plain composition.  JAX's default,
    # "pallas", kept.
    prox_impl_accel: str = "pallas"

    # Whether solve_auto stores the fast mid-loop's carry in bf16, read for
    # a CUDA tensor only; the name is JAX's, so ADMM_TPU_BF16_STATE_ON_TPU
    # acts on both packages.  H100 80GB HBM3, 700.00 W, policy runs 1-3:
    # bf16 state's per-pair time over fp32's had a median of 1.0018-1.0089
    # at 50 iterations on the 1080p batch 4, 1.0005-1.0086 on the 4K frame
    # and 1.0182-1.0230 to tolerance on ttq_1080p (same iterations), against
    # fp32-to-fp32 spreads of 0.4-1.7%: never faster; and it costs 0.070 dB
    # on the blocks scenario (54.9297 against 54.9996 dB).  JAX's default
    # is True.
    bf16_state_on_tpu: bool = False

    # solve_auto's residual-check block length (tolerance branch; 1 when it
    # does not divide max_iters).  H100 80GB HBM3, 700.00 W, policy runs
    # 1-3, seconds to tolerance on ttq_1080p (fp32 state, max_iters 400):
    # k = 8 0.0758-0.0772 s at 32 iterations, against 0.0863-0.0881 (k = 4,
    # 28 it), 0.0879-0.0896 (10, 40 it), 0.1122-0.1137 (20) and
    # 0.1363-0.1377 (40).  JAX's default, 8, kept.
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
