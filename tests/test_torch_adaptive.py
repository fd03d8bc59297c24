"""Parity of the PyTorch port's ``tv_deconvolve_adaptive``, ``solve_auto``,
``tv_objective`` and ``ops.policy`` with the JAX package, on the CPU.

The same seeded numpy blocks scene (piecewise-constant tiles, 5x5 motion
blur, light noise) goes through the JAX function with ``fft_mode="xla"``
and the given ``prox_impl`` ("pallas" runs JAX's Pallas kernels in
interpret mode) and through the port, whose kernels take their plain
twins on CPU tensors.

Tolerances: x to ``atol=2e-5`` (pocketfft and XLA's FFT round differently;
the stopping blocks and the rho path are equal, so the iterates differ by
rounding only).  Iteration counts are equal: the seeds and tolerances are
ones where no residual sits at its threshold, so a rounding-level change
cannot move a stop by a block.  rho to ``rtol=1e-6`` (it is a product of
exact powers of 2 on the same path).  r/s norms to ``atol=1e-5`` (sums over
a plane taken in another order).  bf16 state rounds the carry at other
points than JAX's does and is held to the fp32 envelope, as in
``test_torch_solver.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu.ops import policy as jax_policy_mod
from admm_deconv_tpu.ops.solver import solve_auto as jax_solve_auto
from admm_deconv_tpu.ops.solver import tv_deconvolve_adaptive as jax_adaptive
from admm_deconv_tpu.ops.solver import tv_objective as jax_objective
from admm_deconv_tpu_torch import solve_auto, tv_deconvolve_adaptive, tv_objective
from admm_deconv_tpu_torch.ops import policy as policy_mod
from admm_deconv_tpu_torch.ops.kernels.prox_kernels import fused_prox_dual
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import fused_admm_stencil

torch.set_num_threads(2)

ATOL = 2e-5
KW = {"lam": 0.01, "rho": 0.05, "max_iters": 40, "eps_abs": 1e-3, "eps_rel": 1e-2}


def blocks(seed, shape=(2, 32, 48, 3), px=8):
    rng = np.random.default_rng(seed)
    tiles = rng.random((shape[0], shape[1] // px, shape[2] // px, shape[3])) > 0.5
    clean = np.clip(0.2 + np.kron(tiles, np.ones((1, px, px, 1))) * 0.4, 0, 1).astype(np.float32)
    psf = np.zeros((5, 5), np.float32)
    psf[2, :] = 0.2
    blurred = sum(psf[a, c] * np.roll(clean, (a - 2, c - 2), (1, 2))
                  for a in range(5) for c in range(5))
    noisy = blurred + 0.01 * rng.standard_normal(blurred.shape)
    return clean, noisy.astype(np.float32), psf


@pytest.fixture(scope="module")
def scene():
    return blocks(0)


def _jax(y, psf, **kw):
    kw.setdefault("fft_mode", "xla")
    return jax_adaptive(jnp.asarray(y), psf=jnp.asarray(psf), **kw)


def _port(y, psf, **kw):
    return tv_deconvolve_adaptive(torch.from_numpy(y), psf=torch.from_numpy(psf), **kw)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _assert_diag(dt, dj):
    assert int(dt.iterations) == int(dj.iterations)
    np.testing.assert_allclose(dt.rho.numpy(), np.asarray(dj.rho), rtol=1e-6, atol=0)
    _close(dt.r_norm, dj.r_norm, atol=1e-5)
    _close(dt.s_norm, dj.s_norm, atol=1e-5)


@pytest.mark.parametrize("prox_impl", ["pallas", "xla"])
@pytest.mark.parametrize("check_every", [1, 2, 4, 8])
def test_adaptive_matches_jax(scene, check_every, prox_impl):
    _, y, psf = scene
    kw = {**KW, "check_every": check_every, "prox_impl": prox_impl}
    xj, dj = _jax(y, psf, **kw)
    xt, dt = _port(y, psf, **kw)
    assert xt.shape == y.shape and isinstance(dt.iterations, torch.Tensor)
    _close(xt, xj)
    _assert_diag(dt, dj)
    assert int(dt.iterations) < KW["max_iters"]  # it stopped early


CASES = {
    "per_image_lam": {"lam": np.asarray([0.01, 0.02], np.float32)},
    "x_bounds": {"x_bounds": (0.0, 1.0)},
    "no_adapt": {"adapt_rho": False},
    "alpha": {"alpha": 1.5},
    "iso": {"prox": "iso"},
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("prox_impl", ["pallas", "xla"])
def test_adaptive_options_match_jax(scene, case, prox_impl):
    _, y, psf = scene
    kw = {**KW, "check_every": 4, "prox_impl": prox_impl, **CASES[case]}
    xj, dj = _jax(y, psf, **kw)
    xt, dt = _port(y, psf, **kw)
    _close(xt, xj)
    _assert_diag(dt, dj)


@pytest.mark.parametrize("check_every", [1, 4])
def test_adaptive_warm_start_and_state_match_jax(scene, check_every):
    from admm_deconv_tpu.ops.solver import ADMMState as JaxADMMState
    from admm_deconv_tpu_torch import ADMMState

    _, y, psf = scene
    kw = {**KW, "check_every": check_every, "prox_impl": "pallas", "max_iters": 8,
          "eps_abs": 0.0, "eps_rel": 0.0}
    _, _, sj = _jax(y, psf, return_state=True, **kw)
    _, _, st = _port(y, psf, return_state=True, **kw)
    for f in ADMMState._fields:
        _close(getattr(st, f), getattr(sj, f))
    init_j = JaxADMMState(*(jnp.asarray(np.asarray(a)) for a in sj))
    init_t = ADMMState(*(torch.from_numpy(np.asarray(a).copy()) for a in sj))
    xj, dj, sj2 = _jax(y, psf, init_state=init_j, return_state=True, **KW | {
        "check_every": check_every, "prox_impl": "pallas"})
    xt, dt, st2 = _port(y, psf, init_state=init_t, return_state=True, **KW | {
        "check_every": check_every, "prox_impl": "pallas"})
    _close(xt, xj)
    _assert_diag(dt, dj)
    for f in ADMMState._fields:
        _close(getattr(st2, f), getattr(sj2, f))


def test_adaptive_bf16_state_within_fp32_envelope(scene):
    _, y, psf = scene
    kw = {**KW, "check_every": 8, "prox_impl": "pallas", "eps_abs": 0.0, "eps_rel": 0.0}
    j32, _ = _jax(y, psf, **kw)
    j16, _ = _jax(y, psf, state_dtype="bfloat16", **kw)
    xt, dt = _port(y, psf, state_dtype="bfloat16", **kw)
    assert xt.dtype == torch.float32 and int(dt.iterations) == kw["max_iters"]
    j32 = np.asarray(j32)
    bound = 2 * np.abs(np.asarray(j16) - j32).max() + 1e-3
    assert np.abs(xt.numpy() - j32).max() <= bound


def test_adaptive_odd_height_kernel_path_matches_jax_plain_body():
    """At H=37 JAX has no row block, so its adaptive solver runs every
    iteration in the full-state form, while the port runs the q-carry
    stencil between checks.  The two are the same iterates by induction;
    they round differently (the stencil recomputes D x and D^T w), so x is
    held to 1e-4 and the stopping block and rho path to equality."""
    _, y, psf = blocks(1, shape=(1, 37, 48, 3))
    kw = {**KW, "check_every": 8, "prox_impl": "pallas"}
    xj, dj = _jax(y, psf, **kw)
    xt, dt = _port(y, psf, **kw)
    _close(xt, xj, atol=1e-4)
    assert int(dt.iterations) == int(dj.iterations)
    np.testing.assert_allclose(dt.rho.numpy(), np.asarray(dj.rho), rtol=1e-6)


def test_cpu_adaptive_never_launches_kernels(scene):
    _, y, psf = scene
    before = fused_admm_stencil.launches, fused_prox_dual.launches
    _port(y, psf, **{**KW, "check_every": 8})
    assert (fused_admm_stencil.launches, fused_prox_dual.launches) == before


@pytest.mark.parametrize(
    "kw, err",
    [
        ({"check_every": 0}, "check_every"),
        ({"check_every": 3}, "check_every"),
        ({"check_every": 80}, "check_every"),
        ({"check_every": 1, "state_dtype": "bfloat16"}, "fast mid-loop"),
        ({"check_every": 4, "alpha": 1.5, "state_dtype": "bfloat16"}, "fast mid-loop"),
        ({"check_every": 4, "prox_impl": "xla", "state_dtype": "bfloat16"}, "fast mid-loop"),
        ({"check_every": 4, "prox": lambda vx, vy, t: (vx, vy), "state_dtype": "bfloat16"},
         "fast mid-loop"),
        ({"fft_mode": "fold2"}, "fft_mode must be"),
        ({"prox_impl": "cuda"}, "prox_impl must be"),
    ],
    ids=["zero", "not_divisor", "above_max", "k1_bf16", "alpha_bf16", "xla_bf16",
         "callable_bf16", "fft", "impl"],
)
def test_adaptive_rejects(scene, kw, err):
    _, y, psf = scene
    with pytest.raises(ValueError, match=err):
        _port(y, psf, **{**KW, **kw})


def _jax_defaults() -> dict:
    """The JAX package's defaults of the port's policy fields: what JAX's
    ``solve_auto`` decides by on the CPU (the port's own defaults are the
    H100's)."""
    return {k: v for k, v in vars(jax_policy_mod.AutoPolicy()).items() if k in policy_mod._FIELDS}


def test_solve_auto_fixed_budget_matches_jax(scene):
    """``iters`` given: JAX's CPU backend takes ``tv_deconvolve`` with
    diagnostics, the port one ``check_every=iters`` adaptive block through
    the kernels' twins; the iterates and the final residuals agree."""
    _, y, psf = scene
    xj, dj = jax_solve_auto(jnp.asarray(y), psf=jnp.asarray(psf), lam=0.01, rho=0.05, iters=20)
    with policy_mod.overrides(**_jax_defaults()):
        xt, dt = solve_auto(torch.from_numpy(y), psf=torch.from_numpy(psf), lam=0.01, rho=0.05,
                            iters=20)
    _close(xt, xj)
    _assert_diag(dt, dj)
    assert int(dt.iterations) == 20


def test_solve_auto_tolerance_matches_jax(scene):
    _, y, psf = scene
    kw = {"lam": 0.01, "rho": 0.05, "eps_abs": 1e-3, "eps_rel": 1e-2, "max_iters": 40}
    xj, dj = jax_solve_auto(jnp.asarray(y), psf=jnp.asarray(psf), **kw)
    with policy_mod.overrides(**_jax_defaults()):
        xt, dt = solve_auto(torch.from_numpy(y), psf=torch.from_numpy(psf), **kw)
    _close(xt, xj)
    _assert_diag(dt, dj)
    # JAX's check_every blocks (8 in both packages' defaults)
    assert int(dt.iterations) % _jax_defaults()["solve_auto_check_every"] == 0


def test_solve_auto_single_iteration_and_callable_prox_take_fixed_solver(scene):
    from admm_deconv_tpu_torch.ops.prox import soft

    _, y, psf = scene
    for kw in ({"iters": 1}, {"iters": 6, "prox": lambda vx, vy, t: soft(vx, vy, t)}):
        xj, dj = jax_solve_auto(jnp.asarray(y), psf=jnp.asarray(psf), lam=0.01, rho=0.05,
                                **{**kw, "prox": "aniso"})
        xt, dt = solve_auto(torch.from_numpy(y), psf=torch.from_numpy(psf), lam=0.01, rho=0.05,
                            **kw)
        _close(xt, xj)
        assert int(dt.iterations) == kw["iters"]


def test_policy_matches_jax_defaults_and_overrides(monkeypatch):
    # The port keeps every JAX field but the FFT ones, under JAX's names and
    # types; JAX's whole default policy is one override away (its FFT fields
    # are accepted and ignored).
    jax_fields = vars(jax_policy_mod.AutoPolicy())
    assert set(jax_fields) == set(policy_mod._FIELDS) | set(policy_mod._JAX_ONLY_FIELDS)
    for name in policy_mod._FIELDS:
        assert isinstance(getattr(policy_mod.AutoPolicy(), name), type(jax_fields[name])), name
    with policy_mod.overrides(**jax_fields) as p:
        assert p == policy_mod.AutoPolicy(**_jax_defaults())
    base = policy_mod.policy()
    with policy_mod.overrides(solve_auto_check_every=4) as p:
        assert p.solve_auto_check_every == 4 == policy_mod.policy().solve_auto_check_every
    assert policy_mod.policy() == base
    # A JAX-only name is accepted, so one override serves both packages,
    # and changes nothing here.
    with policy_mod.overrides(fft_mode_tpu="xla", precompute_fft_mxu=False,
                              deep_eps_abs=1e-5) as p:
        assert p == dataclasses.replace(base, deep_eps_abs=1e-5)
    assert policy_mod.policy() == base
    with pytest.raises(ValueError, match="unknown policy fields"):
        policy_mod.set_policy(no_such_field=1)
    monkeypatch.setenv("ADMM_TPU_DEEP_EPS_ABS", "1e-5")
    monkeypatch.setenv("ADMM_TPU_BF16_STATE_ON_TPU", "false")
    monkeypatch.setenv("ADMM_TPU_PROX_IMPL_ACCEL", "xla")
    try:
        p = policy_mod.refresh()
        assert (p.deep_eps_abs, p.bf16_state_on_tpu, p.prox_impl_accel) == (1e-5, False, "xla")
        policy_mod.set_policy(solve_auto_check_every=2)
        assert policy_mod.policy().solve_auto_check_every == 2
    finally:
        monkeypatch.delenv("ADMM_TPU_DEEP_EPS_ABS")
        monkeypatch.delenv("ADMM_TPU_BF16_STATE_ON_TPU")
        monkeypatch.delenv("ADMM_TPU_PROX_IMPL_ACCEL")
        policy_mod.refresh()
    assert policy_mod.policy() == policy_mod.AutoPolicy()


def test_policy_defaults_are_the_h100_measurements(scene, monkeypatch):
    """The defaults measured on the H100 (``chip_times.py --policy``,
    PERF.md): fp32 state, check_every 8, deep_eps_abs 1e-4, the kernels.
    And a CPU tensor never gets bf16 state, whatever the policy says."""
    p = policy_mod.AutoPolicy()
    assert (p.bf16_state_on_tpu, p.solve_auto_check_every, p.deep_eps_abs,
            p.prox_impl_accel) == (False, 8, 1e-4, "pallas")
    from admm_deconv_tpu_torch.ops import solver as solver_mod

    asked = []
    real = solver_mod.tv_deconvolve_adaptive

    def spy(*args, **kw):
        asked.append(kw.get("state_dtype"))
        return real(*args, **kw)

    monkeypatch.setattr(solver_mod, "tv_deconvolve_adaptive", spy)
    _, y, psf = scene
    yt, pt = torch.from_numpy(y), torch.from_numpy(psf)
    for kw in ({"iters": 20}, {"eps_abs": 1e-3, "eps_rel": 1e-2, "max_iters": 40}):
        with policy_mod.overrides(bf16_state_on_tpu=True, deep_eps_abs=0.0):
            x16, _ = solve_auto(yt, psf=pt, lam=0.01, rho=0.05, **kw)
        with policy_mod.overrides(bf16_state_on_tpu=False):
            x32, _ = solve_auto(yt, psf=pt, lam=0.01, rho=0.05, **kw)
        assert torch.equal(x16, x32), kw
    assert asked == [None] * 4


@pytest.mark.parametrize("k", [1, 8, 16], ids=["one", "h100_default", "not_a_divisor"])
def test_policy_check_every_steers_solve_auto(scene, k):
    """solve_auto keeps the policy's check_every where it divides max_iters
    (40 here) and falls back to 1 where it does not."""
    _, y, psf = scene
    kw = {"lam": 0.01, "rho": 0.05, "eps_abs": 1e-3, "eps_rel": 1e-2, "max_iters": 40}
    used = k if kw["max_iters"] % k == 0 else 1
    with policy_mod.overrides(solve_auto_check_every=k):
        _, d = solve_auto(torch.from_numpy(y), psf=torch.from_numpy(psf), **kw)
    _, dj = jax_adaptive(jnp.asarray(y), psf=jnp.asarray(psf), check_every=used, fft_mode="xla",
                         prox_impl="xla", **kw)
    assert int(d.iterations) == int(dj.iterations)
    assert int(d.iterations) % used == 0


@pytest.mark.parametrize("isotropic", [False, True])
@pytest.mark.parametrize("with_psf", [True, False])
def test_tv_objective_matches_jax(scene, isotropic, with_psf):
    clean, y, psf = scene
    p = psf if with_psf else None
    want = float(jax_objective(jnp.asarray(clean), jnp.asarray(y),
                               None if p is None else jnp.asarray(p), 0.01, isotropic))
    got = tv_objective(torch.from_numpy(clean), torch.from_numpy(y),
                       None if p is None else torch.from_numpy(p), 0.01, isotropic)
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_adaptive_lowers_the_objective(scene):
    _, y, psf = scene
    x, _ = _port(y, psf, **{**KW, "check_every": 8})
    yt, pt = torch.from_numpy(y), torch.from_numpy(psf)
    assert float(tv_objective(x, yt, pt, KW["lam"])) < float(tv_objective(yt, yt, pt, KW["lam"]))


@pytest.mark.parametrize("entry", ["tv_deconvolve_adaptive", "solve_auto",
                                   "composite_tv_deconvolve_adaptive"])
def test_adaptive_solvers_refuse_a_gradient(entry):
    """JAX's adaptive solvers run a ``while_loop``, which ``jax.grad``
    refuses; the port's refuse an input that asks for a gradient rather than
    record a graph over every iteration, and solve once it is detached."""
    import admm_deconv_tpu_torch as adt

    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.random((1, 16, 16, 3)).astype(np.float32))
    psf = torch.full((3, 3), 1 / 9)
    kw = {"max_iters": 4} if entry != "solve_auto" else {"iters": 4}
    fn = getattr(adt, entry)
    with pytest.raises(ValueError, match=f"{entry} is an inference path"):
        fn(y.clone().requires_grad_(), psf=psf, **kw)
    lam_kw = {"lam_tv": torch.tensor(0.01, requires_grad=True)} if "composite" in entry \
        else {"lam": torch.tensor(0.01, requires_grad=True)}
    with pytest.raises(ValueError, match="not differentiable"):
        fn(y, psf=psf, **lam_kw, **kw)
    with torch.no_grad():
        x, _ = fn(y.clone().requires_grad_(), psf=psf, **kw)
    x2, _ = fn(y, psf=psf, **kw)
    assert not x2.requires_grad and torch.equal(x, x2)
