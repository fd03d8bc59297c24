"""The port's ``utils/`` and ``ops.fft.psf_to_otf_full`` against the JAX
package's, on the CPU.

Tolerances: the array helpers and the 3-D differences are exact
(``rtol=0``) or, where an FFT is involved, ``rtol=1e-5, atol=1e-5``
(pocketfft and XLA's FFT round differently).  A solver state written by
either package's ``save_solver_state`` loads bit for bit in the other.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_deconv_tpu.utils as jax_utils
import admm_deconv_tpu_torch.utils as utils
from admm_deconv_tpu.ops.fft import psf_to_otf_full as jax_otf_full
from admm_deconv_tpu.ops.solver import tv_deconvolve as jax_tv_deconvolve
from admm_deconv_tpu_torch import ops, tv_deconvolve
from admm_deconv_tpu_torch.ops.fft import psf_to_otf, psf_to_otf_full
from admm_deconv_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_utils_exports_the_jax_names():
    assert sorted(utils.__all__) == sorted(jax_utils.__all__)
    for name in utils.__all__:
        assert callable(getattr(utils, name)), name
    assert ops.psf_to_otf_full is psf_to_otf_full


@pytest.mark.parametrize("dim", [0, 1, 2, -1])
def test_expand_dims_matches_jax(dim):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = utils.expand_dims(torch.from_numpy(a), dim)
    want = np.asarray(jax_utils.expand_dims(jnp.asarray(a), dim))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,out_shape", [((3, 4), (8, 8)), ((5,), (9,)), ((2, 3, 4), (2, 6, 7)),
                                             ((4, 4), (4, 4))])
def test_fftn_matlike_matches_jax(shape, out_shape):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = utils.fftn_matlike(torch.from_numpy(a), out_shape)
    want = np.asarray(jax_utils.fftn_matlike(jnp.asarray(a), out_shape))
    assert tuple(got.shape) == out_shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_shape,err", [((8,), "one entry per dimension"),
                                           ((2, 8), "smaller than input")])
def test_fftn_matlike_rejects_as_jax(out_shape, err):
    a = np.ones((3, 4), np.float32)
    with pytest.raises(ValueError, match=err):
        utils.fftn_matlike(torch.from_numpy(a), out_shape)
    with pytest.raises(ValueError, match=err):
        jax_utils.fftn_matlike(jnp.asarray(a), out_shape)


@pytest.mark.parametrize("beta", [(1.0, 1.0, 1.0), (0.5, 2.0, 0.0), (1.0, 1.0, 0.25)])
def test_diff3d_matches_jax_and_is_adjoint(beta):
    rng = np.random.default_rng(1)
    u, x, y, z = (rng.standard_normal((5, 6, 7)).astype(np.float32) for _ in range(4))
    got = utils.forward_diff3d(torch.from_numpy(u), beta)
    want = jax_utils.forward_diff3d(jnp.asarray(u), beta)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=0)
    div = utils.divergence3d(*(torch.from_numpy(a) for a in (x, y, z)), beta)
    np.testing.assert_allclose(
        div.numpy(), np.asarray(jax_utils.divergence3d(*(jnp.asarray(a) for a in (x, y, z)), beta)),
        rtol=0, atol=1e-6)
    # <forward_diff3d(u), (x, y, z)> == -<u, divergence3d(x, y, z)>, in float64.
    u64, xyz64 = torch.from_numpy(u).double(), [torch.from_numpy(a).double() for a in (x, y, z)]
    lhs = sum((d * a).sum() for d, a in zip(utils.forward_diff3d(u64, beta), xyz64))
    rhs = -(u64 * utils.divergence3d(*xyz64, beta)).sum()
    assert abs(float(lhs - rhs)) <= 1e-10 * max(1.0, abs(float(lhs)))


def test_diff3d_defaults_and_validation():
    u = torch.rand(3, 4, 5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(utils.forward_diff3d(u)[2], torch.roll(u, -1, 2) - u)
    # The divergence's default beta drops the third axis, as JAX's does.
    assert torch.equal(utils.divergence3d(u, u, u), utils.divergence3d(u, u, 7 * u))
    for fn, args in ((utils.forward_diff3d, (u,)), (utils.divergence3d, (u, u, u))):
        with pytest.raises(ValueError, match="beta param. must have 3 elements"):
            fn(*args, (1.0, 1.0))
    with pytest.raises(ValueError, match="beta param. must have 3 elements"):
        jax_utils.forward_diff3d(jnp.asarray(u.numpy()), (1.0,))


@pytest.mark.parametrize("psf_shape,image",
                         [((5, 5), (16, 24)), ((3, 7), (12, 9)), ((4, 4), (8, 8))])
def test_psf_to_otf_full_matches_jax(psf_shape, image):
    psf = np.random.default_rng(2).random(psf_shape).astype(np.float32)
    got = psf_to_otf_full(torch.from_numpy(psf), image)
    assert tuple(got.shape) == image and got.is_complex()
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_otf_full(jnp.asarray(psf), image)),
                               rtol=1e-5, atol=1e-5)
    # Its first W//2+1 columns are the half-spectrum OTF.
    torch.testing.assert_close(got[:, :image[1] // 2 + 1], psf_to_otf(torch.from_numpy(psf), image),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="larger than image"):
        psf_to_otf_full(torch.from_numpy(psf), (2, 2))


def _solve_inputs():
    rng = np.random.default_rng(5)
    y = rng.random((1, 16, 24, 3)).astype(np.float32)
    psf = np.zeros((5, 5), np.float32)
    psf[2, :] = 0.2
    return y, psf


def test_state_written_by_jax_loads_in_the_port(tmp_path):
    y, psf = _solve_inputs()
    kw = {"lam": 0.01, "rho": 0.1}
    _, sj = jax_tv_deconvolve(jnp.asarray(y), jnp.asarray(psf), iters=6, return_state=True,
                              fft_mode="xla", **kw)
    path = str(tmp_path / "sub" / "state.npz")
    jax_utils.save_solver_state(path, sj)
    st = utils.load_solver_state(path, device="cpu")
    for field in st._fields:
        a = getattr(st, field)
        assert a.device.type == "cpu" and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(sj, field)))
    got = tv_deconvolve(torch.from_numpy(y), torch.from_numpy(psf), iters=5, init_state=st, **kw)
    want = jax_tv_deconvolve(jnp.asarray(y), jnp.asarray(psf), iters=5, init_state=sj,
                             fft_mode="xla", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_state_written_by_the_port_loads_in_jax(tmp_path):
    y, psf = _solve_inputs()
    _, st = tv_deconvolve(torch.from_numpy(y), torch.from_numpy(psf), lam=0.01, rho=0.1, iters=6,
                          return_state=True)
    path = str(tmp_path / "deep" / "er" / "state.npz")
    utils.save_solver_state(path, st)
    sj = jax_utils.load_solver_state(path)
    back = utils.load_solver_state(path, device="cpu")
    for field in st._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, field)), getattr(st, field).numpy())
        assert torch.equal(getattr(back, field), getattr(st, field))


def test_load_solver_state_goes_to_the_card_by_default(tmp_path):
    _, st = tv_deconvolve(torch.rand(8, 8), iters=2, return_state=True)
    path = str(tmp_path / "s.npz")
    utils.save_solver_state(path, st)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            utils.load_solver_state(path)


def test_iteration_timer_keys_and_order():
    """The four keys of JAX's ``measure()``; every input is made before the
    clock starts (warm-ups first, with negative indices)."""
    events = []

    def make_input(i):
        events.append(("make", i))
        return (torch.full((4,), float(i)),)

    def fn(a):
        events.append(("call", int(a[0])))
        time.sleep(0.002)
        return {"out": (a * 2,)}

    stats = utils.IterationTimer(fn, make_input).measure(repeats=3, warmup=2)
    jstats = jax_utils.IterationTimer(lambda a: a * 2, lambda i: (jnp.full((4,), float(i)),)
                                      ).measure(repeats=3, warmup=2)
    assert stats.keys() == jstats.keys() == {"seconds_total", "seconds_per_call", "calls_per_s",
                                             "repeats"}
    assert stats["repeats"] == 3 and stats["seconds_total"] >= 3 * 0.002
    assert stats["seconds_per_call"] == pytest.approx(stats["seconds_total"] / 3)
    assert stats["calls_per_s"] == pytest.approx(1 / stats["seconds_per_call"])
    assert events == [("make", -1), ("call", -1), ("make", -2), ("call", -2),
                      ("make", 0), ("make", 1), ("make", 2), ("call", 0), ("call", 1), ("call", 2)]


def test_force_completion_and_trace_annotation(tmp_path):
    assert profiling.force_completion([(), {"a": torch.ones(3)}]) == 3.0
    with pytest.raises(ValueError, match="at least one tensor"):
        profiling.force_completion([1, "x"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with utils.trace_annotation("admm/test_range"):
            torch.ones(4).sum()
    assert any(e.key == "admm/test_range" for e in prof.key_averages())
    out = profiling.profile_trace(lambda a: a + 1, torch.zeros(2), log_dir=str(tmp_path / "tr"))
    assert torch.equal(out, torch.ones(2))
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("before", [False, True])
def test_enable_nan_checks_toggles(before):
    was = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    try:
        utils.enable_nan_checks(before)
        assert torch.is_anomaly_enabled() is before
        utils.enable_nan_checks(not before)
        assert torch.is_anomaly_enabled() is (not before)
        if not before:
            # On: a NaN born in a backward pass raises (a forward NaN does not).
            x = torch.zeros(2, requires_grad=True)
            with pytest.raises(RuntimeError, match="nan"):
                (torch.sqrt(x) * 0).sum().backward()
            assert bool(torch.isnan(torch.sqrt(torch.tensor(-1.0))))
    finally:
        torch.autograd.set_detect_anomaly(was[0], check_nan=was[1])


@pytest.mark.parametrize("anomaly,det,warn", [(False, False, False), (True, False, False),
                                              (False, True, True), (True, True, False)])
def test_deterministic_mode_restores_what_it_found(anomaly, det, warn):
    was = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(),
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        torch.autograd.set_detect_anomaly(anomaly, check_nan=True)
        torch.use_deterministic_algorithms(det, warn_only=warn)
        with pytest.raises(KeyError):
            with utils.deterministic_mode():
                assert torch.is_anomaly_enabled()
                assert torch.are_deterministic_algorithms_enabled()
                assert not torch.is_deterministic_algorithms_warn_only_enabled()
                # The solvers run under it on the CPU.
                x = tv_deconvolve(torch.rand(8, 8, generator=torch.Generator().manual_seed(0)),
                                  iters=3)
                assert bool(torch.isfinite(x).all())
                raise KeyError("restores on an exception too")
        assert torch.is_anomaly_enabled() is anomaly
        assert torch.are_deterministic_algorithms_enabled() is det
        assert torch.is_deterministic_algorithms_warn_only_enabled() is (det and warn)
    finally:
        torch.autograd.set_detect_anomaly(was[0], check_nan=was[1])
        torch.use_deterministic_algorithms(was[2], warn_only=was[3])


def test_jax_deterministic_mode_restores_too():
    before = jax.config.jax_debug_nans
    with jax_utils.deterministic_mode():
        assert jax.config.jax_debug_nans
    assert jax.config.jax_debug_nans == before
