"""Parity of the PyTorch port's prox-dual step (``fused_prox_dual``) with
the JAX package's Pallas kernel, and of the solver loops that run it, on
the CPU.

The same numpy inputs go through JAX's ``fused_prox_dual(interpret=True)``
and through the port, whose wrapper takes the kernel's plain twin for CPU
tensors (the CUDA kernel is held against that twin on the card by
``chip_smoke.py``).

Tolerances: aniso and hard outputs are bit-exact; iso and gauss go through
sqrt and exp, where torch's vectorised CPU functions may round one ulp away
from XLA's, so they agree to ``atol=rtol=1e-6``.  Gradients are the same
analytic VJP: ``atol=rtol=1e-5`` for the arrays; tau's, a sum over every
element taken in another order, to 1e-6 of the sum of its terms'
magnitudes.  Solves agree to ``atol=2e-5`` (pocketfft and XLA's FFT round
differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu.ops.pallas.prox_kernels import fused_prox_dual as jax_prox_dual
from admm_deconv_tpu.ops.solver import tv_deconvolve as jax_tv
from admm_deconv_tpu_torch import ADMMState, tv_deconvolve
from admm_deconv_tpu_torch.ops import prox
from admm_deconv_tpu_torch.ops.kernels.prox_kernels import fused_prox_dual
from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES, prox_vjp

torch.set_num_threads(2)

EXACT_MODES = ("aniso", "hard")


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _inputs(rng, shape):
    return [(0.5 * rng.standard_normal(shape)).astype(np.float32) for _ in range(4)]


def _tau(rng, n, per_plane):
    return rng.uniform(0.1, 0.5, (n,)).astype(np.float32) if per_plane else np.float32(0.3)


def _assert_out(got, want, mode, atol=1e-6):
    got, want = got.detach().numpy(), np.asarray(want)
    if mode in EXACT_MODES:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=atol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape, per_plane",
    [((3, 16, 24), False), ((3, 16, 24), True), ((2, 3, 5, 8), False), ((4, 7, 9, 2), True)],
    ids=["3d_scalar", "3d_plane", "4d_scalar", "4d_plane"],
)
def test_prox_dual_matches_jax(rng, mode, shape, per_plane):
    arrays = _inputs(rng, shape)
    tau = _tau(rng, shape[0], per_plane)
    want = jax_prox_dual(*map(jnp.asarray, arrays), jnp.asarray(tau), mode=mode, interpret=True)
    got = fused_prox_dual(*map(_t, arrays), _t(tau), mode=mode)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        _assert_out(g, w, mode)


@pytest.mark.parametrize("mode", MODES)
def test_prox_dual_equals_port_composition(rng, mode):
    arrays = [_t(a) for a in _inputs(rng, (3, 17, 29))]
    tau = _t(rng.uniform(0.1, 0.5, (3,)))
    got = fused_prox_dual(*arrays, tau, mode=mode)
    want = prox.prox_dual_step(*arrays, tau[:, None, None], prox.resolve(mode))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "plane"])
def test_prox_dual_gradient_matches_jax(rng, mode, per_plane):
    shape = (3, 12, 20)
    arrays = _inputs(rng, shape)
    cts = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    tau = _tau(rng, shape[0], per_plane)

    def jloss(*args):
        out = jax_prox_dual(*args[:4], args[4], mode=mode, interpret=True)
        return sum(jnp.sum(o * c) for o, c in zip(out, cts))

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, arrays), jnp.asarray(tau))
    leaves = [_t(a).requires_grad_() for a in (*arrays, tau)]
    out = fused_prox_dual(*leaves[:4], leaves[4], mode=mode)
    sum((o * _t(c)).sum() for o, c in zip(out, cts)).backward()
    for leaf, w in zip(leaves[:4], want[:4]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    # tau's cotangent sums one term per element, in another order than
    # XLA's: held to 1e-6 of the sum of the terms' magnitudes.
    d, u = (_t(a) for a in arrays[:2]), (_t(a) for a in arrays[2:])
    vx, vy = (a + b for a, b in zip(d, u))
    t = _t(tau) if not per_plane else _t(tau)[:, None, None]
    gzx, gzy, gux, guy = map(_t, cts)
    _, _, terms = prox_vjp(mode, vx, vy, t, gzx - gux, gzy - guy)
    scale = terms.abs().sum() if not per_plane else terms.abs().sum(dim=(1, 2))
    diff = np.abs(leaves[4].grad.numpy() - np.asarray(want[4]))
    assert np.all(diff <= 1e-6 * scale.numpy()), (diff, scale)


def test_iso_flat_region_gradient_is_finite_and_equals_jax():
    """v = 0 everywhere (a flat region under zero duals): autograd through
    the plain iso prox gives 0 * inf = NaN; the analytic VJP, JAX's and the
    port's, gives a finite gradient."""
    shape = (1, 8, 8)
    zeros = np.zeros(shape, np.float32)
    cts = [np.full(shape, c, np.float32) for c in (1.0, -0.5, 0.3, 0.7)]

    def jloss(d):
        out = jax_prox_dual(d, jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(zeros), 0.1,
                            mode="iso", interpret=True)
        return sum(jnp.sum(o * c) for o, c in zip(out, cts))

    want = jax.grad(jloss)(jnp.asarray(zeros))
    d = _t(zeros).requires_grad_()
    out = fused_prox_dual(d, _t(zeros), _t(zeros), _t(zeros), 0.1, mode="iso")
    sum((o * _t(c)).sum() for o, c in zip(out, cts)).backward()
    assert bool(torch.isfinite(d.grad).all())
    np.testing.assert_array_equal(d.grad.numpy(), np.asarray(want))
    plain = _t(zeros).requires_grad_()
    out = prox.prox_dual_step(plain, _t(zeros), _t(zeros), _t(zeros), 0.1, prox.block)
    sum((o * _t(c)).sum() for o, c in zip(out, cts)).backward()
    assert not bool(torch.isfinite(plain.grad).all())  # why the Function exists


@pytest.mark.parametrize(
    "kw, err",
    [
        ({"mode": "l0"}, "unknown prox mode"),
        ({"tau": np.ones(2, np.float32)}, "not scalar or per-plane"),
    ],
    ids=["mode", "tau_shape"],
)
def test_prox_dual_rejects(rng, kw, err):
    arrays = [_t(a) for a in _inputs(rng, (3, 4, 5))]
    kw = {"mode": "aniso", "tau": np.float32(0.3), **kw}
    with pytest.raises(ValueError, match=err):
        fused_prox_dual(*arrays, _t(kw["tau"]), mode=kw["mode"])
    with pytest.raises(ValueError, match="differs from dxx"):
        fused_prox_dual(arrays[0], arrays[1][:2], *arrays[2:], 0.3)


def test_cpu_never_launches(rng):
    before = fused_prox_dual.launches
    fused_prox_dual(*[_t(a) for a in _inputs(rng, (2, 4, 5))], 0.3)
    assert fused_prox_dual.launches == before


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    psf = np.zeros((5, 5), np.float32)
    psf[2, :] = 0.2
    return rng.random((2, 16, 24, 3)).astype(np.float32), psf


@pytest.mark.parametrize("prox_mode", ["aniso", "iso"])
@pytest.mark.parametrize(
    "flags",
    [{"return_diagnostics": True}, {"return_state": True}, {"alpha": 1.5},
     {"alpha": 1.5, "return_diagnostics": True, "return_state": True}],
    ids=["diagnostics", "state", "alpha_fast", "alpha_diag_state"],
)
def test_solver_prox_dual_loops_match_jax(problem, prox_mode, flags):
    """The loops that run the prox-dual step under ``prox_impl="pallas"``
    (the reference-shaped loop and the over-relaxed fast loop) against JAX's
    with its Pallas kernel interpreted."""
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1, "iters": 12, "prox": prox_mode, "prox_impl": "pallas",
          **flags}
    want = jax_tv(jnp.asarray(y), psf=jnp.asarray(psf), fft_mode="xla", **kw)
    got = tv_deconvolve(torch.from_numpy(y), psf=torch.from_numpy(psf), **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        if isinstance(g, ADMMState):
            for a, b in zip(g, w):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0)
        else:
            np.testing.assert_allclose(g.r_norm.numpy(), np.asarray(w.r_norm), atol=1e-4)
            np.testing.assert_allclose(g.s_norm.numpy(), np.asarray(w.s_norm), atol=1e-4)
    # prox_impl="pallas" and the plain composition give one answer.
    plain = tv_deconvolve(torch.from_numpy(y), psf=torch.from_numpy(psf),
                          **{**kw, "prox_impl": "xla"})
    plain = plain if isinstance(plain, tuple) else (plain,)
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=0)


def test_solver_gradient_through_prox_dual_matches_jax(problem):
    """Autograd through the reference-shaped loop's prox-dual Function
    against jax.grad through JAX's custom VJP."""
    y, psf = problem
    y = y[:1, :, :, :1]
    kw = {"rho": 0.1, "iters": 6, "alpha": 1.4, "prox_impl": "pallas"}

    def jloss(yy, ll):
        return jnp.sum(jax_tv(yy, psf=jnp.asarray(psf), lam=ll, fft_mode="xla", **kw) ** 2)

    gy, gl = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y), jnp.float32(0.02))
    yy = torch.from_numpy(y.copy()).requires_grad_()
    ll = torch.tensor(0.02).requires_grad_()
    (tv_deconvolve(yy, psf=torch.from_numpy(psf), lam=ll, **kw) ** 2).sum().backward()
    np.testing.assert_allclose(yy.grad.numpy(), np.asarray(gy), atol=1e-4, rtol=2e-4)
    np.testing.assert_allclose(float(ll.grad), float(gl), atol=1e-4, rtol=2e-4)
