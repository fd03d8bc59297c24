"""The port's implicit (fixed-point) differentiation against the JAX
package's, on the CPU.

The port's counterparts of the six tests of ``tests/test_implicit.py`` (on
the same problem: a seeded uniform 32x32 image and a 5-tap motion PSF), the
implicit gradients of ``lam``, ``rho``, ``y`` and ``psf`` against
``jax.grad`` of JAX's ``tv_deconvolve_implicit`` on the same numpy inputs,
the layer with JAX's parameters, and the module's point: the forward saves
the final state only.

Tolerances: forward within ``atol=1e-6`` of the unrolled solve (the same
iterations; the implicit forward takes the reference-shaped loop and the
unrolled one the q-carry loop) and ``2e-5`` of JAX (pocketfft and XLA's FFT
round differently); gradients against ``jax.grad`` to ``rtol=1e-3`` of the
largest entry (those roundings, carried through ``bwd_iters`` VJPs of one
step; ``1e-2`` for lam and rho under a box that clips most pixels);
implicit against unrolled as the JAX test states them (5% for lam, 10% of
the largest entry for y and psf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu.layers import ADMMDeconv as JaxADMMDeconv
from admm_deconv_tpu.ops.implicit import tv_deconvolve_implicit as jax_implicit
from admm_deconv_tpu_torch import tv_deconvolve, tv_deconvolve_implicit
from admm_deconv_tpu_torch.layers import deconv as tl
from admm_deconv_tpu_torch.utils.params_io import load_flax_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    y = rng.random((1, 32, 32, 1)).astype(np.float32)
    psf = np.zeros((5, 5), np.float32)
    psf[2, :] = 1 / 5
    return y, psf


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def test_forward_matches_unrolled(problem):
    y, psf = problem
    kw = {"psf": torch.from_numpy(psf), "lam": 0.005, "rho": 0.05, "iters": 60}
    xa = tv_deconvolve_implicit(torch.from_numpy(y), **kw)
    xb = tv_deconvolve(torch.from_numpy(y), **kw)
    torch.testing.assert_close(xa, xb, atol=1e-6, rtol=0)
    xj = jax_implicit(jnp.asarray(y), psf=jnp.asarray(psf), lam=0.005, rho=0.05, iters=60,
                      fft_mode="xla")
    np.testing.assert_allclose(xa.numpy(), np.asarray(xj), atol=2e-5, rtol=0)


def test_gradients_match_unrolled_at_convergence(problem):
    """With a well-converged forward and a deep Neumann adjoint, the implicit
    lam/y/psf gradients approach the unrolled ones."""
    y, psf = problem

    def grads(solver, **extra):
        lam, yy, p = _leaf(0.005), _leaf(y), _leaf(psf)
        x = solver(yy, psf=p, lam=lam, rho=0.05, iters=400, **extra)
        (x ** 2).sum().backward()
        return lam.grad.numpy(), yy.grad.numpy(), p.grad.numpy()

    gl_i, gy_i, gp_i = grads(tv_deconvolve_implicit, bwd_iters=200)
    gl_u, gy_u, gp_u = grads(tv_deconvolve)
    assert abs(float(gl_i - gl_u)) / (abs(float(gl_u)) + 1e-12) < 0.05
    assert _rel(gy_i, gy_u) < 0.10
    assert _rel(gp_i, gp_u) < 0.10


def test_rho_gradient_vanishes_at_fixed_point(problem):
    """At the exact fixed point the solution does not depend on rho, so the
    implicit rho gradient is far below the unrolled finite-iteration one."""
    y, psf = problem

    def grad_rho(solver, **extra):
        rho = _leaf(0.05)
        x = solver(torch.from_numpy(y), psf=torch.from_numpy(psf), lam=0.005, rho=rho,
                   iters=400, **extra)
        (x ** 2).sum().backward()
        return float(rho.grad)

    assert abs(grad_rho(tv_deconvolve_implicit, bwd_iters=200)) < 0.5 * abs(grad_rho(tv_deconvolve))


@pytest.mark.parametrize("psf", [None, np.zeros((0, 0), np.float32)], ids=["none", "empty"])
def test_denoise_mode_differentiable(problem, psf):
    y, _ = problem
    lam = _leaf(0.01)
    x = tv_deconvolve_implicit(torch.from_numpy(y), psf=psf, lam=lam, rho=0.05, iters=100)
    (x ** 2).sum().backward()
    g = float(lam.grad)
    assert np.isfinite(g) and g != 0.0
    gj = jax.grad(lambda l: jnp.sum(
        jax_implicit(jnp.asarray(y), psf=None, lam=l, rho=0.05, iters=100, fft_mode="xla") ** 2
    ))(jnp.float32(0.01))
    np.testing.assert_allclose(g, float(gj), rtol=1e-3)


def test_layer_implicit_mode(problem):
    """The layer with JAX's own parameters: the same output, finite
    gradients equal to JAX's, signal on the weight."""
    y, _ = problem
    mk = lambda m: m(kernel_shape=(3, 3), iters=20, diff_mode="implicit", bwd_iters=10,  # noqa: E731
                     lam_init=0.01, rho_init=0.1)
    jlayer = mk(JaxADMMDeconv)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(y))
    jval, jgrads = jax.value_and_grad(
        lambda p: jnp.mean((jlayer.apply(p, jnp.asarray(y)) - jnp.asarray(y)) ** 2))(params)
    layer = load_flax_params(mk(tl.ADMMDeconv), jax.device_get(params))
    assert layer.bwd_iters == 10 and tl.ADMMDeconv().bwd_iters == 30
    yt = torch.from_numpy(y)
    loss = ((layer(yt) - yt) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-4)
    assert float(layer.weight.grad.abs().max()) > 0
    for name, g_want in jax.device_get(jgrads)["params"].items():
        g, g_want = getattr(layer, name).grad.numpy(), np.asarray(g_want)
        assert np.all(np.isfinite(g)), name
        tol = 1e-3 * max(float(np.abs(g_want).max()), 1e-9)
        np.testing.assert_allclose(g, g_want, atol=tol, rtol=0, err_msg=name)


def test_every_fft_mode_name_gives_the_exact_gradient():
    """Counterpart of JAX's fold1 regression test: the backward's step must
    solve what the forward solved.  Here every mode name is the exact
    ``torch.fft`` path, so the gradients are equal bit for bit, and equal to
    JAX's xla one."""
    rng = np.random.default_rng(42)
    img = np.clip(rng.random((16, 16)).astype(np.float32) * 0.5 + 0.2, 0, 1)

    def grad(mode):
        lam = _leaf(0.05)
        x = tv_deconvolve_implicit(torch.from_numpy(img), None, lam=lam, rho=0.5, iters=40,
                                   fft_mode=mode)
        (x * x).sum().backward()
        return float(lam.grad)

    g_xla = grad("xla")
    assert grad("fold1") == g_xla == grad("auto")
    gj = jax.grad(lambda l: jnp.sum(
        jax_implicit(jnp.asarray(img), None, lam=l, rho=0.5, iters=40, fft_mode="xla") ** 2
    ))(0.05)
    np.testing.assert_allclose(g_xla, float(gj), rtol=1e-3)


@pytest.mark.parametrize("case", ["aniso", "iso", "x_bounds", "per_image"])
def test_implicit_gradients_match_jax_grad(problem, case):
    """lam, rho, y and psf gradients against ``jax.grad`` of JAX's implicit
    solver on the same inputs (``iso`` on a noisy image: no flat region,
    where the plain composition's gradient is NaN in both packages)."""
    y, psf = problem
    kw = {"iters": 60, "bwd_iters": 30}
    lam0, rho0 = np.float32(0.005), np.float32(0.05)
    if case == "iso":
        kw["prox"] = "iso"
    elif case == "x_bounds":
        kw["x_bounds"] = (0.2, 0.8)
    elif case == "per_image":
        rng = np.random.default_rng(7)
        y = rng.random((2, 16, 24, 3)).astype(np.float32)
        lam0, rho0 = np.asarray([0.005, 0.02], np.float32), np.asarray([0.05, 0.2], np.float32)
    w = np.random.default_rng(3).standard_normal(y.shape).astype(np.float32)

    def jloss(lam, rho, yy, p):
        return jnp.sum(jax_implicit(yy, psf=p, lam=lam, rho=rho, fft_mode="xla", **kw) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(lam0), jnp.asarray(rho0), jnp.asarray(y), jnp.asarray(psf))
    leaves = [_leaf(a) for a in (lam0, rho0, y, psf)]
    lam, rho, yy, p = leaves
    x = tv_deconvolve_implicit(yy, psf=p, lam=lam, rho=rho, **kw)
    (x * torch.from_numpy(w)).sum().backward()
    for name, leaf, g_want in zip(("lam", "rho", "y", "psf"), leaves, want):
        g_want = np.asarray(g_want)
        assert leaf.grad.shape == leaf.shape, name
        # A box that clips two thirds of the pixels leaves lam's and rho's
        # gradients as sums of large terms of both signs: rounding shows at
        # 1e-3 there (y's and psf's stay at 1e-6), so those two get 1e-2.
        rtol = 1e-2 if case == "x_bounds" and name in ("lam", "rho") else 1e-3
        tol = rtol * float(np.abs(g_want).max())
        np.testing.assert_allclose(leaf.grad.numpy(), g_want, atol=tol, rtol=0, err_msg=name)


def test_forward_saves_the_final_state_only(problem):
    """O(1) memory: whatever ``iters``, autograd holds the four state planes
    and the four inputs, and nothing of the loop."""
    y, psf = problem
    yy, p, lam, rho = _leaf(y), _leaf(psf), _leaf(0.005), _leaf(0.05)

    def saved_by(solver, iters):
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(
            lambda t: (shapes.append(tuple(t.shape)), t)[1], lambda t: t
        ):
            solver(yy, psf=p, lam=lam, rho=rho, iters=iters)
        return shapes

    state, inputs = [(1, 32, 32)] * 4, [(1, 32, 32, 1), (5, 5), (), ()]
    assert saved_by(tv_deconvolve_implicit, 10) == state + inputs
    assert saved_by(tv_deconvolve_implicit, 40) == state + inputs
    assert len(saved_by(tv_deconvolve, 40)) > 3 * len(saved_by(tv_deconvolve, 10)) > 24


def test_gradients_only_where_asked(problem):
    y, psf = problem
    lam, p = _leaf(0.005), torch.from_numpy(psf)
    x = tv_deconvolve_implicit(torch.from_numpy(y), psf=p, lam=lam, rho=0.05, iters=20,
                               bwd_iters=5)
    assert x.requires_grad
    x.sum().backward()
    assert lam.grad is not None and p.grad is None
    x = tv_deconvolve_implicit(torch.from_numpy(y), psf=p, lam=0.005, rho=0.05, iters=5)
    assert not x.requires_grad


def test_callable_prox_is_refused(problem):
    y, _ = problem
    with pytest.raises(ValueError, match="implicit mode requires a named prox operator"):
        tv_deconvolve_implicit(torch.from_numpy(y), prox=lambda vx, vy, tau: (vx, vy))
    with pytest.raises(ValueError, match="implicit mode requires a named prox operator"):
        jax_implicit(jnp.asarray(y), prox=lambda vx, vy, tau: (vx, vy))


def test_implicit_layer_trains(problem):
    """A few optimiser steps on an implicit F3 layer lower its loss."""
    y, psf = problem
    clean = torch.from_numpy(y)
    blurred = torch.from_numpy(sum(
        psf[2, c] * np.roll(y, c - 2, 2) for c in range(5)).astype(np.float32))
    layer = tl.ADMMDeconvF3((5, 5), 20, 0.002, 0.05, diff_mode="implicit", bwd_iters=10)
    layer.reset_parameters_from(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(layer.parameters(), lr=1e-2)
    losses = []
    for _ in range(6):
        opt.zero_grad()
        loss = ((layer(blurred) - clean) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert layer.lam.grad is None and layer.rho.grad is None
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
