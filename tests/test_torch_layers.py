"""The port's ADMMDeconv layer and its F1/F2/F3 factories against the JAX
package, on the CPU.

The JAX layer is initialised, its flax parameters go into the port's
layer through ``load_flax_params``, and the same numpy input goes through
both.  JAX on the CPU differentiates the plain prox composition; the port
takes the fused stencil's analytic backward.  Tolerances: outputs to
``atol=2e-5`` (pocketfft and XLA's FFT round differently; a few 1e-6 over
the iterations, as in ``test_torch_solver.py``), parameter gradients to
``rtol=1e-3`` of the largest entry (those roundings, carried back through
the unrolled iterations).  A frozen parameter has no gradient in the port
and a zero one in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu.layers import deconv as jl
from admm_deconv_tpu.models.blocks import relu1 as jax_relu1
from admm_deconv_tpu_torch.layers import deconv as tl
from admm_deconv_tpu_torch.models.blocks import relu1
from admm_deconv_tpu_torch.utils.params_io import load_flax_params

torch.set_num_threads(2)

SHAPE = (2, 16, 16, 3)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    return (rng.random(SHAPE).astype(np.float32),
            rng.standard_normal(SHAPE).astype(np.float32))


CASES = {
    "full_aniso_bias": (
        lambda m: m.ADMMDeconv(kernel_shape=(5, 5), iters=4, use_bias=True),
    ),
    "full_iso_creg_remat": (
        lambda m: m.ADMMDeconv(kernel_shape=(5, 5), iters=4, iso=True, creg=0.05, remat=True,
                               lam_init=0.02, rho_init=0.3),
    ),
    "kernel_less_relu1": (
        lambda m: m.ADMMDeconv(kernel_shape=(), iters=4, lam_init=0.05, rho_init=0.5,
                               trainable=("lam", "rho"),
                               activation=relu1 if m is tl else jax_relu1),
    ),
    "F1": (lambda m: m.ADMMDeconvF1((5, 5), 4, 0.01, use_bias=True),),
    "F2": (lambda m: m.ADMMDeconvF2((3, 5), 4, 0.1, iso=True),),
    "F3": (lambda m: m.ADMMDeconvF3((4, 4), 4, 0.01, 0.1),),
}


def _jax_run(layer, x, w):
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    out = layer.apply(params, jnp.asarray(x))
    grads = jax.grad(lambda p: jnp.sum(layer.apply(p, jnp.asarray(x)) * w))(params)
    return jax.device_get(params), np.asarray(out), jax.device_get(grads)["params"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_forward_and_grads_match_jax(data, case):
    x, w = data
    params, want, want_g = _jax_run(CASES[case][0](jl), x, w)
    layer = load_flax_params(CASES[case][0](tl), params)
    out = layer(torch.from_numpy(x))
    assert tuple(out.shape) == SHAPE
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    for name, g_want in want_g.items():
        g_want = np.asarray(g_want)
        g = getattr(layer, name).grad
        if name not in layer.trainable:
            assert g is None and not np.any(g_want), name
            continue
        tol = 1e-3 * max(float(np.abs(g_want).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), g_want, atol=tol, rtol=0, err_msg=name)


def test_layer_bf16_state_matches_jax_envelope(data):
    """bf16 loop state: the port's grads sit within twice JAX's own
    bf16-vs-fp32 deviation of JAX's bf16 grads (the two round the carry at
    different points)."""
    x, w = data
    mk = lambda m, sdt, **kw: m.ADMMDeconv(kernel_shape=(5, 5), iters=4, lam_init=0.02,  # noqa: E731
                                           rho_init=0.3, state_dtype=sdt, **kw)
    params, want16, g16 = _jax_run(mk(jl, "bfloat16", prox_impl="pallas"), x, w)
    _, want32, g32 = _jax_run(mk(jl, None), x, w)
    layer = load_flax_params(mk(tl, "bfloat16"), params)
    out = layer(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    env = np.abs(want16 - want32).max()
    assert np.abs(out.detach().numpy() - want16).max() <= 2 * env + 1e-4
    for name in ("weight", "lam", "rho"):
        env = np.abs(np.asarray(g16[name]) - np.asarray(g32[name])).max()
        dev = np.abs(getattr(layer, name).grad.numpy() - np.asarray(g16[name])).max()
        assert dev <= 2 * env + 1e-3 * np.abs(np.asarray(g32[name])).max(), name


def test_layer_squeezes_3d_input_and_detaches_frozen(data):
    x, _ = data
    layer = tl.ADMMDeconvF3((5, 5), 3, 0.01, 0.1)
    out3 = layer(torch.from_numpy(x[0]))
    out4 = layer(torch.from_numpy(x[:1]))
    assert tuple(out3.shape) == SHAPE[1:]
    torch.testing.assert_close(out3, out4[0], rtol=0, atol=0)
    out3.sum().backward()
    assert layer.lam.grad is None and layer.rho.grad is None and layer.weight.grad is not None


def test_layer_init_matches_flax_initialisers():
    """lam/rho |glorot| in [0, sqrt 3); PSF glorot-uniform with
    fan_in = fan_out = kh*kw; a seeded generator redraws them the same."""
    layer = tl.ADMMDeconv(kernel_shape=(5, 5), use_bias=True)
    for p in (layer.lam, layer.rho):
        assert 0.0 <= float(p.detach()) < np.sqrt(3.0)
    assert float(layer.weight.detach().abs().max()) <= np.sqrt(6.0 / 50)
    assert float(layer.bias.detach()) == 0.0
    a, b = (tl.ADMMDeconv(kernel_shape=(5, 5)) for _ in range(2))
    a.reset_parameters_from(torch.Generator().manual_seed(1))
    b.reset_parameters_from(torch.Generator().manual_seed(1))
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)


@pytest.mark.parametrize(
    "make, err, exc",
    [
        (lambda: tl.ADMMDeconv(diff_mode="implicit"), "Queue 1 item 11", NotImplementedError),
        (lambda: tl.ADMMDeconv(diff_mode="neumann"), "diff_mode must be", ValueError),
        (lambda: tl.ADMMDeconv(kernel_shape=(3,)), "kernel_shape", ValueError),
        (lambda: tl.ADMMDeconv(trainable=("psf",)), "unknown trainable", ValueError),
        (lambda: tl.ADMMDeconvF1((3, 3), 2, 0.0), "lam must be", ValueError),
        (lambda: tl.ADMMDeconvF2((3, 3), 2, -1.0), "rho must be", ValueError),
        (lambda: tl.ADMMDeconvF3((3, 3), 2, 0.1, 0.0), "rho must be", ValueError),
    ],
    ids=["implicit", "diff_mode", "kernel_shape", "trainable", "F1", "F2", "F3"],
)
def test_layer_rejects(make, err, exc):
    with pytest.raises(exc, match=err):
        make()
