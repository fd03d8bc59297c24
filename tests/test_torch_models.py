"""The port's model blocks and zoo against the JAX package, on the CPU.

Each JAX module is initialised, its flax parameters go into the port's
module through ``load_flax_params``, and the same numpy input goes through
both.  Tolerances: single blocks agree to ``atol=1e-5`` (fp32 convolutions
sum in another order in XLA and in torch's CPU kernels); whole networks of
some twenty conv layers with per-image normalisation to ``atol=1e-4``;
the ADMM parts as in ``test_torch_layers.py``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from admm_deconv_tpu.models import blocks as jb
from admm_deconv_tpu.models import zoo as jz
from admm_deconv_tpu_torch.models import blocks as tb
from admm_deconv_tpu_torch.models import zoo as tz
from admm_deconv_tpu_torch.models.blocks import _max_pool_same, init_parameters
from admm_deconv_tpu_torch.utils.params_io import conv_kernel_from_flax, load_flax_params

torch.set_num_threads(2)


def _x(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _jax(module, x):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return jax.device_get(params), np.asarray(jax.jit(module.apply)(params, jnp.asarray(x)))


def _port(module, params, x):
    load_flax_params(module, params)
    return module(torch.from_numpy(x)).detach().numpy()


def test_activations_and_normalise_match_jax():
    v = np.asarray([-1.0, 0.0, 0.5, 1.0, 3.0, 6.0, 7.0], np.float32)
    for tf, jf in ((tb.relu1, jb.relu1), (tb.relu6, jb.relu6)):
        np.testing.assert_array_equal(tf(torch.from_numpy(v)).numpy(), np.asarray(jf(v)))
        # a tie at a clamp edge splits the gradient as JAX does
        t = torch.from_numpy(v).requires_grad_()
        tf(t).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jax.grad(
            lambda a: jf(a).sum())(jnp.asarray(v))))
    x = _x(1, (2, 8, 8, 3)) * 5 + 2
    np.testing.assert_allclose(tb.normalise(torch.from_numpy(x)).numpy(),
                               np.asarray(jb.normalise(jnp.asarray(x))), atol=1e-6)
    a, b = _x(2, (1, 4, 4, 2)), _x(3, (1, 4, 4, 3))
    np.testing.assert_array_equal(tb.chcat(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jb.chcat(a, b)))


def test_conv_transpose_kernel_is_flipped():
    """flax's VALID ConvTranspose (transpose_kernel=False) correlates with
    the kernel as stored; torch's ConvTranspose2d correlates with it
    flipped, so the carried kernel is flipped in both spatial axes."""
    x = _x(4, (1, 7, 6, 2))
    mod = fnn.ConvTranspose(4, (3, 2), padding="VALID")
    params, want = _jax(mod, x)
    conv = nn.ConvTranspose2d(2, 4, (3, 2))
    got = _port_conv(conv, params["params"], x)
    np.testing.assert_allclose(got, want, atol=1e-6)
    with torch.no_grad():  # the same kernel without the flip differs
        conv.weight.copy_(conv_kernel_from_flax(conv, params["params"]["kernel"]).flip(2, 3))
    assert np.abs(_run_conv(conv, x) - want).max() > 1e-2


def test_conv_kernel_layout():
    x = _x(5, (1, 7, 6, 2))
    mod = fnn.Conv(4, (3, 2), padding="VALID")
    params, want = _jax(mod, x)
    got = _port_conv(nn.Conv2d(2, 4, (3, 2)), params["params"], x)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _run_conv(conv, x):
    return conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()


def _port_conv(conv, p, x):
    with torch.no_grad():
        conv.weight.copy_(conv_kernel_from_flax(conv, p["kernel"]))
        conv.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    return _run_conv(conv, x)


@pytest.mark.parametrize("window", [(3, 3), (5, 5), (7, 3)])
def test_max_pool_same_pads_with_minus_inf(window):
    x = _x(6, (2, 9, 8, 3)) - 2.0  # all negative: a zero pad would win at the border
    want = fnn.max_pool(jnp.asarray(x), window, strides=(1, 1), padding="SAME")
    np.testing.assert_array_equal(_max_pool_same(torch.from_numpy(x), window).numpy(),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="odd windows"):
        _max_pool_same(torch.from_numpy(x), (2, 2))


@pytest.mark.parametrize(
    "make_j, make_t, shape",
    [
        (lambda: jb.UpDownBlock((5, 5), (5, 5), 8, 4),
         lambda: tb.UpDownBlock((5, 5), (5, 5), 8, 4, in_features=3), (1, 20, 20, 3)),
        (lambda: jb.UpDownBlock((3, 3), (5, 5), 6, 5),
         lambda: tb.UpDownBlock((3, 3), (5, 5), 6, 5, in_features=3), (2, 12, 12, 3)),
        (lambda: jb.DownBlock((5, 5), 8, (3, 3)),
         lambda: tb.DownBlock((5, 5), 8, (3, 3), in_features=3), (1, 20, 20, 3)),
        (lambda: jb.UpBlock((5, 5), 8, (5, 5)),
         lambda: tb.UpBlock((5, 5), 8, (5, 5), in_features=3), (1, 16, 16, 3)),
    ],
    ids=["updown", "updown_grow", "down", "up"],
)
def test_block_matches_jax(make_j, make_t, shape):
    x = _x(7, shape)
    params, want = _jax(make_j(), x)
    got = _port(make_t(), params, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


class _OwnedResidual(tb.UpDownResidualBlock):
    """A standalone residual block owns its inner parts, as flax names them
    when the parts are built outside any module (``inner_0``, ...)."""

    def __init__(self, inner, *args, **kw):
        super().__init__(inner, *args, **kw)
        for i, part in enumerate(inner):
            setattr(self, f"inner_{i}", part)


def test_updown_residual_block_matches_jax():
    x = _x(8, (1, 24, 24, 3))
    jmod = jb.UpDownResidualBlock(
        (jb.DownBlock((5, 5), 8, (3, 3)), jb.UpBlock((5, 5), 6, (3, 3))), (3, 3), (3, 3), 4, 4)
    params, want = _jax(jmod, x)
    tmod = _OwnedResidual(
        (tb.DownBlock((5, 5), 8, (3, 3), in_features=3),
         tb.UpBlock((5, 5), 6, (3, 3), in_features=8)),
        (3, 3), (3, 3), 4, 4, in_features=3, inner_features=6,
    )
    got = _port(tmod, params, x)
    assert got.shape == want.shape == (1, 24, 24, 10) and tmod.out_features == 10
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_combinators_match_jax():
    x = _x(9, (2, 6, 5, 3))
    chain_j = jb.Chain((jb.normalise, jb.relu1))
    chain_t = tb.Chain((tb.normalise, tb.relu1))
    cases = [
        (chain_j, chain_t),
        (jb.Parallel((jb.relu1, jb.normalise)), tb.Parallel((tb.relu1, tb.normalise))),
        (jb.SkipConnection(chain_j), tb.SkipConnection(chain_t)),
        (jb.SkipConnection(chain_j, merge=lambda a, b: a + b),
         tb.SkipConnection(chain_t, merge=torch.add)),
        (jb.Activation(jb.relu6), tb.Activation(tb.relu6)),
    ]
    for jm, tm in cases:
        want = jm.apply({}, jnp.asarray(x))
        got = tm(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        assert not list(tm.parameters())  # combinators hold, never own, their parts


def test_autoencoder_matches_jax():
    x = _x(10, (1, 96, 96, 3))
    params, want = _jax(jz.Autoencoder(), x)
    model = tz.Autoencoder()
    got = _port(model, params, x)
    assert got.shape == (1, 96, 96, 160) and model.out_features == 160
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_denoiser_bank_fused_matches_unfused_and_jax():
    x = _x(11, (2, 16, 16, 3))
    lam = np.asarray([0.001, 0.01, 0.05, 0.1, 0.2], np.float32)
    fused = tz.DenoiserBank(iters=4)
    unfused = tz.DenoiserBank(iters=4, fused=False)
    with torch.no_grad():
        fused.lam.copy_(torch.from_numpy(lam))
        for i in range(5):
            getattr(unfused, f"ADMMDeconv_{i}").lam.fill_(float(lam[i]))
    got = fused(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 16, 16, 15)
    np.testing.assert_allclose(got.detach().numpy(),
                               unfused(torch.from_numpy(x)).detach().numpy(), atol=1e-6)
    jmod = jz.DenoiserBank(iters=4)
    params = {"params": {"lam": jnp.asarray(lam)}}
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)
    g_want = jax.grad(lambda p: jnp.sum(jmod.apply(p, jnp.asarray(x)) ** 2))(params)
    (got**2).sum().backward()
    g_want = np.asarray(g_want["params"]["lam"])
    np.testing.assert_allclose(fused.lam.grad.numpy(), g_want,
                               atol=1e-3 * np.abs(g_want).max())


@pytest.fixture(scope="module")
def flagship():
    x = _x(12, (1, 96, 96, 3))
    params, want = _jax(jz.AdmmDenoiser(denoiser_iters=2), x)
    return x, params, want


def test_admm_denoiser_matches_jax(flagship):
    x, params, want = flagship
    model = load_flax_params(tz.AdmmDenoiser(denoiser_iters=2), params)
    out = model(torch.from_numpy(x))
    assert tuple(out.shape) == x.shape
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-4)
    assert float(out.detach().min()) >= 0.0 and float(out.detach().max()) <= 1.0
    out.square().mean().backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_admm_denoiser_parameter_names_are_flax_paths(flagship):
    _, params, _ = flagship
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    flax_names = {".".join(k.key for k in path) for path, _ in flat}
    port_names = {n.replace(".weight", ".kernel") if ".Conv" in n else n
                  for n, _ in tz.AdmmDenoiser(denoiser_iters=2).named_parameters()}
    assert port_names == flax_names


def test_multistage_matches_jax():
    x = _x(13, (1, 32, 32, 3))
    params, want = _jax(jz.MultistageUpDownscale(), x)
    got = _port(tz.MultistageUpDownscale(), params, x)
    assert got.shape == (1, 32, 32, 32)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_deconv_bank_matches_jax():
    x = _x(14, (1, 32, 32, 3))
    params, want = _jax(jz.DeconvBank(iters=2), x)
    got = _port(tz.DeconvBank(iters=2), params, x)
    assert got.shape == (1, 32, 32, 9)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_build_model():
    cfg = {"use_iso": False, "state_dtype": "bfloat16"}
    m = tz.build_model("admm_denoiser", cfg, device="cpu")
    assert isinstance(m, tz.AdmmDenoiser) and m.DenoiserBank_0.iso is False
    assert m.DenoiserBank_0.state_dtype == "bfloat16"
    assert isinstance(tz.build_model("deconv_bank", cfg, device="cpu"), tz.DeconvBank)
    for name, cls in (("autoencoder", tz.Autoencoder), ("denoiser_bank", tz.DenoiserBank),
                      ("multistage", tz.MultistageUpDownscale)):
        assert isinstance(tz.build_model(name, device="cpu"), cls)
    with pytest.raises(ValueError, match="unknown model"):
        tz.build_model("nope", device="cpu")


def test_build_model_goes_to_the_card(monkeypatch):
    """``build_model`` puts the module on the card, as JAX's ``init`` puts
    the parameters on its default device: with no CUDA device the default
    raises instead of building on the CPU; ``device="cpu"`` asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="on the CUDA device"):
        tz.build_model("admm_denoiser")
    m = tz.build_model("admm_denoiser", device="cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())


def test_init_parameters_is_seeded_and_orthogonal():
    a, b = (tz.AdmmDenoiser(denoiser_iters=2) for _ in range(2))
    init_parameters(a, torch.Generator().manual_seed(3))
    init_parameters(b, torch.Generator().manual_seed(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    conv = a.UpDownBlock_0.Conv_0  # flax layout (5*5*32, 32): orthonormal columns
    w = conv.weight.detach().permute(2, 3, 1, 0).reshape(-1, 32)
    torch.testing.assert_close(w.T @ w, torch.eye(32), atol=1e-5, rtol=0)
    assert float(a.UpDownBlock_0.Conv_0.bias.detach().abs().max()) == 0.0
    lam = a.DenoiserBank_0.lam.detach()
    assert bool(((lam >= 0) & (lam < 3**0.5)).all())


def test_load_flax_params_rejects_mismatch(flagship):
    _, params, _ = flagship
    with pytest.raises(ValueError, match="no submodule"):
        load_flax_params(tz.Autoencoder(), params)
    with pytest.raises(ValueError, match="no flax value"):
        load_flax_params(tz.AdmmDenoiser(denoiser_iters=2),
                         {"DenoiserBank_0": params["params"]["DenoiserBank_0"]})
    bad = {"lam": np.zeros(4, np.float32)}
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_params(tz.DenoiserBank(), bad)
