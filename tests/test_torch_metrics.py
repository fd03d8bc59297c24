"""The port's metrics (iqa, GMSD, SSIM, PSNR, MSE) against the JAX package,
on the CPU.

The same numpy images go to both.  Tolerances: fp32 convolutions and
reductions sum in another order in XLA and in torch's CPU kernels, so
values agree to ``rtol=1e-5`` (``atol=1e-6`` near zero) and gradients to
``rtol=1e-4, atol=1e-7``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu import metrics as jm
from admm_deconv_tpu.metrics.ssim import ssim_kernel as jax_ssim_kernel
from admm_deconv_tpu_torch import metrics as tm
from admm_deconv_tpu_torch.metrics.ssim import _symmetric_pad, ssim_kernel

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    x = rng.random((2, 24, 20, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    return x, y


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kernel", ["sobel", "prewitt"])
def test_imgrads_and_gradientsmag_match_jax(images, kernel):
    x, _ = images
    want = jm.imgrads(jnp.asarray(x), kernel=kernel)
    got = tm.imgrads(_t(x), kernel=kernel)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    _close(tm.gradientsmag(*got), jm.gradientsmag(*want))
    for name in ("SOBEL_X", "SOBEL_Y", "PREWITT_X", "PREWITT_Y"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))


@pytest.mark.parametrize(
    "name, kw",
    [
        ("gmsd", {}),
        ("gmsd_loss", {"t": 0.01, "alpha": 0.5}),
        ("ssim", {}),
        ("ssim", {"crop": False}),
        ("ssim", {"peakval": 2.0}),
        ("ssim_loss", {}),
        ("ssim_loss_fast", {}),
        ("ssim_loss_fast", {"kernel_length": 3, "crop": False}),
        ("peak_snr", {}),
    ],
    ids=["gmsd", "gmsd_loss_t_alpha", "ssim", "ssim_nocrop", "ssim_peak", "ssim_loss",
         "ssim_loss_fast", "ssim_fast_k3_nocrop", "psnr"],
)
def test_metric_and_gradient_match_jax(images, name, kw):
    x, y = images
    jfn, tfn = getattr(jm, name), getattr(tm, name)
    want, want_g = jax.value_and_grad(lambda a: jfn(a, jnp.asarray(y), **kw))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = tfn(xt, _t(y), **kw)
    got.backward()
    _close(got, want)
    _close(xt.grad, want_g, rtol=1e-4, atol=1e-7)


def test_mse_matches_trainer_mse(images):
    x, y = images
    np.testing.assert_allclose(float(tm.mse(_t(x), _t(y))), float(np.mean((x - y) ** 2)),
                               rtol=1e-6)


def test_ssim_custom_kernel_and_3d_input(images):
    x, y = images
    k = np.full((5, 5, 1, 1), 1 / 25, np.float32)
    want = jm.ssim(jnp.asarray(x[0]), jnp.asarray(y[0]), kernel=jnp.asarray(k))
    _close(tm.ssim(_t(x[0]), _t(y[0]), kernel=_t(k)), want)
    _close(tm.ssim(_t(x[0]), _t(y[0]), kernel=_t(k[:, :, 0, 0])), want)
    np.testing.assert_array_equal(ssim_kernel().numpy(), np.asarray(jax_ssim_kernel()))


def test_ssim_of_identical_images_is_one_and_bounded(images):
    x, y = images
    assert abs(float(tm.ssim(_t(x), _t(x))) - 1.0) < 1e-6
    assert float(tm.ssim(_t(x), _t(y))) <= 1.0
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.ssim(_t(x), _t(y[:, :8]))


@pytest.mark.parametrize("pads", [((5, 5), (5, 5)), ((2, 1), (0, 3))])
def test_symmetric_pad_matches_numpy(images, pads):
    x, _ = images
    want = np.pad(x, ((0, 0), pads[0], pads[1], (0, 0)), mode="symmetric")
    np.testing.assert_array_equal(_symmetric_pad(_t(x), *pads).numpy(), want)


def test_gmsd_of_identical_images_is_zero(images):
    x, _ = images
    assert float(tm.gmsd(_t(x), _t(x))) == 0.0


@pytest.fixture(scope="module")
def numpy_pair():
    """(2, 32, 32, 3) float32 pair from seed 11."""
    rng = np.random.default_rng(11)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    return x, y


NUMPY_METRICS = ["peak_snr", "mse", "ssim", "ssim_loss", "ssim_loss_fast", "gmsd", "gmsd_loss"]


@pytest.mark.parametrize("name", NUMPY_METRICS)
def test_metric_takes_numpy_beside_a_tensor(numpy_pair, name):
    """A numpy argument beside a tensor takes the tensor's device and dtype,
    on either side, and the value equals JAX's on the same arrays."""
    x, y = numpy_pair
    fn = getattr(tm, name)
    jfn = (lambda a, b: jnp.mean((a - b) ** 2)) if name == "mse" else getattr(jm, name)
    want = float(jfn(jnp.asarray(x), jnp.asarray(y)))
    for got in (fn(_t(x), y), fn(x, _t(y))):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _close(got, want)
    got64 = fn(_t(x).double(), y)
    assert got64.dtype == torch.float64
    _close(got64, want)


@pytest.mark.parametrize("name", NUMPY_METRICS)
def test_metric_sends_a_numpy_pair_to_the_card(numpy_pair, name, monkeypatch):
    """Two numpy arguments go to the card as float32, as the solvers' inputs
    do: with no CUDA device the call raises the solvers' error, and with the
    card's place taken by the CPU a float64 pair gives JAX's float32 value."""
    from admm_deconv_tpu_torch.utils import arrays

    x, y = numpy_pair
    fn = getattr(tm, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="goes to the CUDA device"):
        fn(x, y)
    monkeypatch.setattr(arrays, "default_device", lambda: torch.device("cpu"))
    got = fn(x.astype(np.float64), y.astype(np.float64))
    assert got.dtype == torch.float32
    _close(got, fn(_t(x), _t(y)), rtol=0, atol=0)
