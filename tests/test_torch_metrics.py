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
