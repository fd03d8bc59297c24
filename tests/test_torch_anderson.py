"""Parity of the PyTorch port's ``tv_deconvolve_anderson`` with the JAX
package's, on the CPU.

The same seeded numpy blocks scene (piecewise-constant tiles, 5x5 motion
blur, light noise) goes through JAX's solver with ``fft_mode="xla"`` and the
given ``prox_impl`` ("pallas" runs JAX's Pallas kernels in interpret mode)
and through the port, whose kernels take their plain twins on CPU tensors.

Tolerances.  Anderson amplifies rounding: the mixing solve on an fp32 Gram
with ``aa_reg=1e-10`` is nearly singular, LAPACK and XLA's batched LU do not
agree to the last bits, and the extrapolation feeds the difference back.  So
short runs (``iters <= 12``) are held elementwise, x to ``rtol=1e-4,
atol=1e-5`` and the residual norms to ``rtol=1e-3``; long runs (60-121
iterations, ``early_stop``) to the solver's contract: the final primal
residual within 10% of JAX's, the PSNR against the clean scene within 0.1 dB
(0.05 dB under ``early_stop``), and equal iteration counts under
``early_stop`` (the scene's stops sit clear of their thresholds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu.ops.solver import _resolve_anderson_m as jax_resolve_m
from admm_deconv_tpu.ops.solver import anderson_history_bytes as jax_history_bytes
from admm_deconv_tpu.ops.solver import tv_deconvolve_anderson as jax_anderson
from admm_deconv_tpu_torch import anderson_history_bytes, tv_deconvolve, tv_deconvolve_anderson
from admm_deconv_tpu_torch.ops.kernels import prox_kernels as pk
from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk
from admm_deconv_tpu_torch.ops.solver import _resolve_anderson_m
from test_torch_adaptive import blocks

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
KW = {"lam": 0.01, "rho": 0.05}


@pytest.fixture(scope="module")
def scene():
    return blocks(0)


def _jax(y, psf, **kw):
    x, d = jax_anderson(jnp.asarray(y), None if psf is None else jnp.asarray(psf),
                        fft_mode="xla", **kw)
    return np.asarray(x), d


def _port(y, psf, **kw):
    x, d = tv_deconvolve_anderson(torch.from_numpy(y),
                                  None if psf is None else torch.from_numpy(psf), **kw)
    return x.numpy(), d


def _psnr(x, ref):
    return 10 * np.log10(1.0 / np.mean((np.clip(x, 0, 1) - ref) ** 2))


def _hold_short(y, psf, **kw):
    x, d = _port(y, psf, **kw)
    xj, dj = _jax(y, psf, **kw)
    assert x.shape == y.shape
    info = f"{kw}: port r={d.r_norm.numpy()} jax r={np.asarray(dj.r_norm)}"
    np.testing.assert_allclose(x, xj, rtol=RTOL, atol=ATOL, err_msg=info)
    assert int(d.iterations) == int(dj.iterations) == kw["iters"]
    np.testing.assert_allclose(d.r_norm.numpy(), np.asarray(dj.r_norm), rtol=1e-3)
    np.testing.assert_allclose(d.s_norm.numpy(), np.asarray(dj.s_norm), rtol=1e-3)
    np.testing.assert_allclose(d.rho.numpy(), np.asarray(dj.rho), rtol=1e-6)


@pytest.mark.parametrize("m", [1, 3, 5])
@pytest.mark.parametrize("prox_impl", ["xla", "pallas"])
def test_anderson_short_run_matches_jax(scene, m, prox_impl):
    _, y, psf = scene
    _hold_short(y, psf, iters=11, m=m, prox_impl=prox_impl, **KW)


@pytest.mark.parametrize("aa_interval,prox_impl", [(2, "xla"), (2, "pallas"), (4, "xla"),
                                                   (4, "pallas")])
def test_anderson_every_k_matches_jax(scene, aa_interval, prox_impl):
    """``aa_interval > 2`` under "pallas": the leading steps of a block run
    the fused stencil's twin (JAX: its kernel where it has a row block for
    the shape, else the same steps unfused)."""
    _, y, psf = scene
    _hold_short(y, psf, iters=9, m=3, aa_interval=aa_interval, prox_impl=prox_impl, **KW)


@pytest.mark.parametrize("prox", ["aniso", "soft", "iso", "block", "hard", "gauss"])
def test_anderson_every_prox_name_matches_jax(scene, prox):
    _, y, psf = scene
    _hold_short(y, psf, iters=9, m=3, prox=prox, aa_interval=4, prox_impl="pallas", **KW)


@pytest.mark.parametrize("case", ["per_image", "per_channel", "x_bounds", "denoise", "hw", "hwc"])
def test_anderson_options_match_jax(scene, case):
    _, y, psf = scene
    kw = {"iters": 9, "m": 3, **KW}
    if case == "per_image":
        kw |= {"lam": np.asarray([0.01, 0.03], np.float32),
               "rho": np.asarray([0.05, 0.2], np.float32), "aa_interval": 4}
    elif case == "per_channel":
        kw |= {"lam": np.full((2, 3), 0.01, np.float32) * [[1, 2, 3], [3, 2, 1]]}
    elif case == "x_bounds":
        kw |= {"x_bounds": (0.25, 0.55)}
    elif case == "denoise":
        psf = None
    elif case == "hw":
        y = np.ascontiguousarray(y[0, :, :, 0])
    elif case == "hwc":
        y = np.ascontiguousarray(y[0])
    _hold_short(y, psf, **kw)
    if case == "x_bounds":
        x, _ = _port(y, psf, **kw)
        assert x.min() >= 0.25 and x.max() <= 0.55


def test_anderson_callable_prox_takes_the_plain_step(scene):
    _, y, psf = scene
    soft = lambda vx, vy, tau: (torch.sign(vx) * torch.clamp(vx.abs() - tau, min=0),  # noqa: E731
                                torch.sign(vy) * torch.clamp(vy.abs() - tau, min=0))
    x, _ = _port(y, psf, iters=9, m=3, prox=soft, aa_interval=4, **KW)
    want, _ = _port(y, psf, iters=9, m=3, prox="aniso", aa_interval=4, prox_impl="xla", **KW)
    np.testing.assert_allclose(x, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("iters,aa_interval", [(60, 1), (120, 1), (121, 8)])
def test_anderson_long_run_holds_the_contract(scene, iters, aa_interval):
    """Residual and PSNR of a long accelerated run, and the point of the
    solver: a lower primal residual than plain ADMM at equal iterations."""
    clean, y, psf = scene
    kw = {"iters": iters, "m": 5, "aa_interval": aa_interval, **KW}
    x, d = _port(y, psf, **kw)
    xj, dj = _jax(y, psf, **kw)
    r, rj = float(d.r_norm.max()), float(np.asarray(dj.r_norm).max())
    assert abs(r - rj) <= 0.1 * rj, (r, rj)
    assert abs(_psnr(x, clean) - _psnr(xj, clean)) <= 0.1
    _, d_plain = tv_deconvolve(torch.from_numpy(y), torch.from_numpy(psf), iters=iters,
                               return_diagnostics=True, **KW)
    assert r < float(d_plain.r_norm.max())


@pytest.mark.parametrize("aa_interval,prox_impl,eps", [
    (1, "xla", (1e-3, 1e-2)), (4, "pallas", (1e-3, 1e-2)), (1, "pallas", (1e-4, 1e-3)),
    (8, "pallas", (1e-4, 1e-3)),
])
def test_anderson_early_stop_matches_jax(scene, aa_interval, prox_impl, eps):
    clean, y, psf = scene
    kw = {"iters": 121, "m": 5, "early_stop": True, "aa_interval": aa_interval,
          "eps_abs": eps[0], "eps_rel": eps[1], "prox_impl": prox_impl, **KW}
    x, d = _port(y, psf, **kw)
    xj, dj = _jax(y, psf, **kw)
    its = int(d.iterations)
    assert its == int(dj.iterations) < 121, (its, int(dj.iterations))
    assert (its - 1) % aa_interval == 0
    r, rj = float(d.r_norm.max()), float(np.asarray(dj.r_norm).max())
    assert abs(r - rj) <= 0.1 * rj, (r, rj)
    assert abs(_psnr(x, clean) - _psnr(xj, clean)) <= 0.05


def test_anderson_images_stay_independent(scene):
    """Per-image mixing and safeguard: a batch solves each image as alone."""
    _, y, psf = scene
    kw = {"iters": 25, "m": 3, **KW}
    xb, db = _port(y, psf, **kw)
    for i in range(2):
        xi, di = _port(np.ascontiguousarray(y[i:i + 1]), psf, **kw)
        np.testing.assert_allclose(xb[i:i + 1], xi, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(db.r_norm.numpy()[3 * i:3 * i + 3], di.r_norm.numpy(),
                                   rtol=1e-3)


@pytest.mark.parametrize("shape", [(64, 48), (64, 48, 3), (4, 64, 48, 3), (4, 1080, 1920, 3)])
@pytest.mark.parametrize("m", [1, 5])
def test_history_bytes_equal_jax(shape, m):
    assert anderson_history_bytes(shape, m) == jax_history_bytes(shape, m)
    assert anderson_history_bytes(shape, m, itemsize=2) == jax_history_bytes(shape, m, itemsize=2)


def test_history_bytes_is_what_the_mixer_allocates():
    from admm_deconv_tpu_torch.ops.solver import _AndersonMixer

    shape, m = (2, 8, 12, 3), 3
    n, d = 6, 4 * 8 * 12
    mixer = _AndersonMixer(n, d, m, 1e-10, 1e6, torch.float32, torch.device("cpu"), chunks=8)
    held = sum(a.numel() * a.element_size()
               for a in (mixer.dSF, mixer.dF, mixer.t_prev, mixer.f_prev))
    assert held == anderson_history_bytes(shape, m)


@pytest.mark.parametrize("chunks", [1, 8, 32])
def test_probe_contraction_split_equals_the_whole(chunks):
    """The mixer's probe contraction split over chunks of D (what keeps
    cuBLAS off one thread block an image) is the einsum it replaces, summed
    in another order: ``rtol=1e-5`` of the largest entry."""
    from admm_deconv_tpu_torch.ops.solver import _AndersonMixer

    n, m, d = 3, 4, 4 * 8 * 12
    gen = torch.Generator().manual_seed(0)
    mixer = _AndersonMixer(n, d, m, 1e-10, 1e6, torch.float32, torch.device("cpu"), chunks=chunks)
    mixer.dF.copy_(torch.randn((m, n, d), generator=gen))
    probe = torch.randn((2, n, d), generator=gen)
    want = torch.einsum("knd,jnd->nkj", mixer.dF, probe)
    got = mixer._probe_ring(probe)
    assert got.shape == (n, m, 2)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_auto_window_matches_jax(scene):
    _, y, psf = scene
    for shape in [(1, 64, 64, 1), (64, 2160, 3840, 3), (16, 2160, 3840, 3), (2160, 3840)]:
        assert _resolve_anderson_m("auto", shape) == jax_resolve_m("auto", shape)
    assert _resolve_anderson_m("auto", (64, 2160, 3840, 3)) < 5
    assert _resolve_anderson_m(3, (1, 64, 64, 1)) == jax_resolve_m(3, (1, 64, 64, 1)) == 3
    x_auto, _ = _port(y, psf, iters=9, m="auto", **KW)
    x_m5, _ = _port(y, psf, iters=9, m=5, **KW)
    np.testing.assert_array_equal(x_auto, x_m5)
    xj, _ = _jax(y, psf, iters=9, m="auto", **KW)
    np.testing.assert_allclose(x_auto, xj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw,err", [
    ({"m": 0}, "Anderson window m must be >= 1, got 0"),
    ({"iters": 1}, "tv_deconvolve_anderson needs iters >= 2"),
    ({"iters": 100, "aa_interval": 4},
     "aa_interval \\(4\\) must be >= 1 and divide iters - 1 \\(99\\)"),
    ({"aa_interval": 0, "iters": 9}, "aa_interval \\(0\\) must be >= 1"),
    ({"fft_mode": "fft"}, "fft_mode must be"),
])
def test_anderson_rejects_as_jax(scene, kw, err):
    _, y, psf = scene
    with pytest.raises(ValueError, match=err):
        tv_deconvolve_anderson(torch.from_numpy(y), torch.from_numpy(psf), **kw)
    with pytest.raises(ValueError, match=err):
        jax_anderson(jnp.asarray(y), jnp.asarray(psf), **kw)


def test_anderson_refuses_a_gradient(scene):
    _, y, psf = scene
    lam = torch.tensor(0.01, requires_grad=True)
    with pytest.raises(ValueError, match="inference path and is not differentiable"):
        tv_deconvolve_anderson(torch.from_numpy(y), torch.from_numpy(psf), lam=lam, iters=5)
    with torch.no_grad():
        x, _ = tv_deconvolve_anderson(torch.from_numpy(y), torch.from_numpy(psf), lam=lam, iters=5)
    assert not x.requires_grad


@pytest.mark.parametrize("aa_interval,prox_impl,stencil,prox_dual", [
    (8, "pallas", 6, 2), (8, "xla", 0, 0), (1, "pallas", 0, 1), (2, "pallas", 0, 2),
    (3, "pallas", 1, 2),
])
def test_anderson_twin_calls_per_block(scene, monkeypatch, aa_interval, prox_impl, stencil,
                                       prox_dual):
    """What the card launches per outer step, counted on the plain twins a
    CPU tensor takes in the kernels' place: ``aa_interval - 2`` fused
    stencils and two prox-dual steps per block (one at ``aa_interval=1``);
    and no kernel is launched or built on the CPU."""
    _, y, psf = scene
    calls = {"stencil": 0, "prox_dual": 0}
    stencil_plain, prox_dual_plain = sk._stencil_plain, pk._prox_dual_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(sk, "_stencil_plain", count("stencil", stencil_plain))
    monkeypatch.setattr(pk, "_prox_dual_plain", count("prox_dual", prox_dual_plain))
    before = sk.fused_admm_stencil.launches, pk.fused_prox_dual.launches
    blocks_run = 3
    _port(y, psf, iters=blocks_run * aa_interval + 1, m=3, aa_interval=aa_interval,
          prox_impl=prox_impl, **KW)
    assert calls == {"stencil": blocks_run * stencil, "prox_dual": blocks_run * prox_dual}
    assert (sk.fused_admm_stencil.launches, pk.fused_prox_dual.launches) == before
    assert sk._kernel_fn.cache_info().currsize == 0
    assert pk._kernel_fn.cache_info().currsize == 0
