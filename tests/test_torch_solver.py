"""Parity of the PyTorch port's ``tv_deconvolve`` with the JAX package, on
the CPU.

The JAX reference is the fp32-exact ``fft_mode="xla", prox_impl="xla"``
solve.  The port's default path (``prox_impl="auto"``) runs the fused
stencil's plain version on CPU tensors.  Tolerances: fp32 solves agree to
``atol=2e-5`` (pocketfft and XLA's FFT round differently; over tens of
iterations that stays a few 1e-6).  bf16-state solves round the carry at
different points than JAX's, so they are held to the fp32 envelope:
``max|port_bf16 - jax_fp32| <= 2 * max|jax_bf16 - jax_fp32| + 1e-3``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from reference_twin import admm_tv_reference, circ_conv_centered

from admm_deconv_tpu.metrics.psnr import peak_snr as jax_peak_snr
from admm_deconv_tpu.ops.solver import ADMMState as JaxADMMState
from admm_deconv_tpu.ops.solver import tv_deconvolve as jax_tv
from admm_deconv_tpu_torch import ADMMState, peak_snr, tv_deconvolve
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
    fused_admm_stencil,
    fused_admm_stencil_mixed,
)
from admm_deconv_tpu_torch.ops.solver import _FFT_MODES
from admm_deconv_tpu_torch.utils.state_io import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

SHAPE = (2, 32, 64, 3)
ATOL = 2e-5


def _motion_psf(k):
    psf = np.zeros((k, k), np.float32)
    psf[k // 2, :] = 1.0 / k
    return psf


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    return rng.random(SHAPE).astype(np.float32), _motion_psf(5)


def _jax(y, psf, **kw):
    kw.setdefault("fft_mode", "xla")
    kw.setdefault("prox_impl", "xla")
    return jax_tv(jnp.asarray(y), psf=None if psf is None else jnp.asarray(psf), **kw)


def _port(y, psf, **kw):
    return tv_deconvolve(
        torch.from_numpy(y), psf=None if psf is None else torch.from_numpy(psf), **kw
    )


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


CASES = {
    "aniso": {},
    "iso": {"prox": "iso"},
    "hard": {"prox": "hard", "lam": 0.002},
    "gauss": {"prox": "gauss"},
    "per_image": {"lam": np.asarray([0.01, 0.02], np.float32),
                  "rho": np.asarray([0.1, 0.2], np.float32)},
    "per_channel": {"lam": np.asarray([[0.01, 0.02, 0.03], [0.015, 0.025, 0.005]],
                                      np.float32),
                    "rho": np.asarray([[0.1, 0.2, 0.3], [0.15, 0.25, 0.05]], np.float32)},
    "no_psf": {"psf": None, "lam": 0.05, "rho": 0.5},
    "x_bounds": {"x_bounds": (0.0, 1.0)},
    "alpha": {"alpha": 1.6},
    "iters1": {"iters": 1},
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("prox_impl", ["auto", "xla"])
def test_fp32_matches_jax(problem, case, prox_impl):
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1, "iters": 20, "psf": psf, **CASES[case]}
    psf = kw.pop("psf")
    want = _jax(y, psf, **kw)
    got = _port(y, psf, prox_impl=prox_impl, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("shape", [(32, 64), (32, 64, 3)], ids=["hw", "hwc"])
def test_input_ranks(problem, shape):
    y = problem[0][0, ..., 0] if len(shape) == 2 else problem[0][0]
    kw = {"lam": 0.01, "rho": 0.1, "iters": 5}
    got = _port(y, problem[1], **kw)
    assert tuple(got.shape) == shape
    _close(got, _jax(y, problem[1], **kw))


@pytest.mark.parametrize("fft_mode", _FFT_MODES)
def test_every_fft_mode_is_the_exact_transform(problem, fft_mode):
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1, "iters": 4}
    torch.testing.assert_close(
        _port(y, psf, fft_mode=fft_mode, **kw), _port(y, psf, fft_mode="auto", **kw),
        rtol=0, atol=0,
    )


@pytest.mark.parametrize("case", ["aniso", "iso", "alpha", "per_image"])
def test_diagnostics_and_state_match_jax(problem, case):
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1, "iters": 9, **CASES[case]}
    xj, dj, sj = _jax(y, psf, return_diagnostics=True, return_state=True, **kw)
    xt, dt, st = _port(y, psf, return_diagnostics=True, return_state=True, **kw)
    _close(xt, xj)
    _close(dt.r_norm, dj.r_norm, atol=1e-4)
    _close(dt.s_norm, dj.s_norm, atol=1e-4)
    _close(dt.rho, dj.rho, atol=0)
    assert int(dt.iterations) == int(dj.iterations) == 9
    for f in ADMMState._fields:
        _close(getattr(st, f), getattr(sj, f))
    # The reference-shaped loop and the q-carry loop give one answer.
    _close(_port(y, psf, **kw), xt.numpy(), atol=2e-6)


def test_state_dtype_bf16_within_fp32_envelope(problem):
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1, "iters": 20}
    j32 = np.asarray(_jax(y, psf, **kw))
    j16 = np.asarray(_jax(y, psf, prox_impl="pallas", state_dtype="bfloat16", **kw))
    before = fused_admm_stencil_mixed.launches
    got = _port(y, psf, state_dtype="bfloat16", **kw)
    assert got.dtype == torch.float32
    assert fused_admm_stencil_mixed.launches == before  # CPU: plain version
    bound = 2 * np.abs(j16 - j32).max() + 1e-3
    assert np.abs(got.numpy() - j32).max() <= bound


def test_blocks_scenario_psnr():
    """The 256^2 blocks scenario: 3 RGB images of 16-px tiles, 7x7 motion
    PSF, lam=0.0041, rho=0.021, 100 iterations."""
    rng = np.random.default_rng(1)
    tiles = rng.random((3, 16, 16, 3)) > 0.5
    clean = np.clip(0.2 + np.kron(tiles, np.ones((1, 16, 16, 1))) * 0.4, 0, 1).astype(
        np.float32
    )
    psf = _motion_psf(7)
    blurred = sum(
        psf[a, c] * np.roll(clean, (a - 3, c - 3), (1, 2))
        for a in range(7) for c in range(7)
    ).astype(np.float32)
    kw = {"lam": 0.0041, "rho": 0.021, "iters": 100}
    ref_j, ref_t = jnp.asarray(clean), torch.from_numpy(clean)

    def jax_db(**extra):
        return float(jax_peak_snr(jnp.clip(_jax(blurred, psf, **kw, **extra), 0, 1), ref_j))

    def port_db(**extra):
        return float(peak_snr(torch.clamp(_port(blurred, psf, **kw, **extra), 0, 1), ref_t))

    assert abs(float(peak_snr(torch.from_numpy(blurred), ref_t)) - 25.445) < 1e-3
    j32 = jax_db()
    assert abs(j32 - 54.9997) < 1e-3
    assert abs(port_db() - j32) < 1e-3
    j16 = jax_db(prox_impl="pallas", state_dtype="bfloat16")
    assert abs(port_db(state_dtype="bfloat16") - j16) < 0.1


@pytest.mark.parametrize("init_path", ["fast", "diagnostics"])
def test_warm_start_from_jax_state(problem, init_path):
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1}
    _, sj = _jax(y, psf, iters=7, return_state=True, **kw)
    st = state_from_numpy(sj, device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in st)
    diag = init_path == "diagnostics"
    want = _jax(y, psf, iters=6, init_state=sj, return_diagnostics=diag, **kw)
    got = _port(y, psf, iters=6, init_state=st, return_diagnostics=diag, **kw)
    if diag:
        want, got = want[0], got[0]
    _close(got, want)


def test_state_round_trip_to_jax(problem, tmp_path):
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1}
    _, st = _port(y, psf, iters=5, return_state=True, **kw)
    arrays = state_to_numpy(st)
    assert set(arrays) == set(ADMMState._fields)
    np.savez(tmp_path / "state.npz", **arrays)
    with np.load(tmp_path / "state.npz") as loaded:
        back = state_from_numpy(loaded, device="cpu")
    for a, b in zip(back, st):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = _jax(y, psf, iters=4, init_state=JaxADMMState(**arrays), **kw)
    _close(_port(y, psf, iters=4, init_state=back, **kw), want)


def test_gradients_match_jax(problem):
    """Autograd through the plain CPU path (fused stencil's twin and the
    composition) against jax.grad of the JAX solve."""
    y, psf = problem
    y = y[:1, :16, :32]
    lam = np.asarray([0.02], np.float32)

    def jloss(yy, ll):
        return jnp.sum(
            jax_tv(yy, psf=jnp.asarray(psf), lam=ll, rho=0.1, iters=6,
                   fft_mode="xla", prox_impl="xla") ** 2
        )

    gy_j, gl_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y), jnp.asarray(lam))
    for prox_impl, remat in (("auto", False), ("xla", False), ("auto", True)):
        yy = torch.from_numpy(y.copy()).requires_grad_()
        ll = torch.from_numpy(lam.copy()).requires_grad_()
        out = tv_deconvolve(yy, psf=torch.from_numpy(psf), lam=ll, rho=0.1, iters=6,
                            prox_impl=prox_impl, remat=remat)
        (out**2).sum().backward()
        np.testing.assert_allclose(yy.grad.numpy(), np.asarray(gy_j), atol=1e-4, rtol=2e-4)
        np.testing.assert_allclose(ll.grad.numpy(), np.asarray(gl_j), atol=1e-4, rtol=2e-4)


def test_cpu_solve_never_launches_kernels(problem):
    y, psf = problem
    counts = fused_admm_stencil.launches, fused_admm_stencil_mixed.launches
    _port(y, psf, lam=0.01, rho=0.1, iters=3)
    assert (fused_admm_stencil.launches, fused_admm_stencil_mixed.launches) == counts


@pytest.mark.parametrize(
    "kw, err",
    [
        ({"state_dtype": "bfloat16", "return_diagnostics": True}, "fast q-carry path"),
        ({"state_dtype": "bfloat16", "return_state": True}, "fast q-carry path"),
        ({"state_dtype": "bfloat16", "iters": 0}, "fast q-carry path"),
        ({"state_dtype": "bfloat16", "prox_impl": "xla"}, "kernel path"),
        ({"state_dtype": "bfloat16", "alpha": 1.5}, "kernel path"),
        ({"state_dtype": "bfloat16", "prox": lambda vx, vy, t: (vx, vy)}, "kernel path"),
        ({"state_dtype": "float8"}, "unknown state_dtype"),
        ({"fft_mode": "fold2"}, "fft_mode must be"),
        ({"prox_impl": "cuda"}, "prox_impl must be"),
        ({"lam": np.ones(3, np.float32)}, "not broadcastable"),
        ({"return_diagnostics": True, "iters": 0}, "iters >= 1"),
    ],
    ids=["diag", "state", "iters0", "xla", "alpha", "callable", "dtype", "fft",
         "impl", "lam_shape", "diag_iters0"],
)
def test_rejects(problem, kw, err):
    y, psf = problem
    with pytest.raises(ValueError, match=err):
        _port(y, psf, **{"iters": 3, **kw})


@pytest.mark.parametrize("prox", ["aniso", "iso", "denoise"])
def test_matches_numpy_reference_twin(prox):
    """The independent numpy oracle of the reference algorithm, at the JAX
    package's own tolerances for it (``tests/test_solver.py``)."""
    rng = np.random.default_rng(3)
    img = np.kron(rng.random((4, 4)) > 0.5, np.ones((8, 8))) * 0.6 + 0.2
    if prox == "denoise":
        y, psf, kw = img + 0.1 * rng.standard_normal(img.shape), None, {
            "lam": 0.1, "rho": 1.0, "iters": 15}
    else:
        psf = _motion_psf(5).astype(np.float64)
        y, kw = circ_conv_centered(img, psf), {"lam": 0.01, "rho": 0.05, "iters": 20}
    want = admm_tv_reference(y, psf, isotropic=prox == "iso", **kw)
    got = tv_deconvolve(
        torch.from_numpy(y.astype(np.float32)),
        psf=None if psf is None else torch.from_numpy(psf.astype(np.float32)),
        prox="iso" if prox == "iso" else "aniso", **kw,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)


def test_photo_fixtures_match_jax():
    """The reference E2E scenario on the three committed photographs
    (``tests/fixtures/``): the port's restoration equals JAX's and gains
    at least 1.5 dB on each photo."""
    from PIL import Image

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    ref = np.stack([
        np.asarray(Image.open(os.path.join(fixtures, f"{n}.png")), np.float32) / 255.0
        for n in ("china", "flower", "hopper")
    ])
    psf = _motion_psf(7)
    blurred = sum(
        psf[3, c] * np.roll(ref, c - 3, axis=2) for c in range(7)
    ).astype(np.float32)
    kw = {"lam": 0.0041, "rho": 0.021, "iters": 100}
    got = _port(blurred, psf, **kw)
    _close(got, _jax(blurred, psf, **kw))
    x = torch.clamp(got, 0, 1)
    for i in range(3):
        gain = float(peak_snr(x[i:i + 1], torch.from_numpy(ref[i:i + 1]))) - float(
            peak_snr(torch.from_numpy(blurred[i:i + 1]), torch.from_numpy(ref[i:i + 1])))
        assert gain >= 1.5, (i, gain)


def test_callable_prox_matches_named(problem):
    from admm_deconv_tpu_torch.ops.prox import soft

    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1, "iters": 5}
    torch.testing.assert_close(
        _port(y, psf, prox=lambda vx, vy, t: soft(vx, vy, t), **kw),
        _port(y, psf, prox="soft", **kw), rtol=0, atol=0,
    )


def _entry_points():
    import admm_deconv_tpu_torch as adt

    return {
        "tv_deconvolve": lambda y, p: adt.tv_deconvolve(y, psf=p, lam=0.01, rho=0.1, iters=3),
        "adaptive": lambda y, p: adt.tv_deconvolve_adaptive(y, psf=p, lam=0.01, rho=0.1,
                                                            max_iters=4, check_every=2)[0],
        "solve_auto": lambda y, p: adt.solve_auto(y, psf=p, lam=0.01, rho=0.1, iters=4)[0],
        "composite": lambda y, p: adt.composite_tv_deconvolve(y, psf=p, iters=3),
        "composite_adaptive": lambda y, p: adt.composite_tv_deconvolve_adaptive(
            y, psf=p, max_iters=3)[0],
    }


ENTRY_POINTS = ["tv_deconvolve", "adaptive", "solve_auto", "composite", "composite_adaptive"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_cpu_tensor_stays_on_the_cpu(problem, entry):
    y, psf = problem
    out = _entry_points()[entry](torch.from_numpy(y), psf)  # a numpy PSF follows y
    assert out.device.type == "cpu" and out.shape == y.shape


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_numpy_input_goes_to_the_card(problem, entry, monkeypatch):
    """A numpy ``y`` goes to the card, as JAX puts it on its default device:
    with no CUDA device the call raises instead of solving on the CPU."""
    y, psf = problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="goes to the CUDA device"):
        _entry_points()[entry](y, psf)


def test_state_from_numpy_defaults_to_the_card(problem):
    y, psf = problem
    _, sj = _jax(y, psf, lam=0.01, rho=0.1, iters=2, return_state=True)
    # CPU-only torch: building a CUDA tensor fails, so the default is the card.
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        state_from_numpy(sj)
    assert all(t.device.type == "cpu" for t in state_from_numpy(sj, device="cpu"))


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_float64_numpy_input_solves_to_float32(problem, entry, monkeypatch):
    """numpy's default float64 goes to the card as float32, as JAX (x64 off)
    makes it: with the card's place taken by the CPU, every entry point
    returns float32."""
    from admm_deconv_tpu_torch.utils import arrays

    y, psf = problem
    y64 = y.astype(np.float64)
    assert arrays.as_tensor(y64, device="cpu").dtype == torch.float32
    assert arrays.as_tensor(y64.astype(np.float16), device="cpu").dtype == torch.float32
    assert arrays.as_tensor((y * 255).astype(np.uint8), device="cpu").dtype == torch.uint8
    monkeypatch.setattr(arrays, "default_device", lambda: torch.device("cpu"))
    out = _entry_points()[entry](y64, psf)
    assert out.dtype == torch.float32 and out.device.type == "cpu" and out.shape == y.shape
    torch.testing.assert_close(out, _entry_points()[entry](torch.from_numpy(y), psf),
                               rtol=0, atol=1e-6)
