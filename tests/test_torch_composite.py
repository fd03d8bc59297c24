"""Parity of the PyTorch port's composite prior (TV + L1 + box) with the
JAX package, on the CPU: the fused composite stencil and both composite
solvers.

The same numpy inputs go through the JAX function (its Pallas kernel in
interpret mode) and through the port, whose wrapper takes the kernel's
plain twin for CPU tensors (the CUDA kernel is held against that twin on
the card by ``chip_smoke.py``).

Tolerances: the stencil's fp32 duals are bit-exact for aniso and hard and
within ``atol=rtol=1e-6`` for iso and gauss (torch's vectorised CPU
sqrt/exp may round one ulp away from XLA's); its fp32 ``q`` is within
``atol=rtol=1e-6`` in every mode, as XLA's CPU backend contracts
``q1 + ratio * (z2 - u2')`` into a fused multiply-add where the port (and
the CUDA kernel, built with ``--fmad=false``) rounds twice; bf16 outputs
are equal or one bf16 ulp apart.  Solves agree to ``atol=2e-5`` (pocketfft
and XLA's FFT round differently); iteration counts are equal and rho to
``rtol=1e-6``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu.ops.composite import composite_tv_deconvolve as jax_composite
from admm_deconv_tpu.ops.composite import (
    composite_tv_deconvolve_adaptive as jax_composite_adaptive,
)
from admm_deconv_tpu.ops.pallas.stencil_kernels import (
    fused_admm_stencil_composite as jax_stencil_composite,
)
from admm_deconv_tpu_torch import composite_tv_deconvolve, composite_tv_deconvolve_adaptive
from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
    _composite_plain,
    fused_admm_stencil_composite,
)

torch.set_num_threads(2)

EXACT_MODES = ("aniso", "hard")
ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _assert_bf16_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) - ulp))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("carry", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_bounds", [None, (0.0, 1.0)], ids=["nobox", "box"])
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "plane"])
def test_composite_stencil_matches_jax(rng, mode, carry, x_bounds, per_plane):
    shape = (3, 16, 40)
    x = (0.5 + 0.5 * rng.standard_normal(shape)).astype(np.float32)
    duals = [(0.3 * rng.standard_normal(shape)).astype(np.float32) for _ in range(3)]
    jd = [jnp.asarray(d).astype(carry) for d in duals]
    td = [_t(np.asarray(d.astype(jnp.float32))).to(getattr(torch, carry)) for d in jd]
    if per_plane:
        table = [rng.uniform(0.05, 0.3, (3,)).astype(np.float32) for _ in range(3)]
    else:
        table = [np.float32(0.2), np.float32(0.05), np.float32(0.6)]
    want = jax_stencil_composite(jnp.asarray(x), *jd, *map(jnp.asarray, table), x_bounds,
                                 mode, interpret=True)
    got = fused_admm_stencil_composite(_t(x), *td, *map(_t, table), x_bounds, mode)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == getattr(torch, carry) and tuple(g.shape) == shape
        if carry == "bfloat16":
            _assert_bf16_ulp(g, w)
        elif mode in EXACT_MODES and k > 0:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_composite_plain_is_the_solver_composition(rng):
    """The twin equals the plain body's steps: D, prox_dual_step, D^T, the
    identity split and the combined rhs."""
    from admm_deconv_tpu_torch.ops import prox
    from admm_deconv_tpu_torch.ops.diff import grad2d, grad2d_adjoint

    shape = (2, 9, 13)  # odd: the kernel has no row-block constraint
    x, ux, uy, u2 = (_t(rng.standard_normal(shape)) for _ in range(4))
    table = _t(rng.uniform(0.05, 0.3, (2, 3)))
    q, ux2, uy2, u22 = _composite_plain(x, ux, uy, u2, table, (0.0, 1.0), "iso")
    dxx, dxy = grad2d(x)
    zx, zy, uxr, uyr = prox.prox_dual_step(dxx, dxy, ux, uy, table[:, 0, None, None], prox.block)
    v = x + u2
    z2 = torch.clamp(torch.sign(v) * torch.clamp(v.abs() - table[:, 1, None, None], min=0), 0, 1)
    qr = grad2d_adjoint(zx - uxr, zy - uyr) + table[:, 2, None, None] * (z2 - (v - z2))
    for g, w in ((q, qr), (ux2, uxr), (uy2, uyr), (u22, v - z2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_composite_stencil_rejects(rng):
    x = _t(rng.standard_normal((2, 8, 8)))
    with pytest.raises(ValueError, match="unknown prox mode"):
        fused_admm_stencil_composite(x, x, x, x, 0.1, 0.1, 1.0, mode="l0")
    with pytest.raises(ValueError, match="dtypes differ"):
        fused_admm_stencil_composite(x, x, x, x.bfloat16(), 0.1, 0.1, 1.0)
    with pytest.raises(ValueError, match="not scalar or per-plane"):
        fused_admm_stencil_composite(x, x, x, x, 0.1, np.ones(3, np.float32), 1.0)
    with pytest.raises(ValueError, match=r"expected \(N, H, W\)"):
        fused_admm_stencil_composite(x[0], x[0], x[0], x[0], 0.1, 0.1, 1.0)


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


KW = {"lam_tv": 0.01, "lam_l1": 0.002, "rho1": 0.05, "rho2": 0.05}


def _jax(y, psf, fn=jax_composite, **kw):
    return fn(jnp.asarray(y), psf=jnp.asarray(psf), fft_mode="xla", **kw)


def _port(y, psf, fn=composite_tv_deconvolve, **kw):
    return fn(torch.from_numpy(y), psf=torch.from_numpy(psf), **kw)


CASES = {
    "box": {"x_bounds": (0.0, 1.0)},
    "nobox": {},
    "iso": {"x_bounds": (0.0, 1.0), "prox": "iso"},
    "per_image": {"x_bounds": (0.0, 1.0), "lam_tv": np.asarray([0.01, 0.02], np.float32),
                  "rho1": np.asarray([0.05, 0.1], np.float32)},
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("prox_impl", ["pallas", "xla"], ids=["fast", "plain"])
def test_composite_matches_jax(scene, case, prox_impl):
    _, y, psf = scene
    kw = {**KW, "iters": 30, "prox_impl": prox_impl, **CASES[case]}
    want = _jax(y, psf, **kw)
    got = _port(y, psf, **kw)
    assert got.shape == y.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if "x_bounds" in kw:
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_composite_fast_and_plain_paths_agree(scene):
    _, y, psf = scene
    kw = {**KW, "iters": 30, "x_bounds": (0.0, 1.0)}
    fast = _port(y, psf, prox_impl="pallas", **kw)
    plain = _port(y, psf, prox_impl="xla", **kw)
    np.testing.assert_allclose(fast.numpy(), plain.numpy(), atol=1e-5, rtol=0)


def test_composite_box_is_exact():
    """A scene that restores past the box: every output lies in it exactly,
    and the box is reached."""
    _, y, psf = blocks(2)
    y = 4.0 * y - 1.1  # the scene's levels 0.2 and 0.6 become -0.3 and 1.3
    for impl in ("pallas", "xla"):
        x = _port(y, psf, **{**KW, "iters": 30, "x_bounds": (0.0, 1.0), "prox_impl": impl})
        assert float(x.min()) == 0.0 and float(x.max()) == 1.0


def test_composite_odd_height_kernel_path_matches_jax_plain_body():
    """At H=37 JAX has no row block and runs its plain body; the port runs
    the fused stencil's q-carry loop.  The same iterates by induction,
    rounded at other points (the stencil forms q in one pass): 1e-4."""
    _, y, psf = blocks(1, shape=(1, 37, 48, 3))
    kw = {**KW, "iters": 30, "x_bounds": (0.0, 1.0), "prox_impl": "pallas"}
    np.testing.assert_allclose(_port(y, psf, **kw).numpy(), np.asarray(_jax(y, psf, **kw)),
                               atol=1e-4, rtol=0)


def test_composite_bf16_state_within_fp32_envelope(scene):
    _, y, psf = scene
    kw = {**KW, "iters": 30, "x_bounds": (0.0, 1.0), "prox_impl": "pallas"}
    j32 = np.asarray(_jax(y, psf, **kw))
    j16 = np.asarray(_jax(y, psf, state_dtype="bfloat16", **kw))
    got = _port(y, psf, state_dtype="bfloat16", **kw)
    assert got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    bound = 2 * np.abs(j16 - j32).max() + 1e-3
    assert np.abs(got.numpy() - j32).max() <= bound


def test_composite_cpu_never_launches(scene):
    _, y, psf = scene
    before = fused_admm_stencil_composite.launches
    _port(y, psf, **{**KW, "iters": 4})
    assert fused_admm_stencil_composite.launches == before


@pytest.mark.parametrize(
    "kw, err",
    [({"state_dtype": "bfloat16", "prox_impl": "xla"}, "fused composite fast path"),
     ({"state_dtype": "bfloat16", "prox": lambda vx, vy, t: (vx, vy)},
      "fused composite fast path"),
     ({"fft_mode": "fold2"}, "fft_mode must be")],
    ids=["xla_bf16", "callable_bf16", "fft"],
)
def test_composite_rejects(scene, kw, err):
    _, y, psf = scene
    with pytest.raises(ValueError, match=err):
        _port(y, psf, **{**KW, "iters": 4, **kw})


@pytest.mark.parametrize("case", ["box", "iso", "per_image"])
def test_composite_adaptive_matches_jax(scene, case):
    _, y, psf = scene
    kw = {**KW, "max_iters": 40, "eps_abs": 1e-3, "eps_rel": 1e-2, **CASES[case]}
    xj, dj = _jax(y, psf, fn=jax_composite_adaptive, **kw)
    xt, dt = _port(y, psf, fn=composite_tv_deconvolve_adaptive, **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL, rtol=0)
    assert int(dt.iterations) == int(dj.iterations) < kw["max_iters"]
    np.testing.assert_allclose(dt.rho.numpy(), np.asarray(dj.rho), rtol=1e-6, atol=0)
    np.testing.assert_allclose(dt.r_norm.numpy(), np.asarray(dj.r_norm), atol=1e-5)
    np.testing.assert_allclose(dt.s_norm.numpy(), np.asarray(dj.s_norm), atol=1e-5)


@pytest.mark.parametrize("fft_mode", ["fold1", "pack", "pack_precise"])
def test_composite_adaptive_rejects_jax_rejected_modes(scene, fft_mode):
    _, y, psf = scene
    with pytest.raises(ValueError, match=fft_mode.split("_")[0]):
        _port(y, psf, fn=composite_tv_deconvolve_adaptive, fft_mode=fft_mode, **KW)
