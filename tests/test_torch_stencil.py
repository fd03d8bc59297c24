"""Parity of the PyTorch port's primitives and fused stencil with the JAX
package, on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode) and through the port, whose wrappers take the kernel's
plain-torch version for CPU tensors.  The CUDA kernel itself is held
against that plain version on the card by ``chip_smoke.py``.

Tolerances: aniso and hard are bit-exact.  iso and gauss go through sqrt
and exp, where torch's vectorised CPU functions may round one ulp away
from XLA's, so fp32 outputs agree to ``atol=rtol=1e-6``.  bf16 outputs are
equal or one bf16 ulp apart (an fp32 ulp can flip the final rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu.metrics.psnr import peak_snr as jax_peak_snr
from admm_deconv_tpu.ops import diff as jax_diff
from admm_deconv_tpu.ops import fft as jax_fft
from admm_deconv_tpu.ops import prox as jax_prox
from admm_deconv_tpu.ops.pallas.stencil_kernels import (
    fused_admm_stencil as jax_stencil,
    fused_admm_stencil_mixed as jax_stencil_mixed,
)
from admm_deconv_tpu_torch.metrics import peak_snr
from admm_deconv_tpu_torch.ops import diff, fft, prox
from admm_deconv_tpu_torch.ops.kernels import _build
from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES, prox_apply
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
    _stencil_plain,
    fused_admm_stencil,
    fused_admm_stencil_mixed,
)

torch.set_num_threads(2)

SHAPES = [(2, 24, 128), (3, 40, 96)]
EXACT_MODES = ("aniso", "hard")


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _bf16_pair(rng, shape):
    """The same bf16 values as a JAX and a torch array."""
    a = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _tau(rng, n, per_plane):
    return rng.uniform(0.1, 0.5, (n,)).astype(np.float32) if per_plane else np.float32(0.3)


def _assert_fp32(got, want, mode):
    got, want = got.detach().numpy(), np.asarray(want)
    if mode in EXACT_MODES:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _assert_bf16_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) - ulp))


def _fp32_pair(x, ux, uy, tau, mode):
    """JAX's interpreted kernel and the port's stencil on the same inputs."""
    want = jax_stencil(
        jnp.asarray(x), jnp.asarray(ux), jnp.asarray(uy), jnp.asarray(tau),
        mode=mode, interpret=True,
    )
    return want, fused_admm_stencil(_t(x), _t(ux), _t(uy), _t(tau), mode=mode)


def _which_side_moved(x, ux, uy, tau, mode, want, got):
    """For a failed comparison: both sides evaluated again, and each against
    the plain stencil in float64, per output, with the misses per plane."""
    want2, got2 = _fp32_pair(x, ux, uy, tau, mode)
    f64 = [torch.from_numpy(np.asarray(a, dtype=np.float64)) for a in (x, ux, uy, tau)]
    ref = _stencil_plain(*f64, mode)
    lines = []
    for k in range(3):
        w, w2 = np.asarray(want[k]), np.asarray(want2[k])
        g, g2, r = got[k].numpy(), got2[k].numpy(), ref[k].numpy()
        miss = ~np.isclose(g, w, atol=1e-6, rtol=1e-6)
        lines.append(
            f"output {k}: {int(miss.sum())} of {miss.size} off, per plane "
            f"{miss.reshape(miss.shape[0], -1).sum(axis=1).tolist()}; evaluated again, JAX "
            f"moved {np.abs(w2 - w).max():.3e} and the port {np.abs(g2 - g).max():.3e}; "
            f"against float64, JAX {np.abs(w - r).max():.3e} and the port {np.abs(g - r).max():.3e}"
        )
    return "\n".join(lines)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x24x128", "3x40x96"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "vector"])
def test_stencil_fp32_matches_jax(rng, shape, mode, per_plane):
    x, ux, uy = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    tau = _tau(rng, shape[0], per_plane)
    want, got = _fp32_pair(x, ux, uy, tau, mode)
    for g in got:
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
    try:
        for g, w in zip(got, want):
            _assert_fp32(g, w, mode)
    except AssertionError as err:
        moved = _which_side_moved(x, ux, uy, tau, mode, want, got)
        raise AssertionError(f"{err}\n{moved}") from None


@pytest.mark.parametrize("repeat", range(10))
def test_stencil_flake_case_is_stable(rng, repeat):
    """``test_stencil_fp32_matches_jax[scalar-iso-2x24x128]``, which failed
    once in a full xdist run on a loaded host, evaluated twice on each side:
    each side repeats itself bit for bit, and the port stays within the
    case's tolerance of JAX.  Under xdist every repeat runs beside the other
    workers' load."""
    shape = SHAPES[0]
    x, ux, uy = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    tau = _tau(rng, shape[0], False)
    want, got = _fp32_pair(x, ux, uy, tau, "iso")
    want2, got2 = _fp32_pair(x, ux, uy, tau, "iso")
    report = _which_side_moved(x, ux, uy, tau, "iso", want, got)
    for g, g2, w, w2 in zip(got, got2, want, want2):
        assert torch.equal(g, g2), report
        np.testing.assert_array_equal(np.asarray(w), np.asarray(w2), err_msg=report)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6,
                                   err_msg=report)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x24x128", "3x40x96"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "vector"])
def test_stencil_bf16_matches_jax(rng, shape, mode, per_plane):
    x = rng.standard_normal(shape).astype(np.float32)
    jux, tux = _bf16_pair(rng, shape)
    juy, tuy = _bf16_pair(rng, shape)
    tau = _tau(rng, shape[0], per_plane)
    want = jax_stencil_mixed(
        jnp.asarray(x), jux, juy, jnp.asarray(tau),
        mode=mode, impl="blocked", interpret=True,
    )
    got = fused_admm_stencil_mixed(_t(x), tux, tuy, _t(tau), mode=mode)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == shape
        _assert_bf16_ulp(g, w)


@pytest.mark.parametrize("mode", MODES)
def test_stencil_matches_port_composition(rng, mode):
    """The fused stencil equals D -> prox_dual_step -> D^T of the port."""
    shape = (3, 17, 29)  # odd sizes: the kernel has no row-block constraint
    x, ux, uy = (_t(rng.standard_normal(shape)) for _ in range(3))
    tau = _t(rng.uniform(0.1, 0.5, (3,)))
    q, ux2, uy2 = fused_admm_stencil(x, ux, uy, tau, mode=mode)
    dxx, dxy = diff.grad2d(x)
    zx, zy, ux_r, uy_r = prox.prox_dual_step(
        dxx, dxy, ux, uy, tau[:, None, None], prox.resolve(mode)
    )
    q_r = diff.grad2d_adjoint(zx - ux_r, zy - uy_r)
    for g, w in ((q, q_r), (ux2, ux_r), (uy2, uy_r)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize(
    "call, err",
    [
        (lambda x, u: fused_admm_stencil(x[0], u, u, 0.3), "expected \\(N, H, W\\)"),
        (lambda x, u: fused_admm_stencil(x, u, u, 0.3, mode="tv"), "unknown prox mode"),
        (lambda x, u: fused_admm_stencil(x, u, u.to(torch.bfloat16), 0.3), "dtypes differ"),
        (lambda x, u: fused_admm_stencil(x, u, u, torch.ones(3)), "not scalar or per-plane"),
        (lambda x, u: fused_admm_stencil_mixed(x, u, u, 0.3, impl="tiled"), "impl must be"),
        (
            lambda x, u: fused_admm_stencil_mixed(
                x, u.to(torch.bfloat16), u, 0.3
            ),
            "dtypes differ",
        ),
        (lambda x, u: fused_admm_stencil(x, u[:, :4], u[:, :4], 0.3), "shapes differ"),
        (lambda x, u: fused_admm_stencil(x, u, u.to("meta"), 0.3), "devices differ"),
        (lambda x, u: fused_admm_stencil(x.to("meta"), u.to("meta"), u.to("meta"), 0.3),
         "no stencil kernel for device meta"),
    ],
    ids=["ndim", "mode", "dtype", "tau", "impl", "mixed_dtype", "shape", "devices",
         "device"],
)
def test_stencil_rejects(call, err):
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match=err):
        call(x, torch.zeros(2, 8, 16))


def test_stencil_tau_forms_agree(rng):
    """Scalar, (1,), (N,) and (N,1,1) tau give the same planes; CPU calls
    never count as kernel launches."""
    shape = (2, 8, 16)
    x, ux, uy = (_t(rng.standard_normal(shape)) for _ in range(3))
    before = fused_admm_stencil.launches
    ref = fused_admm_stencil(x, ux, uy, 0.25)
    for tau in (torch.tensor(0.25), torch.tensor([0.25]), torch.full((2,), 0.25),
                torch.full((2, 1, 1), 0.25)):
        for g, w in zip(fused_admm_stencil(x, ux, uy, tau), ref):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fused_admm_stencil.launches == before


def test_stencil_plain_is_differentiable(rng):
    shape = (2, 8, 16)
    x = _t(rng.standard_normal(shape)).requires_grad_()
    tau = torch.tensor(0.3, requires_grad=True)
    q, ux, uy = fused_admm_stencil(x, torch.zeros(shape), torch.zeros(shape), tau)
    (q.square().sum() + ux.sum() + uy.sum()).backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(tau.grad)


def test_grad2d_matches_jax(rng):
    x = rng.standard_normal((2, 9, 14)).astype(np.float32)
    zx, zy = (rng.standard_normal((2, 9, 14)).astype(np.float32) for _ in range(2))
    for g, w in zip(diff.grad2d(_t(x)), jax_diff.grad2d(jnp.asarray(x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        diff.grad2d_adjoint(_t(zx), _t(zy)).numpy(),
        np.asarray(jax_diff.grad2d_adjoint(jnp.asarray(zx), jnp.asarray(zy))),
    )


def test_grad2d_adjoint_identity(rng):
    """<D x, z> == <x, D^T z> in float64."""
    x, zx, zy = (torch.from_numpy(rng.standard_normal((3, 11, 7))) for _ in range(3))
    dxx, dxy = diff.grad2d(x)
    lhs = (dxx * zx).sum() + (dxy * zy).sum()
    rhs = (x * diff.grad2d_adjoint(zx, zy)).sum()
    assert abs(float(lhs - rhs)) < 1e-10


@pytest.mark.parametrize("name", sorted(prox.PROX_FNS))
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "vector"])
def test_prox_matches_jax(rng, name, per_plane):
    vx, vy = (rng.standard_normal((3, 10, 12)).astype(np.float32) for _ in range(2))
    tau = rng.uniform(0.1, 0.5, (3, 1, 1)).astype(np.float32) if per_plane else 0.3
    want = jax_prox.PROX_FNS[name](jnp.asarray(vx), jnp.asarray(vy), jnp.asarray(tau))
    got = prox.PROX_FNS[name](_t(vx), _t(vy), _t(tau))
    mode = {"soft": "aniso", "block": "iso"}.get(name, name)
    for g, w in zip(got, want):
        _assert_fp32(g, w, mode)
    for g, w in zip(prox_apply(mode, _t(vx), _t(vy), _t(tau)), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_prox_dual_step_matches_jax(rng):
    arrs = [rng.standard_normal((2, 8, 8)).astype(np.float32) for _ in range(4)]
    want = jax_prox.prox_dual_step(*map(jnp.asarray, arrs), 0.2, jax_prox.soft)
    got = prox.prox_dual_step(*map(_t, arrs), 0.2, prox.soft)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_prox_resolve():
    assert prox.resolve("iso") is prox.block
    assert prox.resolve(prox.hard) is prox.hard
    with pytest.raises(ValueError, match="Unknown prox"):
        prox.resolve("l0")
    with pytest.raises(ValueError, match="unknown prox mode"):
        prox_apply("soft", torch.zeros(1), torch.zeros(1), 0.1)


@pytest.mark.parametrize("psf_shape", [(7, 7), (5, 3), (4, 6), (1, 1)])
def test_psf_to_otf_matches_jax(rng, psf_shape):
    psf = rng.random(psf_shape).astype(np.float32)
    psf /= psf.sum()
    assert fft.psf_center(psf_shape) == jax_fft.psf_center(psf_shape)
    want = np.asarray(jax_fft.psf_to_otf(jnp.asarray(psf), (24, 30)))
    got = fft.psf_to_otf(_t(psf), (24, 30))
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-7)


def test_psf_to_otf_rejects_oversize():
    with pytest.raises(ValueError, match="larger than image"):
        fft.psf_to_otf(torch.ones(9, 3), (8, 8))


@pytest.mark.parametrize("hw", [(24, 30), (17, 33), (1080, 1920)])
def test_laplacian_spectrum_matches_jax(hw):
    got = fft.laplacian_spectrum(hw)
    want = np.asarray(jax_fft.laplacian_spectrum(hw))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_peak_snr_matches_jax(rng):
    x, y = (rng.random((3, 8, 8, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(peak_snr(_t(x), _t(y))), float(jax_peak_snr(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-6,
    )
    assert torch.isfinite(peak_snr(_t(x), _t(x)))


def test_build_fails_loudly_without_toolkit(tmp_path, monkeypatch):
    """A build with no CUDA toolkit raises; it never falls back."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    lib = _build.library_path("stencil_fwd")
    assert lib.parent == tmp_path and lib.name.startswith("libstencil_fwd-")
    with pytest.raises(RuntimeError, match="no CUDA toolkit"):
        _build.build("stencil_fwd")
    assert not lib.exists()
