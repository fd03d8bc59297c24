"""Parity of the PyTorch port's tile-halo stencil (kernel Q2-4's plain twin)
and its tiled solvers on a one-rank mesh with the JAX package, on the CPU.

The kernel module: ``_halo_plain`` (what ``fused_admm_stencil_halo`` runs on
a CPU tensor) against JAX's ``fused_admm_stencil_halo`` in interpret mode,
with random halo rows; and the port's twin over 2 and 4 tiles, one-row
tiles included, against the port's circular twin on the whole (the CUDA
kernel is held to the twin on the card by ``chip_smoke.py``).

The solvers: ``tiled_tv_deconvolve``, ``tiled_composite_tv_deconvolve`` and
``tiled_tv_deconvolve_anderson`` on
``make_mesh({"tile": 1}, device_type="cpu")`` (a one-rank gloo group in this
process) against the JAX package's on ``make_mesh({"tile": 1})``, and
against the port's single-device solvers.  Several ranks:
``tests/test_torch_tiling_ranks.py``.

Tolerances: aniso and hard bit-exact; iso and gauss to ``atol=rtol=1e-6``
(torch's vectorised CPU ``sqrt`` and ``exp`` round an ulp away from XLA's,
and ``q`` is a difference of such terms; as ``tests/test_torch_stencil.py``);
bf16 outputs within one bf16 ulp; the port's twin over tiles equals the
port's circular twin bit for bit.  Solves:
x within ``rtol=1e-4, atol=1e-5`` (pocketfft and XLA's FFT round
differently), iteration counts equal, rho to ``rtol=1e-6``; bf16 state is
held to the fp32 envelope of JAX's bf16 solve, as in ``test_torch_solver.py``.
The Anderson solves are short or stop early (at most 17 iterations), where
the mixing solve's rounding has not grown yet (``test_torch_anderson.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu.ops.pallas.stencil_kernels import fused_admm_stencil_halo as jax_halo
from admm_deconv_tpu.ops.solver import ADMMState as JaxADMMState
from admm_deconv_tpu.parallel import make_mesh as jax_make_mesh
from admm_deconv_tpu.parallel import tiled_composite_tv_deconvolve as jax_composite
from admm_deconv_tpu.parallel import tiled_tv_deconvolve as jax_tiled
from admm_deconv_tpu.parallel import tiled_tv_deconvolve_anderson as jax_tiled_anderson
from admm_deconv_tpu_torch import (
    composite_tv_deconvolve,
    tv_deconvolve,
    tv_deconvolve_adaptive,
    tv_deconvolve_anderson,
)
from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk
from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES
from admm_deconv_tpu_torch.parallel import (
    distributed,
    make_mesh,
    tiled_composite_tv_deconvolve,
    tiled_tv_deconvolve,
    tiled_tv_deconvolve_anderson,
)
from admm_deconv_tpu_torch.utils.state_io import state_from_numpy, state_to_numpy
from _torch_tiling_worker import scene

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
ADAPTIVE = {"lam": 0.01, "rho": 0.05, "iters": 40, "eps_abs": 1e-3, "eps_rel": 1e-2,
            "adapt_rho": True, "early_stop": True}


# -- kernel Q2-4's plain twin ------------------------------------------------


def _halo_inputs(seed, shape, carry):
    """x, duals in the carry dtype, four random halo rows and a tau pair."""
    rng = np.random.default_rng(seed)
    n, _, w = shape
    x = rng.standard_normal(shape).astype(np.float32)
    u = [(0.5 * rng.standard_normal(shape)).astype(np.float32) for _ in range(2)]
    if carry == "bf16":  # the same bf16 values on both sides
        u = [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) for a in u]
    halos = [rng.standard_normal((n, 1, w)).astype(np.float32) for _ in range(2)]
    halos += [(0.5 * rng.standard_normal((n, 1, w))).astype(np.float32) for _ in range(2)]
    taus = {"scalar": np.asarray(0.3, np.float32), "plane": rng.uniform(0.1, 0.5, n).astype(np.float32)}
    return x, u, halos, taus


def _bf16_ulp_ok(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)
    return bool(np.all(np.abs(g - w) <= ulp))


@pytest.mark.parametrize("tau_kind", ["scalar", "plane"])
@pytest.mark.parametrize("carry", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_halo_plain_matches_jax(mode, carry, tau_kind):
    x, u, halos, taus = _halo_inputs(1, (2, 24, 128), carry)
    jdt = jnp.bfloat16 if carry == "bf16" else jnp.float32
    tdt = torch.bfloat16 if carry == "bf16" else torch.float32
    want = jax_halo(jnp.asarray(x), *(jnp.asarray(a).astype(jdt) for a in u),
                    *map(jnp.asarray, halos), jnp.asarray(taus[tau_kind]), mode=mode,
                    interpret=True)
    got = sk.fused_admm_stencil_halo(torch.from_numpy(x), *(torch.from_numpy(a).to(tdt) for a in u),
                                     *map(torch.from_numpy, halos), torch.from_numpy(taus[tau_kind]),
                                     mode=mode)
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == x.shape
        g32, w32 = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        if carry == "bf16":
            assert _bf16_ulp_ok(g32, w32)
        elif mode in ("aniso", "hard"):
            np.testing.assert_array_equal(g32, w32)
        else:
            np.testing.assert_allclose(g32, w32, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tiles", [((2, 24, 48), 2), ((2, 24, 48), 4), ((3, 4, 64), 4)])
def test_halo_tiles_equal_the_whole(shape, tiles, carry):
    """The twin over ``tiles`` H-tiles, each given its neighbours' rows,
    concatenated, equals the circular twin on the whole image bit for bit
    (the port's copy of the JAX ``TestHaloStencilKernel``); ``(3, 4, 64)``
    over 4 tiles is one row a tile."""
    g = torch.Generator().manual_seed(2)
    n, h, _ = shape
    x = torch.randn(shape, generator=g)
    ux, uy = ((0.5 * torch.randn(shape, generator=g)).to(carry) for _ in range(2))
    tau = 0.3 * torch.rand(n, generator=g)
    ht = h // tiles
    for mode in MODES:
        want = sk._stencil_plain(x, ux, uy, tau, mode)
        outs = []
        for t in range(tiles):
            rows = slice(t * ht, (t + 1) * ht)
            below = ((t + 1) * ht) % h
            outs.append(sk.fused_admm_stencil_halo(
                x[:, rows], ux[:, rows], uy[:, rows], x[:, (t * ht - 1) % h, None],
                x[:, below, None], ux[:, below, None].float(), uy[:, below, None].float(),
                tau, mode=mode))
        for k in range(3):
            assert torch.equal(torch.cat([o[k] for o in outs], dim=1), want[k]), (mode, k)


@pytest.mark.parametrize("case,err", [
    ("x_2d", "expected \\(N, H, W\\)"),
    ("halo_shape", "x_top must be \\(N, 1, W\\)"),
    ("halo_dtype", "ux_bot must be float32 or bfloat16"),
    ("dual_dtypes", "ux/uy dtypes differ"),
    ("tau_shape", "not scalar or per-plane"),
    ("mode", "unknown prox mode"),
])
def test_halo_wrapper_rejects(case, err):
    x = torch.zeros(2, 8, 16)
    row = torch.zeros(2, 1, 16)
    args = {"x": x, "ux": x, "uy": x, "x_top": row, "x_bot": row, "ux_bot": row,
            "uy_bot": row, "tau": 0.1, "mode": "aniso"}
    args |= {
        "x_2d": {"x": x[0]},
        "halo_shape": {"x_top": torch.zeros(2, 2, 16)},
        "halo_dtype": {"ux_bot": row.double()},
        "dual_dtypes": {"uy": x.bfloat16()},
        "tau_shape": {"tau": torch.ones(3)},
        "mode": {"mode": "nope"},
    }[case]
    with pytest.raises(ValueError, match=err):
        sk.fused_admm_stencil_halo(**args)


# -- the tiled solvers on a one-rank mesh ------------------------------------


@pytest.fixture(scope="module")
def meshes():
    """A one-rank gloo mesh, closed with this module: a process group left
    open would turn on data parallelism in a later module's ``Trainer``
    (``tests/test_torch_data_parallel.py`` on the same xdist worker)."""
    yield make_mesh({"tile": 1}, device_type="cpu"), jax_make_mesh({"tile": 1})
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def problem():
    s = scene(1)
    return s["y"], s["psf"]


def _port(y, psf, mesh, solver=tiled_tv_deconvolve, **kw):
    return solver(torch.from_numpy(y), psf=None if psf is None else torch.from_numpy(psf),
                  mesh=mesh, **kw)


def _jax(y, psf, mesh, solver=jax_tiled, **kw):
    return solver(jnp.asarray(y), psf=None if psf is None else jnp.asarray(psf), mesh=mesh,
                  fft_mode="xla", **kw)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("use_psf", [True, False])
@pytest.mark.parametrize("prox_impl", ["pallas", "xla"])
def test_tiled_matches_jax_and_single_device(problem, meshes, prox_impl, use_psf):
    """The fast path (``pallas``: q-carry through Q2-4's twin) and the plain
    path, with and without a PSF."""
    y, psf = problem
    psf = psf if use_psf else None
    kw = {"lam": 0.01, "rho": 0.1, "iters": 16, "prox_impl": prox_impl}
    got = _port(y, psf, meshes[0], **kw)
    assert got.shape == y.shape and got.device.type == "cpu"
    _close(got, _jax(y, psf, meshes[1], **kw))
    single = tv_deconvolve(torch.from_numpy(y), None if psf is None else torch.from_numpy(psf), **kw)
    _close(got, single.numpy())


@pytest.mark.parametrize("case", ["iso", "alpha", "x_bounds", "per_image", "per_channel"])
def test_tiled_options_match_jax(problem, meshes, case):
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1, "iters": 12, "prox_impl": "pallas"}
    kw |= {
        "iso": {"prox": "iso"},
        "alpha": {"alpha": 1.6},
        "x_bounds": {"x_bounds": (0.0, 1.0)},
        "per_image": {"lam": np.asarray([0.01, 0.03], np.float32),
                      "rho": np.asarray([0.1, 0.3], np.float32)},
        "per_channel": {"lam": np.full((2, 3), 0.01, np.float32) * [[1, 2, 3], [3, 2, 1]]},
    }[case]
    _close(_port(y, psf, meshes[0], **kw), _jax(y, psf, meshes[1], **kw))


@pytest.mark.parametrize("check_every,prox_impl", [(1, "pallas"), (4, "pallas"), (4, "xla")])
def test_tiled_adaptive_matches_jax(problem, meshes, check_every, prox_impl):
    """early_stop + adapt_rho in check blocks (with ``pallas`` and
    ``check_every > 1`` the mid-block iterations run Q2-4's twin): equal
    iteration counts and final rho, against JAX's tiled solver and the
    port's single-device adaptive solver."""
    y, psf = problem
    kw = {**ADAPTIVE, "check_every": check_every, "prox_impl": prox_impl}
    x, d = _port(y, psf, meshes[0], return_diagnostics=True, **kw)
    xj, dj = _jax(y, psf, meshes[1], return_diagnostics=True, **kw)
    assert int(d.iterations) == int(dj.iterations) < kw["iters"]
    np.testing.assert_allclose(d.rho.numpy(), np.asarray(dj.rho), rtol=1e-6)
    assert not np.allclose(d.rho.numpy(), kw["rho"])
    for a, b in ((d.r_norm, dj.r_norm), (d.s_norm, dj.s_norm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    _close(x, xj)
    single_kw = {k: v for k, v in kw.items() if k not in ("iters", "early_stop")}
    xs, ds = tv_deconvolve_adaptive(torch.from_numpy(y), torch.from_numpy(psf),
                                    max_iters=kw["iters"], **single_kw)
    assert int(ds.iterations) == int(d.iterations)
    torch.testing.assert_close(ds.rho, d.rho, rtol=1e-6, atol=0)
    _close(x, xs.numpy())


def test_tiled_diagnostics_and_state_match_jax(problem, meshes):
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1, "iters": 10}
    x, d, st = _port(y, psf, meshes[0], return_diagnostics=True, return_state=True, **kw)
    xj, dj, sj = _jax(y, psf, meshes[1], return_diagnostics=True, return_state=True, **kw)
    _close(x, xj)
    assert int(d.iterations) == int(dj.iterations) == 10
    for a, b in ((d.r_norm, dj.r_norm), (d.s_norm, dj.s_norm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    for field, a in state_to_numpy(st).items():
        assert a.shape == (6, 32, 48)
        np.testing.assert_allclose(a, np.asarray(getattr(sj, field)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prox_impl", ["pallas", "xla"])
def test_tiled_warm_start_across_packages(problem, meshes, prox_impl):
    """A JAX tiled state warm-starts the port, and the port's state the JAX
    package, through ``utils/state_io.py``."""
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.1}
    _, sj = _jax(y, psf, meshes[1], iters=7, return_state=True, **kw)
    st = state_from_numpy(sj, device="cpu")
    want = _jax(y, psf, meshes[1], iters=6, init_state=sj, prox_impl=prox_impl, **kw)
    _close(_port(y, psf, meshes[0], iters=6, init_state=st, prox_impl=prox_impl, **kw), want)
    _, sp = _port(y, psf, meshes[0], iters=7, return_state=True, **kw)
    back = JaxADMMState(**state_to_numpy(sp))
    want = _jax(y, psf, meshes[1], iters=6, init_state=back, prox_impl=prox_impl, **kw)
    _close(_port(y, psf, meshes[0], iters=6, init_state=sp, prox_impl=prox_impl, **kw), want)


@pytest.mark.parametrize("path", ["fast", "mid"])
def test_tiled_bf16_state_within_fp32_envelope(problem, meshes, path):
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.5, "iters": 24, "prox_impl": "pallas"}
    if path == "mid":
        kw |= {"adapt_rho": True, "early_stop": True, "check_every": 8, "eps_abs": 0.0,
               "eps_rel": 0.0}
    j32 = np.asarray(_jax(y, psf, meshes[1], **kw))
    j16 = np.asarray(_jax(y, psf, meshes[1], state_dtype="bfloat16", **kw))
    launches = sk.fused_admm_stencil_halo.launches
    got = _port(y, psf, meshes[0], state_dtype="bfloat16", **kw)
    assert got.dtype == torch.float32
    assert sk.fused_admm_stencil_halo.launches == launches  # CPU: the plain twin
    assert np.abs(got.numpy() - j32).max() <= 2 * np.abs(j16 - j32).max() + 1e-3


@pytest.mark.parametrize("prox_impl", ["pallas", "xla"])
def test_tiled_composite_matches_jax(problem, meshes, prox_impl):
    y, psf = problem
    kw = {"lam_tv": 0.01, "lam_l1": 0.002, "rho1": 0.05, "rho2": 0.05, "iters": 12,
          "x_bounds": (0.0, 1.0), "prox_impl": prox_impl}
    got = _port(y, psf, meshes[0], tiled_composite_tv_deconvolve, **kw)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    _close(got, _jax(y, psf, meshes[1], jax_composite, **kw))
    single = composite_tv_deconvolve(torch.from_numpy(y), torch.from_numpy(psf), **kw)
    _close(got, single.numpy())


@pytest.mark.parametrize("case", ["aa1_pallas", "aa1_xla", "aa4_pallas", "aa4_xla", "iso_bounds",
                                  "per_image", "denoise", "early_stop", "early_stop_aa4"])
def test_tiled_anderson_matches_jax_and_single_device(problem, meshes, case):
    """The tiled Anderson solver against JAX's tiled one and the port's
    single-device one: x, both residual norms, equal iteration counts."""
    y, psf = problem
    kw = {"lam": 0.01, "rho": 0.05, "iters": 9, "m": 3}
    kw |= {
        "aa1_pallas": {"prox_impl": "pallas"},
        "aa1_xla": {"prox_impl": "xla"},
        "aa4_pallas": {"aa_interval": 4, "prox_impl": "pallas"},
        "aa4_xla": {"aa_interval": 4, "prox_impl": "xla"},
        "iso_bounds": {"prox": "iso", "x_bounds": (0.25, 0.55), "aa_interval": 4},
        "per_image": {"lam": np.asarray([0.01, 0.03], np.float32),
                      "rho": np.asarray([0.05, 0.2], np.float32), "m": 5},
        "denoise": {},
        "early_stop": {"iters": 41, "m": 5, "early_stop": True, "eps_abs": 1e-3, "eps_rel": 1e-2},
        "early_stop_aa4": {"iters": 41, "m": 5, "early_stop": True, "eps_abs": 1e-3,
                           "eps_rel": 1e-2, "aa_interval": 4, "prox_impl": "pallas"},
    }[case]
    psf = None if case == "denoise" else psf
    x, d = _port(y, psf, meshes[0], tiled_tv_deconvolve_anderson, **kw)
    xj, dj = _jax(y, psf, meshes[1], jax_tiled_anderson, **kw)
    xs, ds = tv_deconvolve_anderson(torch.from_numpy(y),
                                    None if psf is None else torch.from_numpy(psf), **kw)
    assert x.shape == y.shape
    assert int(d.iterations) == int(dj.iterations) == int(ds.iterations)
    if kw.get("early_stop"):
        assert int(d.iterations) < kw["iters"]
    else:
        assert int(d.iterations) == kw["iters"]
    _close(x, xj)
    _close(x, xs.numpy())
    for field in ("r_norm", "s_norm", "rho"):
        got = getattr(d, field).numpy()
        assert got.shape == (6,)
        np.testing.assert_allclose(got, np.asarray(getattr(dj, field)), rtol=1e-3, err_msg=field)
        np.testing.assert_allclose(got, getattr(ds, field).numpy(), rtol=1e-3, err_msg=field)


@pytest.mark.parametrize("kw,err", [
    ({"mesh": None}, "tiled_tv_deconvolve_anderson requires a mesh"),
    ({"m": 0}, "Anderson window m must be >= 1, got 0"),
    ({"iters": 1}, "tiled_tv_deconvolve_anderson needs iters >= 2"),
    ({"iters": 10, "aa_interval": 4}, "aa_interval \\(4\\) must be >= 1 and divide iters - 1 \\(9\\)"),
    ({"fft_mode": "mxu"}, "tiled solver fft_mode must be xla/fold/fold1/fold_precise, got 'mxu'"),
])
def test_tiled_anderson_rejects_as_jax(problem, meshes, kw, err):
    y, _ = problem
    kw = dict(kw)
    port_mesh, jax_mesh = (None, None) if "mesh" in kw and kw.pop("mesh") is None else meshes
    with pytest.raises(ValueError, match=err):
        tiled_tv_deconvolve_anderson(torch.from_numpy(y), mesh=port_mesh, **kw)
    with pytest.raises(ValueError, match=err):
        jax_tiled_anderson(jnp.asarray(y), mesh=jax_mesh, **kw)
    with pytest.raises(ValueError, match="inference path and is not differentiable"):
        tiled_tv_deconvolve_anderson(torch.from_numpy(y).requires_grad_(), mesh=meshes[0], iters=3)


@pytest.mark.parametrize("case,err", [
    ("odd_w", "W=47 must be even"),
    ("no_mesh", "requires a mesh"),
    ("check_every_divides", "check_every \\(3\\) must be >= 1 and divide iters \\(10\\)"),
    ("check_every_above_iters", "check_every \\(8\\) must be >= 1 and divide iters \\(4\\)"),
    ("fold1_adapt", "tiled fft_mode='fold1' hoists x_B"),
    ("fft_mode", "tiled solver fft_mode must be xla/fold/fold1/fold_precise, got 'mxu'"),
    ("state_dtype", "state_dtype requires the fast q-carry path"),
])
def test_tiled_rejects_as_jax(problem, meshes, case, err):
    """Every validation error of the JAX tiled solver, with its text."""
    y, psf = problem
    kw = {"iters": 10}
    kw |= {
        "odd_w": {"y": y[:, :, :47]},
        "no_mesh": {"mesh": None},
        "check_every_divides": {"check_every": 3, "early_stop": True},
        "check_every_above_iters": {"iters": 4, "check_every": 8, "adapt_rho": True,
                                    "early_stop": True},
        "fold1_adapt": {"fft_mode": "fold1", "adapt_rho": True},
        "fft_mode": {"fft_mode": "mxu"},
        "state_dtype": {"state_dtype": "bfloat16", "return_diagnostics": True},
    }[case]
    yy = np.ascontiguousarray(kw.pop("y", y))
    port_mesh, jax_mesh = (None, None) if kw.pop("mesh", True) is None else meshes
    with pytest.raises(ValueError, match=err):
        tiled_tv_deconvolve(torch.from_numpy(yy), mesh=port_mesh, **kw)
    with pytest.raises(ValueError, match=err):
        jax_tiled(jnp.asarray(yy), mesh=jax_mesh, **kw)


def test_make_mesh_checks_the_world_and_the_device(monkeypatch, meshes):
    with pytest.raises(ValueError, match="mesh needs 2 devices, only 1 available"):
        make_mesh({"tile": 2}, device_type="cpu")
    with pytest.raises(ValueError, match="mesh needs 16 devices"):
        jax_make_mesh({"data": 16})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        make_mesh({"tile": 1})  # the card never falls back to gloo on the CPU


def test_numpy_input_goes_to_the_mesh_device(problem, meshes):
    y, psf = problem
    got = tiled_tv_deconvolve(y, psf=psf, lam=0.01, rho=0.1, iters=4, mesh=meshes[0])
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _close(got, _jax(y, psf, meshes[1], lam=0.01, rho=0.1, iters=4))


def test_cpu_tiled_solves_build_and_launch_no_kernel(problem, meshes):
    y, psf = problem
    before = sk.fused_admm_stencil_halo.launches
    _port(y, psf, meshes[0], lam=0.01, rho=0.1, iters=4)
    _port(y, psf, meshes[0], tiled_composite_tv_deconvolve, iters=4)
    _port(y, psf, meshes[0], tiled_tv_deconvolve_anderson, iters=9, aa_interval=4)
    assert sk.fused_admm_stencil_halo.launches == before
    assert sk._halo_kernel_fn.cache_info().currsize == 0


def test_distributed_helpers_on_one_rank(monkeypatch, meshes):
    assert not distributed.is_multi_host()
    assert distributed.local_batch_slice(8) == slice(0, 8)
    local = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(distributed.assemble_global_batch(local), local)
    monkeypatch.setattr(distributed, "_world", lambda: (2, 1))
    assert distributed.local_batch_slice(8) == slice(4, 8)
    with pytest.raises(ValueError, match="global batch 7 must divide process count 2"):
        distributed.local_batch_slice(7)


@pytest.mark.parametrize("solver", ["tiled_tv_deconvolve", "tiled_composite_tv_deconvolve"])
def test_tiled_solvers_refuse_a_gradient(problem, meshes, solver):
    """``jax.grad`` through the JAX package's tiled solvers raises; the
    port's refuse an input that asks for a gradient instead of returning a
    constant, and still solve it under ``no_grad`` or once detached."""
    y, psf = problem
    fn = {"tiled_tv_deconvolve": tiled_tv_deconvolve,
          "tiled_composite_tv_deconvolve": tiled_composite_tv_deconvolve}[solver]
    lam = {"lam": torch.tensor(0.05, requires_grad=True)} if solver == "tiled_tv_deconvolve" \
        else {"lam_tv": torch.tensor(0.05, requires_grad=True)}
    with pytest.raises(ValueError, match=f"{solver} is an inference path"):
        _port(y, psf, meshes[0], solver=fn, iters=4, **lam)
    with pytest.raises(ValueError, match="not differentiable"):
        fn(torch.from_numpy(y).requires_grad_(), psf=torch.from_numpy(psf), mesh=meshes[0],
           iters=4)
    with torch.no_grad():
        x = _port(y, psf, meshes[0], solver=fn, iters=4, **lam)
    x2 = _port(y, psf, meshes[0], solver=fn, iters=4, **{k: 0.05 for k in lam})
    assert not x2.requires_grad and torch.equal(x, x2)
    # numpy's float64 goes to the mesh's device as float32, as JAX makes it.
    x64 = fn(y.astype(np.float64), psf=psf, mesh=meshes[0], iters=4, **{k: 0.05 for k in lam})
    assert x64.dtype == torch.float32 and torch.equal(x64, x2)
