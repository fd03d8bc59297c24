"""The PyTorch port's tiled solvers across real ranks, against the JAX package.

Each mesh spawns one process per rank (``tests/_torch_tiling_worker.py``,
gloo collectives on the CPU, torch and the port only); the processes run
every case of the worker's ``cases()`` and write their results.  The parent
runs the same cases through the JAX package's tiled solvers on the same
mesh shape of its 8 virtual CPU devices (``tests/conftest.py``).

Tolerances: x within ``rtol=1e-4, atol=1e-5`` (pocketfft and XLA's FFT
round differently; the paths are the same), diagnostics' norms within
``atol=1e-5`` (sums over a plane and over the tiles taken in another
order), iteration counts equal and rho to ``rtol=1e-6`` (products of exact
powers of 2 on the same path; the scene stops well clear of every
threshold).  The Anderson cases (short, or stopping by iteration 17):
iteration counts equal, the residual norms to ``rtol=1e-3``.  bf16 state
rounds the carry at other points than JAX's and is held to the fp32 envelope, ``2 max|x_jax16 - x_jax32| + 1e-3`` from JAX's
fp32 solve.  Every rank returns the same bits.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_tiling_worker as worker
from admm_deconv_tpu.parallel import make_mesh
from admm_deconv_tpu.parallel import tiled_composite_tv_deconvolve as jax_composite
from admm_deconv_tpu.parallel import tiled_tv_deconvolve as jax_tiled
from admm_deconv_tpu.parallel import tiled_tv_deconvolve_anderson as jax_anderson

REPO = os.path.join(os.path.dirname(__file__), "..")
WORLD = {name: int(np.prod(list(axes.values()))) for name, axes in worker.MESHES.items()}
SPAWN_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mesh_name, outdir):
    """Run one worker per rank; every rank's results, in rank order."""
    world, port = WORLD[mesh_name], _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ""}
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_torch_tiling_worker.py"),
             str(r), str(world), str(port), mesh_name, str(outdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:  # a hung collective fails the test instead of stalling it
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(world)]


def _jax_results(mesh_name):
    axes = worker.MESHES[mesh_name]
    mesh = make_mesh(axes)
    data_kw = {"data_axis_name": "data"} if "data" in axes else {}
    inputs = {k: jnp.asarray(v) for k, v in worker.scene(axes["tile"]).items()}
    solvers = {"tiled": jax_tiled, "composite": jax_composite, "anderson": jax_anderson}

    def run(solver, inp, kw):
        res = solvers[solver](inputs[inp], psf=None if inp == "rows" else inputs["psf"],
                              mesh=mesh, fft_mode="xla", **data_kw, **kw)
        return res if isinstance(res, tuple) else (res, None)

    out = {}
    for name, solver, inp, kw in worker.cases():
        x, diag = run(solver, inp, kw)
        out[f"{name}.x"] = np.asarray(x)
        if diag is not None:
            for field in ("r_norm", "s_norm", "iterations", "rho"):
                out[f"{name}.{field}"] = np.asarray(getattr(diag, field))
        if "state_dtype" in kw:  # the fp32 solve gives the envelope
            fp32 = {k: v for k, v in kw.items() if k != "state_dtype"}
            out[f"{name}.x32"] = np.asarray(run(solver, inp, fp32)[0])
    return out


@pytest.mark.parametrize("mesh_name", list(worker.MESHES))
def test_tiled_solvers_across_ranks_match_jax(mesh_name, tmp_path):
    ranks = _spawn(mesh_name, tmp_path)
    for r, res in enumerate(ranks[1:], start=1):
        assert res.keys() == ranks[0].keys()
        for k, v in res.items():
            np.testing.assert_array_equal(v, ranks[0][k], err_msg=f"rank {r} {k}")
    got, want = ranks[0], _jax_results(mesh_name)
    for name, solver, _, kw in worker.cases():
        x, xj = got[f"{name}.x"], want[f"{name}.x"]
        assert x.shape == xj.shape, name
        if kw.get("state_dtype"):
            x32 = want[f"{name}.x32"]
            bound = 2 * np.abs(xj - x32).max() + 1e-3
            assert np.abs(x - x32).max() <= bound, name
        else:
            np.testing.assert_allclose(x, xj, rtol=1e-4, atol=1e-5, err_msg=name)
        if solver == "anderson":
            # The Gram row, rhs and residual are sums over the tiles taken in
            # another order than JAX's psum; the runs are short or stop early.
            assert int(got[f"{name}.iterations"]) == int(want[f"{name}.iterations"]), name
            for field in ("r_norm", "s_norm", "rho"):
                np.testing.assert_allclose(got[f"{name}.{field}"], want[f"{name}.{field}"],
                                           rtol=1e-3, err_msg=f"{name} {field}")
        elif kw.get("return_diagnostics"):
            assert int(got[f"{name}.iterations"]) == int(want[f"{name}.iterations"]), name
            np.testing.assert_allclose(got[f"{name}.rho"], want[f"{name}.rho"], rtol=1e-6,
                                       err_msg=name)
            if not kw.get("state_dtype"):
                for field in ("r_norm", "s_norm"):
                    np.testing.assert_allclose(got[f"{name}.{field}"], want[f"{name}.{field}"],
                                               atol=1e-5, rtol=0, err_msg=f"{name} {field}")
    assert int(got["adaptive_check4.iterations"]) < 40  # the scene stops early
    assert not np.allclose(got["adaptive_check4.rho"], 0.05)  # and adapts rho
    for name in ("anderson_stop", "anderson_stop_aa4"):  # Anderson stops early too
        assert int(got[f"{name}.iterations"]) < 41
    composite = got["composite.x"]
    assert composite.min() >= 0.0 and composite.max() <= 1.0
