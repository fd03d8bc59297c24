"""Worker of the multi-rank tiled-solver test (``tests/test_torch_tiling_ranks.py``).

One process per rank, gloo collectives between them on the CPU.  Each
process joins the group through ``parallel.distributed.initialize``, checks
the batch helpers, runs every case of :func:`cases` through the PyTorch
port's tiled solvers on the mesh named on the command line, and writes its
results to ``<outdir>/rank<r>.npz``.  Imports numpy, torch and the port,
never jax.

Usage: python tests/_torch_tiling_worker.py <rank> <world> <port> <mesh> <outdir>
"""

import os
import sys

import numpy as np

MESHES = {"tile2": {"tile": 2}, "tile4": {"tile": 4}, "data2_tile2": {"data": 2, "tile": 2}}


def scene(tile: int):
    """Seeded inputs: a blocks batch (2 x 32 x 48 x 3, 8-px tiles, 5x5
    motion blur, light noise), its PSF, and a batch whose tiles are one row
    high (2 x ``tile`` x 64 x 1)."""
    rng = np.random.default_rng(0)
    tiles = rng.random((2, 4, 6, 3)) > 0.5
    clean = np.clip(0.2 + np.kron(tiles, np.ones((1, 8, 8, 1))) * 0.4, 0, 1)
    psf = np.zeros((5, 5), np.float32)
    psf[2, :] = 0.2
    blurred = sum(psf[a, c] * np.roll(clean, (a - 2, c - 2), (1, 2))
                  for a in range(5) for c in range(5))
    y = (blurred + 0.01 * rng.standard_normal(blurred.shape)).astype(np.float32)
    rows = rng.random((2, tile, 64, 1)).astype(np.float32)
    return {"y": y, "psf": psf, "rows": rows}


def cases():
    """(name, solver, input, kwargs): the same calls go to the JAX package."""
    lam2 = np.asarray([0.01, 0.03], np.float32)
    rho2 = np.asarray([0.1, 0.3], np.float32)
    adaptive = {"lam": 0.01, "rho": 0.05, "iters": 40, "eps_abs": 1e-3, "eps_rel": 1e-2,
                "adapt_rho": True, "early_stop": True, "return_diagnostics": True}
    return [
        ("fast", "tiled", "y", {"lam": 0.01, "rho": 0.1, "iters": 16, "prox_impl": "pallas"}),
        ("plain_diag", "tiled", "y", {"lam": lam2, "rho": rho2, "iters": 12, "prox_impl": "xla",
                                      "return_diagnostics": True}),
        ("adaptive_check4", "tiled", "y", {**adaptive, "check_every": 4, "prox_impl": "pallas"}),
        ("adaptive_check1", "tiled", "y", {**adaptive, "check_every": 1, "prox_impl": "xla"}),
        ("bf16_fast", "tiled", "y", {"lam": 0.01, "rho": 0.1, "iters": 16, "prox_impl": "pallas",
                                     "state_dtype": "bfloat16"}),
        ("bf16_mid", "tiled", "y", {"lam": 0.01, "rho": 0.5, "iters": 24, "adapt_rho": True,
                                    "early_stop": True, "check_every": 8, "eps_abs": 0.0,
                                    "eps_rel": 0.0, "prox_impl": "pallas",
                                    "state_dtype": "bfloat16", "return_diagnostics": True}),
        ("composite", "composite", "y", {"lam_tv": 0.01, "lam_l1": 0.002, "rho1": 0.05,
                                         "rho2": 0.05, "iters": 12, "x_bounds": (0.0, 1.0),
                                         "prox_impl": "pallas"}),
        ("one_row", "tiled", "rows", {"lam": 0.02, "rho": 0.5, "iters": 5, "prox_impl": "pallas"}),
        ("anderson_aa1", "anderson", "y", {"lam": 0.01, "rho": 0.05, "iters": 9, "m": 3,
                                           "prox_impl": "pallas"}),
        ("anderson_aa4", "anderson", "y", {"lam": lam2, "rho": rho2, "iters": 13, "m": 5,
                                           "aa_interval": 4, "prox_impl": "pallas"}),
        ("anderson_stop", "anderson", "y", {"lam": 0.01, "rho": 0.05, "iters": 41, "m": 5,
                                            "early_stop": True, "eps_abs": 1e-3,
                                            "eps_rel": 1e-2}),
        ("anderson_stop_aa4", "anderson", "y", {"lam": 0.01, "rho": 0.05, "iters": 41, "m": 5,
                                                "early_stop": True, "eps_abs": 1e-3,
                                                "eps_rel": 1e-2, "aa_interval": 4,
                                                "prox_impl": "pallas"}),
        ("anderson_rows", "anderson", "rows", {"lam": 0.02, "rho": 0.5, "iters": 7, "m": 2,
                                               "aa_interval": 3, "prox_impl": "pallas"}),
    ]


def main() -> None:
    rank, world, port, mesh_name, outdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import torch

    torch.set_num_threads(1)
    from admm_deconv_tpu_torch.parallel import (
        distributed,
        make_mesh,
        replicate,
        shard_batch,
        tiled_composite_tv_deconvolve,
        tiled_tv_deconvolve,
        tiled_tv_deconvolve_anderson,
    )

    distributed.initialize(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    assert distributed.is_multi_host()
    sl = distributed.local_batch_slice(2 * world)
    assert sl == slice(2 * rank, 2 * rank + 2), sl
    full = torch.arange(2.0 * world)[:, None] * torch.ones(1, 3)
    assert torch.equal(distributed.assemble_global_batch(full[sl]), full)

    axes = MESHES[mesh_name]
    mesh = make_mesh(axes, device_type="cpu")
    t = axes["tile"]
    data_kw = {"data_axis_name": "data"} if "data" in axes else {}
    if "data" in axes:
        assert torch.equal(shard_batch(full, mesh, "data"),
                           full.chunk(axes["data"])[mesh.get_local_rank("data")])
    assert int(replicate(torch.tensor([float(rank)]), mesh)) == 0
    try:
        tiled_tv_deconvolve(torch.zeros(8 * t + 1, 8), mesh=mesh, iters=2)
    except ValueError as e:
        assert f"must divide by tile axis size {t}" in str(e), e
    else:
        raise AssertionError("H % T != 0 was not rejected")
    if "data" in axes:
        try:
            tiled_tv_deconvolve(torch.zeros(8 * t, 8), mesh=mesh, iters=2, **data_kw)
        except ValueError as e:
            assert f"batch*channels=1 must divide by data axis size {axes['data']}" in str(e), e
        else:
            raise AssertionError("planes % D != 0 was not rejected")

    inputs = {k: torch.from_numpy(v) for k, v in scene(t).items()}
    solvers = {"tiled": tiled_tv_deconvolve, "composite": tiled_composite_tv_deconvolve,
               "anderson": tiled_tv_deconvolve_anderson}
    results = {}
    for name, solver, inp, kw in cases():
        out = solvers[solver](inputs[inp], psf=None if inp == "rows" else inputs["psf"],
                              mesh=mesh, **data_kw, **kw)
        if isinstance(out, tuple):
            x, diag = out
            for field in ("r_norm", "s_norm", "iterations", "rho"):
                results[f"{name}.{field}"] = getattr(diag, field).numpy()
        else:
            x = out
        results[f"{name}.x"] = x.numpy()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **results)


if __name__ == "__main__":
    main()
