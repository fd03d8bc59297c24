#!/usr/bin/env python3
"""Kernel times and the end-to-end rows of the stencil kernels on one H100.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_times.py            # kernel times, the 1080p solve, tiled T = 1
    python3 chip_times.py --sweep    # the row march's geometry: rows x warps

The first form prints, for each of the port's five kernels at the stacks
``chip_smoke.py`` times them, the ms per call from the host (``cuda_ms``)
and on the device alone by two timers: ``chip_smoke.device_ms`` (a CUDA
graph of 20 calls, each after an L2-evicting read, less the reads alone;
it charges a call the write-back of the outputs it leaves dirty in L2) and
``profiler_ms`` (torch.profiler's records of the kernel over the same
calls; it does not).  Then the 1080p batch-4 ``tv_deconvolve`` (it/s, and
device time by kernel in one profiled solve) and the tiled solver at T = 1
(it/s, ``chip_smoke.profile_tiled``), fp32 and bf16 state.  It imports the
port and ``chip_smoke`` from the current directory, so two trees compare by
running it from each root in turns on one card (parent, change, change,
parent), e.g. from ``git archive`` of each.  ``--sweep`` times the forward
and tile kernels at every strip height and block width
``march_geometry`` could choose, against the one it does choose.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SWEEP_SHAPES = [(12, 1080, 1920), (6, 1080, 1920), (12, 270, 1920), (3, 540, 3840)]
SWEEP_ROWS = (1, 2, 4, 8, 16, 32, 64)


def profiler_ms(fn, calls: int, kernel: str) -> float:
    """Device ms per launch of the kernel whose name holds ``kernel`` over
    ``calls`` calls of ``fn``, each after an L2-evicting read, from
    torch.profiler's kernel records (the mean over the launches recorded;
    a run that lost records says so)."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(32 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.max()
            fn()
        torch.cuda.synchronize()
    hits = [e for e in cs.device_events(prof, kernel) if kernel in e.key]
    launched = sum(e.count for e in hits)
    if launched != calls:
        print(f"[profiler] {launched} of {calls} launches of {kernel} recorded")
    cs.check(launched > 0, f"the profile recorded no launch of {kernel}")
    return sum(e.self_device_time_total for e in hits) / 1e3 / launched


def profiler_times(dev, gen) -> None:
    """The forward and tile kernels by the profiler's timer at their timed
    stacks, aniso, fp32 and bf16 duals."""
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        fused_admm_stencil,
        fused_admm_stencil_halo,
        fused_admm_stencil_mixed,
    )

    tau = torch.tensor(cs.LAM / cs.RHO, device=dev)
    for shape in cs.HALO_TIME_SHAPES:
        n, h, w = shape
        x = torch.rand(shape, generator=gen, device=dev)
        halos = [torch.rand((n, 1, w), generator=gen, device=dev) for _ in range(4)]
        for dual in (torch.float32, torch.bfloat16):
            ux, uy = ((0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
                      for _ in range(2))
            floor = cs.bound(shape, 14 if dual == torch.bfloat16 else 24, 21)["bound_ms"]
            line = f"[profiler] {shape} {str(dual)[6:]:8s}"
            if shape in ((12, 1080, 1920), (6, 1080, 1920)):
                fwd = fused_admm_stencil if dual == torch.float32 else fused_admm_stencil_mixed
                ms = profiler_ms(lambda: fwd(x, ux, uy, tau), 20, "stencil_fwd_kernel")
                line += f" fwd {ms:.4f} ms ({floor / ms:.1%})"
            ms = profiler_ms(lambda: fused_admm_stencil_halo(x, ux, uy, *halos, tau), 20,
                             "stencil_halo_kernel")
            print(f"{line} halo {ms:.4f} ms ({floor / ms:.1%} of the {floor:.4f} ms floor)")


def tiled_rows(dev) -> None:
    """The tiled solver at T = 1 on the 1080p batch-4 inputs: it/s over
    ``REPEATS`` fresh inputs, then ``chip_smoke.profile_tiled``."""
    from admm_deconv_tpu_torch import tv_deconvolve
    from admm_deconv_tpu_torch.parallel import make_mesh, tiled_tv_deconvolve

    mesh = make_mesh({"tile": 1})
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random(cs.BENCH_SHAPE, dtype=np.float64).astype(np.float32))
    y = y.to(dev)
    kw = {"psf": cs.motion_psf(dev), "lam": cs.LAM, "rho": cs.RHO, "iters": cs.BENCH_ITERS}
    for sdt in (None, "bfloat16"):
        def tiled(v, sdt=sdt):
            return tiled_tv_deconvolve(v, mesh=mesh, state_dtype=sdt, **kw)

        def single(v, sdt=sdt):
            return tv_deconvolve(v, state_dtype=sdt, **kw)

        tiled(y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(cs.REPEATS):
            tiled(y + 0.001 * (i + 1))
        torch.cuda.synchronize()
        rate = cs.BENCH_ITERS * cs.REPEATS / (time.perf_counter() - t0)
        print(f"[tiled] T=1 state={sdt or 'float32'}: {rate:.2f} it/s")
        cs.profile_tiled(tiled, single, y)
    torch.distributed.destroy_process_group()


def sweep(dev, gen) -> None:
    """Both row-march kernels at every strip height of ``SWEEP_ROWS`` and
    every block of whole warps that divides a row, by ``device_ms``."""
    from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk

    chosen = sk.march_geometry
    tau = torch.tensor(cs.LAM / cs.RHO, device=dev)
    for shape in SWEEP_SHAPES:
        n, h, w = shape
        x = torch.rand(shape, generator=gen, device=dev)
        halos = [torch.rand((n, 1, w), generator=gen, device=dev) for _ in range(4)]
        warps_row = -(-w // (32 * sk._MARCH_VEC))
        for dual in (torch.float32, torch.bfloat16):
            ux, uy = ((0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
                      for _ in range(2))
            fwd = sk.fused_admm_stencil if dual == torch.float32 else sk.fused_admm_stencil_mixed
            floor = cs.bound(shape, 14 if dual == torch.bfloat16 else 24, 21)["bound_ms"]
            rows = sk._MARCH_ROWS_FWD_FP32 if dual == torch.float32 else sk._MARCH_ROWS
            print(f"[sweep] {shape} {str(dual)[6:]}: chosen for fwd {chosen(n, h, w, rows)}, "
                  f"for halo {chosen(n, h, w)}; floor {floor:.4f} ms")
            for warps in (d for d in range(1, 6) if warps_row % d == 0):
                for rows in SWEEP_ROWS:
                    strips = -(-h // rows)
                    geo = sk.MarchGeometry(rows, strips, warps_row // warps, 32 * warps)
                    sk.march_geometry = lambda *_, geo=geo: geo
                    try:
                        f_ms = cs.device_ms(lambda: fwd(x, ux, uy, tau), 20)
                        h_ms = cs.device_ms(
                            lambda: sk.fused_admm_stencil_halo(x, ux, uy, *halos, tau), 20)
                    finally:
                        sk.march_geometry = chosen
                    print(f"[sweep] {shape} {str(dual)[6:]:8s} {32 * warps:3d} threads, "
                          f"{rows:2d} rows, {geo.chunks * n * strips:6d} blocks: fwd "
                          f"{f_ms:.4f} ms ({floor / f_ms:.1%}), halo {h_ms:.4f} ms "
                          f"({floor / h_ms:.1%})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="the row march's geometry sweep")
    args = ap.parse_args()
    dev = cs.phase_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    cs.phase_build()
    if args.sweep:
        sweep(dev, gen)
    else:
        cs.phase_stencil_times(dev, gen)
        cs.phase_kernel_times(dev, gen)
        cs.phase_new_kernel_times(dev, gen)
        cs.phase_halo_times(dev, gen)
        profiler_times(dev, gen)
        cs.phase_profile(cs.phase_main_path(dev, gen))
        tiled_rows(dev)
    print(f"[times] nvidia-smi: {cs.nvidia_smi()}")


if __name__ == "__main__":
    main()
