#!/usr/bin/env python3
"""Kernel times and the end-to-end rows of the stencil kernels on one H100.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_times.py            # kernel times, the 1080p solve, tiled T = 1
    python3 chip_times.py --sweep    # the row march's geometry: rows x warps
    python3 chip_times.py --policy   # solve_auto's policy fields, A/B on the card

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

``--policy`` measures the fields of ``admm_deconv_tpu_torch/ops/policy.py``
that ``solve_auto`` reads, printing one JSON line a row, each naming the
card and its power limit.  Every row runs A/B pairs in turns (A first in
even pairs, B first in odd ones), both arms of a pair on the same fresh
input, each solve timed by the host clock up to a synchronize:

1. ``bf16_state_on_tpu`` at a fixed budget: ``solve_auto(iters=50)`` with
   bf16 state against fp32 state on bench.py's 1080p batch 4 and 4K frame,
   beside an fp32-against-fp32 pairing that gives the spread; it/s and
   max |x_bf16 - x_fp32|;
2. the same on the ttq_1080p scene through the tolerance branch: seconds
   to tolerance and iterations;
3. ``solve_auto_check_every`` over ``CHECK_EVERY_SWEEP`` (and 8 once more,
   for the spread) through the tolerance branch at its default
   ``max_iters=400`` on both ttq scenes, fp32 and bf16 state on ttq_1080p
   (ttq_deep_512's eps is below ``deep_eps_abs``, so its state is fp32):
   seconds to tolerance, iterations, and the ``check_every`` each run used,
   read from the launch counts;

then the blocks scenario's PSNR with either state, and one ``rule`` line a
decision as this call's rows read it: bf16 wins at a shape when the median
of its per-pair time ratio lies below ``1 - 2 s``, ``s`` the fp32-against-
fp32 spread at that shape (the larger of its median ratio's distance from
1 and half its quartile range); the best ``check_every`` is the one with
the least median seconds on ttq_1080p, held to k = 8 on ttq_deep_512 and
against the 8-against-8 spread.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SWEEP_SHAPES = [(12, 1080, 1920), (6, 1080, 1920), (12, 270, 1920), (3, 540, 3840)]
SWEEP_ROWS = (1, 2, 4, 8, 16, 32, 64)
# --policy: A/B pairs a pairing, rounds of the check_every rotation, and the
# candidates (divisors of solve_auto's default max_iters=400, so that
# solve_auto keeps each).
POLICY_PAIRS, POLICY_ROUNDS = 20, 7
CHECK_EVERY_SWEEP = (4, 8, 10, 20, 40)


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


def _seconds(solve, v):
    """Host seconds of one solve of ``v``, up to a synchronize, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solve(v)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _quartiles(values) -> list[float]:
    return [float(q) for q in np.quantile(np.asarray(values, dtype=np.float64), (0.25, 0.5, 0.75))]


def ab_pairs(a, b, y, step: float, pairs: int = POLICY_PAIRS) -> dict:
    """``pairs`` A/B pairs of solves (``a``, ``b``: input -> ``(x, diags)``)
    on ``y + step (i + 1)``, in turns, after one warm-up of each: seconds,
    iterations, the per-pair time ratio b/a and max |x_b - x_a|."""
    a(y), b(y)
    out = {"a_s": [], "b_s": [], "a_iters": [], "b_iters": [], "max_abs_dx": 0.0}
    for i in range(pairs):
        v = y + step * (i + 1)
        res = {}
        for arm, solve in ((("a", a), ("b", b)) if i % 2 == 0 else (("b", b), ("a", a))):
            sec, res[arm] = _seconds(solve, v)
            out[f"{arm}_s"].append(sec)
            out[f"{arm}_iters"].append(int(res[arm][1].iterations))
        dx = float((res["b"][0] - res["a"][0]).abs().max())
        out["max_abs_dx"] = max(out["max_abs_dx"], dx)
    ratio = np.asarray(out["b_s"]) / np.asarray(out["a_s"])
    out["ratio_quartiles"] = _quartiles(ratio)
    out["a_s_quartiles"], out["b_s_quartiles"] = _quartiles(out["a_s"]), _quartiles(out["b_s"])
    out["b_faster_pairs"] = int((ratio < 1).sum())
    return out


def spread(same: dict) -> float:
    """The spread of an arm against itself: the larger of its median
    ratio's distance from 1 and half its ratio's quartile range."""
    q1, med, q3 = same["ratio_quartiles"]
    return max(abs(med - 1.0), (q3 - q1) / 2)


def policy_rows(dev, card: dict) -> None:
    """The ``--policy`` rows (module docstring)."""
    from admm_deconv_tpu_torch import peak_snr, solve_auto
    from admm_deconv_tpu_torch.ops.policy import overrides, policy

    def emit(row: dict) -> None:
        print(json.dumps(card | row), flush=True)

    def auto(bf16: bool, **kw):
        def solve(v):
            with overrides(bf16_state_on_tpu=bf16):
                return solve_auto(v, lam=cs.LAM, rho=cs.RHO, **kw)
        return solve

    emit({"row": "policy", "defaults": vars(policy()), "pairs": POLICY_PAIRS})
    rng = np.random.default_rng(0)
    psf = cs.motion_psf(dev)
    wins = {}
    # Rows 1 and 2: bf16 against fp32 state, and fp32 against itself.
    scenes = {name: (torch.from_numpy(rng.random(shape, dtype=np.float64).astype(np.float32))
                     .to(dev), {"psf": psf, "iters": cs.BENCH_ITERS}, 1e-3)
              for name, shape in (("1080p_b4", cs.BENCH_SHAPE), ("4k_frame", cs.FRAME_4K))}
    _, y_ttq, psf_ttq = cs.ttq_scene(dev, "ttq_1080p")
    eps_abs, eps_rel = cs.TTQ["ttq_1080p"][2:4]
    scenes["ttq_1080p"] = (y_ttq, {"psf": psf_ttq, "eps_abs": eps_abs, "eps_rel": eps_rel}, 1e-4)
    for name, (y, kw, step) in scenes.items():
        row = "1 bf16_state fixed budget" if "iters" in kw else "2 bf16_state tolerance"
        same = ab_pairs(auto(False, **kw), auto(False, **kw), y, step)
        ab = ab_pairs(auto(False, **kw), auto(True, **kw), y, step)
        s = spread(same)
        wins[name] = ab["ratio_quartiles"][1] < 1.0 - 2.0 * s
        for pairing, res in (("fp32 state vs fp32 state", same), ("bf16 state vs fp32 state", ab)):
            rates = ({"a_it_s_median": cs.BENCH_ITERS / res["a_s_quartiles"][1],
                      "b_it_s_median": cs.BENCH_ITERS / res["b_s_quartiles"][1]}
                     if "iters" in kw else {})
            emit({"row": row, "scene": name, "shape": list(y.shape), "pairing": pairing,
                  "a": "fp32 state", "b": pairing.split(" vs ")[0], **rates, **res,
                  "spread": s})
        emit({"row": row, "scene": name, "rule": "bf16 faster by more than twice the spread",
              "bf16_ratio_median": ab["ratio_quartiles"][1], "spread": s, "holds": wins[name]})

    # Row 3: check_every through the tolerance branch at max_iters=400.
    best = {}
    for name in cs.TTQ:
        _, y, p = cs.ttq_scene(dev, name)
        eps_abs, eps_rel = cs.TTQ[name][2:4]
        deep = eps_abs < policy().deep_eps_abs
        for bf16 in ((False,) if deep else (False, True)):
            arms = [*CHECK_EVERY_SWEEP, "8 again"]
            secs = {k: [] for k in arms}
            info = {k: {"iterations": [], "check_every_used": set()} for k in arms}

            def solve(v, k, bf16=bf16, p=p, eps_abs=eps_abs, eps_rel=eps_rel):
                with overrides(solve_auto_check_every=8 if k == "8 again" else k,
                               bf16_state_on_tpu=bf16):
                    return solve_auto(v, psf=p, lam=cs.LAM, rho=cs.RHO, eps_abs=eps_abs,
                                      eps_rel=eps_rel)

            for k in arms:
                solve(y, k)
            for r in range(POLICY_ROUNDS):
                v = y + 1e-4 * (r + 1)
                for k in arms[r % len(arms):] + arms[:r % len(arms)]:
                    cs.reset_counts()
                    sec, (_, d) = _seconds(lambda u, k=k: solve(u, k), v)
                    counts = cs.read_counts()
                    secs[k].append(sec)
                    its = int(d.iterations)
                    info[k]["iterations"].append(its)
                    info[k]["check_every_used"].add(cs.used_check_every(counts, its))
            state = "bf16 state" if bf16 else "fp32 state"
            med = {k: _quartiles(v)[1] for k, v in secs.items()}
            s8 = abs(med["8 again"] - med[8]) / med[8]
            for k in arms:
                emit({"row": "3 solve_auto_check_every", "scene": name, "state": state,
                      "eps_abs": eps_abs, "eps_rel": eps_rel, "max_iters": 400,
                      "check_every": k, "check_every_used": sorted(info[k]["check_every_used"]),
                      "s_quartiles": _quartiles(secs[k]), "s": secs[k],
                      "iterations": info[k]["iterations"], "spread_8_vs_8": s8})
            best[(name, state)] = (med, s8)
    for state in ("fp32 state", "bf16 state"):
        med, s8 = best[("ttq_1080p", state)]
        k = min(CHECK_EVERY_SWEEP, key=lambda c: med[c])
        tie = med[8] - med[k] <= s8 * med[8]
        deep_med, deep_s8 = best[("ttq_deep_512", "fp32 state")]
        deep_worse = deep_med[k] > deep_med[8] * (1.0 + 2.0 * deep_s8)
        emit({"row": "3 solve_auto_check_every", "rule": "least median s on ttq_1080p",
              "state": state, "fastest": k, "tie_with_8": tie,
              "slower_on_ttq_deep_512_than_8": deep_worse,
              "pick": 8 if tie or deep_worse else k})

    # The blocks scenario's PSNR with either state, both branches.
    clean, blurred, bpsf = cs.blocks_scenario()
    ref = torch.from_numpy(clean).to(dev)
    yb, pb = torch.from_numpy(blurred).to(dev), torch.from_numpy(bpsf).to(dev)
    for branch, kw in (("iters=100", {"iters": 100}), ("tolerance", {})):
        psnr = {}
        for state, bf16 in (("fp32 state", False), ("bf16 state", True)):
            x, d = auto(bf16, psf=pb, **kw)(yb)
            psnr[state] = {"psnr_db": float(peak_snr(torch.clamp(x, 0, 1), ref)),
                           "iterations": int(d.iterations)}
        emit({"row": "blocks quality", "branch": branch, **psnr,
              "bf16_minus_fp32_db": psnr["bf16 state"]["psnr_db"] - psnr["fp32 state"]["psnr_db"]})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="the row march's geometry sweep")
    ap.add_argument("--policy", action="store_true", help="solve_auto's policy fields, A/B")
    args = ap.parse_args()
    dev = cs.phase_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    cs.phase_build()
    if args.policy:
        name, limit = (f.strip() for f in cs.nvidia_smi().split(","))
        policy_rows(dev, {"card": name, "power_limit": limit})
    elif args.sweep:
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
