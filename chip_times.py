#!/usr/bin/env python3
"""Kernel times and the end-to-end rows of the stencil kernels on one H100.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_times.py            # kernel times, the 1080p solve, tiled T = 1
    python3 chip_times.py --sweep    # the row marches' geometry: rows x warps
    python3 chip_times.py --policy   # solve_auto's policy fields, A/B on the card
    python3 chip_times.py --frame    # the 4K frame: its check's readings, fp32 beside bf16
    python3 chip_times.py --ttq      # the solve to tolerance: its check's readings
    python3 chip_times.py --composite  # the composite solve: its check's readings
    python3 chip_times.py --layer  # the 1080p TV-layer step: its check's readings
    python3 chip_times.py --anderson  # the 1080p Anderson solve: its check's readings
    python3 chip_times.py --train-scaling  # the flagship step at batches 2, 4 and 8
    python3 chip_times.py --tiled [--arms alone,after,controls]  # the four-card cell
    python3 chip_times.py --train-check N  # both flagship step cells' checks, N runs each
    python3 chip_times.py --windows DIR  # host-bound cells at 100 and 400 timed units
    python3 chip_times.py --control-reads NAME N  # one control through its cell's check, N runs
    python3 chip_times.py --step-recompute VARIANTS [--steps N]  # the recompute detector
    python3 chip_times.py --route-hunt SETTINGS  # failing float64 reads taken apart
    python3 chip_times.py --settings-at-states SETTINGS  # every setting at shared states
    python3 chip_times.py --conv-passes SETTINGS  # each convolution's passes: ms, error
    python3 chip_times.py --step-cells SETTINGS [--rounds N]  # both step cells by setting
    python3 chip_times.py --trainer-phases  # chip_smoke.py's trainer phases alone: ms/step
    python3 chip_times.py --rhs  # the x-update's complex rhs: by kernel, and the pass alone

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
parent), e.g. from ``git archive`` of each.  ``--sweep`` times the backward
kernel at every strip height and block width ``bwd_march_geometry`` could
choose, then the forward and tile kernels at every one ``march_geometry``
could choose, each against the one it does choose.

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

``--frame`` reads what the ``solve_4k_frame_bf16`` cell of ``bench_torch``
is checked by, one JSON line a row, each naming the card and its power
limit: at seeds 0 and 1, each arm of ``FRAME_ARMS`` run by the cell's own
``cells.run_solve`` with one timed solve and held by its check to the
float64 reference of that solve's input (the cell itself, the same frame
with fp32 state, the controls of ``bench_torch.controls`` and faults read
beside them); for the cell and fp32 state, the device ms of its traced
solves by kernel name and by the cell's layers; then Q2-1 alone at the
frame's planes with either dual.

``--ttq`` reads what the ``ttq_1080p_adaptive`` cell is checked by, one
JSON line a row in the same way: at seeds 1 and 2, each arm of
``ttq_arms()`` (the cell, its controls, and bfloat16 loop state beside
them) run by ``cells.run_ttq`` with one timed solve and held to the float64
adaptive reference of its input: iterations, rho, the residuals at the
stop against the reference's thresholds, max |x - x_float64|, and the
reference's decision margins nearest 1; for the cell, the device ms of its
traced solves by kernel name and by the cell's layers, and its launches;
last, where three traced solves of the cell wait on the host: each block's
synchronize and the device's idle after it, and the longer idle gaps.

``--composite`` does the same for the ``composite_1080p`` cell at seeds 1
and 2: the cell, its controls and bfloat16 loop state beside them, each
run by ``cells.run_composite`` and held to the float64 composite reference
of its input (max |x - x_float64|, the elements at the box's bounds, the
reference's branch counts); for the cell, the device ms by kernel name and
by its layers, and its launches.

``--layer`` reads what the ``tv_layer_1080p_step`` cell is checked by, one
JSON line a row: at seeds 3 and 4, each arm of ``layer_arms()`` (the cell,
its controls, and bfloat16 loop state beside them) run by
``cells.run_layer`` with the cell's 100 timed steps, its last step held to
the float64 unrolled step on its input: the loss, ``dL/dlam`` and
``dL/drho`` each relative, the update and Adam's moments, lam and rho, the
reference's peak memory; beside it the step's ms (whole window and
median), its peak memory and its launches.  For the cell, the device ms of
its traced steps by the cell's layers and by kernel name within each.

``--anderson`` reads what the ``anderson_1080p`` cell is checked by, one
JSON line a row: at seeds 0 and 1, the cell run by ``cells.run_anderson``
with its 100 timed solves and with one (as ``chip_smoke.py``'s
``phase_bench`` runs it), then each of its controls with one timed solve
(the check reads only the last unit), each held to the float64 Anderson
reference of its last input: the four readings against their limits, the
primal residual over float64 plain ADMM's, each plane's residuals and the
refusals of both safeguards; beside them it/s (whole window and median),
the solve's peak memory and its launches.  For the cell, the device ms of
its traced solves by the cell's layers and by kernel name within each,
the idle share and the longest idle gaps with what the host was doing;
last, one traced solve's host synchronizations by the op that made them.

``--train-scaling`` reads ``bench_suite.py``'s ``--train-scaling`` rows
on the card, one JSON line a row: first, for each convolution of the
flagship at batches 2 and 8 (its operands captured from one fp32 step),
the cuDNN kernels of its forward, data gradient and weight gradient, each
pass run alone under the profiler and read under its aten op, their device
ms, and each pass's fp32 error against float64 with cuDNN and with torch's
own convolutions (``cudnn.enabled`` off); the same at 256^2 with cuDNN
deterministic, as ``chip_smoke_multi.py --probe-gradient`` runs it; then
the gradient at batches 2, 4 and 8, seed 2, from the same parameters after
0 and 100 AdaBelief steps, against ``bench_torch/train_reference.py`` in
float64 plainly and along the routes the card's forward took (as
``chip_smoke.py``'s ``phase_grad_routes``), with cuDNN and with it off, and
the mean of the batch-2 shards' gradients; the same at 256^2 at batches 2
and 8 from the initial parameters, cuDNN deterministic beside; last, each
row (batches 2, 4 and 8, fp32 and bf16 loop state) through
``cells.run_train`` with 100 timed steps: ms/step, images/s, busy, idle
share, ``cudnn_ms`` and every layer, peak memory of the step and of the
float64 reference, and the last step's readings (the bf16 rows held to no
limit).

``--tiled`` runs ``bench_torch``'s four-card cell (on a host with four
cards) through the benchmark's own ``main``, as the command runs it:
first from this process before it makes a CUDA context (alone); then
after the one-card ``solve_1080p_b4`` cell has run in this process on card
0, its context, plans and allocator kept there while rank 0 shares the
card (after); then the cell's controls at ``TILED_CONTROL_REPEATS`` timed
units each (each control's check reads only the last unit).  The cell's
lines are printed as the benchmark prints them, each arm's headed by a
``{"tiled_arm": ...}`` line.

``--train-check N`` runs each of ``STEP_CELLS`` (the batch-2 and batch-8
flagship step cells) by ``cells.run_train`` N times in one process, as the
command runs it (its seed, 100 timed steps, its check of the last one, its
traced steps), and prints a line a run: the check's readings against its limits; the max-pool
windows and clamped elements whose route the card's forward at the last
step's parameters and input takes apart from float64's; the step's own
gradient against float64 made to take the card's routes (what is left is
the card's arithmetic); and the cuDNN kernels of its traced steps (their
number and names, a kernel a choice of algorithm).  Last, the runs that
failed the check out of N.

``--windows DIR`` runs ``WINDOW_CELLS``, the host-bound one-card cells with
the widest bounds, through the benchmark's own ``main`` at 100 and at 400
timed units a cell, ``WINDOW_ROUNDS`` rounds, the order of the two
lengths turned each round; each run's lines go to ``DIR/r<units>/<round>.log``,
so that ``python3 -m bench_torch.spread DIR/r100 DIR/r400`` gives each
window length's spread within the call.

``--control-reads NAME N`` runs the control ``NAME`` of
``bench_torch/controls.py`` N times in one process through its cell's own
run and check, as ``python3 -m bench_torch --controls`` runs it
(``CONTROL_READ_REPEATS`` timed units; the check reads the last), and
prints a line a run with every reading of the check and whether it
rejected the control; last, the runs in which it did not.

``--step-recompute VARIANTS`` runs ``chip_smoke.step_recompute`` (the
``flagship_train_step`` cell's trajectory, each step's gradient computed
twice, every 20th held to float64) for ``--steps`` steps under each named
variant of ``RECOMPUTE_VARIANTS`` in turn: cuDNN as the cell has it,
deterministic, or off; the bank on its plain composition; every Q2-1 and
Q2-2 launch shadowed by its plain twin.  A line a variant with its
disagreeing steps, the largest difference of the agreeing pairs and, of
each disagreeing pair, the first cotangent that parts; last, a summary.

``--route-hunt SETTINGS`` runs the cell's trajectory under each setting of
``conv_setting`` (cuDNN's flags, the parent's convolutions, cuDNN on
channels-last views, passes split between cuDNN and torch's own), holds
every 5th step's gradient to float64, and takes a few failing (and
passing) reads apart: each setting's gradient at that state against
float64 plainly and along the routes its own forward recorded, and the
cotangents at ``RECOMPUTE_POINTS`` against float64's along them.
``--settings-at-states SETTINGS`` runs one trajectory with the port as it
is and, every 5th step, every named setting's gradient at that state
against float64 (besides ``conv_setting``'s: the bank on its plain
composition, the bank's solve in float64, the port's model in float64).
``--conv-passes SETTINGS`` reads each convolution's three passes at
batches 2 and 8 under each setting (``conv_rows``).  ``--step-cells
SETTINGS`` runs the two step cells by ``bench_torch``'s own ``main`` under
each setting, the order turned each round.

``--trainer-phases`` runs ``chip_smoke.py``'s ``phase_trainer`` (the
production trainer at 256^2: an epoch, a resume, ms per train step) and
``phase_data_parallel`` (the trainer in a one-rank NCCL group beside it
without one, ms per step of each) alone, and prints their ms/step on one
line.  Run from the root of another checkout (``cd DIR && python3
/path/to/chip_times.py --trainer-phases``) it times that checkout's
``chip_smoke.py`` and package, so a parent and a change compare in one call.

``--rhs`` reads the x-update's complex right-hand side ``C (B + rho
rfft2(q))``, one JSON line a row: for each of ``RHS_CELLS``, the cell run
by its own ``cells.run_*`` with one timed unit, and its traced units'
device ms a unit by the cell's layer, the aten ops open at each launch
(innermost three) and the kernel's name; then, where the tree has the
hand-written pass, ``chip_smoke.phase_spectral_times`` (the pass and the
composition's three torch calls alone, against the pass's HBM floor).
Run from a tree without the pass (``cd DIR && python3
/path/to/chip_times.py --rhs``), it reads the cells alone.
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
# The backward kernel's sweep: the TV-layer step's stack (aniso) and the
# flagship steps' bank stacks (iso, a per-plane tau), and the most warps a
# block takes (a block holds whole 256-column chunks of two warps; one warp
# at 112 columns).
BWD_SWEEP_SHAPES = {(6, 1080, 1920): "aniso", (120, 112, 112): "iso", (30, 112, 112): "iso",
                    (30, 256, 256): "iso"}
BWD_SWEEP_WARPS = {1: (8, 16, 32), 4: (2, 4, 8)}
# --policy: A/B pairs a pairing, rounds of the check_every rotation, and the
# candidates (divisors of solve_auto's default max_iters=400, so that
# solve_auto keeps each).
POLICY_PAIRS, POLICY_ROUNDS = 20, 7
CHECK_EVERY_SWEEP = (4, 8, 10, 20, 40)
TILED_CONTROL_REPEATS = 20
LAYER_SEEDS, LAYER_REPEATS = (3, 4), 100
ANDERSON_SEEDS, ANDERSON_REPEATS = (0, 1), 100
# --train-scaling: bench_suite.py's batches, the train cells' timed steps, the
# AdaBelief steps (of the batch-2 cell's trajectory) before each gradient
# read, the batches whose convolutions are read one by one, and the cells'
# size of the step (its height, width and channels).
TRAIN_SCALING_BATCHES, TRAIN_SCALING_REPEATS = (2, 4, 8), 100
TRAIN_SCALING_POINTS, TRAIN_SCALING_CONV_BATCHES = (0, 100), (2, 8)
TRAIN_SCALING_SIZE = "full"
# ... and the crop of chip_smoke_multi.py --probe-gradient (the production
# config's 256^2, where a batch of 8 once read twice as far from float64 as
# one of 2), read at batches 2 and 8 from the initial parameters.
TRAIN_SCALING_PROBE = (256, 256)
TILED_ARMS = ("alone", "after", "controls")
# --windows: the host-bound one-card cells with the widest bounds, the timed
# units a cell (the benchmark's, and four times as many), and the rounds.
WINDOW_CELLS = ("tv_layer_1080p_step", "flagship_train_step")
WINDOW_REPEATS, WINDOW_ROUNDS = (100, 400), 4
# --control-reads: the timed units a run, as the command's --controls and
# chip_smoke.py's phase_bench run most controls.
CONTROL_READ_REPEATS = 100
# --step-recompute: chip_smoke.step_recompute's variants, each its cuDNN
# setting (chip_smoke.cudnn_as), the bank's prox_impl and whether every Q2-1
# and Q2-2 launch is shadowed by its plain twin.
RECOMPUTE_VARIANTS = {"cudnn": ("cudnn", "auto", False),
                      "cudnn deterministic": ("cudnn deterministic", "auto", False),
                      "native convolutions": ("native convolutions", "auto", False),
                      "plain bank": ("cudnn", "xla", False),
                      "shadow": ("cudnn", "auto", True)}
# --route-hunt: the steps of the cell's trajectory under each cuDNN setting,
# every how many steps the step's gradient is held to float64, how many
# failing reads (and, for comparison, passing ones) are taken apart.
HUNT_STEPS, HUNT_EVERY, HUNT_FAILING, HUNT_PASSING = 300, 5, 4, 2
HUNT_SETTINGS = ("cudnn", "cudnn deterministic", "native convolutions", "cudnn nhwc",
                 "native forward", "native wgrad", "hybrid")
# --settings-at-states: the steps of the cell's trajectory (cuDNN as the cell
# has it), every how many steps its state is read, and the thresholds each
# setting's gradient is counted above (whole, worst leaf) beside the cell's.
STATES_STEPS, STATES_EVERY, STATES_ABOVE = 400, 5, (1e-3, 5e-3)
# --step-cells: the two step cells, timed under each cuDNN setting in turns.
STEP_CELLS = ("flagship_train_step", "flagship_train_step_b8")
# --rhs: the cells whose elementwise_ms the x-update's complex rhs fills.
RHS_CELLS = ("solve_1080p_b4", "composite_1080p")


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


def _aten_ops(stack: list[str]) -> str:
    """The innermost three aten ops open at a launch, outermost first."""
    return " > ".join([s for s in stack if s.startswith("aten::")][-3:]) or "(no aten op)"


def rhs_rows(dev, gen, card: dict) -> None:
    """The ``--rhs`` rows (module docstring)."""
    from bench_torch import cells

    def emit(row: dict) -> None:
        print(json.dumps(card | row), flush=True)

    for cell in RHS_CELLS:
        layer_of = cells.classify_solve if cell == "solve_1080p_b4" else cells.classify_composite
        run = cells.RUNS[cell](dev, cells.DEFAULT_SEEDS[cell], 1, "full", classify=(
            lambda name, stack, ranges, layer_of=layer_of:
            json.dumps([layer_of(name, stack, ranges), _aten_ops(stack), name[:200]])))
        keyed = run.breakdown.pop("layers_ms") or {}  # {} on the CPU
        rows = sorted(([*json.loads(k), ms] for k, ms in keyed.items()), key=lambda r: -r[3])
        layers = {}
        for layer, _, _, ms in rows:
            layers[layer] = layers.get(layer, 0.0) + ms
        emit({"row": "rhs breakdown", "cell": cell, "layers_ms": layers,
              "busy_ms": run.breakdown.get("busy_ms"), "wall_ms": run.breakdown.get("wall_ms"),
              "check_ok": run.checks["solve"]["ok"]})
        for layer, ops, name, ms in rows:
            emit({"row": "rhs kernel", "cell": cell, "layer": layer, "ops": ops, "kernel": name,
                  "ms_a_unit": ms})
    if hasattr(cs, "phase_spectral_times"):  # a tree with the pass
        cs.phase_spectral_times(dev, gen)


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


def bwd_sweep(dev, gen) -> None:
    """The backward kernel at 1 and 4 columns a thread, every strip height
    of ``SWEEP_ROWS`` and every block of whole chunks up to
    ``BWD_SWEEP_WARPS`` warps, by ``device_ms``, at ``BWD_SWEEP_SHAPES``."""
    from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk

    chosen = sk.bwd_march_geometry
    for shape, mode in BWD_SWEEP_SHAPES.items():
        n, h, w = shape
        x = torch.rand(shape, generator=gen, device=dev)
        tau = (torch.tensor(cs.LAM / cs.RHO, device=dev) if mode == "aniso" else
               torch.empty(n, device=dev).uniform_(0.01, 0.1, generator=gen))
        for dual in (torch.float32, torch.bfloat16):
            ux, uy = ((0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
                      for _ in range(2))
            gq, gux, guy = (torch.randn(shape, generator=gen, device=dev).to(dual)
                            for _ in range(3))
            floor = cs.bound(shape, 22 if dual == torch.bfloat16 else 36,
                             cs.BWD_ISO_OPS if mode == "iso" else 40)["bound_ms"]
            print(f"[sweep] bwd {shape} {mode} {str(dual)[6:]}: chosen {chosen(n, h, w)}; "
                  f"floor {floor:.4f} ms")
            seen = set()
            for cols, warps, rows in ((c, m, r) for c, ms in BWD_SWEEP_WARPS.items()
                                      for m in ms for r in SWEEP_ROWS):
                geo = chosen(n, h, w, max_warps=warps, cols=cols)._replace(
                    rows=rows, strips=-(-h // rows))
                if rows > h or geo in seen:
                    continue
                seen.add(geo)
                sk.bwd_march_geometry = lambda *_, geo=geo: geo
                try:
                    ms = cs.device_ms(
                        lambda: sk.fused_admm_stencil_bwd(x, ux, uy, tau, gq, gux, guy, mode),
                        20)
                finally:
                    sk.bwd_march_geometry = chosen
                print(f"[sweep] bwd {shape} {str(dual)[6:]:8s} {geo.cols} cols, "
                      f"{geo.threads:4d} threads, {rows:2d} rows, "
                      f"{geo.col_blocks * n * geo.strips:6d} blocks: {ms:.4f} ms "
                      f"({floor / ms:.1%})")


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


def keep_bits(bits: int):
    """Rounding to ``bits`` significant bits (bfloat16 keeps 8)."""
    def rounding(t: torch.Tensor) -> torch.Tensor:
        m, e = torch.frexp(t.float())
        return torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits, e).to(t.dtype)

    return rounding


def frame_arms() -> dict:
    """The solvers ``--frame`` runs the 4K cell with: None is the cell's."""
    from bench_torch import cells, controls

    bf16 = controls.through(torch.bfloat16)
    in_bf16 = controls.output_through(bf16, controls.state_through(lambda t: t, x_rounding=bf16))
    return {
        "bf16 state": None,
        "fp32 state": controls.with_arguments(state_dtype=None),
        **{name: controls.SOLVE_CONTROLS[name][1]() for name in controls.FRAME_CONTROLS},
        "one iteration short": controls.with_arguments(iters=cells.ITERS - 1),
        "output in bf16": controls.output_through(bf16),
        "state at 7 bits (2x bf16's rounding)": controls.state_through(keep_bits(7)),
        "state at 6 bits (4x bf16's rounding)": controls.state_through(keep_bits(6)),
        "input, iterate, state and output in bf16": lambda y, **kw: in_bf16(bf16(y), **kw),
    }


def frame_rows(dev, gen, card: dict) -> None:
    """The ``--frame`` rows (module docstring)."""
    from bench_torch import cells

    def emit(row: dict) -> None:
        print(json.dumps(card | row), flush=True)

    cell = "solve_4k_frame_bf16"
    for seed in (0, 1):
        for arm, solver in frame_arms().items():
            run = cells.run_solve(dev, seed, 1, "full", cell, solver=solver,
                                  classify=lambda name, *_: name)
            emit({"row": "frame check", "seed": seed, "arm": arm, **run.checks["solve"]})
            if arm in ("bf16 state", "fp32 state"):
                by_name = run.breakdown.pop("layers_ms")
                layers = {}
                for name, ms in by_name.items():
                    layer = cells.classify_frame(name, [], [])
                    layers[layer] = layers.get(layer, 0.0) + ms
                emit({"row": "frame breakdown", "seed": seed, "arm": arm, "layers_ms": layers,
                      **run.breakdown, "ms_by_kernel": by_name})
    for dual, t in cs.phase_stencil_times(dev, gen, cs.FRAME_STACK).items():
        emit({"row": "frame stencil", "shape": list(cs.FRAME_STACK), "duals": dual, **t})


def ttq_arms() -> dict:
    """The solvers ``--ttq`` runs the solve-to-tolerance cell with: None is
    the cell's."""
    from bench_torch import controls

    return {"the cell": None,
            **{name: make() for name, make in controls.TTQ_CONTROLS.items()},
            "bf16 state": controls.with_arguments(controls.tv_adaptive,
                                                  state_dtype="bfloat16")}


def check_rows(dev, emit, label: str, run_cell, arms: dict, classify) -> None:
    """At seeds 1 and 2, each arm (a solver; None is the cell's own) run by
    the cell's ``run_cell`` with one timed solve, and its check's line; for
    the cell, its traced solves' device ms by kernel name and by ``classify``
    into the cell's layers, and its launches."""
    for seed in (1, 2):
        for arm, solver in arms.items():
            run = run_cell(dev, seed, 1, "full", solver=solver, classify=lambda name, *_: name)
            emit({"row": f"{label} check", "seed": seed, "arm": arm, "unit_s": run.samples_s[0],
                  "setup_s": run.setup_s, **run.checks["solve"]})
            if solver is None:
                by_name = run.breakdown.pop("layers_ms") or {}  # {} on the CPU
                layers = {}
                for name, ms in by_name.items():
                    layer = classify(name, [], [])
                    layers[layer] = layers.get(layer, 0.0) + ms
                emit({"row": f"{label} breakdown", "seed": seed, "layers_ms": layers,
                      **run.breakdown, "launches": run.launches,
                      "launches_expected": run.launches_expected, "ms_by_kernel": by_name})


def ttq_rows(dev, card: dict) -> None:
    """The ``--ttq`` rows (module docstring)."""
    from bench_torch import cells

    def emit(row: dict) -> None:
        print(json.dumps(card | row), flush=True)

    check_rows(dev, emit, "ttq", cells.run_ttq, ttq_arms(), cells.classify_ttq)
    if dev.type == "cuda":
        ttq_syncs(dev, emit)


def composite_arms() -> dict:
    """The solvers ``--composite`` runs the composite cell with: None is
    the cell's."""
    from bench_torch import controls

    return {"the cell": None,
            **{name: make() for name, make in controls.COMPOSITE_CONTROLS.items()},
            "bf16 state": controls.with_arguments(controls.composite, state_dtype="bfloat16")}


def composite_rows(dev, card: dict) -> None:
    """The ``--composite`` rows (module docstring)."""
    from bench_torch import cells

    check_rows(dev, lambda row: print(json.dumps(card | row), flush=True), "composite",
               cells.run_composite, composite_arms(), cells.classify_composite)


def layer_arms() -> dict:
    """The arguments of ``cells.run_layer`` for each arm of ``--layer``:
    the cell's (none), its controls', and bfloat16 loop state."""
    from bench_torch import controls

    return {"the cell": {}, **{name: make() for name, make in controls.LAYER_CONTROLS.items()},
            "bf16 state": {"layer_kw": {"state_dtype": "bfloat16"}}}


def layer_rows(dev, card: dict) -> None:
    """The ``--layer`` rows (module docstring)."""
    from bench_torch import cells

    def emit(row: dict) -> None:
        print(json.dumps(card | row), flush=True)

    def by_layer_and_name(name, stack, ranges):
        return f"{cells.classify_layer(name, stack, ranges)} | {name}"

    for seed in LAYER_SEEDS:
        for arm, kw in layer_arms().items():
            run = cells.run_layer(dev, seed, LAYER_REPEATS, "full",
                                  classify=None if kw else by_layer_and_name, **kw)
            emit({"row": "layer check", "seed": seed, "arm": arm,
                  "ms_per_step": 1e3 * float(np.mean(run.samples_s)),
                  "median_ms": 1e3 * float(np.median(run.samples_s)), "setup_s": run.setup_s,
                  **run.extra, "launches": run.launches,
                  "launches_expected": run.launches_expected,
                  **run.checks["last timed step"]})
            if not kw:
                by_name = run.breakdown.pop("layers_ms") or {}  # {} on the CPU
                layers = {}
                for key, ms in by_name.items():
                    layer = key.split(" | ")[0]
                    layers[layer] = layers.get(layer, 0.0) + ms
                emit({"row": "layer breakdown", "seed": seed, "layers_ms": layers,
                      **run.breakdown, "ms_by_layer_and_kernel": by_name})


def anderson_rows(dev, card: dict) -> None:
    """The ``--anderson`` rows (module docstring)."""
    from bench_torch import cells, controls

    def emit(row: dict) -> None:
        print(json.dumps(card | row), flush=True)

    def by_layer_and_name(name, stack, ranges):
        return f"{cells.classify_anderson(name, stack, ranges)} | {name}"

    arms = {"the cell": (None, ANDERSON_REPEATS), "the cell, one unit": (None, 1),
            **{name: (make(), 1) for name, make in controls.ANDERSON_CONTROLS.items()}}
    for seed in ANDERSON_SEEDS:
        for arm, (solver, repeats) in arms.items():
            run = cells.run_anderson(dev, seed, repeats, "full", solver=solver,
                                     classify=by_layer_and_name if arm == "the cell" else None)
            emit({"row": "anderson check", "seed": seed, "arm": arm, "units": len(run.samples_s),
                  "iters_per_s": cells.ITERS / float(np.mean(run.samples_s)),
                  "median_iters_per_s": cells.ITERS / float(np.median(run.samples_s)),
                  "setup_s": run.setup_s, **run.extra, "launches": run.launches,
                  "launches_expected": run.launches_expected, **run.checks["solve"]})
            if arm == "the cell":
                by_name = run.breakdown.pop("layers_ms") or {}  # {} on the CPU
                layers = {}
                for key, ms in by_name.items():
                    layer = key.split(" | ")[0]
                    layers[layer] = layers.get(layer, 0.0) + ms
                emit({"row": "anderson breakdown", "seed": seed, "layers_ms": layers,
                      **run.breakdown, "ms_by_layer_and_kernel": by_name})
    anderson_syncs(dev, emit)


def anderson_syncs(dev, emit) -> None:
    """One traced solve of the Anderson cell (seed 0): its host's
    ``cudaStreamSynchronize`` calls, counted and summed by the op that made
    them (the innermost ``aten::`` op open on the host)."""
    from admm_deconv_tpu_torch import tv_deconvolve_anderson
    from bench_torch import cells, trace

    y_np, psf_np = cells.solve_inputs(0, cells.SHAPES[cells.ANDERSON]["full"])
    y, psf = torch.from_numpy(y_np).to(dev), torch.from_numpy(psf_np).to(dev)

    def solve(v):
        return tv_deconvolve_anderson(v, psf=psf, **cells.ANDERSON_SETTINGS)

    solve(y)
    cells._sync(dev.type == "cuda")
    tl = trace.Timeline(trace.trace_units([lambda: solve(y + 0.001)], dev.type == "cuda"))
    by_op = {}
    for events in tl.host.values():
        syncs = sorted(e["ts"] for e in events if e["name"] == "cudaStreamSynchronize")
        waited = {e["ts"]: e["dur"] for e in events if e["name"] == "cudaStreamSynchronize"}
        for t, stack in zip(syncs, trace._stacks(events, syncs)):
            op = next((name for name in reversed(stack) if name.startswith("aten::")), "(none)")
            where = " > ".join(name for name in stack if name.startswith("admm/")) or "-"
            entry = by_op.setdefault(f"{where} | {op}", {"calls": 0, "waited_ms": 0.0})
            entry["calls"] += 1
            entry["waited_ms"] += waited[t] / 1e3
    emit({"row": "anderson syncs", "unit_wall_ms": (tl.units[0][1] - tl.units[0][0]) / 1e3,
          "by_range_and_op": by_op})


def ttq_syncs(dev, emit) -> None:
    """Three traced solves of the ttq cell (seed 1): for each unit, every
    ``cudaStreamSynchronize`` (the block's read of ``done``: where it falls,
    how long the host waited in it) and the device's idle time from its
    return to the next kernel; the idle before the unit's first kernel; and
    every idle gap of at least 0.1 ms with what the host had open."""
    from admm_deconv_tpu_torch import tv_deconvolve_adaptive
    from bench_torch import cells, trace

    y_np, psf_np = cells.ttq_inputs(1, *cells.TTQ_SCENES["full"])
    y, psf = torch.from_numpy(y_np).to(dev), torch.from_numpy(psf_np).to(dev)

    def solve(v):
        return tv_deconvolve_adaptive(v, psf=psf, **cells.TTQ_SETTINGS)

    solve(y)
    torch.cuda.synchronize()
    tl = trace.Timeline(trace.trace_units(
        [lambda i=i: solve(y + cells.TTQ_STEP * i) for i in range(1, 4)], True))
    starts = sorted(ev.start for ev in tl.device)
    syncs = sorted((e["ts"], e["ts"] + e["dur"]) for events in tl.host.values() for e in events
                   if e["name"] == "cudaStreamSynchronize")
    gaps = tl.gaps()
    stacks = tl.host_at([(a + b) / 2 for a, b in gaps])
    for k, (u0, u1) in enumerate(tl.units):
        first = next(t for t in starts if t >= u0)
        row = {"row": "ttq syncs", "unit": k + 1, "wall_ms": (u1 - u0) / 1e3,
               "idle_before_first_kernel_ms": (first - u0) / 1e3, "syncs": []}
        for a, b in syncs:
            if u0 <= a < u1:
                nxt = next((t for t in starts if t >= b), u1)
                row["syncs"].append({"at_ms": (a - u0) / 1e3, "waited_ms": (b - a) / 1e3,
                                     "idle_after_ms": (min(nxt, u1) - b) / 1e3})
        row["gaps_over_0.1_ms"] = [
            {"at_ms": (a - u0) / 1e3, "ms": (b - a) / 1e3, "host": [" > ".join(x[-3:]) for x in st]}
            for (a, b), st in zip(gaps, stacks) if u0 <= a < u1 and b - a >= 100]
        emit(row)


def scaling_inputs(dev, batch: int, crop=None):
    """The step's input and target at ``batch`` (and ``crop``, else the
    cells'), drawn as the train cells draw theirs (seed 2)."""
    from bench_torch import cells

    shape = cells.SHAPES[cells.FLAGSHIP][TRAIN_SCALING_SIZE]
    shape = (batch, *(crop or shape[1:3]), shape[3])
    return tuple(torch.from_numpy(a).to(dev)
                 for a in cells.train_inputs(cells.DEFAULT_SEEDS[cells.FLAGSHIP], shape))


def init_model(dev):
    """The flagship at the train cells' initial parameters (seed 2)."""
    from admm_deconv_tpu_torch.models import AdmmDenoiser, init_parameters
    from bench_torch import cells

    return init_parameters(AdmmDenoiser(), torch.Generator().manual_seed(
        cells.DEFAULT_SEEDS[cells.FLAGSHIP])).to(dev)


def port_gradient(dev, state: dict, x, t, setting: str) -> tuple[dict, list]:
    """``chip_smoke.port_gradient`` under the cuDNN ``setting``, held to 49
    launches each of Q2-1 and Q2-2 on the card (none on the CPU)."""
    grads, routes, counts = cs.port_gradient(dev, state, x, t, setting)
    n = cs.FLAGSHIP_LAUNCHES if dev.type == "cuda" else 0
    want = cs.expect_counts(fused_admm_stencil=n, stencil_bwd=n)
    cs.check(counts == want, f"train-scaling gradient: launches {counts} != {want}")
    return grads, routes


def _peak_gb(dev) -> float | None:
    return torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def scaling_gradients(dev, emit, crop, batches, points, settings) -> None:
    """The gradient at each of ``batches`` (at ``crop``; None is the cells')
    against float64, each at the same parameters (after each of ``points``
    AdaBelief steps of the first batch's own trajectory, as the batch-2
    cell takes them), under each cuDNN setting of ``settings``: plainly and
    along the routes the card's forward took; above the first batch, the
    mean of its shards' gradients too (the first setting).  The float64
    reference's seconds and peak memory beside them."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.optim import AdaBelief
    from admm_deconv_tpu_torch.utils.precision import fp32_convs
    from bench_torch import cells

    inputs = {b: scaling_inputs(dev, b, crop) for b in batches}
    model = init_model(dev)
    opt = AdaBelief(model.parameters(), cells.TRAIN_LR)
    shard = batches[0]
    x_shard, t_shard = inputs[shard]
    done = 0
    for steps in points:
        for i in range(done + 1, steps + 1):
            with fp32_convs():
                loss = gmsd_loss(model(x_shard + 0.001 * i), t_shard)
                opt.zero_grad(set_to_none=True)
                loss.backward()
            opt.step()
        done = steps
        state = model.state_dict()
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        for b, (x, t) in inputs.items():
            xi = x + 0.001 * (steps + 1)
            routes64 = []
            _reset_peak(dev)
            t0 = time.perf_counter()
            g64 = cs.reference_gradient(params, xi, t, routes64, follow=False)
            row = {"row": "train-scaling gradient", "shape": list(x.shape),
                   "after_steps": steps, "batch": b, "reference_s": time.perf_counter() - t0,
                   "reference_peak_gb": _peak_gb(dev)}
            for setting in settings:
                grads, routes = port_gradient(dev, state, xi, t, setting)
                row[setting] = {"flips": cs.route_flips(routes, routes64),
                                "plain": cs.gradient_summary(grads, g64),
                                "routed": cs.gradient_summary(grads, cs.reference_gradient(
                                    params, xi, t, routes, follow=True))}
            if b > shard:
                shards = [port_gradient(dev, state, xi[k:k + shard], t[k:k + shard],
                                        settings[0])[0] for k in range(0, b, shard)]
                mean = {n: sum(s[n] for s in shards) / len(shards) for n in shards[0]}
                row[f"{settings[0]}, mean of the batch-{shard} shards"] = {
                    "plain": cs.gradient_summary(mean, g64)}
            emit(row)


CONV_PASSES = ("forward", "data_grad", "weight_grad")


def conv_calls(dev, batch: int, crop=None) -> dict:
    """Each convolution of the flagship (init parameters) as one fp32 step
    with cuDNN calls it at ``batch``: its module, input and output
    cotangent, by name."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.utils.precision import fp32_convs

    model = init_model(dev)
    x, t = scaling_inputs(dev, batch, crop)
    calls = {}

    def hook(module, args, out, name):
        cs.check(name not in calls, f"{name} ran twice in one forward")
        calls[name] = {"module": module, "x": args[0].detach(),
                       "needs_data_grad": args[0].requires_grad}
        out.register_hook(lambda g: calls[name].update(g=g.detach()))

    handles = [m.register_forward_hook(lambda mod, a, o, name=name: hook(mod, a, o, name))
               for name, m in model.named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with fp32_convs():
        gmsd_loss(model(x + 0.001), t).backward()
    for h in handles:
        h.remove()
    return calls


def conv_pass(call: dict, which: str, dtype=torch.float32):
    """One pass of a captured convolution in ``dtype``, through the aten ops
    the model's own call and its autograd reach: ``aten::convolution`` for
    the forward (with the bias), ``aten::convolution_backward`` for the data
    gradient or for the weight gradient (with the bias's)."""
    m = call["module"]
    transposed = isinstance(m, torch.nn.ConvTranspose2d)
    x, w, g = (v.to(dtype) for v in (call["x"], m.weight.detach(), call["g"]))
    geometry = (list(m.stride), list(m.padding), list(m.dilation), transposed,
                list(m.output_padding) if transposed else [0, 0], m.groups)
    if which == "forward":
        return torch.ops.aten.convolution(x, w, m.bias.detach().to(dtype), *geometry)
    mask = [which == "data_grad", which == "weight_grad", which == "weight_grad"]
    out = torch.ops.aten.convolution_backward(g, x, w, [m.out_channels], *geometry, mask)
    return out[0] if which == "data_grad" else out[1]


def conv_passes(calls: dict) -> None:
    """Every pass of every captured convolution, each in a range of its own."""
    from torch.autograd.profiler import record_function

    for name, call in calls.items():
        for which in CONV_PASSES:
            with record_function(f"conv {name} {which}"):
                conv_pass(call, which)


def conv_rows(dev, emit, crop, batches, setting: str) -> None:
    """For each convolution of the flagship at each of ``batches`` (at
    ``crop``; its operands captured from one fp32 step under the cuDNN
    ``setting``): the kernels of its forward, data gradient and weight
    gradient, each pass run alone under the same setting and the profiler
    and read under its aten op (``aten::cudnn_convolution*``,
    ``aten::convolution_backward``), with their device ms; each pass's fp32
    error against float64 under the setting and with torch's own
    convolutions; last, the kernels the whole step launched under a
    convolution op of the model that no pass alone launched (none
    expected; the loss's depthwise Sobel filters are left out)."""
    from admm_deconv_tpu_torch.utils.precision import fp32_convs
    from bench_torch import cells, trace

    cuda = dev.type == "cuda"
    for batch in batches:
        with cs.cudnn_as(setting):
            calls = conv_calls(dev, batch, crop)
            with fp32_convs():
                for call in calls.values():  # warm: cuDNN's plans
                    for which in CONV_PASSES:
                        conv_pass(call, which)
                tr = trace.trace_units([lambda: conv_passes(calls)], cuda)
        alone = {}
        for ev in trace.Timeline(tr).device:
            label = next((s for s in ev.stack if s.startswith("conv ")), None)
            if label is None:
                continue
            ops = [s for s in ev.stack if s.startswith("aten::")]
            entry = alone.setdefault(label, {"kernels": [], "device_ms": 0.0, "ops": ops})
            entry["kernels"].append(ev.name)
            entry["device_ms"] += ev.dur / 1e3
        seen = {k for entry in alone.values() for k in entry["kernels"]}
        for name, call in calls.items():
            m = call["module"]
            row = {"row": "train-scaling conv", "cudnn": setting, "batch": batch, "conv": name,
                   "kind": type(m).__name__, "input": list(call["x"].shape),
                   "weight": list(m.weight.shape), "needs_data_grad": call["needs_data_grad"]}
            for which in CONV_PASSES:
                want = conv_pass(call, which, torch.float64)
                errors = {}
                for lib in (setting, "native convolutions"):
                    with fp32_convs(), cs.cudnn_as(lib):
                        errors[lib] = cells.leaf_error(conv_pass(call, which), want)
                entry = alone.get(f"conv {name} {which}", {})
                row[which] = {"kernels": entry.get("kernels", []),
                              "device_ms": entry.get("device_ms"), "ops": entry.get("ops"),
                              "rel_err_float64": errors}
            emit(row)
        with cs.cudnn_as(setting):
            step = model_step_kernels(dev, batch, crop)
        emit({"row": "train-scaling conv kernels", "cudnn": setting, "batch": batch,
              "shape": list(scaling_inputs(dev, batch, crop)[0].shape),
              "step_kernels_under_convolutions": sorted(step),
              "not_seen_alone": sorted(step - seen)})


def model_step_kernels(dev, batch: int, crop=None) -> set:
    """The kernel names one traced fp32 forward and backward of the
    flagship at ``batch`` launches under a convolution op of the model
    (the cells' ``cudnn_ms``, less the loss's depthwise Sobel filters)."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.utils.precision import fp32_convs
    from bench_torch import cells, trace

    model = init_model(dev)
    x, t = scaling_inputs(dev, batch, crop)

    def step():
        with fp32_convs():
            gmsd_loss(model(x + 0.001), t).backward()

    step()
    tl = trace.Timeline(trace.trace_units([step], dev.type == "cuda"))
    return {ev.name for ev in tl.device
            if cells.classify_train(ev.name, ev.stack, ev.ranges) == "cudnn_ms"
            and not any("depthwise" in s for s in ev.stack) and "depthwise" not in ev.name}


def scaling_rows(dev, emit) -> None:
    """Each of ``bench_suite.py``'s ``--train-scaling`` rows by the train
    cells' own run (``cells.run_train``, 100 timed steps; the fp32 rows at
    batches 2 and 8 are the cells): ms/step, images/s, busy, idle share,
    the device ms by layer and by kernel name, the step's peak memory, the
    float64 reference's seconds and peak memory, and the last step's
    readings against float64 (the bf16 rows held to no limit)."""
    from bench_torch import cells

    def by_layer_and_name(name, stack, ranges):
        return f"{cells.classify_train(name, stack, ranges)} | {name}"

    check_step = cells.check_step
    for state_dtype in (None, "bfloat16"):
        for batch in TRAIN_SCALING_BATCHES:
            seen = {}

            def timed_check(*args, **kwargs):
                seen["step_peak_gb"] = _peak_gb(dev)
                _reset_peak(dev)
                t0 = time.perf_counter()
                out = check_step(*args, **kwargs)
                seen["reference_s"] = time.perf_counter() - t0
                seen["reference_peak_gb"] = _peak_gb(dev)
                return out

            cell = cells.FLAGSHIP_B8 if batch == 8 else cells.FLAGSHIP
            _reset_peak(dev)
            with cs._patched((cells, "check_step", timed_check)):
                run = cells.run_train(dev, cells.DEFAULT_SEEDS[cell], TRAIN_SCALING_REPEATS,
                                      TRAIN_SCALING_SIZE, cell=cell, batch=batch,
                                      state_dtype=state_dtype, classify=by_layer_and_name)
            by_name = run.breakdown.pop("layers_ms") or {}  # {} on the CPU
            layers = {}
            for key, ms in by_name.items():
                layer = key.split(" | ")[0]
                layers[layer] = layers.get(layer, 0.0) + ms
            s = float(np.mean(run.samples_s))
            check = run.checks["last timed step"]
            emit({"row": "train-scaling step", "batch": batch,
                  "state_dtype": state_dtype or "float32",
                  "is_cell": cell if state_dtype is None and batch in (2, 8) else None,
                  "shape": list(run.shape), "steps": len(run.samples_s),
                  "ms_per_step": 1e3 * s, "median_ms": 1e3 * float(np.median(run.samples_s)),
                  "images_per_s": batch / s, "setup_s": run.setup_s, **seen,
                  "busy_ms": run.breakdown.get("busy_ms"),
                  "idle_share": run.breakdown.get("idle_share"),
                  "cudnn_ms": layers.get("cudnn_ms"), "layers_ms": layers,
                  "work": run.work, "launches": run.launches,
                  "launches_ok": run.launches == run.launches_expected,
                  "check_ok": check["ok"], "held_to_limits": state_dtype is None,
                  "loss_rel_err": check["loss_rel_err"],
                  **{k: check[k] for k in ("gradient", "gradient_all", "update", "state")},
                  "breakdown": run.breakdown, "ms_by_layer_and_kernel": by_name})


def train_scaling(dev, card: dict) -> None:
    """The ``--train-scaling`` rows (module docstring)."""
    def emit(row: dict) -> None:
        print(json.dumps(card | row), flush=True)

    conv_rows(dev, emit, None, TRAIN_SCALING_CONV_BATCHES, "cudnn")
    conv_rows(dev, emit, TRAIN_SCALING_PROBE, TRAIN_SCALING_CONV_BATCHES, "cudnn deterministic")
    scaling_gradients(dev, emit, None, TRAIN_SCALING_BATCHES, TRAIN_SCALING_POINTS,
                      ("cudnn", "native convolutions"))
    scaling_gradients(dev, emit, TRAIN_SCALING_PROBE, TRAIN_SCALING_CONV_BATCHES, (0,),
                      ("cudnn", "cudnn deterministic", "native convolutions"))
    scaling_rows(dev, emit)


def train_check_rows(dev, card: dict, runs: int) -> None:
    """The ``--train-check`` rows (module docstring)."""
    from bench_torch import cells

    def emit(row: dict) -> None:
        print(json.dumps(card | row), flush=True)

    def by_layer_and_name(name, stack, ranges):
        return f"{cells.classify_train(name, stack, ranges)} | {name}"

    check_step = cells.check_step
    failed = []
    for k, cell in ((k, cell) for cell in STEP_CELLS for k in range(1, runs + 1)):
        seen = {}

        def captured(before, after, grads, loss, x, t):
            seen.update(params=before["params"], grads=grads, x=x, t=t)
            return check_step(before, after, grads, loss, x, t)

        with cs._patched((cells, "check_step", captured)):
            run = cells.run_train(dev, cells.DEFAULT_SEEDS[cell], TRAIN_SCALING_REPEATS,
                                  TRAIN_SCALING_SIZE, cell=cell, classify=by_layer_and_name)
        check = run.checks["last timed step"]
        params, x, t = seen["params"], seen["x"], seen["t"]
        routes64 = []
        cs.reference_gradient(params, x, t, routes64, follow=False)
        routes = port_gradient(dev, params, x, t, "cudnn")[1]
        routed = cs.reference_gradient(params, x, t, routes, follow=True)
        kernels = sorted({key.split(" | ", 1)[1] for key in run.breakdown.get("layers_ms") or {}
                          if key.startswith("cudnn_ms | ")})
        if not check["ok"]:
            failed.append((cell, k))
        emit({"row": "train check", "cell": cell, "run": k, "check_ok": check["ok"],
              "launches_ok": run.launches == run.launches_expected,
              "ms_per_step": 1e3 * float(np.mean(run.samples_s)),
              "loss_rel_err": check["loss_rel_err"],
              **{kind: check[kind] for kind in ("gradient", "gradient_all", "update", "state")},
              "flips": cs.route_flips(routes, routes64),
              "step_gradient_along_its_routes": cs.gradient_summary(seen["grads"], routed),
              "cudnn_kernels": len(kernels), "cudnn_kernel_names": kernels})
    emit({"row": "train check summary", "runs": runs, "failed": len(failed),
          "failed_runs": failed})


def recompute_rows(card: dict, dev, variants: list[str], steps: int) -> None:
    """The ``--step-recompute`` rows (module docstring)."""
    summary = {}
    for name in variants:
        setting, prox_impl, shadow = RECOMPUTE_VARIANTS[name]
        out = cs.step_recompute(dev, steps, setting, prox_impl, shadow)
        summary[name] = {"disagreeing": out["disagreeing_steps"],
                         "float64_failed": out["float64_failed"],
                         "agreeing_max": out["agreeing_max"],
                         "forwards_differ": out["forwards_differ"],
                         "shadow_misses": out["shadow_miss_count"]}
        print(json.dumps(card | {"row": "step recompute", "variant": name, **out}), flush=True)
    print(json.dumps(card | {"row": "step recompute summary", "steps": steps, **summary}),
          flush=True)


# The split settings of ``conv_setting``: the passes (of ``blocks._on_torch_own``)
# each runs on torch's own convolutions, for every convolution or for those of
# one kernel size; the other passes run as ``blocks._Convolution`` runs them.
SPLIT_SETTINGS = {"native forward": ("forward",), "native wgrad": ("weight",),
                  "hybrid": ("forward", "weight"), "native wgrad 5x5": ("weight",)}
SPLIT_KERNEL = {"native wgrad 5x5": (5, 5)}


def conv_setting(name: str):
    """A block with the model's convolutions under ``name``: a setting of
    ``cs.cudnn_as``; ``"parent convs"``, each convolution the torch module
    it extends (every pass on cuDNN as the caller sets it, not through
    ``blocks._Convolution``); ``"cudnn nhwc"``, cuDNN handed the NHWC
    activations as they lie (channels-last NCHW views, not copied to
    contiguous NCHW); or a split of ``SPLIT_SETTINGS``: ``blocks._Convolution``
    with the passes it names on torch's own CUDA convolutions, the others on
    cuDNN's deterministic algorithms."""
    from admm_deconv_tpu_torch.models import blocks
    from admm_deconv_tpu_torch.utils.precision import fp32_convs

    def module_pass(conv, x):  # the torch module's own forward, as the parent ran it
        return super(blocks._CardConv, conv).forward(x)

    if name == "parent convs":  # every pass on cuDNN as the caller sets it
        return cs._patched((blocks._CardConv, "forward", module_pass))
    if name == "cudnn nhwc":
        def conv_nhwc(conv, x):
            with fp32_convs():
                return module_pass(conv, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return cs._patched((blocks, "_conv_nhwc", conv_nhwc))
    if name in SPLIT_SETTINGS:
        passes, kernel = SPLIT_SETTINGS[name], SPLIT_KERNEL.get(name)

        def on_torch_own(conv_pass, kernel_size):
            return conv_pass in passes and kernel in (None, tuple(kernel_size))
        return cs._patched((blocks, "_on_torch_own", on_torch_own))
    return cs.cudnn_as(name)


def port_gradient_f64(dev, state: dict, x, t) -> dict:
    """The port's own model in float64 (the bank on its plain composition,
    which computes in the input's dtype) at ``state`` on ``x``: its
    gradient, to hold the port's formulas to the float64 reference."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.models import AdmmDenoiser

    model = AdmmDenoiser(prox_impl="xla").to(dev).double()
    model.load_state_dict(state)
    gmsd_loss(model(x.double()), t.double()).backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def port_gradient_under(setting: str, dev, state: dict, x, t, cotangents=None):
    """``cs.port_gradient`` with the convolutions under ``conv_setting``;
    ``"plain bank"`` is cuDNN with the bank on its plain composition,
    ``"float64"`` the port's model in float64 (``port_gradient_f64``)."""
    if setting == "float64":
        return port_gradient_f64(dev, state, x, t), [], {}
    if setting == "plain bank":
        return cs.port_gradient(dev, state, x, t, "cudnn", "xla", cotangents=cotangents)
    if setting == "bank float64":  # the bank's solve alone in float64, plainly
        from admm_deconv_tpu_torch.models import zoo

        solve = zoo.tv_deconvolve

        def solve64(y, lam, rho, prox_impl, **kw):
            return solve(y.double(), lam=lam.double(), rho=rho.double(), prox_impl="xla",
                         **kw).to(y.dtype)
        with cs._patched((zoo, "tv_deconvolve", solve64)):
            return cs.port_gradient(dev, state, x, t, "cudnn", "xla", cotangents=cotangents)
    with conv_setting(setting):
        return cs.port_gradient(dev, state, x, t,
                                setting if setting in ("cudnn", "cudnn deterministic",
                                                       "native convolutions") else "cudnn",
                                cotangents=cotangents)


def reference_with_cotangents(params: dict, x, t, routes: list) -> tuple[dict, dict]:
    """The float64 gradient along ``routes`` (``cs.reference_gradient``) and
    the float64 cotangents at ``cs.RECOMPUTE_POINTS`` where the output is
    not 0 (NHWC, the concat's as the two branches' side by side)."""
    from bench_torch import train_reference as ref

    store = {}

    def keep(name, v, nchw=True):
        live = v.detach() != 0  # as the port's probes keep it

        def hook(g):
            g = (g.detach() * live)
            store[name] = g.permute(0, 2, 3, 1) if nchw else g
        v.register_hook(hook)
        return v

    up_down, autoencoder, bank, flagship = (ref.up_down, ref.autoencoder, ref.denoiser_bank,
                                            ref.flagship)

    def up_down_kept(params, name, v):
        out = up_down(params, name, v)
        return keep(name, out) if name in ("UpDownBlock_0", "UpDownBlock_1") else out

    def autoencoder_kept(params, v, level: int = 5):
        out = autoencoder(params, v, level)
        return keep("Autoencoder_0", out) if level == 5 else out

    with cs._patched((ref, "up_down", up_down_kept), (ref, "autoencoder", autoencoder_kept),
                     (ref, "denoiser_bank",
                      lambda *a, **k: keep("DenoiserBank_0", bank(*a, **k))),
                     (ref, "flagship", lambda *a, **k: keep("output", flagship(*a, **k), False))):
        grads = cs.reference_gradient(params, x, t, routes, follow=True)
    store["concat"] = torch.cat([store["Autoencoder_0"], store["DenoiserBank_0"]], dim=-1)
    return grads, store


def take_apart(dev, params: dict, state: dict, x, t, settings) -> dict:
    """The cell's gradient at one state under each of ``settings``
    (``conv_setting``), each pass against float64 plainly and along the
    routes its own forward took, with the relative error of its cotangent
    at each of ``cs.RECOMPUTE_POINTS`` against float64's along the same
    routes."""
    from bench_torch.cells import whole_error

    routes64 = []
    g64 = cs.reference_gradient(params, x, t, routes64, follow=False)
    out = {}
    for setting in settings:
        cot = {}
        grads, routes, _ = port_gradient_under(setting, dev, state, x, t, cot)
        g64r, cot64 = reference_with_cotangents(params, x, t, routes)
        out[setting] = {
            "flips": cs.route_flips(routes, routes64),
            "plain": cs.gradient_summary(grads, g64),
            "routed": cs.gradient_summary(grads, g64r),
            "routed_whole_float64_against_own": whole_error(g64r, g64)["all leaves"],
            "cotangents_routed": {p: float(torch.linalg.vector_norm(cot[p] - cot64[p].float())
                                           / torch.linalg.vector_norm(cot64[p]))
                                  for p in cs.RECOMPUTE_POINTS}}
    return out


def route_hunt_rows(card: dict, dev, settings: list[str], steps: int) -> None:
    """The ``--route-hunt`` rows (module docstring)."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.models import AdmmDenoiser, init_parameters
    from admm_deconv_tpu_torch.optim import AdaBelief
    from admm_deconv_tpu_torch.utils.precision import fp32_convs
    from bench_torch import train_reference
    from bench_torch.cells import (
        DEFAULT_SEEDS,
        FLAGSHIP,
        TRAIN_LR,
        TRAIN_TOLS,
        leaf_errors,
        train_inputs,
        whole_error,
    )

    def emit(row: dict) -> None:
        print(json.dumps(card | row), flush=True)

    seed = DEFAULT_SEEDS[FLAGSHIP]
    x_np, t_np = train_inputs(seed, cs.FLAGSHIP_SHAPE)
    x, t = torch.from_numpy(x_np).to(dev), torch.from_numpy(t_np).to(dev)
    summary = {}
    for setting in settings:
        model = init_parameters(AdmmDenoiser(), torch.Generator().manual_seed(seed)).to(dev)
        opt = AdaBelief(model.parameters(), TRAIN_LR)
        failing, passing, reads = 0, 0, []
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            xi = x + 0.001 * i
            with conv_setting(setting), fp32_convs():
                loss = gmsd_loss(model(xi), t)
                opt.zero_grad(set_to_none=True)
                loss.backward()
            if i % HUNT_EVERY == 0:
                params = {n: p.detach().clone() for n, p in model.named_parameters()}
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
                g64 = train_reference.loss_and_grads(params, xi, t)[1]
                whole = whole_error(grads, g64)["all leaves"]
                leaf = max(leaf_errors(grads, g64).values())
                ok = whole <= TRAIN_TOLS["gradient_all"] and leaf <= TRAIN_TOLS["gradient"]
                reads.append([i, whole, leaf])
                if (not ok and failing < HUNT_FAILING) or (ok and passing < HUNT_PASSING):
                    failing, passing = failing + (not ok), passing + ok
                    emit({"row": "route hunt read", "setting": setting, "step": i, "ok": ok,
                          "whole": whole, "worst_leaf": leaf,
                          "taken_apart": take_apart(dev, params, model.state_dict(), xi, t,
                                                    (setting, "native convolutions"))})
            opt.step()
        bad = [r for r in reads if r[1] > TRAIN_TOLS["gradient_all"]
               or r[2] > TRAIN_TOLS["gradient"]]
        summary[setting] = {"reads": len(reads), "failed": [r[0] for r in bad],
                            "whole_max": max(r[1] for r in reads),
                            "whole_median": float(np.median([r[1] for r in reads])),
                            "leaf_max": max(r[2] for r in reads),
                            "seconds": time.perf_counter() - t0}
        emit({"row": "route hunt", "setting": setting, "steps": steps, **summary[setting],
              "readings": reads})
    emit({"row": "route hunt summary", **summary})


def settings_at_states_rows(card: dict, dev, settings: list[str], steps: int) -> None:
    """The ``--settings-at-states`` rows (module docstring)."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.models import AdmmDenoiser, init_parameters
    from admm_deconv_tpu_torch.optim import AdaBelief
    from admm_deconv_tpu_torch.utils.precision import fp32_convs
    from bench_torch import train_reference
    from bench_torch.cells import DEFAULT_SEEDS, FLAGSHIP, TRAIN_LR, TRAIN_TOLS, train_inputs

    seed = DEFAULT_SEEDS[FLAGSHIP]
    x_np, t_np = train_inputs(seed, cs.FLAGSHIP_SHAPE)
    x, t = torch.from_numpy(x_np).to(dev), torch.from_numpy(t_np).to(dev)
    model = init_parameters(AdmmDenoiser(), torch.Generator().manual_seed(seed)).to(dev)
    opt = AdaBelief(model.parameters(), TRAIN_LR)
    reads = {s: [] for s in settings}
    for i in range(1, steps + 1):
        xi = x + 0.001 * i
        if i % STATES_EVERY == 0:
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
            g64 = train_reference.loss_and_grads(params, xi, t)[1]
            row = {}
            for k, setting in enumerate(settings):
                grads = port_gradient_under(setting, dev, model.state_dict(), xi, t)[0]
                e = cs.gradient_summary(grads, g64)
                reads[setting].append([i, e["whole"], e["worst"], e["lam"]])
                row[f"{k} {setting}"] = [e["whole"], e["worst"], e["lam"], e["worst_leaves"][0]]
            print(json.dumps(card | {"row": "settings at a state", "step": i, **row}), flush=True)
        with fp32_convs():
            loss = gmsd_loss(model(xi), t)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        opt.step()
    summary = {}
    for setting, r in reads.items():
        a = np.array(r)
        summary[setting] = {
            "states": len(a),
            "failing": [int(s) for s, w, lf, _ in a if w > TRAIN_TOLS["gradient_all"]
                        or lf > TRAIN_TOLS["gradient"]],
            "whole_above": int((a[:, 1] > STATES_ABOVE[0]).sum()),
            "leaf_above": int((a[:, 2] > STATES_ABOVE[1]).sum()),
            **{f"{k}_{q}": float(f(a[:, j])) for j, k in ((1, "whole"), (2, "leaf"), (3, "lam"))
               for q, f in (("median", np.median), ("p90", lambda v: np.percentile(v, 90)),
                            ("max", np.max))}}
    print(json.dumps(card | {"row": "settings at states summary", "steps": steps,
                             "every": STATES_EVERY, "above": STATES_ABOVE, **summary}), flush=True)


def step_cell_rows(settings: list[str], rounds: int) -> None:
    """The ``--step-cells`` rows (module docstring)."""
    from bench_torch import __main__ as bench_main

    for r in range(rounds):
        for setting in (settings if r % 2 == 0 else settings[::-1]):
            print(json.dumps({"step_cells_setting": setting, "round": r}), flush=True)
            with conv_setting(setting):
                bench_main.main(["--repeats", "100"], only=list(STEP_CELLS))


def trainer_phase_rows(dev, card: dict) -> None:
    """The ``--trainer-phases`` row (module docstring)."""
    trainer_ms = cs.phase_trainer(dev, 0)
    dp = cs.phase_data_parallel(dev, 0)
    print(json.dumps(card | {"row": "trainer phases", "chip_smoke": os.path.abspath(cs.__file__),
                             "trainer_ms": trainer_ms, "data_parallel_ms": dp["ms"],
                             "data_parallel_alone_ms": dp["alone_ms"],
                             "data_parallel_equal": dp["equal"]}), flush=True)


def control_rows(dev, card: dict, name: str, runs: int, size: str = "full") -> None:
    """The ``--control-reads`` rows (module docstring)."""
    from bench_torch import controls

    missed = []
    for k in range(1, runs + 1):
        checks = controls.run_control(name, dev, None, CONTROL_READ_REPEATS, size)
        rejected = not all(c["ok"] for c in checks.values())
        if not rejected:
            missed.append(k)
        print(json.dumps(card | {"row": "control read", "control": name, "run": k,
                                 "rejected": rejected, "checks": checks}), flush=True)
    print(json.dumps(card | {"row": "control reads summary", "control": name, "runs": runs,
                             "not_rejected": len(missed), "not_rejected_runs": missed}),
          flush=True)


def window_rows(out_dir: str) -> None:
    """The ``--windows`` runs (module docstring)."""
    import contextlib

    from bench_torch import __main__ as bench_main

    for r in range(1, WINDOW_ROUNDS + 1):
        for repeats in WINDOW_REPEATS[::1 if r % 2 else -1]:
            path = os.path.join(out_dir, f"r{repeats}", f"{r:02d}.log")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            t0 = time.perf_counter()
            with open(path, "w") as f, contextlib.redirect_stdout(f):
                code = bench_main.main(["--repeats", str(repeats)], only=list(WINDOW_CELLS))
            print(json.dumps({"window_round": r, "repeats": repeats, "exit_code": code,
                              "seconds": time.perf_counter() - t0, "log": path}), flush=True)


def tiled_arms(arms: list[str]) -> None:
    """Of the four-card cell alone, then after a one-card cell in this
    process, then its controls, those ``arms`` names; exits non-zero when
    any arm fails."""
    from bench_torch import cells
    from bench_torch import __main__ as bench_main

    only = [cells.TILED]
    codes = {}
    for arm in (a for a in TILED_ARMS if a in arms):
        print(json.dumps({"tiled_arm": arm}), flush=True)
        if arm == "after":
            run = cells.run_solve(torch.device("cuda", 0), cells.DEFAULT_SEEDS["solve_1080p_b4"],
                                  100)
            print(json.dumps({"tiled_arm": "after solve_1080p_b4", "solve_1080p_b4_iters_per_s":
                              cells.ITERS / float(np.mean(run.samples_s)), "ok": run.ok}),
                  flush=True)
        argv = ["--controls", "--repeats", str(TILED_CONTROL_REPEATS)] if arm == "controls" \
            else []
        codes[arm] = bench_main.main(argv, only=only)
    print(json.dumps({"tiled_arms_exit_codes": codes}), flush=True)
    if any(codes.values()):
        sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="the row march's geometry sweep")
    ap.add_argument("--policy", action="store_true", help="solve_auto's policy fields, A/B")
    ap.add_argument("--frame", action="store_true",
                    help="the 4K frame cell's check readings and fp32-state breakdown")
    ap.add_argument("--ttq", action="store_true",
                    help="the solve-to-tolerance cell's check readings and breakdown")
    ap.add_argument("--composite", action="store_true",
                    help="the composite cell's check readings and breakdown")
    ap.add_argument("--layer", action="store_true",
                    help="the TV-layer step cell's check readings and breakdown")
    ap.add_argument("--anderson", action="store_true",
                    help="the Anderson cell's check readings and breakdown, and its controls")
    ap.add_argument("--train-scaling", action="store_true",
                    help="the flagship step at batches 2, 4 and 8: its gradient against float64 "
                         "by route and cuDNN kernel, and each row's readings")
    ap.add_argument("--tiled", action="store_true",
                    help="the four-card cell alone and after one-card work, and its controls")
    ap.add_argument("--arms", default=",".join(TILED_ARMS),
                    help=f"with --tiled, the arms to run, of {','.join(TILED_ARMS)}")
    ap.add_argument("--train-check", type=int, default=0, metavar="N",
                    help="both flagship step cells' checks, N runs each in this process")
    ap.add_argument("--windows", metavar="DIR",
                    help="the host-bound cells at 100 and 400 timed units, logs under DIR")
    ap.add_argument("--control-reads", nargs=2, metavar=("NAME", "N"),
                    help="one control of bench_torch/controls.py through its cell's check, N runs")
    ap.add_argument("--step-recompute", metavar="VARIANTS",
                    help="the recompute detector under each comma-separated variant of "
                         f"{','.join(RECOMPUTE_VARIANTS)}")
    ap.add_argument("--steps", type=int,
                    help="with --step-recompute, --route-hunt or --settings-at-states, the "
                         "steps of the trajectory (default: the mode's own)")
    ap.add_argument("--route-hunt", metavar="SETTINGS",
                    help="the cell's trajectory under each comma-separated cuDNN setting of "
                         f"{','.join(HUNT_SETTINGS)}, its gradient against float64 every "
                         f"{HUNT_EVERY} steps, failing reads taken apart")
    ap.add_argument("--settings-at-states", metavar="SETTINGS",
                    help="the cell's trajectory with cuDNN as the cell has it; every "
                         f"{STATES_EVERY} steps its gradient under each comma-separated setting "
                         "against float64")
    ap.add_argument("--conv-passes", metavar="SETTINGS",
                    help="each convolution's three passes at batches 2 and 8 under each "
                         "comma-separated cuDNN setting: kernels, device ms, fp32 error")
    ap.add_argument("--step-cells", metavar="SETTINGS",
                    help="the two step cells by python3 -m bench_torch under each "
                         "comma-separated cuDNN setting, in turns")
    ap.add_argument("--rounds", type=int, default=2, help="with --step-cells, the rounds")
    ap.add_argument("--trainer-phases", action="store_true",
                    help="chip_smoke.py's phase_trainer and phase_data_parallel alone: ms/step")
    ap.add_argument("--rhs", action="store_true",
                    help="the x-update's complex rhs: the solve cells by kernel, the pass alone")
    args = ap.parse_args()
    if args.tiled:  # before this process makes a CUDA context
        arms = args.arms.split(",")
        if set(arms) - set(TILED_ARMS):
            ap.error(f"--arms takes {TILED_ARMS}, not {arms}")
        tiled_arms(arms)
        return
    dev = cs.phase_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    cs.phase_build()
    card = dict(zip(("card", "power_limit"), (f.strip() for f in cs.nvidia_smi().split(","))))
    if args.trainer_phases:
        trainer_phase_rows(dev, card)
    elif args.rhs:
        rhs_rows(dev, gen, card)
    elif args.route_hunt:
        route_hunt_rows(card, dev, args.route_hunt.split(","),
                        args.steps or HUNT_STEPS)
    elif args.settings_at_states:
        settings_at_states_rows(card, dev, args.settings_at_states.split(","),
                                args.steps or STATES_STEPS)
    elif args.conv_passes:
        for setting in args.conv_passes.split(","):
            conv_rows(dev, lambda row: print(json.dumps(card | row), flush=True), None,
                      TRAIN_SCALING_CONV_BATCHES, setting)
    elif args.step_cells:
        step_cell_rows(args.step_cells.split(","), args.rounds)
    elif args.step_recompute:
        variants = args.step_recompute.split(",")
        if set(variants) - set(RECOMPUTE_VARIANTS):
            ap.error(f"--step-recompute takes {sorted(RECOMPUTE_VARIANTS)}, not {variants}")
        recompute_rows(card, dev, variants, args.steps or cs.RECOMPUTE_STEPS)
    elif args.control_reads:
        name, runs = args.control_reads
        control_rows(dev, card, name, int(runs))
    elif args.windows or args.train_check:
        if args.windows:
            window_rows(args.windows)
        if args.train_check:
            train_check_rows(dev, card, args.train_check)
    elif args.policy:
        policy_rows(dev, card)
    elif args.frame:
        frame_rows(dev, gen, card)
    elif args.ttq:
        ttq_rows(dev, card)
    elif args.composite:
        composite_rows(dev, card)
    elif args.layer:
        layer_rows(dev, card)
    elif args.anderson:
        anderson_rows(dev, card)
    elif args.train_scaling:
        train_scaling(dev, card)
    elif args.sweep:
        bwd_sweep(dev, gen)
        sweep(dev, gen)
    else:
        cs.phase_kernel_times(dev, gen)
        cs.phase_new_kernel_times(dev, gen)
        cs.phase_halo_times(dev, gen)
        profiler_times(dev, gen)
        cs.phase_profile(cs.phase_main_path(dev, gen))
        tiled_rows(dev)
    print(f"[times] nvidia-smi: {cs.nvidia_smi()}")


if __name__ == "__main__":
    main()
