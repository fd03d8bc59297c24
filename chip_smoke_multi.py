#!/usr/bin/env python3
"""Multi-card smoke run of the PyTorch/CUDA port: the H-tiled solvers and
data-parallel training across the cards of one host, one process a card,
NCCL between them.

The counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` and
``_dryrun_two_process``.  Run from the root of a checkout:

    python3 chip_smoke_multi.py [--world N] [--size full|cut|small] [--device cuda|cpu]
                                [--deadline SECONDS] [--seed 0]
    python3 chip_smoke_multi.py --probe-gradient [--world N]

The launcher starts ``--world`` processes of this script (by default one
for every card), each given ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``
and ``RANK``.  It builds the kernels first (one nvcc a source, all at
once), relays rank 0's output, and kills every rank as soon as one fails or
at ``--deadline``, printing the tail of each failing or hung rank's output
and exiting non-zero.  Rank 0's last line, ``{"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": N}}``, is printed only when every
rank exited 0.  Without a card the script exits 2; ``--device cpu`` runs
the same phases on gloo (the tests).  ``--size cut`` keeps the widths and
cuts the depth (``chip_smoke.py``'s one-card phase); ``--size small`` cuts
the shapes, the iterations and the training model (the CPU tests).
``--probe-gradient`` runs no ranks: it reads, on one card and its host's
CPU, how far phase F's one-process gradient on the global batch lies from
the mean of its shards' gradients and from a float64 gradient, and which
module's output moves with the batch size.

Every rank joins through ``parallel.distributed.initialize()`` (``env://``)
and runs, in order:

A. the group: the cards' names and power limits, ``nvidia-smi topo -m``
   and NCCL's version (rank 0); each rank on a card of its own (device
   index and UUID gathered); every mesh made on every rank, a sub-mesh
   included; one warm-up ``all_to_all_single``, all-gather and
   ``all_reduce`` on every group the later phases use, timed as set-up;
   the transports NCCL chose, from rank 0's ``NCCL_DEBUG`` file;
B. ``dryrun_multichip``'s cases at its shapes: a data-parallel ``Trainer``
   epoch (``ADMMDeconv`` 5x5, 5 iterations, remat, and a 1x1 conv; mse;
   batch N of 32^2), the tiled adaptive solve (check_every 3), fold1, the
   tiled Anderson solve (m 2, aa_interval 3), the data x tile mesh and the
   tiled composite, each against the one-card solver or trainer on the
   same inputs and the same bits on every rank;
C. the tiled solvers at full width: ``bench.py``'s 1080p batch 4 and 4K
   frame (a 2-frame 4K batch on the data x tile mesh), 50 iterations, the
   7x7 motion PSF; plain fp32 and bf16 state, the adaptive block solve (96
   iterations, check_every 8, tolerances 0), the composite solver and
   Anderson (m 5, every step and every 8th), on ``{"tile": 2}`` (the first
   two ranks), ``{"tile": N}`` and ``{"data": 2, "tile": N/2}``; each
   against the one-card solver on rank 0, the same bits on every rank,
   kernel Q2-4's launches on every rank; iterations/s of the slowest rank
   and of rank 0 beside the one card's and the scaling efficiency; a
   profile of the fp32 solve on rank 0 (the share under ``nccl:*``, the
   ``direct_copy`` kernels);
D. kernel Q2-4 on the halo rows NCCL delivered: one iteration's tile,
   duals and halo rows captured from a tiled solve on every rank, the
   kernel against its plain twin bit for bit, the halo rows against the
   neighbours' rows, and the gathered tiles against kernel Q2-1 on the
   whole plane stack bit for bit; Q2-4's time at the real tile stacks
   beside its HBM floor;
F. data-parallel training on ``configs/train_cfg.json`` (admm_denoiser,
   256^2, gmsd, AdaBelief) at a global batch of 2 a card: the replicas'
   parameters bit-equal after every step; step 1's all-reduced gradient
   against one process on the global batch at once and against one process
   stepping on the mean of the same shards' gradients; the parameters after
   3 steps against the latter, and printed beside the former (both run on
   rank 0 before it joins the group); ms/step on every rank beside one card
   without a group at batch 2;
E. the collectives alone at the sizes phase C hands them (the re-shard
   ``all_to_all_single``, the halo all-gather, the residual all-reduce)
   and the trainer's flat gradient all-reduce at phase F's size, each
   beside its NVLink floor;
H. on a world of four: ``bench_torch``'s four-card cell
   (``tiled_4k_b4_tile4``: ``tiled_tv_deconvolve`` on ``{"tile": 4}``,
   four 4K frames, 50 iterations; at ``--size small`` its tiny
   rehearsal) through the cell's own run, one timed unit: rank 0's x against
   the float64 reference, the same bits on every rank, 49 Q2-4 launches on
   every rank, and its one-card yardstick on rank 0's card; then its three
   controls (the halo's neighbours swapped, one iteration short, lam x
   1.05), each of which the check must reject;
G. the train CLI (``scripts.train --coordinator env://``, ``mesh_batch`` 0)
   across the ranks for one epoch of 4 seeded pairs a card written as PNGs,
   a global batch of 2 a card: checkpoints and logs from rank 0 only, the
   Q2-1/Q2-2 launches on every rank, the epoch's means equal on every rank.

Imports torch, numpy, the port and ``chip_smoke.py``'s helpers; never JAX
or the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke as cs
from bench_torch import cells as bench_cells
from bench_torch import ranks

REPO = os.path.dirname(os.path.abspath(__file__))
# NVLink between the cards of one host, each way (hopper-kernels guide).
NVLINK_BYTES_PER_S = 450e9
# The run's sizes.  "full": phase C's shapes and depths, phases F and G on
# the production config.  "cut": the same widths at a cut depth (the 1080p
# batch 4 alone, 10 iterations, one timed repeat; the production config at
# 256^2), for chip_smoke.py's one-card phase: every plane stack it hands a
# kernel is one chip_smoke.py holds against the kernel's plain twin.
# "small": shapes and iterations cut and the smoke model trained at 16^2,
# for the CPU tests only.  A shape of None is not run.
SIZES = {
    "full": {"bench": cs.BENCH_SHAPE, "frame": cs.FRAME_4K, "frame2": (2, *cs.FRAME_4K[1:]),
             "iters": cs.BENCH_ITERS, "adaptive": (cs.TILED_ADAPTIVE_ITERS, cs.CHECK_EVERY),
             "aa": (cs.BENCH_ITERS - 1, cs.AA_INTERVAL), "repeats": cs.REPEATS,
             "capture_at": 10, "model": "production", "deadline": 900, "bench_cell": "full"},
    "cut": {"bench": cs.BENCH_SHAPE, "frame": None, "frame2": None, "iters": 10,
            "adaptive": (2 * cs.CHECK_EVERY, cs.CHECK_EVERY), "aa": (9, cs.AA_INTERVAL),
            "repeats": 1, "capture_at": 4, "model": "production", "deadline": 300,
            "bench_cell": "full"},
    "small": {"bench": (2, 32, 48, 3), "frame": (1, 32, 64, 3), "frame2": (2, 32, 64, 3),
              "iters": 6, "adaptive": (8, 4), "aa": (9, 4), "repeats": 2, "capture_at": 4,
              "model": "smoke", "deadline": 300, "bench_cell": "tiny"},
}
# dryrun_multichip's cases (__graft_entry__.py:58-156).
DRYRUN_KW = {"lam": 0.01, "rho": 0.1}
DRYRUN_LR = 1e-3
# Phase F/G: a global batch of 2 a card, 3 steps held against one process.
PER_CARD_BATCH = 2
CLI_BATCHES = 2  # phase G's train (and eval) batches: 4 PNG pairs a card
SMALL_CROP = (16, 16)
# Phase F's bound on the parameters after DP_STEPS steps against the
# one-process trainer, beside the strict 1e-6 of the CPU test: AdaBelief's
# first step is lr * sign(g) / 0.9, so a gradient entry near 0 whose sign
# flips under another summation order moves its parameter by an lr-sized
# amount.  Held as test_torch_data_parallel.py holds the JAX trainer: every
# element within 2.25 lr, all but 1% within 1e-3 lr.
STRICT_PARAM_ATOL = 1e-6
# Step 1's all-reduced gradient against one process on the mean of the
# same 2-image shards' gradients: every entry within 1e-5 of the largest
# gradient entry (the ranks' shard gradients summed in NCCL's order, where
# one process sums them in rank order: a few ulps of the largest shard
# entry, which may exceed the mean's largest several times; an entry whose
# true value is 0, such as a bias GMSD cannot see, is rounding noise on
# both sides, so the bound is not taken per tensor).
GRAD_RTOL = 1e-5
# Step 1's all-reduced gradient against one process on the global batch at
# once, every entry within GLOBAL_GRAD_RTOL of the largest gradient entry.
# Both are fp32 roundings of one gradient: on the card (H100, 256^2, batch
# 8 against 4 shards of 2; ``--probe-gradient``) the batch's gradient lies
# 3.4e-4 of the largest entry from a float64 gradient and the shards' mean
# 1.7e-4 (PyTorch's own convolutions 1.2e-4 both, the CPU 1.7e-4 both), so
# the two may lie 5.1e-4 apart; the bound is about twice that.
GLOBAL_GRAD_RTOL = 1e-3


check = cs.check


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def build_kernels() -> None:
    """Every kernel of the port, one nvcc a source, all started together,
    before the ranks start (each rank then loads the built library)."""
    from concurrent.futures import ThreadPoolExecutor

    from admm_deconv_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cs.KERNEL_SOURCES)) as pool:
        for future in [pool.submit(_build.build, name) for name in cs.KERNEL_SOURCES]:
            future.result()
    print(f"[launcher] kernels {', '.join(cs.KERNEL_SOURCES)} built/found in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# The launcher: one process a rank, rank 0 relayed, a failing or hung rank
# named and every rank killed (``bench_torch/ranks.py``).
launch = ranks.launch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="processes, one a card (default: every card; 2 with --device cpu)")
    ap.add_argument("--size", choices=sorted(SIZES), default="full")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds before every rank is killed (default 900 full, 300 small)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe-gradient", action="store_true",
                    help="read phase F's batch-size gradient gap on one card; no ranks")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        rank_main(args)
        return

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke_multi: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(2)
    import admm_deconv_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.probe_gradient:
        check(args.device == "cuda", "--probe-gradient reads the card")
        build_kernels()
        probe_gradient(args)
        return
    world = args.world or (torch.cuda.device_count() if args.device == "cuda" else 2)
    if args.device == "cuda":
        check(world <= torch.cuda.device_count(),
              f"--world {world} needs {world} cards; this host has {torch.cuda.device_count()}")
        unchecked = unchecked_stacks(SIZES[args.size], world)
        check(not unchecked, f"--size {args.size} at --world {world} hands the kernels plane "
                             f"stacks that chip_smoke.py does not hold against their plain twins: "
                             f"{unchecked}")
        build_kernels()
    deadline = args.deadline or SIZES[args.size]["deadline"]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_multi-")
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", workdir, "--size", args.size,
           "--device", args.device, "--seed", str(args.seed)]
    print(f"[launcher] {world} ranks on {args.device}, size {args.size}, deadline {deadline:.0f} s",
          flush=True)
    try:
        code, ok_line = launch(cmd, world, deadline, workdir, args.device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if code != 0 or ok_line is None:
        print(f"[launcher] FAILED: {'rank 0 printed no result' if code == 0 else 'see above'}",
              file=sys.stderr)
        sys.exit(1)
    print(ok_line, flush=True)


# ---------------------------------------------------------------------------
# A rank
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ctx:
    rank: int
    world: int
    dev: torch.device
    size: dict
    seed: int
    workdir: str
    out: dict = dataclasses.field(default_factory=dict)

    @property
    def lead(self) -> bool:
        return self.rank == 0

    @property
    def cuda(self) -> bool:
        return self.dev.type == "cuda"

    def say(self, msg: str) -> None:
        """A result line: rank 0's output is the run's."""
        if self.lead:
            print(msg, flush=True)

    def phase(self, name: str) -> None:
        print(f"[rank {self.rank}] phase {name} at {time.strftime('%H:%M:%S')}", flush=True)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def gather(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        self.sync()
        dist.barrier()


def mean_ms(ctx: Ctx, fn, calls: int = 20) -> float:
    """Mean ms per call over ``calls`` back-to-back calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    if ctx.cuda:
        return cs.cuda_ms(fn, calls)
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return 1e3 * (time.perf_counter() - t0) / calls


def same_on_every_rank(ctx: Ctx, t: torch.Tensor | None) -> bool:
    """Rank 0's ``t`` broadcast to every rank; True when every rank that
    holds a ``t`` holds the same bits (a rank outside a mesh passes None)."""
    n = torch.tensor([t.numel() if ctx.lead else 0], device=ctx.dev)
    dist.broadcast(n, 0)
    ref = t.reshape(-1).contiguous() if ctx.lead else torch.empty(int(n), device=ctx.dev,
                                                                  dtype=torch.float32)
    dist.broadcast(ref, 0)
    ok = torch.tensor([1 if t is None or torch.equal(ref, t.reshape(-1)) else 0], device=ctx.dev)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok)


def signature(out) -> torch.Tensor:
    """A solve's result as one float32 vector: x and any diagnostics."""
    if isinstance(out, tuple):
        x, diag = out
        return torch.cat([x.reshape(-1)] + [getattr(diag, f).reshape(-1).float()
                                            for f in ("r_norm", "s_norm", "iterations", "rho")])
    return out.reshape(-1)


def seeded(ctx: Ctx, shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(ctx.dev)


def mesh_axes(world: int) -> dict:
    """The meshes of the run: ``{"tile": 2}`` (a sub-mesh when the world is
    larger), ``{"tile": world}`` and, for an even world, ``{"data": 2,
    "tile": world / 2}``."""
    axes = {f"tile{t}": {"tile": t} for t in sorted({2, world}) if t <= world}
    if world % 2 == 0:
        axes[f"data2_tile{world // 2}"] = {"data": 2, "tile": world // 2}
    return axes


def member(mesh) -> bool:
    return mesh.get_coordinate() is not None


def mesh_kw(mesh) -> dict:
    return {"mesh": mesh, **({"data_axis_name": "data"} if "data" in mesh.mesh_dim_names else {})}


def mesh_shapes(ctx: Ctx, mesh) -> list[str]:
    """The shapes solved on ``mesh``: the 1080p batch and the 4K frame, or a
    2-frame 4K batch on a data x tile mesh; those the size runs."""
    names = ("bench", "frame2") if "data" in mesh.mesh_dim_names else ("bench", "frame")
    return [n for n in names if ctx.size[n] is not None]


def kernel_stacks(size: dict, world: int) -> dict[str, set]:
    """The (planes, H, W) stacks a run at ``size`` on ``world`` ranks hands
    each kernel: "fwd" Q2-1 (fp32 and bf16 duals), "bwd" Q2-2, "prox_dual"
    Q2-5, "composite" Q2-3, "halo" Q2-4, "spectral" the x-update's complex-rhs
    pass (every one-card solve's stacks: the tiled path keeps its own
    x-update).  ``chip_smoke.py`` holds each kernel against its plain twin
    at its stacks."""
    from admm_deconv_tpu_torch.models.zoo import DenoiserBank
    from admm_deconv_tpu_torch.train import load_config

    out = {k: set() for k in ("fwd", "bwd", "prox_dual", "composite", "halo")}

    def planes(b, h, w, c=3):
        return (b * c, h, w)

    # B: the dryrun trainer (batch 1 a rank, the world in one process), its
    # solver scenes on one card, and their tiles.
    for b in (1, world):
        out["fwd"].add(planes(b, 32, 32))
        out["bwd"].add(planes(b, 32, 32))
    for kernel in ("fwd", "prox_dual", "composite"):
        out[kernel].add(planes(2, 8 * world, 32))
    out["halo"].add(planes(2, 8, 32))
    if world % 2 == 0:
        out["fwd"].add(planes(2, 4 * world, 32))
        out["prox_dual"].add(planes(2, 4 * world, 32))
        out["halo"].add(planes(1, 8, 32))
    # C and D: each shape on one card, and its tiles on each mesh.
    for axes in mesh_axes(world).values():
        t, d = axes["tile"], axes.get("data", 1)
        for name in (("bench", "frame2") if d > 1 else ("bench", "frame")):
            if size[name] is None:
                continue
            b, h, w, c = size[name]
            for kernel in ("fwd", "prox_dual", "composite"):
                out[kernel].add(planes(b, h, w, c))
            out["halo"].add(planes(b // d, h // t, w, c))
    # H: the four-card cell's tiles, and its one-card yardstick.
    if world == bench_cells.TILES:
        b, h, w, c = bench_cells.SHAPES[bench_cells.TILED][size["bench_cell"]]
        out["halo"].add(planes(b, h // world, w, c))
        out["fwd"].add(planes(b, h, w, c))
    # F and G: the training model on 2 images a rank, and phase F's
    # one-process step on the global batch (admm_denoiser's bank solves 5
    # branches of the batch at once).
    if size["model"] == "production":
        branches, crop = len(DenoiserBank.RHOS), tuple(load_config(
            os.path.join(REPO, cs.TRAIN_CFG)).im_shape)
    else:
        branches, crop = 1, SMALL_CROP
    for b in (PER_CARD_BATCH, PER_CARD_BATCH * world):
        out["fwd"].add(planes(branches * b, *crop))
        out["bwd"].add(planes(branches * b, *crop))
    out["spectral"] = out["fwd"] | out["prox_dual"] | out["composite"]
    return out


def unchecked_stacks(size: dict, world: int) -> dict[str, list]:
    """The stacks of :func:`kernel_stacks` that ``chip_smoke.py`` does not
    hold against a kernel's plain twin, by kernel."""
    checked = {"fwd": cs.KERNEL_SHAPES, "bwd": cs.BWD_SHAPES, "prox_dual": cs.PROX_DUAL_SHAPES,
               "composite": cs.COMPOSITE_SHAPES, "halo": cs.HALO_SHAPES,
               "spectral": cs.SPECTRAL_SHAPES}
    return {k: sorted(v - set(checked[k])) for k, v in kernel_stacks(size, world).items()
            if v - set(checked[k])}


def expected_halo(ctx: Ctx, mesh, launches: int) -> dict:
    """Q2-4's launches this rank must count: a CPU tensor launches none."""
    return cs.expect_counts(stencil_halo=launches if ctx.cuda and member(mesh) else 0)


# ---- phase A ---------------------------------------------------------------

def phase_group(ctx: Ctx, meshes: dict) -> None:
    ctx.phase("A")
    if ctx.lead:
        if ctx.cuda:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True, timeout=60).stdout.strip()
            for line in smi.splitlines():
                print(f"[A] nvidia-smi: {line}")
            topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                                  timeout=60)
            for line in topo.stdout.rstrip().splitlines():
                print(f"[A] topo | {line}")
            print(f"[A] torch {torch.__version__} cuda {torch.version.cuda} nccl "
                  f"{torch.cuda.nccl.version()}; device {torch.cuda.get_device_name(0)}, "
                  f"count {torch.cuda.device_count()}", flush=True)
        else:
            print(f"[A] device cpu (gloo): no nvidia-smi, card names, topology or NCCL here")
    if ctx.cuda:
        d = torch.cuda.current_device()
        props = torch.cuda.get_device_properties(d)
        ident = (d, str(getattr(props, "uuid", props)))
    else:
        ident = (os.getpid(), "cpu")
    idents = ctx.gather(ident)
    ctx.say(f"[A] backend {dist.get_backend()}, world {ctx.world}; (device, uuid) by rank: "
            f"{idents}")
    if ctx.cuda:
        check(len({i[0] for i in idents}) == ctx.world and len({i[1] for i in idents}) == ctx.world,
              f"every rank on a card of its own: {idents}")
    check(dist.get_backend() == ("nccl" if ctx.cuda else "gloo"), "the group's backend")

    from admm_deconv_tpu_torch.parallel.distributed import all_gather_cat

    groups = [("world", None, ctx.world)]
    for name, mesh in meshes.items():
        if member(mesh):
            groups += [(f"{name}.{axis}", mesh.get_group(axis),
                        dist.get_world_size(mesh.get_group(axis))) for axis in mesh.mesh_dim_names]
    times = {}
    for label, group, size in groups:
        t0 = time.perf_counter()
        a = torch.arange(size * 256, dtype=torch.float32, device=ctx.dev)
        recv = torch.empty_like(a)
        dist.all_to_all_single(recv, a, group=group)
        gathered = a.new_empty(size * a.numel())
        all_gather_cat(gathered, a, group=group)
        dist.all_reduce(a, group=group)
        ctx.sync()
        times[label] = 1e3 * (time.perf_counter() - t0)
    every = ctx.gather(times)
    for label in sorted({k for t in every for k in t}):
        per_rank = {r: round(t[label], 3) for r, t in enumerate(every) if label in t}
        ctx.say(f"[A] warm-up all_to_all_single + all-gather + all_reduce on {label} (set-up, "
                f"communicator creation included): ms by rank {per_rank}")
    ctx.out["A"] = {"devices": idents, "warmup_ms": every,
                    "members": {n: ctx.gather(member(m)) for n, m in meshes.items()}}
    ranks_in = {n: [r for r, m in enumerate(v) if m] for n, v in ctx.out["A"]["members"].items()}
    ctx.say(f"[A] meshes {{name: ranks in it}}: {ranks_in}")
    if ctx.lead and ctx.cuda:
        path = os.path.join(ctx.workdir, "nccl.rank0.log")
        text = open(path, errors="replace").read() if os.path.isfile(path) else ""
        via = collections.Counter(re.findall(r" via (\S+)", text))
        ctx.out["A"]["nccl_transports"] = dict(via)
        print(f"[A] NCCL transports in rank 0's channels (NCCL_DEBUG=INFO): {dict(via)}")
        for line in [ln for ln in text.splitlines() if " via " in ln][:6]:
            print(f"[A] nccl | {line.strip()[:160]}")


# ---- the training models ---------------------------------------------------

class SmokeModel(torch.nn.Module):
    """``dryrun_multichip``'s model: the unrolled ADMM layer (5x5 PSF, 5
    iterations, remat) and a 1x1 convolution head."""

    def __init__(self):
        super().__init__()
        from admm_deconv_tpu_torch.layers import ADMMDeconv

        self.deconv = ADMMDeconv(kernel_shape=(5, 5), iters=5, remat=True)
        self.head = torch.nn.Conv2d(3, 3, 1)

    def forward(self, v):
        from admm_deconv_tpu_torch.models.blocks import _conv_nhwc

        return _conv_nhwc(self.head, self.deconv(v))


# Q2-1 launches of one forward, Q2-1 and Q2-2 launches of one train step:
# the production admm_denoiser (50-iteration bank, no remat) and the smoke
# model (5 iterations under remat: the backward runs each forward again).
LAUNCHES = {"production": (cs.FLAGSHIP_LAUNCHES, cs.FLAGSHIP_LAUNCHES, cs.FLAGSHIP_LAUNCHES),
            "smoke": (4, 8, 4)}


def train_config(ctx: Ctx):
    """Phase F/G's configuration: ``configs/train_cfg.json``; the small size
    trains the smoke model on 16^2 crops (admm_denoiser needs crops of at
    least 96^2 and takes seconds a step on a CPU thread)."""
    from admm_deconv_tpu_torch.train import load_config

    cfg = load_config(os.path.join(REPO, cs.TRAIN_CFG))
    cfg.checkpointing = False
    kind = ctx.size["model"]
    if kind == "smoke":
        # mse, as dryrun_multichip trains: GMSD is blind to a constant
        # shift, so the head's bias gets a gradient of rounding noise.
        cfg.im_shape, cfg.loss = SMALL_CROP, "mse"
    return cfg, kind


def train_model(ctx: Ctx, cfg, kind: str, device=None):
    from admm_deconv_tpu_torch.models import build_model, init_parameters

    device = device or ctx.dev
    model = (build_model(cfg.model, dataclasses.asdict(cfg), device=device)
             if kind == "production" else SmokeModel().to(device))
    return init_parameters(model, torch.Generator().manual_seed(ctx.seed))


class ArrayPairs:
    """(degraded, clean) arrays indexed as ``ImageDataFeeder`` is."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idxs):
        idxs = np.atleast_1d(np.asarray(idxs))
        return self.x[idxs], self.y[idxs]


def dp_pairs(ctx: Ctx, cfg) -> ArrayPairs:
    """DP_STEPS global batches of 2 a card: blocks, motion blur and AWGN."""
    pairs = cs.training_pairs(ctx.seed + 3, cs.DP_STEPS, PER_CARD_BATCH * ctx.world, cfg.im_shape)
    return ArrayPairs(np.concatenate([p[0] for p in pairs]), np.concatenate([p[1] for p in pairs]))


def dryrun_pairs(ctx: Ctx) -> ArrayPairs:
    rng = np.random.default_rng(0)
    x = rng.random((ctx.world, 32, 32, 3)).astype(np.float32)
    return ArrayPairs(x, rng.random((ctx.world, 32, 32, 3)).astype(np.float32))


def dryrun_config():
    from admm_deconv_tpu_torch.train import TrainConfig

    return TrainConfig(epochs=1, lr_rate=DRYRUN_LR, loss="mse", checkpointing=False,
                       im_shape=(32, 32), prefetch_batches=0)


def grad_rel(got, want) -> float:
    """The largest entry of |got - want| over the largest of |want|."""
    return (max(float((g - w).abs().max()) for g, w in zip(got, want))
            / max(float(w.abs().max()) for w in want))


def params_of(model) -> list[torch.Tensor]:
    return [p.detach().clone() for p in model.parameters()]


def compare_params(got, want, lr: float) -> dict:
    """The largest difference, the count beyond STRICT_PARAM_ATOL and the
    sign-flip bound of the module docstring."""
    diffs = torch.cat([(g - w).abs().reshape(-1) for g, w in zip(got, want)])
    worst = float(diffs.max())
    off = int((diffs > 1e-3 * lr).sum())
    return {"max_abs": worst, "beyond_strict": int((diffs > STRICT_PARAM_ATOL).sum()),
            "n": diffs.numel(), "strict": worst <= STRICT_PARAM_ATOL,
            "bound": worst <= 2.25 * lr and off <= 0.01 * diffs.numel()}


def shard_mean_step(trainer, state, x, y, shards: int) -> None:
    """One optimizer step of one process on the mean of ``shards`` shards'
    gradients, each shard's loss and backward run alone at its own batch
    size: the ranks' arithmetic, summed in rank order."""
    from admm_deconv_tpu_torch.utils.precision import fp32_convs

    total = None
    for xs, ys in zip(x.chunk(shards), y.chunk(shards)):
        with fp32_convs():
            state.optimizer.zero_grad(set_to_none=True)
            trainer.loss_fn(state.model(xs), ys).backward()
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        total = grads if total is None else [t + g for t, g in zip(total, grads)]
    for p, t in zip([p for p in state.model.parameters() if p.grad is not None], total):
        p.grad = t / shards
    state.optimizer.step()


def train_references(ctx: Ctx) -> dict:
    """Rank 0, before it joins the group (``Trainer`` turns data parallelism
    on whenever a group exists): phase B's one-process epoch on the global
    batch; phase F's one-process steps on the global batches and, from the
    same start, on the mean of the 2-image shards' gradients (step 1's
    gradient and the parameters after DP_STEPS steps of each); ms/step of
    one card at batch 2."""
    from admm_deconv_tpu_torch.data import DataLoader
    from admm_deconv_tpu_torch.models import init_parameters
    from admm_deconv_tpu_torch.train import Trainer

    ctx.phase("references")
    ref = {}
    model = init_parameters(SmokeModel().to(ctx.dev), torch.Generator().manual_seed(ctx.seed))
    trainer = Trainer(model, dryrun_config())
    check(not trainer.data_parallel, "the reference trainer has no group")
    pairs = dryrun_pairs(ctx)
    with tempfile.TemporaryDirectory(dir=ctx.workdir) as tmp:
        trainer.fit(trainer.init_state(), DataLoader(pairs, batch_size=ctx.world),
                    DataLoader(pairs, batch_size=ctx.world), model_dir=tmp,
                    log_fn=lambda *_: None)
    ref["B"] = params_of(model)

    cfg, kind = train_config(ctx)
    pairs = dp_pairs(ctx, cfg)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = train_model(ctx, cfg, kind)
        trainer = Trainer(model, cfg)
        state = trainer.init_state()
        global_batches = [trainer._to_device(x, y) for x, y in
                          DataLoader(pairs, batch_size=PER_CARD_BATCH * ctx.world)]
        for step, (x, y) in enumerate(global_batches, 1):
            trainer.train_step(state, x, y, trainer._zero_acc())
            if step == 1:
                ref["F_grad"] = [p.grad.detach().clone() for p in model.parameters()]
        ref["F_params"] = params_of(model)
        model = train_model(ctx, cfg, kind)
        trainer = Trainer(model, cfg)
        state = trainer.init_state()
        for step, (x, y) in enumerate(global_batches, 1):
            shard_mean_step(trainer, state, x, y, ctx.world)
            if step == 1:
                ref["F_grad_shards"] = [p.grad.detach().clone() for p in model.parameters()]
        ref["F_params_shards"] = params_of(model)
        # One card at batch 2, no group: one warm-up step, then DP_STEPS.
        model = train_model(ctx, cfg, kind)
        trainer = Trainer(model, cfg)
        state = trainer.init_state()
        batches = [trainer._to_device(x, y)
                   for x, y in DataLoader(pairs, batch_size=PER_CARD_BATCH)]
        batches = (batches * 2)[:cs.DP_STEPS + 1]  # a world of one has DP_STEPS batches of 2
        ref["F_alone_ms"] = step_times(ctx, trainer, state, batches[0], batches[1:])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return ref


def step_times(ctx: Ctx, trainer, state, warm, batches) -> list[float]:
    """ms of each train step on ``batches`` after one warm-up step."""
    trainer.train_step(state, *warm, trainer._zero_acc())
    times = []
    for x, y in batches:
        ctx.sync()
        t0 = time.perf_counter()
        trainer.train_step(state, x, y, trainer._zero_acc())
        ctx.sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


# ---- phase B ---------------------------------------------------------------

def tiled_against_single(ctx: Ctx, label: str, mesh, tiled, single, y, tol: float, launches,
                         diag: bool = False, box: bool = False) -> dict:
    """One tiled solve on the mesh's ranks against the one-card solve on
    rank 0: |dx| within ``tol``, equal iterations and rho with ``diag``,
    the same bits on every rank, Q2-4's launches on every rank (``launches``
    a count, or a function of the solve's result where it stops early)."""
    inside = member(mesh)
    cs.reset_counts()
    out = tiled(y) if inside else None
    ctx.sync()
    counts = cs.read_counts()
    if callable(launches):
        launches = launches(out) if inside else 0
    want = expected_halo(ctx, mesh, launches)
    check(counts == want, f"{label}: rank {ctx.rank} launches {counts}, expected {want}")
    same = same_on_every_rank(ctx, signature(out) if inside else None)
    check(same, f"{label}: the ranks' results differ")
    row = {"same_bits": same, "launches": ctx.gather(counts["stencil_halo"])}
    if ctx.lead:
        want = single(y)
        x, xs = (out[0], want[0]) if diag else (out, want)
        check(cs.x_ok(x, y), f"{label}: tiled output shape or finiteness")
        dx = float((x - xs).abs().max())
        row |= {"dx": dx, "tol": tol}
        extra = ""
        if diag:
            its = (int(out[1].iterations), int(want[1].iterations))
            same_rho = bool(torch.equal(out[1].rho, want[1].rho))
            row |= {"iterations": its, "rho_equal": same_rho}
            extra = f"; iterations tiled/one card {its}, rho equal {same_rho}"
            check(its[0] == its[1] and same_rho, f"{label}: iterations or rho differ {its}")
        if box:
            lo, hi = float(x.min()), float(x.max())
            row["box"] = (lo, hi)
            extra += f"; box [{lo:.4f}, {hi:.4f}]"
            check(lo >= 0.0 and hi <= 1.0, f"{label}: outside the box")
        print(f"[{label}] max|x_tiled - x_one_card| {dx:.3e} (bound {tol:.1e}){extra}; same bits "
              f"on every rank {same}; Q2-4 launches by rank {row['launches']}", flush=True)
        check(dx <= tol, f"{label}: off the one-card solve by {dx} > {tol}")
    return row


def phase_dryrun(ctx: Ctx, meshes: dict, ref: dict | None) -> dict:
    """``dryrun_multichip``'s cases at its shapes."""
    from admm_deconv_tpu_torch import (
        composite_tv_deconvolve,
        tv_deconvolve,
        tv_deconvolve_adaptive,
        tv_deconvolve_anderson,
    )
    from admm_deconv_tpu_torch.data import DataLoader
    from admm_deconv_tpu_torch.models import init_parameters
    from admm_deconv_tpu_torch.parallel import (
        tiled_composite_tv_deconvolve,
        tiled_tv_deconvolve,
        tiled_tv_deconvolve_anderson,
    )
    from admm_deconv_tpu_torch.train import Trainer

    ctx.phase("B")
    out = {}
    # 1. One data-parallel epoch (a step and an eval) through the Trainer.
    model = init_parameters(SmokeModel().to(ctx.dev), torch.Generator().manual_seed(ctx.seed))
    trainer = Trainer(model, dataclasses.replace(dryrun_config(), mesh_batch=ctx.world))
    check(trainer.data_parallel and trainer.world == ctx.world, "the dryrun trainer joined")
    pairs = dryrun_pairs(ctx)
    shard = {"process_count": ctx.world, "process_index": ctx.rank}
    loader = DataLoader(pairs, batch_size=ctx.world, **shard)
    with tempfile.TemporaryDirectory(dir=ctx.workdir) as tmp:
        state = trainer.fit(trainer.init_state(), loader, loader, model_dir=tmp,
                            log_fn=lambda *_: None)
    x, y = next(iter(loader))
    loss = float(trainer.eval_step(model, *trainer._to_device(x, y), trainer._zero_acc())["loss"])
    params = params_of(model)
    same = same_on_every_rank(ctx, torch.cat([p.reshape(-1) for p in params]))
    check(np.isfinite(loss) and same and state.step == 1,
          f"dryrun trainer: loss {loss}, same {same}")
    row = {"loss": loss, "same_bits": same}
    if ctx.lead:
        row |= compare_params(params, ref["B"], DRYRUN_LR)
        print(f"[B] dryrun trainer, {ctx.world} ranks x batch 1 of 32^2 (ADMMDeconv 5x5, 5 it, "
              f"remat + 1x1 conv; mse; AdaBelief lr {DRYRUN_LR}): eval loss {loss:.6f}; "
              f"replicas equal bit for bit {same}; parameters against the one-process epoch: max "
              f"|d| {row['max_abs']:.3e}, {row['beyond_strict']} of {row['n']} beyond "
              f"{STRICT_PARAM_ATOL}", flush=True)
        check(row["bound"], f"dryrun trainer off the one-process epoch: {row}")
    out["trainer"] = row

    # 2-6. The tiled solvers on the tile axis and the data x tile mesh.
    mesh = meshes[f"tile{ctx.world}"]
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((2, 8 * ctx.world, 32, 3)).astype(np.float32)).to(ctx.dev)
    psf = torch.full((3, 3), 1 / 9, device=ctx.dev)
    kw = {"psf": psf, **DRYRUN_KW}
    adaptive = {"check_every": 3, "adapt_rho": True, "prox_impl": "pallas"}
    # One Q2-4 launch in each 3-iteration block; the default tolerances may
    # stop the solve after the first block.
    per_block = lambda out: int(out[1].iterations) // 3  # noqa: E731
    out["adaptive"] = tiled_against_single(
        ctx, "B tiled adaptive check_every=3", mesh,
        lambda v: tiled_tv_deconvolve(v, iters=6, early_stop=True, return_diagnostics=True,
                                      mesh=mesh, **kw, **adaptive),
        lambda v: tv_deconvolve_adaptive(v, max_iters=6, **kw, **adaptive), img, 1e-4,
        per_block, diag=True)
    out["fold1"] = tiled_against_single(
        ctx, "B tiled fold1", mesh,
        lambda v: tiled_tv_deconvolve(v, iters=5, fft_mode="fold1", prox_impl="pallas",
                                      mesh=mesh, **kw),
        lambda v: tv_deconvolve(v, iters=5, **kw), img, 1e-4, 4)
    aa = {"iters": 7, "m": 2, "aa_interval": 3, "prox_impl": "pallas"}
    out["anderson"] = tiled_against_single(
        ctx, "B tiled anderson m=2 aa_interval=3", mesh,
        lambda v: tiled_tv_deconvolve_anderson(v, mesh=mesh, **kw, **aa),
        lambda v: tv_deconvolve_anderson(v, **kw, **aa), img, 1e-3, 2, diag=True)
    if ctx.world % 2 == 0:
        mesh2 = meshes[f"data2_tile{ctx.world // 2}"]
        img2 = torch.from_numpy(
            rng.random((2, 8 * (ctx.world // 2), 32, 3)).astype(np.float32)).to(ctx.dev)
        out["data_x_tile"] = tiled_against_single(
            ctx, f"B data2 x tile{ctx.world // 2} adaptive", mesh2,
            lambda v: tiled_tv_deconvolve(v, iters=6, early_stop=True, return_diagnostics=True,
                                          **mesh_kw(mesh2), **kw, **adaptive),
            lambda v: tv_deconvolve_adaptive(v, max_iters=6, **kw, **adaptive), img2, 1e-4,
            per_block, diag=True)
    ckw = {"psf": psf, "lam_tv": 0.01, "lam_l1": 0.002, "rho1": 0.1, "rho2": 0.1, "iters": 6,
           "x_bounds": (0.0, 1.0), "prox_impl": "pallas"}
    out["composite"] = tiled_against_single(
        ctx, "B tiled composite", mesh,
        lambda v: tiled_composite_tv_deconvolve(v, mesh=mesh, **ckw),
        lambda v: composite_tv_deconvolve(v, **ckw), img, 1e-4, 5, box=True)
    return out


# ---- phase C ---------------------------------------------------------------

def solver_cases(size: dict) -> list:
    """(name, tiled solver, one-card solver, iterations, Q2-4 launches of one
    solve, has diagnostics, bound on |dx| or None for the bf16 envelope)."""
    from admm_deconv_tpu_torch import (
        composite_tv_deconvolve,
        tv_deconvolve,
        tv_deconvolve_adaptive,
        tv_deconvolve_anderson,
    )
    from admm_deconv_tpu_torch.parallel import (
        tiled_composite_tv_deconvolve,
        tiled_tv_deconvolve,
        tiled_tv_deconvolve_anderson,
    )

    iters = size["iters"]
    n_ad, check_every = size["adaptive"]
    aa_iters, aa_interval = size["aa"]
    fixed = {"lam": cs.LAM, "rho": cs.RHO}
    ad = {**fixed, "check_every": check_every, "eps_abs": 0.0, "eps_rel": 0.0, "adapt_rho": True}
    return [
        ("fp32", lambda v, psf, m: tiled_tv_deconvolve(v, psf=psf, iters=iters, **fixed, **m),
         lambda v, psf: tv_deconvolve(v, psf=psf, iters=iters, **fixed), iters, iters - 1,
         False, 1e-4),
        ("bf16", lambda v, psf, m: tiled_tv_deconvolve(v, psf=psf, iters=iters,
                                                       state_dtype="bfloat16", **fixed, **m),
         lambda v, psf: tv_deconvolve(v, psf=psf, iters=iters, state_dtype="bfloat16", **fixed),
         iters, iters - 1, False, None),
        (f"adaptive check_every={check_every}",
         lambda v, psf, m: tiled_tv_deconvolve(v, psf=psf, iters=n_ad, early_stop=True,
                                               return_diagnostics=True, **ad, **m),
         lambda v, psf: tv_deconvolve_adaptive(v, psf=psf, max_iters=n_ad, **ad), n_ad,
         (check_every - 2) * (n_ad // check_every), True, 1e-4),
        ("composite", lambda v, psf, m: tiled_composite_tv_deconvolve(
            v, psf=psf, iters=iters, **cs.COMPOSITE_KW, **m),
         lambda v, psf: composite_tv_deconvolve(v, psf=psf, iters=iters, **cs.COMPOSITE_KW),
         iters, iters - 1, False, 1e-4),
        (f"anderson m={cs.ANDERSON_M}", lambda v, psf, m: tiled_tv_deconvolve_anderson(
            v, psf=psf, iters=iters, m=cs.ANDERSON_M, **fixed, **m),
         lambda v, psf: tv_deconvolve_anderson(v, psf=psf, iters=iters, m=cs.ANDERSON_M, **fixed),
         iters, 0, True, 1e-3),
        (f"anderson m={cs.ANDERSON_M} aa_interval={aa_interval}",
         lambda v, psf, m: tiled_tv_deconvolve_anderson(
             v, psf=psf, iters=aa_iters, m=cs.ANDERSON_M, aa_interval=aa_interval, **fixed, **m),
         lambda v, psf: tv_deconvolve_anderson(v, psf=psf, iters=aa_iters, m=cs.ANDERSON_M,
                                               aa_interval=aa_interval, **fixed),
         aa_iters, (aa_interval - 2) * ((aa_iters - 1) // aa_interval), True, 1e-3),
    ]


def rate(ctx: Ctx, solve, y, iters: int, repeats: int) -> float:
    """Iterations/s of ``repeats`` solves of fresh inputs, host clock, the
    last ending in a synchronize (after the caller's warm-up)."""
    ctx.sync()
    t0 = time.perf_counter()
    for i in range(repeats):
        solve(y + 0.001 * (i + 1))
    ctx.sync()
    return iters * repeats / (time.perf_counter() - t0)


def single_card_references(ctx: Ctx, y, psf) -> dict:
    """Rank 0: every solver case on one card, its result and it/s."""
    refs = {}
    for name, _, single, iters, _, _, _ in solver_cases(ctx.size):
        first = single(y, psf)
        refs[name] = {"out": first, "it_s": rate(ctx, lambda v: single(v, psf), y, iters,
                                                 ctx.size["repeats"])}
    refs["envelope"] = float((refs["bf16"]["out"] - refs["fp32"]["out"]).abs().max())
    return refs


def profile_tiled(ctx: Ctx, label: str, mesh, solve, y) -> dict | None:
    """Rank 0's device time of one tiled solve under torch.profiler: the
    share under the collectives' ``nccl:*`` ranges and the ``direct_copy``
    kernels.  Every rank of the mesh solves beside it."""
    if not member(mesh):
        ctx.barrier()
        return None
    ctx.barrier()
    if not (ctx.lead and ctx.cuda):
        solve(y)
        ctx.sync()
        return None
    run = cs.profiled_solve(solve, y, label)
    kernels, busy, wall = run["kernels"], run["busy_ms"], run["wall_ms"]
    nccl = sum(run["collectives"].values())
    copies = [e for e in kernels if "direct_copy" in e.key]
    row = {"wall_ms": wall, "busy_ms": busy, "nccl_ms": nccl, "nccl_share": nccl / busy,
           "direct_copy_n": sum(e.count for e in copies),
           "direct_copy_ms": sum(e.self_device_time_total for e in copies) / 1e3}
    print(f"[C profile] {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.3f}); under nccl:* {nccl:.3f} ms ({row['nccl_share']:.1%} of busy); "
          f"direct_copy kernels {row['direct_copy_n']} ({row['direct_copy_ms']:.3f} ms)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[C profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x {e.key[:90]}")
    return row


def phase_tiled_full(ctx: Ctx, meshes: dict) -> list:
    """Every solver case on every mesh at the full-width shapes."""
    ctx.phase("C")
    psf = cs.motion_psf(ctx.dev)
    rows = []
    shapes = {"bench": [], "frame": [], "frame2": []}
    for name, mesh in meshes.items():
        for shape in mesh_shapes(ctx, mesh):
            shapes[shape].append(name)
    for shape_name, mesh_names in shapes.items():
        if not mesh_names:
            continue
        shape = ctx.size[shape_name]
        y = seeded(ctx, shape, ctx.seed)
        refs = single_card_references(ctx, y, psf) if ctx.lead else None
        ctx.barrier()
        for mesh_name in mesh_names:
            mesh = meshes[mesh_name]
            cards = mesh.size()
            for name, tiled, _, iters, launches, diag, tol in solver_cases(ctx.size):
                label = f"C {mesh_name} {shape} {name}"
                if ctx.lead:
                    ref = refs[name]
                    bound = tol if tol is not None else 2 * refs["envelope"] + 1e-3
                else:
                    ref, bound = None, 0.0
                row = tiled_against_single(
                    ctx, label, mesh, lambda v: tiled(v, psf, mesh_kw(mesh)),
                    lambda v, ref=ref: ref["out"], y, bound, launches, diag=diag,
                    box=name == "composite")
                ctx.barrier()
                its = (rate(ctx, lambda v: tiled(v, psf, mesh_kw(mesh)), y, iters,
                            ctx.size["repeats"]) if member(mesh) else None)
                per_rank = ctx.gather(its)
                inside = [v for v in per_rank if v is not None]
                row |= {"mesh": mesh_name, "shape": shape, "solver": name, "iters": iters,
                        "cards": cards,
                        "it_s_by_rank": per_rank, "it_s_slowest": min(inside),
                        "it_s_rank0": per_rank[0]}
                if ctx.lead:
                    row["it_s_one_card"] = ref["it_s"]
                    row["efficiency"] = min(inside) / (cards * ref["it_s"])
                    shown = [None if v is None else round(v, 2) for v in per_rank]
                    print(f"[{label}] it/s slowest rank {min(inside):.2f}, rank 0 "
                          f"{per_rank[0]:.2f} (by rank {shown}); one "
                          f"card {ref['it_s']:.2f}; scaling efficiency it/s / ({cards} x one card) "
                          f"{row['efficiency']:.3f}", flush=True)
                rows.append(row)
            fp32 = solver_cases(ctx.size)[0][1]
            prof = profile_tiled(ctx, f"{mesh_name} {shape} fp32", mesh,
                                 lambda v: fp32(v, psf, mesh_kw(mesh)), y + 1e-4)
            if prof is not None:
                rows.append({"mesh": mesh_name, "shape": shape, "profile": prof})
        del refs, y
    return rows


# ---- phase H ---------------------------------------------------------------

def phase_bench_cell(ctx: Ctx) -> dict | None:
    """``bench_torch``'s four-card cell once, and its controls, on this
    world's ranks; not run unless the world is four."""
    from bench_torch import cells, controls

    ctx.phase("H")
    if ctx.world != cells.TILES:
        ctx.say(f"[H] {cells.TILED} runs on {cells.TILES} ranks; this world has {ctx.world}: "
                f"not run")
        return None
    size = ctx.size["bench_cell"]
    run = cells.run_tiled(ctx.dev, cells.DEFAULT_SEEDS[cells.TILED], 1, size)
    row = {"cell": cells.TILED, "size": size, "shape": list(run.shape),
           "passed": {k: c["ok"] for k, c in run.checks.items()},
           "max_abs_err": run.checks["solve"]["max_abs_err"],
           "counts_by_rank": run.checks["launches on every rank"]["counts_by_rank"],
           "unit_ms": 1e3 * run.samples_s[0], "wall_ms_by_rank": run.breakdown["wall_ms_by_rank"],
           "layers_ms": run.breakdown["layers_ms"]}
    ctx.say(f"[H] {cells.TILED} at {run.shape}, one unit {row['unit_ms']:.3f} ms: checks "
            f"{row['passed']}, max|x - x_float64| {row['max_abs_err']:.3e} (limit "
            f"{cells.TILED_TOLS['max_abs']:.1e}); Q2-4 launches by rank "
            f"{[c['stencil_halo'] for c in row['counts_by_rank']]}; traced wall by rank "
            f"{[round(w, 3) for w in row['wall_ms_by_rank']]} ms, rank 0's layers "
            f"{row['layers_ms']}")
    check(run.ok, f"[H] {cells.TILED} failed its checks: {run.checks}")
    row["rejected"] = {}
    for name in controls.controls_of(cells.TILED):
        checks = controls.run_control(name, ctx.dev, None, 1, size)
        row["rejected"][name] = not all(c["ok"] for c in checks.values())
        ctx.say(f"[H] control {name}: rejected {row['rejected'][name]}, failed "
                f"{sorted(k for k, c in checks.items() if not c['ok'])}, max|x - x_float64| "
                f"{checks['solve']['max_abs_err']:.3e}")
    check(all(row["rejected"].values()), f"[H] a control passed the check: {row['rejected']}")
    return row


# ---- phase D ---------------------------------------------------------------

def capture_halo_call(solve, at: int) -> dict:
    """Run ``solve`` with the tiled solver's Q2-4 wrapped: the ``at``-th
    call's arguments and results, copied."""
    from admm_deconv_tpu_torch.parallel import tiling

    real = tiling.fused_admm_stencil_halo
    box, calls = {}, [0]

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls[0] += 1
        if calls[0] == at:
            box.update(args=[a.clone() for a in args], kw=kw, out=[o.clone() for o in out])
        return out

    tiling.fused_admm_stencil_halo = spy
    try:
        solve()
    finally:
        tiling.fused_admm_stencil_halo = real
    return box


def phase_halo_on_real_rows(ctx: Ctx, meshes: dict) -> list:
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _halo_plain,
        fused_admm_stencil,
        fused_admm_stencil_halo,
        fused_admm_stencil_mixed,
    )
    from admm_deconv_tpu_torch.parallel import tiled_tv_deconvolve
    from admm_deconv_tpu_torch.parallel.distributed import all_gather_cat

    ctx.phase("D")
    psf = cs.motion_psf(ctx.dev)
    at = ctx.size["capture_at"]
    rows = []
    for mesh_name, mesh in meshes.items():
        for shape_name in mesh_shapes(ctx, mesh):
            y = seeded(ctx, ctx.size[shape_name], ctx.seed + 1)
            for sdt in ("float32", "bfloat16"):
                label = f"D {mesh_name} {ctx.size[shape_name]} {sdt}"
                result = None
                if member(mesh):
                    box = capture_halo_call(lambda: tiled_tv_deconvolve(
                        y, psf=psf, lam=cs.LAM, rho=cs.RHO, iters=at + 1, state_dtype=sdt,
                        **mesh_kw(mesh)), at)
                    x, ux, uy, x_top, x_bot, ux_bot, uy_bot, tau = box["args"]
                    mode = box["kw"]["mode"]
                    plain = _halo_plain(x, ux, uy, x_top, x_bot, ux_bot, uy_bot, tau, mode)
                    again = fused_admm_stencil_halo(*box["args"], **box["kw"])
                    twin = all(torch.equal(a, b) for a, b in zip(box["out"], plain))
                    check(twin and all(torch.equal(a, b) for a, b in zip(box["out"], again)),
                          f"{label}: Q2-4 against its plain twin on the delivered rows")
                    # The tile ring's whole stack, in tile order.
                    group, t = mesh.get_group("tile"), mesh.size(mesh.mesh_dim_names.index("tile"))
                    idx = mesh.get_local_rank("tile")

                    def whole(a):
                        out = a.new_empty((t * a.shape[0], *a.shape[1:]))
                        all_gather_cat(out, a.contiguous(), group=group)
                        return out.view(t, *a.shape).permute(1, 0, 2, 3).reshape(
                            a.shape[0], t * a.shape[1], a.shape[2])

                    xw, uxw, uyw = whole(x), whole(ux), whole(uy)
                    ht, h = x.shape[1], xw.shape[1]
                    above, below = (idx * ht - 1) % h, ((idx + 1) * ht) % h
                    rows_ok = (torch.equal(x_top, xw[:, above:above + 1])
                               and torch.equal(x_bot, xw[:, below:below + 1])
                               and torch.equal(ux_bot, uxw[:, below:below + 1].float())
                               and torch.equal(uy_bot, uyw[:, below:below + 1].float()))
                    check(rows_ok, f"{label}: the halo rows are not the neighbours' rows")
                    circular = fused_admm_stencil if ux.dtype == torch.float32 \
                        else fused_admm_stencil_mixed
                    want = circular(xw, uxw, uyw, tau, mode=mode)
                    decomposed = all(torch.equal(whole(o), w) for o, w in zip(box["out"], want))
                    check(decomposed, f"{label}: the tiles' Q2-4 outputs differ from Q2-1's on the "
                                      f"whole stack")
                    n, _, w = x.shape
                    bytes_px = (14 if ux.dtype == torch.bfloat16 else 24) + 16 / ht
                    ms = mean_ms(ctx, lambda: fused_admm_stencil_halo(*box["args"], **box["kw"]))
                    plain_ms = mean_ms(ctx, lambda: _halo_plain(x, ux, uy, x_top, x_bot, ux_bot,
                                                                uy_bot, tau, mode))
                    result = {"tile": tuple(x.shape), "ms": ms, "plain_ms": plain_ms,
                              **cs.bound(x.shape, bytes_px, 21)}
                    del box, xw, uxw, uyw, want
                every = ctx.gather(result)
                inside = [r for r in every if r is not None]
                row = {"mesh": mesh_name, "shape": ctx.size[shape_name], "state": sdt,
                       "tile": inside[0]["tile"], "ms_by_rank": [r["ms"] for r in inside],
                       "ms": max(r["ms"] for r in inside),
                       "plain_ms": max(r["plain_ms"] for r in inside),
                       "bound_ms": inside[0]["bound_ms"], "bound_by": inside[0]["bound_by"]}
                rows.append(row)
                clock = "device" if ctx.cuda else "host (cpu, not a device time)"
                ctx.say(f"[{label}] tile {row['tile']}: Q2-4 equal to _halo_plain bit for bit on "
                        f"the rows the exchange delivered, the rows the neighbours' own, the tiles "
                        f"equal to Q2-1 on the whole stack, on every rank of the mesh; Q2-4 "
                        f"{row['ms']:.4f} ms ({clock}, slowest rank; by rank "
                        f"{[round(v, 4) for v in row['ms_by_rank']]}), plain "
                        f"{row['plain_ms']:.4f} ms, HBM floor {row['bound_ms']:.4f} ms")
            del y
    return rows


# ---- phase E ---------------------------------------------------------------

def phase_collectives(ctx: Ctx, meshes: dict, grad_numel: int) -> list:
    from admm_deconv_tpu_torch.parallel.distributed import all_gather_cat

    ctx.phase("E")
    rows = []
    clock = "device" if ctx.cuda else "host (cpu, not a device time)"

    def timed(label, ranks, payload_bytes, leaving_bytes, op):
        """ms of ``op`` on every rank that runs it (``op`` None elsewhere)."""
        every = ctx.gather(mean_ms(ctx, op) if op is not None else None)
        floor = 1e3 * leaving_bytes / NVLINK_BYTES_PER_S
        row = {"collective": label, "ranks": ranks, "payload_bytes": payload_bytes,
               "leaving_bytes": leaving_bytes, "ms": max(v for v in every if v is not None),
               "ms_rank0": every[0], "floor_ms": floor}
        rows.append(row)
        ctx.say(f"[E] {label}: {payload_bytes / 1e6:.3f} MB a rank, {leaving_bytes / 1e6:.3f} MB "
                f"leave it; {row['ms']:.4f} ms ({clock}, slowest rank; rank 0 {every[0]:.4f}); "
                f"NVLink floor {floor:.4f} ms")

    for mesh_name, mesh in meshes.items():
        t = mesh.size(mesh.mesh_dim_names.index("tile"))
        d = mesh.size(mesh.mesh_dim_names.index("data")) if "data" in mesh.mesh_dim_names else 1
        group = mesh.get_group("tile") if member(mesh) else None
        for shape_name in mesh_shapes(ctx, mesh):
            b, h, w, c = ctx.size[shape_name]
            nl, ht = b * c // d, h // t
            wp = -(-(w // 2 + 1) // t) * t
            # Bytes a rank holds: the re-shard's complex64 columns, the halo
            # slab, the five residual sums.
            a2a, slab, norms = nl * ht * wp * 8, nl * 4 * w * 4, 5 * nl * 4
            ops = {}
            if group is not None:
                send = torch.zeros((t, nl, ht, wp // t, 2), device=ctx.dev)
                recv = torch.empty_like(send)
                halo = torch.zeros((nl, 4, w), device=ctx.dev)
                gathered = halo.new_empty((t * nl, 4, w))
                sums = torch.zeros((5, nl), device=ctx.dev)
                ops = {"a2a": lambda: dist.all_to_all_single(recv, send, group=group),
                       "halo": lambda: all_gather_cat(gathered, halo, group=group),
                       "norms": lambda: dist.all_reduce(sums, group=group)}
            tag = f"{mesh_name} {(b, h, w, c)}"
            timed(f"{tag} re-shard all_to_all_single ({nl}, {ht}, {wp}) complex64", t, a2a,
                  a2a * (t - 1) / t, ops.get("a2a"))
            timed(f"{tag} halo all-gather ({nl}, 4, {w}) fp32", t, slab, slab * (t - 1),
                  ops.get("halo"))
            timed(f"{tag} residual all_reduce (5, {nl}) fp32", t, norms, 2 * (t - 1) / t * norms,
                  ops.get("norms"))
            ops.clear()
    flat = torch.zeros(grad_numel, device=ctx.dev)
    timed(f"world trainer gradient all_reduce ({grad_numel},) fp32", ctx.world, grad_numel * 4,
          2 * (ctx.world - 1) / ctx.world * grad_numel * 4, lambda: dist.all_reduce(flat))
    return rows


# ---- phase F ---------------------------------------------------------------

def phase_data_parallel(ctx: Ctx, ref: dict | None) -> dict:
    from admm_deconv_tpu_torch.data import DataLoader
    from admm_deconv_tpu_torch.train import Trainer

    ctx.phase("F")
    cfg, kind = train_config(ctx)
    pairs = dp_pairs(ctx, cfg)
    shard = {"process_count": ctx.world, "process_index": ctx.rank}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # A warm-up step of a replica that is thrown away (its all-reduce
        # sets the world's communicator up), then DP_STEPS from the seed.
        warm = Trainer(train_model(ctx, cfg, kind), dataclasses.replace(cfg, mesh_batch=0))
        loader = DataLoader(pairs, batch_size=PER_CARD_BATCH * ctx.world, **shard)
        batches = [warm._to_device(x, y) for x, y in loader]
        check(all(x.shape[0] == PER_CARD_BATCH for x, _ in batches), "a shard of 2 a rank")
        warm.train_step(warm.init_state(), *batches[0], warm._zero_acc())
        model = train_model(ctx, cfg, kind)
        trainer = Trainer(model, dataclasses.replace(cfg, mesh_batch=0))
        check(trainer.data_parallel and trainer.world == ctx.world, "the trainer joined the group")
        state = trainer.init_state()
        cs.reset_counts()
        ms, same = [], []
        for step, (x, y) in enumerate(batches, 1):
            ctx.barrier()
            t0 = time.perf_counter()
            trainer.train_step(state, x, y, trainer._zero_acc())
            ctx.sync()
            ms.append(1e3 * (time.perf_counter() - t0))
            if step == 1:
                grad = [p.grad.detach().clone() for p in model.parameters()]
            same.append(same_on_every_rank(ctx, torch.cat([p.detach().reshape(-1)
                                                           for p in model.parameters()])))
        counts = cs.read_counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _, fwd, bwd = LAUNCHES[kind]
    want = cs.expect_counts(fused_admm_stencil=fwd * cs.DP_STEPS if ctx.cuda else 0,
                            stencil_bwd=bwd * cs.DP_STEPS if ctx.cuda else 0)
    check(counts == want, f"data-parallel launches on rank {ctx.rank}: {counts} != {want}")
    check(all(same), f"replicas differ after steps {[i + 1 for i, s in enumerate(same) if not s]}")
    every_ms = ctx.gather(ms)
    row = {"model": cfg.model if kind == "production" else "smoke", "kind": kind,
           "crop": cfg.im_shape, "global_batch": PER_CARD_BATCH * ctx.world,
           "same_bits_each_step": same, "ms_by_rank": every_ms, "launches": ctx.gather(counts)}
    if ctx.lead:
        ms_n = max(np.mean(m) for m in every_ms)
        ms_1 = float(np.mean(ref["F_alone_ms"]))
        row |= {"grad_rel": grad_rel(grad, ref["F_grad_shards"]),
                "grad_rel_global": grad_rel(grad, ref["F_grad"]),
                "one_card_batch_spread": grad_rel(ref["F_grad_shards"], ref["F_grad"]),
                "params": compare_params(params_of(model), ref["F_params_shards"], cfg.lr_rate),
                "params_global": compare_params(params_of(model), ref["F_params"], cfg.lr_rate),
                "ms_one_card": ref["F_alone_ms"], "ms_step": ms_n, "ms_step_one_card": ms_1,
                "weak_scaling": ms_1 / ms_n}
        p, pg = row["params"], row["params_global"]
        print(f"[F] data-parallel {row['model']} {cfg.im_shape}, {cfg.loss} + {cfg.optimizer} lr "
              f"{cfg.lr_rate}, {ctx.world} ranks x batch {PER_CARD_BATCH} (global "
              f"{row['global_batch']}), {cs.DP_STEPS} steps: replicas equal bit for bit after "
              f"every step {same}", flush=True)
        print(f"[F] step 1's all-reduced gradient, max |d| / max |g|: against one process on the "
              f"mean of the {ctx.world} shards' gradients {row['grad_rel']:.3e} (bound "
              f"{GRAD_RTOL:.0e}); against one process on the global batch "
              f"{row['grad_rel_global']:.3e} (bound {GLOBAL_GRAD_RTOL:.0e}), where one process's "
              f"own global-batch gradient and shard mean differ by "
              f"{row['one_card_batch_spread']:.3e}", flush=True)
        print(f"[F] parameters after {cs.DP_STEPS} steps against one process on the shard means: "
              f"max |d| {p['max_abs']:.3e}, {p['beyond_strict']} of {p['n']} beyond "
              f"{STRICT_PARAM_ATOL:.0e} (strict bound held: {p['strict']}; sign-flip bound held: "
              f"{p['bound']}); against one process on the global batch: max |d| "
              f"{pg['max_abs']:.3e}, {pg['beyond_strict']} beyond (strict {pg['strict']}, "
              f"sign-flip {pg['bound']})", flush=True)
        print(f"[F] ms/step by rank {[[round(v, 3) for v in m] for m in every_ms]}; one card "
              f"without a group at batch {PER_CARD_BATCH}: "
              f"{[round(v, 3) for v in ref['F_alone_ms']]}; slowest rank's mean {ms_n:.3f} ms "
              f"against {ms_1:.3f}: weak-scaling efficiency ms(1)/ms({ctx.world}) "
              f"{row['weak_scaling']:.3f}; launches by rank {row['launches']}", flush=True)
        check(row["grad_rel"] <= GRAD_RTOL,
              f"step 1's gradient off the one-process shard mean by {row['grad_rel']}")
        check(row["grad_rel_global"] <= GLOBAL_GRAD_RTOL,
              f"step 1's gradient off the one-process global batch by {row['grad_rel_global']}")
        check(p["bound"], f"parameters off the one-process shard-mean trainer: {p}")
    return row


# ---- phase G ---------------------------------------------------------------

def write_png_pairs(ctx: Ctx, cfg, dirs: dict) -> None:
    """4 seeded (degraded, clean) pairs a card as 8-bit PNGs, x and y."""
    from PIL import Image

    n = CLI_BATCHES * PER_CARD_BATCH * ctx.world
    (x, y), = cs.training_pairs(ctx.seed + 7, 1, n, cfg.im_shape)
    for k, arr in (("x", x), ("y", y)):
        os.makedirs(dirs[k])
        for i, img in enumerate(arr):
            Image.fromarray(np.round(img * 255).astype(np.uint8)).save(
                os.path.join(dirs[k], f"{i:03d}.png"))


def phase_cli(ctx: Ctx) -> dict:
    """The train CLI across the ranks, in every rank's process: the group of
    the earlier phases is closed first and the CLI joins its own over
    ``env://``."""
    from pathlib import Path

    from admm_deconv_tpu_torch.data import native
    from admm_deconv_tpu_torch.scripts import train
    from admm_deconv_tpu_torch.train import Trainer

    ctx.phase("G")
    cfg, kind = train_config(ctx)
    root = os.path.join(ctx.workdir, "cli")
    dirs = {k: os.path.join(root, "data", k) for k in ("x", "y")}
    if ctx.lead:
        write_png_pairs(ctx, cfg, dirs)
    port = ctx.gather(ranks.free_port() if ctx.lead else None)[0]
    ctx.barrier()
    dist.destroy_process_group()

    with open(os.path.join(REPO, cs.TRAIN_CFG)) as f:
        raw = json.load(f)
    save_dir = os.path.join(root, f"models_rank{ctx.rank}")
    raw |= {"train_data": {"x_path": dirs["x"], "y_path": dirs["y"]},
            "eval_data": {"x_path": dirs["x"], "y_path": dirs["y"]}, "epochs": 1,
            "batch_size": PER_CARD_BATCH * ctx.world, "mesh_batch": 0, "save_dir": save_dir,
            "im_shape": list(cfg.im_shape), **({"model": "smoke"} if kind == "smoke" else {})}
    cfg_path = os.path.join(root, f"cfg_rank{ctx.rank}.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    argv = ["-c", cfg_path, "-n", "multi", "--coordinator", "env://"]
    if not ctx.cuda:
        argv += ["--device", "cpu"]
    means = []
    real_means, real_build, real_tb = (Trainer._epoch_means, train.build_model,
                                       train.tensorboard_available)
    real_native_dir = native.BUILD_DIR

    def recorded(self, acc, n):
        out = real_means(self, acc, n)
        means.append(out)
        return out

    Trainer._epoch_means = recorded
    if kind == "smoke":
        train.build_model = lambda name, cfg, device: SmokeModel().to(device)
    if not ctx.cuda:
        # TensorBoard's import takes TensorFlow along where it is installed
        # (~15 s a rank on a CPU host); the card's runs keep it.
        train.tensorboard_available = lambda: False
    # The native loader builds into the run's directory, not the checkout.
    native.BUILD_DIR = Path(ctx.workdir) / f"native_rank{ctx.rank}"
    os.environ["MASTER_PORT"] = str(port)
    buf = io.StringIO()
    cs.reset_counts()
    try:
        with contextlib.redirect_stdout(buf):
            train.main(argv)
        ctx.sync()
    finally:
        Trainer._epoch_means, train.build_model = real_means, real_build
        train.tensorboard_available = real_tb
        native.BUILD_DIR = real_native_dir
    counts = cs.read_counts()
    check(dist.is_initialized() and dist.get_world_size() == ctx.world, "the CLI joined the ranks")
    printed = buf.getvalue()
    model_dir = os.path.join(save_dir, "multi")
    files = sorted(os.path.relpath(os.path.join(d, f), model_dir)
                   for d, _, fs in os.walk(model_dir) for f in fs)
    batches = CLI_BATCHES
    per_fwd, per_step_fwd, per_step_bwd = LAUNCHES[kind]
    want = cs.expect_counts(
        fused_admm_stencil=(per_step_fwd + per_fwd) * batches if ctx.cuda else 0,
        stencil_bwd=per_step_bwd * batches if ctx.cuda else 0)
    check(counts == want, f"train CLI launches on rank {ctx.rank}: {counts} != {want}")
    if ctx.lead:
        for line in printed.splitlines():
            print(f"    | {line}")
        check(printed.splitlines()[-1] == "DONE", "the CLI's last line on rank 0")
        check("train_eval_metrics_history.csv" in files and "checkpoints/epoch_0.pt" in files
              and sum(f.startswith("best/") for f in files) == 1, f"rank 0 wrote {files}")
    else:
        check(printed == "", f"rank {ctx.rank} printed {printed!r}")
        check(files == [], f"rank {ctx.rank} wrote {files}")
    every = ctx.gather({"means": means, "files": files, "printed_lines": len(printed.splitlines()),
                        "launches": counts})
    check(all(e["means"] == every[0]["means"] for e in every), "the epoch's means differ by rank")
    row = {"batches": batches, "global_batch": PER_CARD_BATCH * ctx.world,
           "files_by_rank": [e["files"] for e in every],
           "printed_lines_by_rank": [e["printed_lines"] for e in every],
           "launches": [e["launches"] for e in every], "means": every[0]["means"]}
    ctx.say(f"[G] train CLI --coordinator env://, {ctx.world} ranks, mesh_batch 0, global batch "
            f"{row['global_batch']}, {batches} train + {batches} eval batches of "
            f"{tuple(cfg.im_shape)} PNGs: files by rank {row['files_by_rank']}; lines printed by "
            f"rank {row['printed_lines_by_rank']}; launches by rank {row['launches']}; the "
            f"epoch's means equal on every rank: {every[0]['means']}")
    return row


# ---- the gradient probe -----------------------------------------------------

def probe_gradient(args, card: str = "cuda") -> None:
    """Phase F's one-process references in this process, no group: the
    production model's step-1 gradient on the global batch of
    PER_CARD_BATCH x ``world`` images against the mean of its 2-image shards'
    gradients, each against a float64 gradient as the truth (on the card, on
    the plain prox path: the kernels take no float64).  Read on the card with
    cuDNN as phase F runs it (fp32, deterministic), on the card with cuDNN
    off (PyTorch's own convolutions), and on this host's CPU; then, on the
    card, each module whose input at the global batch equals its input on a
    shard bit for bit while its output does not."""
    from admm_deconv_tpu_torch.data import DataLoader
    from admm_deconv_tpu_torch.models import build_model, init_parameters
    from admm_deconv_tpu_torch.train import Trainer
    from admm_deconv_tpu_torch.utils.precision import fp32_convs

    world = args.world or 4
    ctx = Ctx(0, world, torch.device(card), SIZES["full"], args.seed, "")
    cfg, _ = train_config(ctx)
    x, y = next(iter(DataLoader(dp_pairs(ctx, cfg), batch_size=PER_CARD_BATCH * world)))
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[probe] {cfg.model} {tuple(cfg.im_shape)}, {cfg.loss}; step 1's gradient on the "
          f"global batch of {len(x)} against the mean of its {world} shards of "
          f"{PER_CARD_BATCH}; TF32 off for matmuls and cuDNN; cuDNN deterministic", flush=True)

    def model_on(device, dtype=torch.float32, prox_impl="auto"):
        model = build_model(cfg.model, dataclasses.asdict(cfg) | {"prox_impl": prox_impl},
                            device=device)
        init_parameters(model, torch.Generator().manual_seed(args.seed))
        return model.to(dtype)

    def gradient(model, xs, ys) -> dict:
        model.zero_grad(set_to_none=True)
        with fp32_convs():
            Trainer(model, cfg).loss_fn(model(xs), ys).backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()
                if p.grad is not None}

    def whole_and_mean(device, dtype=torch.float32, prox_impl="auto", mean=True):
        model = model_on(device, dtype, prox_impl)
        xd, yd = (torch.as_tensor(a, device=device, dtype=dtype) for a in (x, y))
        t0 = time.perf_counter()
        whole = gradient(model, xd, yd)
        if not mean:
            return whole, None, time.perf_counter() - t0
        total = None
        for xs, ys in zip(xd.chunk(world), yd.chunk(world)):
            g = gradient(model, xs, ys)
            total = g if total is None else {n: total[n] + g[n] for n in total}
        return whole, {n: t / world for n, t in total.items()}, time.perf_counter() - t0

    def rel(got: dict, want: dict) -> tuple[float, str]:
        """max |got - want| / max |want| over every tensor, and the tensor
        that holds the largest difference."""
        want = {n: w.to("cpu", torch.float64) for n, w in want.items()}
        diffs = {n: float((got[n].to("cpu", torch.float64) - w).abs().max())
                 for n, w in want.items()}
        worst = max(diffs, key=diffs.get)
        return diffs[worst] / max(float(w.abs().max()) for w in want.values()), worst

    truth, _, secs = whole_and_mean(card, torch.float64, prox_impl="xla", mean=False)
    print(f"[probe] float64 gradient on the card (plain prox path): {secs:.1f} s", flush=True)
    readings = {}
    for label, device, cudnn_on in (("card, cuDNN", card, True),
                                    ("card, cuDNN off", card, False),
                                    ("CPU", "cpu", True)):
        torch.backends.cudnn.enabled = cudnn_on
        if device == "cpu":
            torch.set_num_threads(os.cpu_count() or 1)
        whole, mean, secs = whole_and_mean(device)
        torch.backends.cudnn.enabled = True
        r = {"whole_vs_mean": rel(whole, mean), "whole_vs_f64": rel(whole, truth),
             "mean_vs_f64": rel(mean, truth)}
        readings[label] = r
        print(f"[probe] {label}: max |g_batch - g_shard_mean| / max |g| "
              f"{r['whole_vs_mean'][0]:.3e} (largest in {r['whole_vs_mean'][1]}); against "
              f"float64: the global batch {r['whole_vs_f64'][0]:.3e} (in "
              f"{r['whole_vs_f64'][1]}), the shard mean {r['mean_vs_f64'][0]:.3e} (in "
              f"{r['mean_vs_f64'][1]}); {secs:.1f} s", flush=True)

    # Where the forward first moves with the batch: the input and output of
    # every module that owns parameters (the convolutions and the denoiser
    # bank), in the order they run, on the first shard's images at the
    # global batch and alone; then normalise() (each image's mean and
    # variance over H, W, C), which runs between them.
    from admm_deconv_tpu_torch.models.blocks import normalise

    model = model_on(card)
    owners = [(n, m) for n, m in model.named_modules() if list(m.parameters(recurse=False))]
    seen: list[tuple[str, torch.Tensor, torch.Tensor]] = []

    def hook(name):
        def record(_, inputs, output):
            seen.append((name, inputs[0][:PER_CARD_BATCH].clone(),
                         output[:PER_CARD_BATCH].clone()))
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in owners]
    xd = torch.as_tensor(x, device=card)
    with torch.no_grad(), fp32_convs():
        model(xd)
        at_batch, seen[:] = list(seen), []
        model(xd[:PER_CARD_BATCH])
    for h in handles:
        h.remove()
    calls = [(name, torch.equal(xin, sin), torch.equal(xout, sout))
             for (name, xin, xout), (_, sin, sout) in zip(at_batch, seen)]
    moved = [name for name, same_in, same_out in calls if same_in and not same_out]
    first = next((k for k, (_, same_in, _) in enumerate(calls) if not same_in), None)
    if first is None:
        where = "none"
    else:
        before = [(c[0], c[2]) for c in calls[max(0, first - 2):first]]
        where = f"{calls[first][0]}, after (call, output equal) {before}"
    print(f"[probe] {len(calls)} calls of modules with parameters on the card: equal inputs "
          f"with other outputs {moved}; the first call with another input: {where}", flush=True)
    a = torch.randn((len(x), *cfg.im_shape, 16), generator=torch.Generator(card).manual_seed(0),
                    device=card)
    d = float((normalise(a)[:PER_CARD_BATCH] - normalise(a[:PER_CARD_BATCH])).abs().max())
    print(f"[probe] normalise on a {tuple(a.shape)} tensor: its first {PER_CARD_BATCH} images at "
          f"batch {len(x)} against the same images alone, max |d| {d:.3e}", flush=True)
    print(f"[probe] {json.dumps({k: {m: v[0] for m, v in r.items()} for k, r in readings.items()})}",
          flush=True)


# ---- the rank's run --------------------------------------------------------

def rank_main(args) -> None:
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device_type = args.device
    if device_type == "cpu":
        torch.set_num_threads(1)
    elif rank == 0:  # the transports NCCL picks, read back in phase A
        os.environ |= {"NCCL_DEBUG": "INFO",
                       "NCCL_DEBUG_FILE": os.path.join(args.worker, "nccl.rank0.log")}
    from admm_deconv_tpu_torch.parallel import distributed, make_mesh

    check("jax" not in sys.modules, "the port imported jax")

    dev = torch.device("cuda", rank % torch.cuda.device_count()) if device_type == "cuda" \
        else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(dev)
    ctx = Ctx(rank, world, dev, SIZES[args.size], args.seed, args.worker)
    ref = train_references(ctx) if ctx.lead else None
    distributed.initialize(device_type=device_type)
    check(dist.get_rank() == rank and dist.get_world_size() == world, "env:// rank and world")
    meshes = {name: make_mesh(axes, device_type=device_type)
              for name, axes in mesh_axes(world).items()}
    phase_group(ctx, meshes)
    ctx.out["B"] = phase_dryrun(ctx, meshes, ref)
    ctx.out["C"] = phase_tiled_full(ctx, meshes)
    ctx.out["D"] = phase_halo_on_real_rows(ctx, meshes)
    ctx.out["H"] = phase_bench_cell(ctx)
    cfg, kind = train_config(ctx)
    grad_numel = sum(p.numel() for p in train_model(ctx, cfg, kind, device="cpu").parameters())
    ctx.out["E"] = phase_collectives(ctx, meshes, grad_numel)
    ctx.out["F"] = phase_data_parallel(ctx, ref)
    ctx.out["G"] = phase_cli(ctx)
    check("admm_deconv_tpu" not in sys.modules, "the JAX package was imported")
    done = torch.ones(1, device=dev)
    dist.all_reduce(done)
    check(int(done) == world, "every rank reached the end")
    if ctx.lead:
        kind_name = torch.cuda.get_device_name(0) if ctx.cuda else "cpu"
        summary = {"world": world, "size": args.size, "device": kind_name, **ctx.out}
        print(f"[summary] {json.dumps(summary, default=str)}")
        if ctx.cuda:
            print(f"[summary] nvidia-smi: {cs.nvidia_smi()}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu" if ctx.cuda else "cpu", "kind": kind_name, "count": world}}),
            flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
