#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``admm_deconv_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure raises and exits non-zero:

1. device: a CUDA device must exist (otherwise exit 2 and print no result);
   prints ``nvidia-smi``'s name and power limit of the card;
2. build: compiles the port's six CUDA kernels from
   ``admm_deconv_tpu_torch/csrc``, one nvcc per source, all at once;
3. kernels: the forward stencil against its plain torch version on the
   card, bit for bit, every prox mode, fp32 and bf16 duals, scalar and
   per-plane tau, at the TPU kernel's 1-, 2- and 3-row-block shapes, the
   bench shape, a one-row plane and every inference and training path's
   shape, and again on storage one element off alignment (the row march's
   element-wise accesses); a gradient on the card goes through
   the backward kernel; then the backward kernel against ``_bwd_plain`` at
   the training shapes (also with the outputs nobody asked for skipped), and
   the autograd Function against autograd through the plain forward; then the
   prox-dual kernel against ``_prox_dual_plain`` (and its gradient against
   autograd through the plain composition) and the composite stencil
   against ``_composite_plain``, every mode, tau kind, carry dtype and box,
   at every plane stack an inference path hands them; then the tile-halo
   stencil against ``_halo_plain`` with random halo rows at every tile
   stack a tiled path hands it (a one-row tile and misaligned storage
   included), and over 2 and 4
   tiles of the 1080p batch-4 stack against the circular kernel on the
   whole, bit for bit; then the x-update's complex right-hand side pass
   (``spectral_rhs``) against ``_spectral_rhs_plain`` with ``torch.equal``
   at every half spectrum a solve hands it (``SPECTRAL_SHAPES``), a 0-d
   and a per-plane rho, a C for all planes and one a plane, and on storage
   one bin off alignment (F and B both, or one of them);
4. quality: the 256^2 blocks scenario (3 RGB images, 7x7 motion PSF,
   100 iterations) through ``tv_deconvolve``; PSNR floors, agreement with
   the same solve on the CPU, and one kernel launch per loop iteration;
   then through ``solve_auto`` (both branches) and
   ``composite_tv_deconvolve``, against floors from the JAX package;
5. solve path: ``tv_deconvolve`` at 1080p RGB batch 4, 50 iterations, fp32
   and bf16 state, through the kernels (launches of the stencil and of the
   complex-rhs pass counted) and through the plain composition;
   iterations/s; each state's output ``torch.equal`` to the same solve with
   its complex rhs forced onto the three torch calls; then the stencil
   with bf16 duals alone at the 4K frame's 3 planes of 2160x3840, in ms
   per call, and the complex-rhs pass and its composition alone at
   ``SPECTRAL_TIME_STACKS`` (device ms against the pass's HBM floor);
6. profile: torch.profiler's device time by kernel for one solve per state
   dtype, and the device's idle share under the profiler;
7. inference solvers: ``tv_deconvolve_adaptive`` on ``bench_suite.py``'s
   ttq_1080p and ttq_deep_512 scenes (kernel path against the plain path:
   iterations, rho, launches; seconds to tolerance at check_every 8 and 1);
   ``solve_auto`` with a 50-iteration budget at 1080p batch 4 (the
   policy's state dtype and the other one) and with a tolerance, each held
   by its launch counts to the stencil and check_every the policy implies;
   ``composite_tv_deconvolve`` at 1080p (fp32 and bf16 carry, against the plain path, the box, PSNR)
   and its adaptive twin; then the prox-dual and composite kernels alone
   against their plain twins and HBM floors;
8. tiled solvers on a one-rank NCCL tile mesh: ``bench_suite.py``'s
   tiled_tile1_1080p (fp32 and bf16 state) and
   tiled_adaptive_tile1_1080p_check8 rows, the 4K frame and the tiled
   composite, each beside the single-device solver on the same inputs;
   ``tiled_tv_deconvolve_anderson`` (every outer step, and every 8th with
   the tile-halo kernel between) beside ``tv_deconvolve_anderson``;
   the blocks scenario's quality floor; a profile of the 1080p tiled solve
   (collectives, halo gather and re-shard copies against the single-device
   solve); the tile-halo kernel alone against its plain twin and floor;
9. train parity: one gmsd + AdaBelief step of the same seeded AdmmDenoiser
   on the card and on the CPU: loss, gradients and updated parameters;
10. training path: ``bench.py``'s flagship step (AdmmDenoiser, 2x112^2x3,
   gmsd, AdaBelief lr 1e-4), fp32 and bf16 state, ms/step and kernel
   launches per step; then the benchmark cell's fp32 gradient after 0,
   100 and 300 steps against float64, plainly and along the routes (max
   pools' argmaxes, clamps' branches) the card's forward took, with cuDNN,
   with torch's own convolutions (held to 1e-4 along its routes) and with
   the bank's plain composition besides; then the recompute detector
   (``phase_step_recompute``; alone: ``python3 chip_smoke.py
   --recompute-only``): 200 steps of the ``flagship_train_step`` cell's
   trajectory, each step's gradient computed twice at the same parameters
   and input and the two held to each other (``RECOMPUTE_LIMITS``), every
   20th step held to the float64 step by the cell's own check;
11. production trainer: ``Trainer.fit`` for one epoch at
    ``configs/train_cfg.json`` (batch 2, 256^2 crops) on seeded blocks +
    motion blur + noise pairs, CSV history, checkpoint and resume, ms/step;
12. TV layer: the 1080p ``ADMMDeconv`` train step (2x1080x1920x3, 20
    iterations, remat, Adam, mse) through the kernels (fp32, bf16 state)
    and through the plain composition, ms/step;
13. kernel times: the three stencil kernels and their plain versions at
    the TV layer's 6 planes of 1080x1920, and the forward stencil (fp32 and
    bf16 duals) at the 1080p batch's 12 planes, where the solve cells
    launch it;
14. profile: device time by kernel and idle share for one flagship step and
    one TV-layer step;
15. Anderson acceleration (``tv_deconvolve_anderson``): ``bench_suite.py``'s
    anderson_256 row (the fewest of 20/30/40/50/75/100 Anderson iterations
    that reach 100 plain iterations' residual), anderson_1080p_overhead
    (iterations/s beside ``tv_deconvolve``, peak memory beside
    ``anderson_history_bytes``) and the ttq_1080p ``early_stop`` rows
    (``m=5`` and ``m=5, aa_interval=8``) beside the adaptive solver, the
    kernel path against ``prox_impl="xla"``; a profile of one 1080p solve
    (runs before the tiled phase; the tiled phase drives
    ``tiled_tv_deconvolve_anderson`` beside it);
16. implicit differentiation: the card's ``tv_deconvolve_implicit`` gradients
    against the CPU's on a small seeded problem; the 1080p TV-layer step
    with ``diff_mode="implicit"`` beside the unrolled remat step, ms/step
    and peak memory;
17. data: which of PIL, TensorBoard, g++, make and libpng the machine has;
    the native PNG loader built from ``native/imagefeeder.cpp`` into
    ``admm_deconv_tpu_torch/_build/`` (or why it did not build); the batch
    of ``tests/fixtures`` on each path the machine has, native and PIL, held
    bit for bit against a SHA-256 from the JAX package's same path (and the
    native decode against PIL's where both run); the feeder's ms per batch;
18. the train CLI (``scripts.train``) for one epoch of
    ``configs/train_cfg.json`` from PNG files (``scripts.make_dataset``'s
    AWGN-25 set of the fixtures, or the fixtures themselves where PIL
    cannot write PNGs), its CSV row and checkpoints, a resume to epoch 2,
    launches per batch, and ms per step fed by the feeder beside device
    pairs;
19. data-parallel training: a one-rank NCCL group (``env://``) and
    ``Trainer(mesh_batch=0)`` beside the trainer without a group, the same
    parameters after 3 steps, bit for bit;
20. the demo CLI's ``run`` (``scripts.demo_deconv``) on its synthetic frames,
    each of its six branches: PSNR beside the JAX package's, launches;
21. utils on the card: solver-state save/load, ``profile_trace``, and which
    paths run under ``deterministic_mode()``;
22. the multi-card path at one rank: ``chip_smoke_multi.py --world 1 --size
    cut`` as a subprocess (its launcher, ``env://``, a one-rank NCCL group
    and every phase of the multi-card run at T = 1, at full width with the
    depth cut); its result line and its launch counts;
23. the benchmark: ``bench_torch``'s command (``python3 -m bench_torch``)
    in this process with one timed repeat a cell, at full width, for its
    one-card cells (``main(..., only=)``; the four-card cell runs in
    ``chip_smoke_multi.py``'s phase H): every line
    it prints parses, its eight one-card cells (the 1080p batch-4 solve, the
    flagship step, the 4K frame with bfloat16 state, the 1080p solve to
    tolerance, the composite TV + L1 + box solve, the 1080p TV-layer step,
    the 1080p Anderson solve, the flagship step at batch 8) pass their
    checks and launch counts, each ``*_mfu`` share lies in (0, 1]; then its
    controls (``--controls``, 100 timed units each, the Anderson cell's
    ``ANDERSON_CONTROL_REPEATS`` and the batch-8 step's
    ``TRAIN_B8_CONTROL_REPEATS``):
    the bfloat16-state 1080p solve, the train step with the model's
    output in bfloat16, every gradient or the bank's lam gradient scaled,
    AdaBelief with a frozen state or stale bias corrections, the 4K solve
    handed lam x 1.05, its output with one band of rows offset and its loop
    state stored in float8, the solve to tolerance with eps_rel x 10,
    without rho adaptation or handed lam x 1.05, the composite solve one
    iteration short, handed lam_l1 x 1.05 or with one band of rows of its
    output offset, the TV-layer step with lam's gradient x 1.05, one
    iteration short or rho frozen, the Anderson solve with no mixing, a
    window of 4, one iteration short, handed lam x 1.05 or with its mixing
    coefficients x 1.05, the batch-8 step with the train step's five
    faults, each through its cell's own run, each of
    which the cells' checks must reject.  The cells' plane stacks must be
    among ``KERNEL_SHAPES``, those of the cells that run Q2-2 among
    ``BWD_SHAPES``, those of the cells that run Q2-5
    among ``PROX_DUAL_SHAPES``, those that run Q2-3 among
    ``COMPOSITE_SHAPES`` and the four-card cell's tiles among
    ``HALO_SHAPES``.

Besides, phase 4 solves a float64 numpy input with every solver (float32
on the card, through its kernel) and measures a numpy pair with the
metrics against the JAX package's values; phase 8 does the same for the
tiled solver.

Every path zeroes the kernels' launch counters just before it runs and
checks them just after.  Each kernel's time is printed per call from the
host (``cuda_ms``) and on the device alone (``device_ms``); the build
prints the ptxas report of each row-march kernel instantiation.
The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# The kernels' launch counters and the card's rates, shared with the benchmark.
from bench_torch.cells import counters as _counters  # noqa: E402
from bench_torch.cells import read_counts, reset_counts  # noqa: E402
from bench_torch.work import HBM_BYTES_PER_S  # noqa: E402

LAM, RHO = 0.0041, 0.021
BENCH_SHAPE, BENCH_ITERS, REPEATS = (4, 1080, 1920, 3), 50, 4
# The training paths' plane stacks: the bench flagship's and the production
# crop's denoiser banks (5 branches x batch 2 x RGB), the train CLI's last
# batch of one from the three fixtures (5 x 1 x RGB), an odd shape, and the
# 1080p TV-layer step (batch 2 x RGB: bench_torch's tv_layer_1080p_step
# cell); chip_smoke_multi.py's one-process step on the global batch of 2 a
# rank at worlds 2 and 4 (5 x 4 and 5 x 8 x RGB at 256^2) and its dryrun
# trainer's batch of 1 a rank and of the world in one process (32^2); the
# flagship's bank at batches 4 and 8 (bench_suite.py's --train-scaling rows,
# chip_times.py --train-scaling; batch 8 is bench_torch's
# flagship_train_step_b8 cell).  Both kernels are checked at these.
BWD_SHAPES = [(30, 112, 112), (30, 256, 256), (15, 256, 256), (3, 37, 101), (6, 1080, 1920),
              (60, 256, 256), (120, 256, 256), (3, 32, 32), (6, 32, 32), (12, 32, 32),
              (60, 112, 112), (120, 112, 112)]
# chip_smoke_multi.py's one-card solves besides the 1080p batch 4: the 4K
# frame, a 2-frame 4K batch, and dryrun_multichip's scenes at worlds 1, 2
# and 4 (2 x 8W x 32 x RGB, and 2 x 4W x 32 x RGB for its data x tile case).
# The forward, prox-dual and composite kernels are checked at these.
MULTI_SOLVE_SHAPES = [(3, 2160, 3840), (6, 2160, 3840), (6, 8, 32), (6, 32, 32), (6, 16, 32)]
# The inference paths' plane stacks besides the 1080p batch-4 one: the
# ttq_deep_512 scene (4 x 512^2 x RGB) and the blocks scenario (3 x 256^2 x
# RGB).  The forward, prox-dual and composite kernels are checked at these.
INFERENCE_SHAPES = [(12, 512, 512), (9, 256, 256)]
# The forward kernel's further shapes: the TPU kernel's 1-, 2- and 3-row-block
# shapes, the 1080p batch-4 solve, a one-row plane, and the one-card
# yardstick of bench_torch's four-card cell (its batch of four 4K frames).
KERNEL_SHAPES = [(2, 24, 128), (1, 256, 2048), (1, 384, 2048), (12, 1080, 1920),
                 *INFERENCE_SHAPES, *BWD_SHAPES, *MULTI_SOLVE_SHAPES, (2, 1, 64),
                 (12, 2160, 3840)]
# The three row-march kernels' stacks (forward, tile, backward) held again
# with misaligned storage (the march's element-wise accesses): a width not a
# multiple of 4, aligned widths, a one-row plane, a 4K stack with 64-bit
# offsets, the batch-2 flagship step's bank (one warp a row in the backward).
MISALIGNED_SHAPES = [(3, 37, 101), (2, 24, 128), (6, 8, 32), (2, 1, 64), (3, 2160, 3840),
                     (30, 112, 112)]
KERNEL_SOURCES = ("stencil_fwd", "stencil_bwd", "prox_dual", "stencil_composite",
                  "stencil_halo", "spectral_rhs")
# The three kernels built on the row march (csrc/stencil_march.cuh): their
# ptxas report is printed in full.
MARCH_SOURCES = ("stencil_fwd", "stencil_halo", "stencil_bwd")
CSRC = "admm_deconv_tpu_torch/csrc"
TPU_KERNELS = "admm_deconv_tpu/ops/pallas/stencil_kernels.py"
TPU_PROX_KERNELS = "admm_deconv_tpu/ops/pallas/prox_kernels.py"
# The JAX package's x-update, which the complex-rhs pass computes: jnp that
# XLA fuses, no Pallas kernel.
TPU_X_UPDATE = "admm_deconv_tpu/ops/solver.py:386 (_solve_spectral, jnp; no TPU kernel)"
# The prox-dual kernel's shapes (the last with a scalar tau only: its
# leading axes are not planes) and the composite kernel's.  The 6-plane
# stacks are the implicit layer's: the 1080p TV-layer step and the small
# problem whose gradients are held against the CPU's.
IMPLICIT_GRAD_SHAPE = (2, 48, 64, 3)
PROX_DUAL_SHAPES = [(12, 1080, 1920), *INFERENCE_SHAPES, (3, 37, 101), (6, 1080, 1920),
                    (IMPLICIT_GRAD_SHAPE[0] * IMPLICIT_GRAD_SHAPE[3], *IMPLICIT_GRAD_SHAPE[1:3]),
                    *MULTI_SOLVE_SHAPES]
PROX_DUAL_SCALAR_SHAPES = [(2, 3, 5, 7)]
COMPOSITE_SHAPES = [(12, 1080, 1920), *INFERENCE_SHAPES, (3, 37, 101), (30, 112, 112),
                    *MULTI_SOLVE_SHAPES]
# The tile-halo kernel's tile stacks: the 1080p batch-4 solve and the 4K
# frame at one tile, their tiles at T = 4 and T = 2, the 1080p batch and a
# 2-frame 4K batch on chip_smoke_multi.py's data 2 x tile 2 mesh (6 x 540 x
# 1920 and 3 x 1080 x 3840, the latter also 4K at T = 2) and data 2 x tile
# 1 mesh (6 x 1080 x 1920, and the 4K frame), the tiles of
# dryrun_multichip's scenes (6 x 8 x 32; 3 x 8 x 32 on data x tile), the
# blocks scenario at one tile, an odd shape, a one-row tile, bench_torch's
# four-card cell's tile of four 4K frames on 4 cards; and the tile counts
# of the decomposition check.
HALO_SHAPES = [(12, 1080, 1920), (3, 2160, 3840), (12, 270, 1920), (3, 540, 3840),
               (12, 540, 1920), (3, 1080, 3840), (6, 540, 1920), (6, 1080, 1920),
               (6, 8, 32), (3, 8, 32),
               (9, 256, 256), (3, 37, 101), (2, 1, 64), (12, 540, 3840)]
HALO_TILES = (2, 4)
# The complex-rhs pass's image stacks (its half spectra are (N, H, W//2+1)):
# every solve's x-update runs where no graph is recorded, at the stacks its
# stencil or prox-dual pass takes (the denoiser banks in evaluation
# included); (3, 37, 101) and (2, 1, 64) give an odd plane of bins.
SPECTRAL_SHAPES = sorted(set(KERNEL_SHAPES) | set(PROX_DUAL_SHAPES) | set(COMPOSITE_SHAPES))
# Where the pass is timed: the 1080p batch-4 solve's 12 planes (rho 0-d, one
# C), the 4K frame's 3, and 12 planes with a rho and a C a plane (the
# adaptive solvers').
SPECTRAL_TIME_STACKS = (((12, 1080, 1920), False), ((3, 2160, 3840), False),
                        ((12, 1080, 1920), True))
# The tile-halo kernel's timed stacks: the 1080p batch-4 solve, the TV
# layer's 6 planes and the 4K frame at one tile, chip_smoke_multi.py's
# five tile stacks on 4 cards, and bench_torch's four-card cell's tile.
HALO_TIME_SHAPES = [(12, 1080, 1920), (6, 1080, 1920), (3, 2160, 3840), (12, 540, 1920),
                    (3, 1080, 3840), (12, 270, 1920), (3, 540, 3840), (6, 540, 1920),
                    (12, 540, 3840)]
# bench.py's 4K frame; bench_suite.py's tiled adaptive row (96 iterations,
# check_every 8, tolerances 0 so every block runs).
FRAME_4K = (1, 2160, 3840, 3)
FRAME_STACK = (3, 2160, 3840)  # its planes: the solve_4k_frame_bf16 cell's stack
BENCH_STACK = (12, 1080, 1920)  # the 1080p batch 4's planes, and the ttq scene's
TILE4_STACK = (12, 540, 3840)  # a tile of four 4K frames on 4 cards: tiled_4k_b4_tile4's
TILED_ADAPTIVE_ITERS = 96
# bench_suite.py's time-to-tolerance scenes: tile grid, tile px, eps_abs,
# eps_rel, iteration cap (check_every=8, adapt_rho=True).
TTQ = {"ttq_1080p": ((4, 27, 48, 3), 40, 1e-4, 1e-3, 200),
       "ttq_deep_512": ((4, 32, 32, 3), 16, 1e-5, 1e-4, 400)}
TTQ_REPEATS, CHECK_EVERY = 3, 8
COMPOSITE_KW = {"lam_tv": LAM, "lam_l1": 0.002, "rho1": RHO, "rho2": RHO,
                "x_bounds": (0.0, 1.0)}
# bench_suite.py's Anderson rows: the iteration ladder of anderson_256, the
# window, and the every-k mixing interval of the ttq rows.
ANDERSON_LADDER, ANDERSON_M, AA_INTERVAL = (20, 30, 40, 50, 75, 100), 5, 8
# Timed units of each of the Anderson cell's and the batch-8 step's controls
# in phase_bench (each check reads only the last unit).
ANDERSON_CONTROL_REPEATS, TRAIN_B8_CONTROL_REPEATS = 2, 10
# bench.py's flagship step and bench_suite.py's 1080p TV-layer step.
FLAGSHIP_SHAPE, FLAGSHIP_REPEATS, FLAGSHIP_LAUNCHES = (2, 112, 112, 3), 8, 49
TV_SHAPE, TV_ITERS, TV_REPEATS = (2, 1080, 1920, 3), 20, 4
# The flagship steps' denoiser-bank stacks (5 branches x batch x RGB at
# 112^2: the batch-2 and batch-8 cells), where Q2-1 and Q2-2 are timed in
# iso mode with a per-plane tau; and the fp32 operations a pixel of each in
# iso mode (D, the prox or its VJP with its sqrt and divisions, D^T).
FLAGSHIP_STACKS = [(30, 112, 112), (120, 112, 112)]
FWD_ISO_OPS, BWD_ISO_OPS = 23, 45
# Cuts of the backward march besides its default (``bwd_march_geometry``'s
# keyword arguments): each is held at every BWD_SHAPES stack too.
BWD_GEOMETRIES = ({"cols": 1, "max_warps": 8, "rows": 3}, {"cols": 1, "rows": 1},
                  {"cols": 4, "max_warps": 2, "rows": 4}, {"cols": 4, "max_warps": 8, "rows": 1},
                  {"cols": 4, "rows": 16})
TRAIN_CFG = "configs/train_cfg.json"
TRAINER_BATCHES = (4, 2)  # train, eval batches of the production-trainer epoch
FIXTURES = "tests/fixtures"  # china, flower, hopper: 256^2 RGB PNGs
# The JAX package on the CPU: SHA-256 of the float32 x batch of
# ImageDataFeeder(FIXTURES, FIXTURES, ".png", (128, 128), (128, 128),
# rng=np.random.default_rng(0), backend=...)[[0, 1, 2]] on each path (the
# native path draws its crops from one 64-bit seed, PIL's from two
# integers an image, and scales by 1/255 in another order).
DATA_CROP = (128, 128)
FIXTURE_BATCH_SHA256 = {
    "native": "fafd3d24131bcae6836365c892d43be6db3ec6d1246921daff0c21aaf974ec6d",
    "pil": "5eea011aeee5b0a4e49409550bc9934e5e98ab30113be72f7ac7f1ea0072b39a",
}
# The JAX package's metrics on the CPU of the seed-11 numpy pair
# (tests/test_torch_metrics.py's numpy_pair).
NUMPY_PAIR_JAX = {"peak_snr": 26.293628692626953, "ssim": 0.9848365783691406,
                  "gmsd": 0.035629257559776306}
DP_STEPS = 3  # data-parallel steps held bit for bit
MULTI_WORLD1_DEADLINE = 150  # chip_smoke_multi.py --world 1 --size cut, seconds
# The demo's branches (scripts/demo_deconv.py:143-184) and the JAX package's
# PSNR of each on the CPU (synthetic_images(), 100 iterations, batch PSNR of
# the clipped result): the JAX script's own calls, with prox_impl "pallas"
# (its interpreted kernel) for bf16 state, which its CPU "auto" path lacks.
# JAX's --auto on the CPU takes fp32 state (54.828896), as the card does by
# the policy measured on the H100 (ops/policy.py); bf16 state at check_every
# 8 gives 54.828594 in the JAX package.
DEMO_BRANCHES = {"plain": [], "adaptive": ["--adaptive"], "l1": ["--l1", "0.002"],
                 "anderson": ["--anderson"], "auto": ["--auto"], "bf16_state": ["--bf16-state"]}
DEMO_PSNR_JAX = {"plain": 54.55244064331055, "adaptive": 50.28718185424805,
                 "l1": 51.116966247558594, "anderson": 56.75689697265625,
                 "auto": 54.828895568847656, "bf16_state": 54.4243278503418}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def motion_psf(device) -> torch.Tensor:
    psf = torch.zeros((7, 7), dtype=torch.float32, device=device)
    psf[3, :] = 1.0 / 7.0
    return psf


def bf16_ulp_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal, or at most one bf16 ulp apart at the larger magnitude."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((g - w).abs() <= ulp).all())


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts one element past an
    aligned address."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def fp32_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """|got - want| <= 1e-5 + 1e-5 |want| everywhere."""
    return bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())


def cuda_ms(fn, calls: int) -> float:
    """Mean device ms per call of ``fn`` over ``calls`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, calls: int) -> float:
    """Device ms per call of ``fn``'s kernel, with none of the host's time
    (``cuda_ms`` times the calls from the host's side, so a wrapper slower
    than its kernel shows there).  ``calls`` calls, each after a 128 MB read
    that evicts the 50 MB L2 (as the solver's FFTs between two stencil calls
    do), are captured into one CUDA graph and replayed between CUDA events;
    the same graph of reads alone is timed too and taken off.  (The
    profiler's kernel records were tried first: on an H100 they lost some or
    all of a session's launches once a process had profiled a while.)"""
    flush = torch.ones(32 << 20, device="cuda")
    fn()  # builds and loads the kernel outside the capture
    torch.cuda.synchronize()
    graphs = {"kernel": torch.cuda.CUDAGraph(), "reads": torch.cuda.CUDAGraph()}
    for name, graph in graphs.items():
        with torch.cuda.graph(graph):
            for _ in range(calls):
                flush.max()
                if name == "kernel":
                    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = {}
    for name, graph in graphs.items():
        runs = []
        for _ in range(3):
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        ms[name] = min(runs)
    return (ms["kernel"] - ms["reads"]) / calls


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(2)
    print(f"[device] nvidia-smi: {nvidia_smi()}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from admm_deconv_tpu_torch.ops.kernels import (
        _build,
        prox_kernels,
        spectral_kernels,
        stencil_kernels,
    )

    t0 = time.perf_counter()
    # One nvcc per source, all started together: each thread waits on its own.
    loaders = (stencil_kernels._kernel_fn, stencil_kernels._bwd_kernel_fn,
               prox_kernels._kernel_fn, stencil_kernels._composite_kernel_fn,
               stencil_kernels._halo_kernel_fn, spectral_kernels._kernel_fn)
    with ThreadPoolExecutor(len(loaders)) as pool:
        for future in [pool.submit(fn) for fn in loaders]:
            future.result()
    print(f"[build] {', '.join(KERNEL_SOURCES)} built/loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in zip(KERNEL_SOURCES, map(_build.library_path, KERNEL_SOURCES)):
        log = lib.with_name(lib.name + ".log")
        text = log.read_text() if log.is_file() else ""
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", text)})
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", text)))
        print(f"[build] {lib.name.split('-')[0]} ptxas: {len(regs) and regs[0]}-"
              f"{len(regs) and regs[-1]} registers per instantiation, spill stores {spills}")
        if name in MARCH_SOURCES:
            for entry in ptxas_entries(text):
                print(f"[build]   {name} {entry}")


def ptxas_entries(log: str) -> list[str]:
    """Each kernel instantiation's line of nvcc's ``-Xptxas -v`` report:
    template arguments, registers, spill bytes and shared memory."""
    lines = []
    for block in log.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'([^']+)'", block)
        args = (re.search(r"ILi(\d)E(f|13__nv_bfloat16)(?:Li(\d)E)?E", name.group(1))
                if name else None)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        mode = "?" if args is None else ("aniso", "iso", "hard", "gauss")[int(args.group(1))]
        dual = "?" if args is None else ("fp32" if args.group(2) == "f" else "bf16")
        cols = "" if args is None or args.group(3) is None else f", {args.group(3)} cols"
        lines.append(f"<{mode}, {dual}{cols}>: {regs.group(1) if regs else '?'} registers, spill "
                     f"stores/loads {spill.group(1) if spill else '?'}/"
                     f"{spill.group(2) if spill else '?'} B, shared memory "
                     f"{smem.group(1) if smem else 0} B")
    return lines


def phase_kernels(dev, gen) -> dict:
    """Each kernel against ``_stencil_plain`` on the same CUDA inputs."""
    from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _stencil_plain,
        fused_admm_stencil,
        fused_admm_stencil_bwd,
        fused_admm_stencil_mixed,
    )

    print("[kernels] tolerance: kernel equal to the plain twin bit for bit (fp32 and bf16)")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in KERNEL_SHAPES:
        n = shape[0]
        x = torch.randn(shape, generator=gen, device=dev)
        u32 = [0.5 * torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
        tau_v = torch.empty(n, device=dev).uniform_(0.1, 0.5, generator=gen)
        for dual in (torch.float32, torch.bfloat16):
            ux, uy = (u.to(dual) for u in u32)
            wrapper = fused_admm_stencil if dual == torch.float32 else fused_admm_stencil_mixed
            for mode in MODES:
                for tau_kind, tau in (("scalar", torch.tensor(0.3, device=dev)),
                                      ("plane", tau_v)):
                    got = wrapper(x, ux, uy, tau, mode=mode)
                    want = _stencil_plain(x, ux, uy, tau, mode)
                    torch.cuda.synchronize()
                    err = 0.0
                    for g, w in zip(got, want):
                        check(g.dtype == dual and g.shape == x.shape, f"{shape} output layout")
                        check(bool(torch.isfinite(g).all()), f"{shape} {mode} non-finite")
                        err = max(err, float((g.float() - w.float()).abs().max()))
                        check(torch.equal(g, w),
                              f"kernel vs plain {shape} {mode} {dual} {tau_kind}: {err}")
                    worst[dual] = max(worst[dual], err)
                    print(f"[kernels] {str(shape):16s} {mode:5s} {str(dual)[6:]:8s} "
                          f"tau={tau_kind:6s} max|kernel-plain|={err:.3e}")
    # Rows the 16-byte accesses do not fit: storage one element off an
    # aligned address takes the element-wise accesses of the same kernel.
    for shape in MISALIGNED_SHAPES:
        x = misaligned(torch.randn(shape, generator=gen, device=dev))
        u32 = [0.5 * torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
        for dual in (torch.float32, torch.bfloat16):
            ux, uy = (misaligned(u.to(dual)) for u in u32)
            wrapper = fused_admm_stencil if dual == torch.float32 else fused_admm_stencil_mixed
            for mode in MODES:
                got = wrapper(x, ux, uy, torch.tensor(0.3, device=dev), mode=mode)
                want = _stencil_plain(x, ux, uy, torch.tensor(0.3, device=dev), mode)
                for g, w in zip(got, want):
                    check(torch.equal(g, w), f"kernel vs plain {shape} {mode} {dual} misaligned")
        print(f"[kernels] {str(shape):16s} misaligned storage, every mode, fp32 and bf16: "
              f"equal to the plain twin")
    x = torch.zeros((1, 8, 8), device=dev)
    x[0, :, 4:] = 1.0  # a flat region under zero duals: iso's v = 0
    x.requires_grad_()
    before = fused_admm_stencil_bwd.launches
    q, ux, _ = fused_admm_stencil(x, torch.zeros_like(x), torch.zeros_like(x), 0.1, mode="iso")
    (q.sum() + 0.3 * ux.sum()).backward()
    check(fused_admm_stencil_bwd.launches == before + 1, "the gradient went through the kernel")
    check(bool(torch.isfinite(x.grad).all()), "iso flat-region gradient not finite")
    print("[kernels] a gradient on the card goes through stencil_bwd and is finite "
          "at an iso flat region")
    return worst


def _taub_terms(x, ux, uy, tau, gq, gux, guy, mode):
    """The per-pixel tau-cotangent terms, as ``_bwd_plain`` computes them
    before its sum: what the kernel's table of partial sums adds up."""
    from admm_deconv_tpu_torch.ops.diff import grad2d
    from admm_deconv_tpu_torch.ops.kernels.prox_math import prox_vjp

    t = tau if tau.ndim == 0 else tau[:, None, None]
    dxx, dxy = grad2d(x)
    wbx, wby = grad2d(gq.float())
    _, _, terms = prox_vjp(mode, dxx + ux.float(), dxy + uy.float(), t,
                           2.0 * wbx - gux.float(), 2.0 * wby - guy.float())
    return terms


def _taub_abs_sum(*args):
    """Per-plane sum of |tau-cotangent terms|: the scale of the tau check."""
    return _taub_terms(*args).abs().sum(dim=(-2, -1))


def phase_bwd_kernels(dev, gen) -> dict:
    """The backward kernel against ``_bwd_plain`` on the same CUDA inputs, bit
    for bit, and its table of tau partial sums against
    ``_taub_partials_plain`` (the emulation of its fixed order), bit for bit;
    then
    the autograd Function against autograd through ``_stencil_plain``."""
    from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _bwd_plain,
        _stencil_bwd_table,
        _stencil_plain,
        _taub_partials_plain,
        fused_admm_stencil,
        fused_admm_stencil_bwd,
    )

    def compare(got, args, dual, what) -> float:
        """Each output the kernel wrote against the plain one, and its table
        against the emulation of its order; None where skipped."""
        want = _bwd_plain(*args)
        err = 0.0
        for k, (g, w) in enumerate(zip(got[:3], want[:3])):
            if g is None:
                continue
            want_dtype = torch.float32 if k == 0 else dual
            check(g.dtype == want_dtype and g.shape == w.shape, f"bwd {what} output {k} layout")
            check(bool(torch.isfinite(g).all()), f"bwd {what} non-finite")
            err = max(err, float((g.float() - w.float()).abs().max()))
            check(torch.equal(g, w), f"bwd vs plain {what} out {k}: {err}")
        if got[3] is not None:
            table = _taub_partials_plain(_taub_terms(*args))
            check(got[3].shape == table.shape, f"taub table shape {tuple(got[3].shape)}")
            check(torch.equal(got[3], table), f"taub table {what}: "
                  f"{float((got[3] - table).abs().max())} from the emulated order")
        return err

    print("[bwd] tolerance: xbar, uxbar, uybar equal to the plain twin bit for bit; the "
          "tau table equal to _taub_partials_plain bit for bit; taub (the table's sum) "
          "|kernel-plain| <= 1e-5 * sum|terms| per plane (the plain sum's order differs)")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in BWD_SHAPES:
        n = shape[0]
        x = torch.randn(shape, generator=gen, device=dev)
        u32 = [0.5 * torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
        g32 = [torch.randn(shape, generator=gen, device=dev) for _ in range(3)]
        tau_v = torch.empty(n, device=dev).uniform_(0.1, 0.5, generator=gen)
        for dual in (torch.float32, torch.bfloat16):
            ux, uy = (u.to(dual) for u in u32)
            gq, gux, guy = (g.to(dual) for g in g32)
            for mode in MODES:
                for tau_kind, tau in (("scalar", torch.tensor(0.3, device=dev)),
                                      ("plane", tau_v)):
                    args = (x, ux, uy, tau, gq, gux, guy, mode)
                    what = f"{shape} {mode} {dual} {tau_kind}"
                    table = _stencil_bwd_table(*args)
                    got = fused_admm_stencil_bwd(*args)
                    torch.cuda.synchronize()
                    check(all(g is not None for g in got), f"bwd {what}: an output is missing")
                    check(got[3].shape == (n,), f"taub shape {tuple(got[3].shape)}")
                    err = compare(table, args, dual, what)
                    for g, t in zip(got[:3], table[:3]):
                        check(torch.equal(g, t), f"bwd {what}: two launches differ")
                    check(torch.equal(got[3], torch.sum(table[3], dim=1)),
                          f"bwd {what}: taub is not the table's sum")
                    worst[dual] = max(worst[dual], err)
                    scale = _taub_abs_sum(*args)
                    terr = (got[3] - _bwd_plain(*args)[3]).abs()
                    check(bool((terr <= 1e-5 * scale).all()), f"taub {what}: {float(terr.max())}")
                    print(f"[bwd] {str(shape):16s} {mode:5s} {str(dual)[6:]:8s} "
                          f"tau={tau_kind:6s} max|kernel-plain|={err:.3e} table equal, "
                          f"taub rel={float((terr / scale.clamp_min(1e-30)).max()):.2e}")
            # The kernel's skip branches (null output pointers), as the
            # autograd Function takes them when some input needs no gradient.
            args = (x, ux, uy, tau_v, gq, gux, guy, "iso")
            for need in ((False, True, True), (True, False, False), (False, False, True)):
                got = _stencil_bwd_table(*args, *need)
                torch.cuda.synchronize()
                check([g is not None for g in got] == [need[0], need[1], need[1], need[2]],
                      f"bwd {shape} skip {need}: outputs {[g is None for g in got]}")
                worst[dual] = max(worst[dual], compare(got, args, dual,
                                                       f"{shape} iso {dual} skip {need}"))
            print(f"[bwd] {str(shape):16s} iso   {str(dual)[6:]:8s} need (x, u, tau) in "
                  f"{{(F,T,T), (T,F,F), (F,F,T)}}: written outputs equal the plain ones, "
                  f"skipped ones None")
    # The other cuts of the march (columns a thread, warps a block, strips),
    # which the default geometry does not take at these stacks: iso, a tau a
    # plane.
    from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk

    chosen = sk.bwd_march_geometry
    for shape in BWD_SHAPES + [(2, 24, 300)]:
        x = torch.randn(shape, generator=gen, device=dev)
        arrays = [torch.randn(shape, generator=gen, device=dev) for _ in range(5)]
        tau_v = torch.empty(shape[0], device=dev).uniform_(0.1, 0.5, generator=gen)
        for kw in BWD_GEOMETRIES:
            geo = chosen(*shape, **kw)
            if geo == chosen(*shape):
                continue
            sk.bwd_march_geometry = lambda *_, geo=geo: geo
            try:
                for dual in (torch.float32, torch.bfloat16):
                    ux, uy, gq, gux, guy = (a.to(dual) for a in arrays)
                    args = (x, ux, uy, tau_v, gq, gux, guy, "iso")
                    compare(_stencil_bwd_table(*args), args, dual, f"{shape} iso {geo}")
            finally:
                sk.bwd_march_geometry = chosen
        print(f"[bwd] {str(shape):16s} iso, fp32 and bf16, under the cuts {BWD_GEOMETRIES}: "
              f"equal to the plain twin, table equal")
    # Rows the 16-byte accesses do not fit: storage one element off an
    # aligned address takes the element-wise accesses of the same march.
    for shape in MISALIGNED_SHAPES:
        x = misaligned(torch.randn(shape, generator=gen, device=dev))
        arrays = [torch.randn(shape, generator=gen, device=dev) for _ in range(5)]
        tau_v = torch.empty(shape[0], device=dev).uniform_(0.1, 0.5, generator=gen)
        for dual in (torch.float32, torch.bfloat16):
            ux, uy, gq, gux, guy = (misaligned(a.to(dual)) for a in arrays)
            for mode in MODES:
                args = (x, ux, uy, tau_v, gq, gux, guy, mode)
                compare(_stencil_bwd_table(*args), args, dual, f"{shape} {mode} misaligned")
        print(f"[bwd] {str(shape):16s} misaligned storage, every mode, fp32 and bf16: equal "
              f"to the plain twin, table equal")

    # The Function's gradient against autograd through the plain forward,
    # at inputs whose v sits away from the prox thresholds (|v| or |v|_2 in
    # [0.05, 0.2] or [0.45, 1.0], tau = 0.3): there both are the same
    # derivative, computed in another order.
    shape = (3, 37, 101)
    x = torch.randn(shape, generator=gen, device=dev)
    mag = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5,
                      torch.empty(shape, device=dev).uniform_(0.05, 0.2, generator=gen),
                      torch.empty(shape, device=dev).uniform_(0.45, 1.0, generator=gen))
    ang = torch.empty(shape, device=dev).uniform_(0, 2 * torch.pi, generator=gen)
    dxx = x - torch.roll(x, 1, dims=-1)
    dxy = x - torch.roll(x, 1, dims=-2)
    cts = [torch.randn(shape, generator=gen, device=dev) for _ in range(3)]
    for mode in MODES:
        if mode in ("aniso", "hard"):  # per component
            sx = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5, 1.0, -1.0)
            vx_t, vy_t = sx * mag, -sx * mag.flip(-1)
        else:  # per magnitude
            vx_t, vy_t = mag * torch.cos(ang), mag * torch.sin(ang)
        for tau0 in (torch.tensor(0.3, device=dev), torch.full((3,), 0.3, device=dev)):
            grads = []
            for fn in (lambda *a: fused_admm_stencil(*a, mode=mode),
                       lambda *a: _stencil_plain(*a, mode)):
                leaves = [x.clone(), vx_t - dxx, vy_t - dxy, tau0.clone()]
                for t in leaves:
                    t.requires_grad_()
                out = fn(*leaves)
                sum((o * c).sum() for o, c in zip(out, cts)).backward()
                # hard's tau enters only through a comparison: no autograd path
                grads.append([torch.zeros_like(t) if t.grad is None else t.grad
                              for t in leaves])
            scale = _taub_abs_sum(x, vx_t - dxx, vy_t - dxy, tau0, *cts, mode).sum()
            for name, g, w in zip(("x", "ux", "uy", "tau"), *grads):
                bound = 1e-5 * (float(scale) if name == "tau" else 1.0 + float(w.abs().max()))
                diff = float((g - w).abs().max())
                check(diff <= bound, f"Function grad vs autograd {mode} d{name}: {diff} > {bound}")
        print(f"[bwd] Function gradient = autograd through the plain forward, {mode}: ok")
    return worst


def blocks_scenario(seed: int = 1):
    """``scripts/bench_suite.py``'s parity scenario, in numpy."""
    rng = np.random.default_rng(seed)
    tiles = rng.random((3, 16, 16, 3)) > 0.5
    clean = np.clip(0.2 + np.kron(tiles, np.ones((1, 16, 16, 1))) * 0.4, 0, 1).astype(np.float32)
    psf = np.zeros((7, 7), np.float32)
    psf[3, :] = 1.0 / 7.0
    blurred = sum(
        psf[a, c] * np.roll(clean, (a - 3, c - 3), (1, 2)) for a in range(7) for c in range(7)
    ).astype(np.float32)
    return clean, blurred, psf


def phase_quality(dev) -> None:
    from admm_deconv_tpu_torch import peak_snr, tv_deconvolve
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        fused_admm_stencil,
        fused_admm_stencil_mixed,
    )

    clean, blurred, psf = blocks_scenario()
    kw = {"lam": LAM, "rho": RHO, "iters": 100}
    ref = torch.from_numpy(clean).to(dev)
    y = torch.from_numpy(blurred).to(dev)
    db_blurred = float(peak_snr(y, ref))
    print(f"[quality] blurred PSNR {db_blurred:.4f} dB")
    check(abs(db_blurred - 25.445) < 1e-3, "blurred PSNR 25.445 dB")
    cpu = {
        sdt: tv_deconvolve(torch.from_numpy(blurred), psf=torch.from_numpy(psf),
                           state_dtype=sdt, **kw)
        for sdt in (None, "bfloat16")
    }
    envelope = float((cpu["bfloat16"] - cpu[None]).abs().max())
    for sdt, wrapper, floor in ((None, fused_admm_stencil, QUALITY_FLOORS["tv_deconvolve fp32"]),
                                ("bfloat16", fused_admm_stencil_mixed, 54.85)):
        before = wrapper.launches
        x = tv_deconvolve(y, psf=torch.from_numpy(psf).to(dev), state_dtype=sdt, **kw)
        torch.cuda.synchronize()
        launched = wrapper.launches - before
        check(launched == kw["iters"] - 1, f"{launched} stencil launches in a 100-iteration solve")
        check(x.shape == y.shape and bool(torch.isfinite(x).all()), "restored image layout")
        db = float(peak_snr(torch.clamp(x, 0, 1), ref))
        dev_cpu = float((x.cpu() - cpu[None]).abs().max())
        print(f"[quality] state={sdt or 'float32'}: restored PSNR {db:.4f} dB (floor {floor}), "
              f"{launched} launches, max|card - cpu fp32| {dev_cpu:.3e}")
        check(db >= floor, f"restored PSNR {db} below {floor}")
        bound = 1e-4 if sdt is None else 2 * envelope + 1e-3
        check(dev_cpu <= bound, f"card solve off the CPU solve by {dev_cpu} > {bound}")
    numpy_pair_metrics()


def numpy_pair_metrics() -> None:
    """The metrics on a pair of numpy arrays: it goes to the card as
    float32, and the values equal the JAX package's on the CPU."""
    from admm_deconv_tpu_torch import metrics

    rng = np.random.default_rng(11)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    for name, want in NUMPY_PAIR_JAX.items():
        got = getattr(metrics, name)(x.astype(np.float64), y.astype(np.float64))
        check(got.device.type == "cuda" and got.dtype == torch.float32,
              f"{name} of a numpy pair on {got.device} in {got.dtype}")
        rel = abs(float(got) - want) / want
        print(f"[quality] {name} of a float64 numpy pair (2, 32, 32, 3): {float(got):.7f} on "
              f"{got.device} in {got.dtype}, JAX on the CPU {want:.7f}, rel {rel:.1e} "
              f"(tolerance 1e-5: cuDNN sums in another order)")
        check(rel <= 1e-5, f"{name} of a numpy pair off JAX's by {rel}")


def phase_main_path(dev, gen) -> dict:
    """Time the 1080p batch-4 solve: kernel path (launches counted), plain path."""
    from admm_deconv_tpu_torch import tv_deconvolve
    from admm_deconv_tpu_torch.ops import solver
    from admm_deconv_tpu_torch.ops.kernels.spectral_kernels import (
        _spectral_rhs_plain,
        spectral_rhs,
    )

    y = torch.rand(BENCH_SHAPE, generator=gen, device=dev)
    psf = motion_psf(dev)
    inputs = [y + 0.001 * i for i in range(REPEATS)]

    def solve(v, **kw):
        return tv_deconvolve(v, psf=psf, lam=LAM, rho=RHO, iters=BENCH_ITERS, **kw)

    def iters_per_s(**kw) -> tuple[float, torch.Tensor]:
        out = solve(y, **kw)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for v in inputs:
            out = solve(v, **kw)
        torch.cuda.synchronize()
        return BENCH_ITERS * REPEATS / (time.perf_counter() - t0), out

    reset_counts()
    spectral_rhs.launches = 0
    rate32, x32 = iters_per_s()
    rate16, x16 = iters_per_s(state_dtype="bfloat16")
    counts = read_counts()
    rhs_launches = spectral_rhs.launches
    launches = {"fp32": counts["fused_admm_stencil"], "bf16": counts["fused_admm_stencil_mixed"],
                "spectral_rhs": rhs_launches}
    want = (REPEATS + 1) * (BENCH_ITERS - 1)
    check(counts == expect_counts(fused_admm_stencil=want, fused_admm_stencil_mixed=want),
          f"main-path launches {counts}, want {want} forward")
    # Every x-update of both states' solves: BENCH_ITERS a solve.
    want_rhs = 2 * (REPEATS + 1) * BENCH_ITERS
    check(rhs_launches == want_rhs, f"main-path spectral_rhs launches {rhs_launches}, "
          f"want {want_rhs}")
    # The same solves with the complex rhs forced onto the three torch calls.
    saved = solver.spectral_rhs
    solver.spectral_rhs = _spectral_rhs_plain
    try:
        forced = {name: solve(inputs[-1], **kw) for name, kw in
                  (("fp32", {}), ("bf16", {"state_dtype": "bfloat16"}))}
    finally:
        solver.spectral_rhs = saved
    for name, x in (("fp32", x32), ("bf16", x16)):
        check(torch.equal(x, forced[name]),
              f"{name} solve through spectral_rhs differs from the composition's: max "
              f"{float((x - forced[name]).abs().max()):.3e}")
    print("[main] both states' outputs through spectral_rhs torch.equal to the composition's")

    rate_plain, xp = iters_per_s(prox_impl="xla")
    for name, x in (("fp32", x32), ("bf16", x16), ("plain", xp)):
        check(x.shape == y.shape and bool(torch.isfinite(x).all()), f"{name} bench output")
    d32 = float((x32 - xp).abs().max())
    d16 = float((x16 - xp).abs().max())
    print(f"[main] {BENCH_SHAPE} NHWC, {BENCH_ITERS} iterations: kernel fp32 state {rate32:.2f} it/s, "
          f"kernel bf16 state {rate16:.2f} it/s, plain fp32 {rate_plain:.2f} it/s")
    print(f"[main] max|kernel fp32 - plain| {d32:.3e}, max|kernel bf16 - plain| {d16:.3e}")
    check(d32 <= 1e-4, "kernel fp32 solve off the plain solve")
    print(f"[main] launches in the timed solves: {launches}")
    return {"launches": launches, "solve": solve, "y": y}


def spectral_operands(dev, gen, shape, per_plane: bool, rho_plane: bool) -> tuple:
    """F and B (complex64 half spectra of the image stack ``shape``), C
    (float32, one for all planes or one a plane) and rho (0-d, or ``(N, 1,
    1)`` as the solvers fold it)."""
    n, h, w = shape
    spec = (n, h, w // 2 + 1)
    f, b = (torch.randn(spec, dtype=torch.complex64, generator=gen, device=dev)
            for _ in range(2))
    c = 0.5 + torch.rand(spec if per_plane else spec[1:], generator=gen, device=dev)
    rho = (RHO * (0.5 + torch.rand(n, generator=gen, device=dev)))[:, None, None] \
        if rho_plane else torch.tensor(RHO, device=dev)
    return f, b, c, rho


def phase_spectral_kernel(dev, gen) -> float:
    """The complex-rhs pass against ``_spectral_rhs_plain`` on the same CUDA
    inputs, ``torch.equal`` (the pass rounds after every operation in the
    composition's order): every ``SPECTRAL_SHAPES`` stack, 0-d and
    per-plane rho, one C or a C a plane; and on storage one bin off
    alignment (F and B both: a head bin, then pairs; one of them: bin by
    bin).  Returns the largest |pass - plain| (0.0 when all are equal)."""
    from admm_deconv_tpu_torch.ops.kernels.spectral_kernels import (
        _spectral_rhs_plain,
        spectral_rhs,
    )

    print("[spectral] tolerance: torch.equal with the composition C * (B + rho * F)")
    worst, cases = 0.0, 0
    layouts = {"aligned": (False, False)}
    for shape in SPECTRAL_SHAPES:
        for per_plane in (False, True):
            for rho_plane in (False, True):
                f, b, c, rho = spectral_operands(dev, gen, shape, per_plane, rho_plane)
                want = _spectral_rhs_plain(f, b, c, rho)
                kinds = dict(layouts)
                if shape in MISALIGNED_SHAPES or shape == BENCH_STACK:
                    kinds |= {"F, B misaligned": (True, True), "F misaligned": (True, False),
                              "B misaligned": (False, True)}
                for kind, (mf, mb) in kinds.items():
                    got_f = misaligned(f) if mf else f.clone()
                    b_in = misaligned(b) if mb else b
                    before = spectral_rhs.launches
                    got = spectral_rhs(got_f, b_in, c, rho)
                    torch.cuda.synchronize()
                    what = (f"{shape} C {'a plane' if per_plane else 'shared'} rho "
                            f"{'a plane' if rho_plane else '0-d'} {kind}")
                    check(spectral_rhs.launches == before + 1, f"spectral_rhs launched, {what}")
                    check(got.data_ptr() == got_f.data_ptr(), f"spectral_rhs wrote F, {what}")
                    err = float((got - want).abs().max())
                    worst = max(worst, err)
                    check(torch.equal(got, want), f"spectral_rhs vs plain {what}: {err:.3e}")
                    cases += 1
    print(f"[spectral] {cases} cases torch.equal to the composition "
          f"(max |pass - plain| {worst:.3e})")
    return worst


def phase_spectral_times(dev, gen) -> dict:
    """The complex-rhs pass and its composition (three torch calls) at
    ``SPECTRAL_TIME_STACKS``: ms per call by CUDA events in turns
    (composition, pass, pass, composition), device ms of each (CUDA graph,
    L2 evicted), and the pass's HBM floor: F and B read once, F written
    once (24 B a bin), C and rho read once; 6 operations a bin."""
    from admm_deconv_tpu_torch.ops.kernels.spectral_kernels import (
        _spectral_rhs_plain,
        spectral_rhs,
    )
    from bench_torch.work import least_ms

    times = {}
    for shape, per_plane in SPECTRAL_TIME_STACKS:
        f, b, c, rho = spectral_operands(dev, gen, shape, per_plane, per_plane)
        bins = float(f.numel())
        least = least_ms({"bytes": 24 * bins + 4 * (c.numel() + rho.numel()),
                          "flops": 6 * bins})
        kernel = lambda f=f, b=b, c=c, rho=rho: spectral_rhs(f, b, c, rho)  # noqa: E731
        plain = lambda f=f, b=b, c=c, rho=rho: _spectral_rhs_plain(f, b, c, rho)  # noqa: E731
        p1, k1, k2, p2 = (cuda_ms(fn, 20) for fn in (plain, kernel, kernel, plain))
        key = f"{tuple(f.shape)} {'a rho and a C a plane' if per_plane else 'rho 0-d'}"
        t = times[key] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                          "device_ms": device_ms(kernel, 20),
                          "plain_device_ms": device_ms(plain, 20), **least}
        print(f"[spectral] {key}: pass {k1:.4f}/{k2:.4f} ms per call, device "
              f"{t['device_ms']:.4f} ms ({t['bound_ms'] / t['device_ms']:.1%} of the "
              f"{t['bound_ms']:.4f} ms HBM floor); composition {p1:.4f}/{p2:.4f} ms per call, "
              f"device {t['plain_device_ms']:.4f} ms")
    return times


def phase_stencil_times(dev, gen, shape=None, duals=("fp32", "bf16")) -> dict:
    """The stencil alone at ``shape`` (the bench shape's planes by default),
    kernel vs plain, ms per call, and on the device against its HBM floor."""
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _stencil_plain,
        fused_admm_stencil,
        fused_admm_stencil_mixed,
    )

    shape = shape or (BENCH_SHAPE[0] * BENCH_SHAPE[3],) + BENCH_SHAPE[1:3]
    x = torch.rand(shape, generator=gen, device=dev)
    tau = torch.tensor(LAM / RHO, device=dev)
    times = {}
    for name, dual, wrapper in (("fp32", torch.float32, fused_admm_stencil),
                                ("bf16", torch.bfloat16, fused_admm_stencil_mixed)):
        if name not in duals:
            continue
        ux = (0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
        uy = (0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
        plain = lambda: _stencil_plain(x, ux, uy, tau, "aniso")  # noqa: E731
        kernel = lambda: wrapper(x, ux, uy, tau, mode="aniso")  # noqa: E731
        # plain, kernel, kernel, plain: one card, in turns.
        p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kernel, kernel, plain))
        dev_ms = device_ms(kernel, 20)
        least = bound(shape, 14 if dual == torch.bfloat16 else 24, 21)
        floor = least["bound_ms"]
        times[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "device_ms": dev_ms, **least}
        print(f"[stencil] {shape} {name} duals, aniso: kernel {k1:.4f}/{k2:.4f} ms per call, "
              f"device {dev_ms:.4f} ms ({floor / dev_ms:.1%} of the {floor:.4f} ms HBM floor), "
              f"plain {p1:.4f}/{p2:.4f} ms per call")
    return times


def device_events(prof, label: str) -> list:
    """The profile's device work by name: kernels and copies.  A
    ``record_function`` range (such as ``Optimizer.step``) shows on the
    device's timeline too, under the name of its host range, and would
    count its kernels twice: device events named like a host event are
    left out, and printed."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    ranges = [e for e in device if e.key in host]
    for e in ranges:
        print(f"[profile] {label}: left out of the busy sum, host range on the device: "
              f"{e.key} {e.self_device_time_total / 1e3:.3f} ms")
    return [e for e in device if e.key not in host]


def phase_profile(main: dict) -> None:
    for sdt in (None, "bfloat16"):
        profile_solve(f"state={sdt or 'float32'}",
                      lambda v, sdt=sdt: main["solve"](v, state_dtype=sdt), main["y"])


def expect_counts(**launched) -> dict:
    """Every counter at 0 except the ones named."""
    return {k: 0 for k in _counters()} | launched


def timed_steps(step, inputs) -> float:
    """Mean wall ms per step over ``inputs`` (after one warm-up step on the
    first), host clock around work that ends in a synchronize."""
    step(inputs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in inputs[1:]:
        step(v)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (len(inputs) - 1)


def phase_train_parity(dev, seed: int) -> None:
    """One gmsd + AdaBelief step of the same seeded AdmmDenoiser on the card
    and on the CPU."""
    from admm_deconv_tpu_torch.models import AdmmDenoiser, init_parameters
    from admm_deconv_tpu_torch.train import TrainConfig, Trainer

    lr = 1e-4
    rng = np.random.default_rng(seed)
    x = rng.random(FLAGSHIP_SHAPE, dtype=np.float32)
    t = rng.random(FLAGSHIP_SHAPE, dtype=np.float32)
    cpu_model = init_parameters(AdmmDenoiser(), torch.Generator().manual_seed(seed))
    models = {"cpu": cpu_model, "card": copy.deepcopy(cpu_model).to(dev)}
    res = {}
    for name, model in models.items():
        where = next(model.parameters()).device
        trainer = Trainer(model, TrainConfig(lr_rate=lr, checkpointing=False))
        state = trainer.init_state()
        acc = trainer.train_step(state, torch.from_numpy(x).to(where),
                                 torch.from_numpy(t).to(where), trainer._zero_acc())
        res[name] = float(acc["loss"])
    print("[parity] tolerance: loss rel 1e-4 (convolution sums reassociate); per tensor "
          "max|dgrad| <= 3e-2 * max|grad| (rounding flips max-pool and clamp routing "
          "through ~20 conv layers); updated parameters: every element within 2.25 lr, and "
          "within 1e-3 lr where |grad| >= 1e-5 on both sides with one sign (AdaBelief's first "
          "step is grad / (sqrt(0.81 grad^2 + 1e-13) + 1e-16) * lr, which is lr/0.9 times the "
          "sign to 6e-4 there)")
    loss_rel = abs(res["card"] - res["cpu"]) / abs(res["cpu"])
    worst_g, worst_p, worst_firm, n_firm, n_all = 0.0, 0.0, 0.0, 0, 0
    for (name, pc), pg in zip(cpu_model.named_parameters(), models["card"].parameters()):
        gc, gg = pc.grad, pg.grad.cpu()
        check(bool(torch.isfinite(gg).all()), f"card gradient of {name} not finite")
        rel = float((gg - gc).abs().max()) / max(float(gc.abs().max()), 1e-30)
        worst_g = max(worst_g, rel)
        check(rel <= 3e-2, f"gradient of {name}: card vs cpu {rel:.3e} of its max")
        d = (pg.detach().cpu() - pc.detach()).abs()
        worst_p = max(worst_p, float(d.max()))
        check(float(d.max()) <= 2.25 * lr, f"updated {name} off by {float(d.max())}")
        firm = (gc.abs() >= 1e-5) & (gg.abs() >= 1e-5) & (torch.sign(gc) == torch.sign(gg))
        if bool(firm.any()):
            worst_firm = max(worst_firm, float(d[firm].max()))
        n_firm += int(firm.sum())
        n_all += d.numel()
    print(f"[parity] AdmmDenoiser {FLAGSHIP_SHAPE}: loss card {res['card']:.7f} cpu "
          f"{res['cpu']:.7f} (rel {loss_rel:.2e}); worst grad rel {worst_g:.2e}; updated "
          f"params max |d| {worst_p:.3e}; {n_firm}/{n_all} elements with a firm gradient, "
          f"max |d| there {worst_firm:.3e} ({worst_firm / lr:.2e} lr)")
    check(loss_rel <= 1e-4, f"loss card vs cpu rel {loss_rel}")
    check(worst_firm <= 1e-3 * lr, f"updated element with a firm gradient off by {worst_firm}")


def phase_flagship(dev, seed: int) -> dict:
    """bench.py's flagship step, fp32 and bf16 state: ms/step and launches."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.models import AdmmDenoiser, init_parameters
    from admm_deconv_tpu_torch.optim import AdaBelief
    from admm_deconv_tpu_torch.utils.precision import fp32_convs

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random(FLAGSHIP_SHAPE, dtype=np.float32)).to(dev)
    t = torch.from_numpy(rng.random(FLAGSHIP_SHAPE, dtype=np.float32)).to(dev)
    inputs = [x + 1e-3 * i for i in range(FLAGSHIP_REPEATS + 1)]
    out = {"steps": {}, "launches": {k: 0 for k in read_counts()}}
    for sdt in (None, "bfloat16"):
        model = init_parameters(AdmmDenoiser(state_dtype=sdt),
                                torch.Generator().manual_seed(seed)).to(dev)
        opt = AdaBelief(model.parameters(), 1e-4)
        losses = []

        def step(xi, model=model, opt=opt, losses=losses):
            with fp32_convs():
                loss = gmsd_loss(model(xi), t)
                opt.zero_grad(set_to_none=True)
                loss.backward()
            opt.step()
            losses.append(loss.detach())

        reset_counts()
        ms = timed_steps(step, inputs)
        counts = read_counts()
        out["launches"] = {k: v + counts[k] for k, v in out["launches"].items()}
        per_step = {k: v / len(inputs) for k, v in counts.items()}
        check(all(bool(torch.isfinite(v)) for v in losses), f"flagship {sdt} loss not finite")
        fwd = "fused_admm_stencil_mixed" if sdt else "fused_admm_stencil"
        want = {k: 0 for k in per_step} | {fwd: FLAGSHIP_LAUNCHES, "stencil_bwd": FLAGSHIP_LAUNCHES}
        check(per_step == want, f"flagship {sdt} launches per step {per_step} != {want}")
        name = sdt or "float32"
        out["steps"][name] = (step, inputs[-1], ms)
        print(f"[flagship] {FLAGSHIP_SHAPE} gmsd + AdaBelief, state {name}: {ms:.3f} ms/step "
              f"(1 warm-up, {FLAGSHIP_REPEATS} steps, fresh inputs); launches per step "
              f"{per_step}; loss {float(losses[-1]):.6f}")
    print(f"[flagship] launches in the training path: {out['launches']}")
    return out


# Route flips (the flagship's fp32 gradient against float64): each max pool's
# argmax and each clamp's branch, taken from one forward into another.
CLAMP_TOP = {"relu6": 6.0, "relu1": 1.0}
GRAD_ROUTE_STEPS = (0, 100, 300)  # AdaBelief steps before each read point
# Whole-vector e along the fp32 forward's routes, with cuDNN off (the CPU's
# bound in tests/test_torch_grad_parity.py).
GRAD_ROUTED_LIMIT = 1e-4
# The gradient's variants: cuDNN on, the bank's prox_impl ("auto": Q2-1 and
# Q2-2; "xla": the plain composition, no kernel).
GRAD_ROUTE_VARIANTS = {"cudnn": ("cudnn", "auto"),
                       "native convolutions": ("native convolutions", "auto"),
                       "native convolutions, plain bank": ("native convolutions", "xla")}


def route(kind: str, x: torch.Tensor, window=None) -> tuple[str, torch.Tensor]:
    """The route an NCHW tensor takes through a stride-1 SAME max pool (each
    window's argmax, an index into its plane) or a clamp (0 below 0, 1
    between, 2 above its top)."""
    if kind == "pool":
        return kind, torch.nn.functional.max_pool2d(
            x, tuple(window), 1, (window[0] // 2, window[1] // 2), return_indices=True)[1]
    return kind, (x > 0).to(torch.int8) + (x > CLAMP_TOP[kind]).to(torch.int8)


def _route_takers(routes: list):
    """A max pool and clamps on NCHW tensors that take the next of
    ``routes`` in order, and a check that every route was taken."""
    it = iter(routes)

    def take(kind, shape):
        got, r = next(it)
        check(got == kind and r.numel() == int(np.prod(shape)),
              f"route {got} {tuple(r.shape)} where the forward runs {kind} {tuple(shape)}")
        return r.reshape(shape)

    def pool(v):
        return v.flatten(2).gather(2, take("pool", v.shape).flatten(2)).view_as(v)

    def clamp(kind):
        def f(v):
            b = take(kind, v.shape)
            return v * (b == 1) + CLAMP_TOP[kind] * (b == 2)
        return f

    def done():
        check(next(it, None) is None, "routes left over")

    return pool, clamp, done


@contextlib.contextmanager
def _patched(*changes):
    """Set ``(module, name, value)`` attributes for the block, then restore."""
    old = [(m, n, getattr(m, n)) for m, n, _ in changes]
    try:
        for m, n, v in changes:
            setattr(m, n, v)
        yield
    finally:
        for m, n, v in old:
            setattr(m, n, v)


@contextlib.contextmanager
def port_routes(routes: list, follow: bool):
    """The port's max pools and clamps record their routes (NCHW) into
    ``routes`` or, with ``follow``, take them from it in order.  Build the
    model inside: ``AdmmDenoiser`` keeps the ``relu1`` it finds."""
    from admm_deconv_tpu_torch.models import blocks, zoo

    nchw, nhwc = (lambda v: v.permute(0, 3, 1, 2)), (lambda v: v.permute(0, 2, 3, 1))
    if follow:
        pool, clamp, done = _route_takers(routes)
        changes = [(blocks, "_max_pool_same", lambda x, window: nhwc(pool(nchw(x))))]
        changes += [(m, kind, lambda x, f=clamp(kind): nhwc(f(nchw(x))))
                    for m, kind in ((blocks, "relu6"), (zoo, "relu1"))]
    else:
        done = None

        def rec_pool(x, window, pool=blocks._max_pool_same):
            routes.append(route("pool", nchw(x.detach()), window))
            return pool(x, window)

        def rec(kind, fn):
            def f(x):
                routes.append(route(kind, nchw(x.detach())))
                return fn(x)
            return f

        changes = [(blocks, "_max_pool_same", rec_pool),
                   (blocks, "relu6", rec("relu6", blocks.relu6)),
                   (zoo, "relu1", rec("relu1", zoo.relu1))]
    with _patched(*changes):
        yield
    if done:
        done()


def reference_gradient(params: dict, x, t, routes: list, follow: bool,
                       bank_iters: int | None = None) -> dict:
    """``bench_torch.train_reference``'s float64 gradient, along ``routes``
    (``follow``) or along its own, recorded into ``routes``."""
    from bench_torch import train_reference as ref

    if follow:
        pool, clamp, done = _route_takers(routes)
        changes = [(ref, "max_pool_same", lambda v, k: pool(v)),
                   (ref, "relu6", clamp("relu6")), (ref, "relu1", clamp("relu1"))]
    else:
        done = None

        def rec_pool(v, k, pool=ref.max_pool_same):
            routes.append(route("pool", v.detach(), (k, k)))
            return pool(v, k)

        def rec(kind, fn):
            def f(v):
                routes.append(route(kind, v.detach()))
                return fn(v)
            return f

        changes = [(ref, "max_pool_same", rec_pool), (ref, "relu6", rec("relu6", ref.relu6)),
                   (ref, "relu1", rec("relu1", ref.relu1))]
    kw = {} if bank_iters is None else {"bank_iters": bank_iters}
    with _patched(*changes):
        grads = ref.loss_and_grads(params, x, t, **kw)[1]
    if done:
        done()
    return grads


def route_flips(routes: list, routes64: list) -> dict:
    """Max-pool windows and clamped elements, by kind, whose route differs
    from float64's."""
    check([k for k, _ in routes] == [k for k, _ in routes64], "the forwards' routes differ in kind")
    flips = {kind: 0 for kind in ("pool", *CLAMP_TOP)}
    for (kind, r), (_, r64) in zip(routes, routes64):
        flips[kind] += int((r.reshape(r64.shape) != r64).sum())
    return flips


def cudnn_as(setting: str):
    """cuDNN on (``"cudnn"``, the cells'), on and deterministic
    (``"cudnn deterministic"``, as ``chip_smoke_multi.py``'s phase F and
    ``--probe-gradient`` run it), or off (``"native convolutions"``:
    torch's own CUDA convolutions), for a block."""
    cudnn = torch.backends.cudnn
    return _patched((cudnn, "enabled", setting != "native convolutions"),
                    (cudnn, "deterministic", setting == "cudnn deterministic"))


def port_gradient(dev, state: dict, x, t, setting: str = "cudnn",
                  prox_impl: str = "auto", cotangents: dict | None = None
                  ) -> tuple[dict, list, dict]:
    """The flagship's fp32 gradient at ``state`` on ``x`` under the cuDNN
    ``setting`` (``cudnn_as``), the bank on ``prox_impl``; the routes its
    forward took (``port_routes``) and the kernel launches it made.  With
    ``cotangents``, the cotangents of ``RECOMPUTE_POINTS`` go there."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.models import AdmmDenoiser
    from admm_deconv_tpu_torch.utils.precision import fp32_convs

    routes = []
    with port_routes(routes, follow=False), cudnn_as(setting):
        model = AdmmDenoiser(prox_impl=prox_impl).to(dev)
        model.load_state_dict(state)
        if cotangents is not None:
            _cotangent_probes(model, cotangents, [])
        reset_counts()
        with fp32_convs():
            gmsd_loss(model(x), t).backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = read_counts()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}, routes, counts


def gradient_summary(grads: dict, want: dict) -> dict:
    """A gradient against ``want``: the whole-vector and worst-leaf errors,
    the lam leaf's, and the three worst leaves."""
    from bench_torch.cells import leaf_errors, whole_error

    by_leaf = leaf_errors(grads, want)
    return {"whole": whole_error(grads, want)["all leaves"], "worst": max(by_leaf.values()),
            "lam": by_leaf["DenoiserBank_0.lam"],
            "worst_leaves": sorted(by_leaf, key=by_leaf.get)[::-1][:3]}


def phase_grad_routes(dev) -> dict:
    """The flagship cell's fp32 gradient on the card against float64, plainly
    and along the routes the card's forward took (the float64 reference made
    to take the same max-pool argmaxes and clamp branches), at the cell's
    shape and seed after 0, 100 and 300 AdaBelief steps of its inputs.  What
    is left along the routes is the card's arithmetic: cuDNN's convolutions,
    Q2-1 and Q2-2 (the step's 49 + 49 launches, counted).  The same gradient
    with cuDNN off (torch's own CUDA convolutions, the kernels unchanged)
    parts the two, and is held to the CPU's bound along its routes; with the
    bank's plain composition as well, no kernel is on the path."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.models import AdmmDenoiser, init_parameters
    from admm_deconv_tpu_torch.optim import AdaBelief
    from admm_deconv_tpu_torch.utils.precision import fp32_convs
    from bench_torch.cells import DEFAULT_SEEDS, TRAIN_LR, train_inputs

    seed = DEFAULT_SEEDS["flagship_train_step"]
    x_np, t_np = train_inputs(seed, FLAGSHIP_SHAPE)
    x, t = torch.from_numpy(x_np).to(dev), torch.from_numpy(t_np).to(dev)
    model = init_parameters(AdmmDenoiser(), torch.Generator().manual_seed(seed)).to(dev)
    opt = AdaBelief(model.parameters(), TRAIN_LR)
    out, done = {}, 0
    for steps in GRAD_ROUTE_STEPS:
        for i in range(done + 1, steps + 1):
            with fp32_convs():
                loss = gmsd_loss(model(x + 0.001 * i), t)
                opt.zero_grad(set_to_none=True)
                loss.backward()
            opt.step()
        done = steps
        xi = x + 0.001 * (steps + 1)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        routes64 = []
        g64 = reference_gradient(params, xi, t, routes64, follow=False)
        row = {}
        for name, (setting, prox_impl) in GRAD_ROUTE_VARIANTS.items():
            grads, routes, counts = port_gradient(dev, model.state_dict(), xi, t, setting,
                                                  prox_impl)
            launches = FLAGSHIP_LAUNCHES if prox_impl == "auto" else 0
            want = expect_counts(fused_admm_stencil=launches, stencil_bwd=launches)
            check(counts == want, f"grad routes, {name}: launches {counts} != {want}")
            row[name] = {"flips": route_flips(routes, routes64),
                         "plain": gradient_summary(grads, g64),
                         "routed": gradient_summary(grads, reference_gradient(
                             params, xi, t, routes, follow=True))}
            print(f"[grad routes] {FLAGSHIP_SHAPE} seed {seed}, after {steps} steps, {name}: "
                  f"{json.dumps(row[name])}")
        out[steps] = row
        native = row["native convolutions"]["routed"]["whole"]
        check(native <= GRAD_ROUTED_LIMIT,
              f"with cuDNN off, the card's fp32 gradient along its own routes is {native:.3e} "
              f"from float64 (limit {GRAD_ROUTED_LIMIT})")
    return out


# The recompute detector (phase_step_recompute): steps of the
# flagship_train_step cell's trajectory, the step's gradient against float64
# every RECOMPUTE_F64_EVERY-th of them, and the steps whose disagreeing pair
# is probed further (a third pass and a float64 gradient).
RECOMPUTE_STEPS, RECOMPUTE_F64_EVERY, RECOMPUTE_PROBED = 200, 20, 4
# The two gradients of one step, held to each other: the whole-vector
# relative error and the worst leaf's.  On an H100 the step's two passes
# read 0 in both at all 200 steps, their forwards bit-equal (cuDNN's
# deterministic algorithms, models/blocks.py); with cuDNN's default
# algorithms every pair of forwards differed and the pairs read up to
# 1.58e-3 and 5.6e-3 (192 of 200 past these limits).  The wrong gradient
# these limits were set for read 2.97e-2 and 0.330 (PERF.md, Findings):
# each limit is 10 times or more below it.
RECOMPUTE_LIMITS = {"whole": 1e-4, "worst": 1e-3}
# The tensors whose cotangents the detector keeps, in the order the backward
# reaches them: the model's output, the head's two up/down blocks, the
# Parallel's channel concat and its two branches.
RECOMPUTE_POINTS = ("output", "UpDownBlock_1", "UpDownBlock_0", "concat", "Autoencoder_0",
                    "DenoiserBank_0")


def _cotangent_probes(model, store: dict, flags: list):
    """Forward hooks that keep the cotangent of each of ``RECOMPUTE_POINTS``'
    outputs, where the output is not 0, in ``store``, and record into ``flags``
    ``torch.backends.cudnn.allow_tf32`` as the backward's thread reads it
    there.  Returns the hooks' handles."""
    modules = {"output": model, "UpDownBlock_1": model.UpDownBlock_1,
               "UpDownBlock_0": model.UpDownBlock_0,
               "concat": model.net.layers[0].parts[0].layers[0],
               "Autoencoder_0": model.Autoencoder_0, "DenoiserBank_0": model.DenoiserBank_0}

    def keep(name):
        def forward_hook(module, args, out):
            # Where an output is 0 (clamped) the next clamp's tie passes half
            # a cotangent that its own clamp then stops: kept as 0.
            live = out.detach() != 0

            def tensor_hook(g):
                flags.append(torch.backends.cudnn.allow_tf32)
                store[name] = g.detach() * live
            out.register_hook(tensor_hook)  # returns None: the output stays
        return forward_hook

    return [modules[n].register_forward_hook(keep(n)) for n in RECOMPUTE_POINTS]


def _kernel_shadows(misses: list):
    """Q2-1's and Q2-2's launches, each also computed by its plain twin on
    the same operands: the forward bit for bit, the backward as
    ``phase_bwd_kernels`` holds it.  A launch that differs goes to
    ``misses``."""
    from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk

    fwd, bwd = sk._stencil_cuda, sk._stencil_bwd_cuda

    def fwd_shadow(x, ux, uy, tau, mode):
        got = fwd(x, ux, uy, tau, mode)
        want = sk._stencil_plain(x, ux, uy, tau, mode)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            misses.append({"kernel": "stencil_fwd", "shape": list(x.shape), "max_abs": max(
                float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))})
        return got

    def bwd_shadow(x, ux, uy, tau, gq, gux, guy, mode, need_x=True, need_u=True,
                   need_tau=True):
        got = bwd(x, ux, uy, tau, gq, gux, guy, mode, need_x, need_u, need_tau)
        want = sk._bwd_plain(x, ux, uy, tau, gq, gux, guy, mode)
        scale = _taub_abs_sum(x, ux, uy, tau.expand(x.shape[0]), gq, gux, guy, mode)
        bad = [k for k, (g, w) in enumerate(zip(got[:3], want[:3]))
               if g is not None and not fp32_close(g, w)]
        if got[3] is not None and not bool(((got[3] - want[3]).abs() <= 1e-5 * scale).all()):
            bad.append(3)
        if bad:
            misses.append({"kernel": "stencil_bwd", "shape": list(x.shape), "outputs": bad,
                           "max_abs": [float((got[k] - want[k]).abs().max()) for k in bad]})
        return got

    return _patched((sk, "_stencil_cuda", fwd_shadow), (sk, "_stencil_bwd_cuda", bwd_shadow))


def step_recompute(dev, steps: int = RECOMPUTE_STEPS, setting: str = "cudnn",
                   prox_impl: str = "auto", shadow: bool = False) -> dict:
    """A detector of a wrong backward that needs no float64 limit: the
    ``flagship_train_step`` cell's trajectory (its seed, inputs ``x + 0.001
    i``, ``AdmmDenoiser`` drawn from seed 2, gmsd, ``AdaBelief(1e-4)``,
    ``fp32_convs``, cuDNN as the cell leaves it), each step's gradient
    computed twice at the same parameters and input before ``opt.step()``
    (which takes the second).  The model's convolutions take cuDNN's
    deterministic algorithms, so the two passes are the same bits and a
    pair beyond ``RECOMPUTE_LIMITS`` is a pass gone wrong (forwards that
    differ in a bit are counted and printed).  Every
    ``RECOMPUTE_F64_EVERY``-th step is also held, with the update and
    AdaBelief's state, to the float64 step by the cell's own check and
    ``TRAIN_TOLS`` (a fault that comes back when recomputed).  Each pass
    keeps the cotangents of ``RECOMPUTE_POINTS``; of a disagreeing pair the
    two cotangents' relative difference at each point is printed (in the
    backward's order the first that parts is where the fault entered), and
    the first ``RECOMPUTE_PROBED`` such steps get a third pass and a float64
    gradient, to say which pass was wrong.  Every pass launches Q2-1 and
    Q2-2 49 times each (counted) unless ``prox_impl`` is ``"xla"``.

    ``setting`` is ``cudnn_as``'s, ``prox_impl`` the bank's, ``shadow``
    holds every kernel launch against its plain twin (``_kernel_shadows``)."""
    from admm_deconv_tpu_torch.metrics import gmsd_loss
    from admm_deconv_tpu_torch.models import AdmmDenoiser, init_parameters
    from admm_deconv_tpu_torch.optim import AdaBelief
    from admm_deconv_tpu_torch.utils.precision import fp32_convs
    from bench_torch import train_reference
    from bench_torch.cells import (
        DEFAULT_SEEDS,
        FLAGSHIP,
        TRAIN_LR,
        check_train,
        leaf_errors,
        optimizer_errors,
        snapshot,
        train_inputs,
        whole_error,
    )

    seed = DEFAULT_SEEDS[FLAGSHIP]
    x_np, t_np = train_inputs(seed, FLAGSHIP_SHAPE)
    x, t = torch.from_numpy(x_np).to(dev), torch.from_numpy(t_np).to(dev)
    label = f"{setting}, bank {prox_impl}" + (", kernels shadowed" if shadow else "")
    cot, flags, misses = {}, [], []
    launches = FLAGSHIP_LAUNCHES if prox_impl == "auto" and dev.type == "cuda" else 0
    want_counts = expect_counts(fused_admm_stencil=2 * launches, stencil_bwd=2 * launches)
    with contextlib.ExitStack() as stack:
        stack.enter_context(cudnn_as(setting))
        if shadow:
            stack.enter_context(_kernel_shadows(misses))
        model = init_parameters(AdmmDenoiser(prox_impl=prox_impl),
                                torch.Generator().manual_seed(seed)).to(dev)
        opt = AdaBelief(model.parameters(), TRAIN_LR)
        named = dict(model.named_parameters())
        hooks = _cotangent_probes(model, cot, flags)

        def one_pass(xi):
            cot.clear()
            with fp32_convs():
                out = model(xi)
                loss = gmsd_loss(out, t)
                opt.zero_grad(set_to_none=True)
                loss.backward()
            return {"out": out.detach(), "loss": float(loss.detach()),
                    "grads": {n: p.grad.detach().clone() for n, p in named.items()},
                    "cot": dict(cot)}

        def departs(a, b) -> dict:
            return {p: float(torch.linalg.vector_norm(a["cot"][p] - b["cot"][p])
                             / torch.linalg.vector_norm(b["cot"][p]).clamp_min(1e-30))
                    for p in RECOMPUTE_POINTS}

        agreeing = {k: [] for k in RECOMPUTE_LIMITS}
        forwards_differ, bad, f64_bad, f64_reads, probed, pairs = [], [], [], [], [], []
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            xi = x + 0.001 * i
            f64 = i % RECOMPUTE_F64_EVERY == 0
            before = snapshot(model, opt) if f64 else None
            reset_counts()
            a, b = one_pass(xi), one_pass(xi)
            counts = read_counts()
            check(counts == want_counts, f"recompute step {i}: launches {counts} != {want_counts}")
            same_forward = torch.equal(a["out"], b["out"])
            if not same_forward:
                forwards_differ.append(i)
            err = gradient_summary(a["grads"], b["grads"])
            pairs.append([i, err["whole"], err["worst"]])
            if any(err[k] > limit for k, limit in RECOMPUTE_LIMITS.items()):
                bad.append(i)
                row = {"step": i, "pair": err, "forwards_equal": same_forward,
                       "cotangents_part": departs(a, b)}
                if len(probed) < RECOMPUTE_PROBED:
                    c = one_pass(xi)
                    params = {n: p.detach().clone() for n, p in named.items()}
                    g64 = train_reference.loss_and_grads(params, xi, t)[1]
                    row |= {"third_against_first": gradient_summary(c["grads"], a["grads"]),
                            "third_against_second": gradient_summary(c["grads"], b["grads"]),
                            "float64": {k: whole_error(p["grads"], g64)["all leaves"]
                                        for k, p in (("first", a), ("second", b),
                                                     ("third", c))}}
                    probed.append(i)
                print(f"[recompute] {label}: step {i} disagrees: {json.dumps(row)}")
            else:
                for k, v in agreeing.items():
                    v.append(err[k])
            opt.step()
            if f64:
                after = snapshot(model, opt)
                loss64, g64 = train_reference.loss_and_grads(before["params"], xi, t)
                errors, advanced = optimizer_errors(before, after, b["grads"])
                res = check_train(b["loss"], loss64, {
                    "gradient": leaf_errors(b["grads"], g64),
                    "gradient_all": whole_error(b["grads"], g64), **errors}, advanced)
                f64_reads.append({"step": i, "ok": res["ok"], "loss": res["loss_rel_err"],
                                  "gradient_all": res["gradient_all"]["rel_err"],
                                  "gradient": res["gradient"]["rel_err"]})
                if not res["ok"]:
                    f64_bad.append(i)
                    print(f"[recompute] {label}: step {i} fails the float64 check: "
                          f"{json.dumps(res)}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for h in hooks:
            h.remove()
    out = {"setting": label, "steps": steps, "seconds": seconds, "disagreeing": len(bad),
           "disagreeing_steps": bad,
           "agreeing_max": {k: max(v, default=0.0) for k, v in agreeing.items()},
           "agreeing_median": {k: float(np.median(v)) if v else 0.0
                               for k, v in agreeing.items()},
           "forwards_differ": len(forwards_differ), "forwards_differ_steps": forwards_differ[:20],
           "float64_failed": f64_bad, "float64_reads": f64_reads, "probed": probed,
           "allow_tf32_in_backward": sorted(set(flags)), "shadow_misses": misses[:10],
           "shadow_miss_count": len(misses)}
    print(f"[recompute] {FLAGSHIP_SHAPE} seed {seed}, {label}: {steps} steps in {seconds:.1f} s; "
          f"{json.dumps(out)}")
    return out | {"pairs": pairs}


def phase_step_recompute(dev, **kw) -> dict:
    """:func:`step_recompute` (the cell's step, cuDNN as the cell has it and
    the bank on its kernels unless ``kw`` says otherwise), failed on any
    disagreeing step, float64 check, kernel launch unlike its plain twin, or
    TF32 in the backward."""
    out = step_recompute(dev, **kw)
    label, bad, f64_bad = out["setting"], out["disagreeing_steps"], out["float64_failed"]
    flags = out["allow_tf32_in_backward"]
    check(flags == [False], f"recompute {label}: cuDNN's TF32 flag in the backward {flags}")
    check(not out["shadow_miss_count"], f"recompute {label}: {out['shadow_miss_count']} "
          f"kernel launches differ from their plain twins: {out['shadow_misses'][:3]}")
    check(not bad and not f64_bad,
          f"recompute {label}: {len(bad)} of {out['steps']} steps disagree when recomputed "
          f"(steps {bad}); {len(f64_bad)} fail the float64 check (steps {f64_bad})")
    return out


def training_pairs(seed: int, n: int, batch: int, hw: tuple[int, int]):
    """(degraded, clean) batches: piecewise-constant blocks, a 7x7 motion
    blur and AWGN sigma 25/255 (the awgn_25_25 data of train_cfg.json)."""
    rng = np.random.default_rng(seed)
    psf = np.zeros((7, 7), np.float32)
    psf[3, :] = 1.0 / 7.0
    pairs = []
    for _ in range(n):
        tiles = rng.random((batch, hw[0] // 16, hw[1] // 16, 3))
        clean = np.kron(tiles, np.ones((1, 16, 16, 1))).astype(np.float32)
        blurred = sum(psf[a, c] * np.roll(clean, (a - 3, c - 3), (1, 2))
                      for a in range(7) for c in range(7))
        noisy = blurred + rng.normal(0.0, 25.0 / 255.0, clean.shape)
        pairs.append((np.clip(noisy, 0, 1).astype(np.float32), clean))
    return pairs


def phase_trainer(dev, seed: int) -> float:
    """Trainer.fit for one epoch at configs/train_cfg.json, checkpoint and
    resume; then ms per train step."""
    import csv

    from admm_deconv_tpu_torch.models import build_model, init_parameters
    from admm_deconv_tpu_torch.train import Trainer, load_config

    cfg = load_config(os.path.join(REPO, TRAIN_CFG))
    n_train, n_eval = TRAINER_BATCHES
    train = training_pairs(seed, n_train, cfg.batch_size, cfg.im_shape)
    evals = training_pairs(seed + 1, n_eval, cfg.batch_size, cfg.im_shape)

    def make(model_seed):
        model = build_model(cfg.model, dataclasses.asdict(cfg), device=dev)
        init_parameters(model, torch.Generator().manual_seed(model_seed))
        trainer = Trainer(model, cfg)
        return trainer, trainer.init_state()

    with tempfile.TemporaryDirectory() as model_dir:
        trainer, state = make(seed)
        logs = []
        reset_counts()
        state = trainer.fit(state, train, evals, epochs=1, model_dir=model_dir, log_fn=logs.append)
        torch.cuda.synchronize()
        counts = read_counts()
        # The bank launches each stencil as often as in the flagship step:
        # the forward per train and eval batch, the backward per train batch.
        want = expect_counts(fused_admm_stencil=FLAGSHIP_LAUNCHES * (n_train + n_eval),
                             stencil_bwd=FLAGSHIP_LAUNCHES * n_train)
        check(counts == want, f"trainer epoch launches {counts} != {want}")
        with open(os.path.join(model_dir, "train_eval_metrics_history.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 1 and state.epoch == 1 and state.step == n_train,
              f"one epoch: {len(rows)} CSV rows, epoch {state.epoch}, step {state.step}")
        for k in ("train_loss", "eval_loss", "eval_psnr"):
            check(np.isfinite(float(rows[0][k])), f"{k} not finite")
        check(os.listdir(os.path.join(model_dir, "checkpoints")) == ["epoch_0.pt"],
              "epoch checkpoint written")
        check(len(os.listdir(os.path.join(model_dir, "best"))) == 1, "best checkpoint written")
        print(f"[trainer] {cfg.model}, {cfg.loss} + {cfg.optimizer} lr {cfg.lr_rate}, batch "
              f"{cfg.batch_size} x {cfg.im_shape}: one epoch of {n_train} train / {n_eval} eval "
              f"batches, launches {counts}; {logs[0]}")

        trained = [p.detach().clone() for p in state.model.parameters()]
        trainer2, state2 = make(seed + 7)
        state2, start = trainer2.restore_latest(model_dir, state2)
        check(start == 1 and state2.step == n_train, f"resume at epoch {start}")
        check(all(torch.equal(a, b) for a, b in zip(trained, state2.model.parameters())),
              "resumed parameters equal the saved ones")
        state2 = trainer2.fit(state2, train, evals, epochs=2, model_dir=model_dir,
                              log_fn=logs.append, resume=True)
        check(logs[1] == "resumed from epoch 1" and state2.epoch == 2, "resumed fit")

    x = [torch.from_numpy(a).to(dev) for a, _ in train]
    y = [torch.from_numpy(b).to(dev) for _, b in train]
    ms = timed_steps(lambda i: trainer2.train_step(state2, x[i], y[i], trainer2._zero_acc()),
                     [0, *range(len(x))])
    print(f"[trainer] resumed at epoch 1 and trained on; train step {ms:.3f} ms/step "
          f"({len(x)} steps after one warm-up)")
    return ms


def _importable(name: str) -> bool:
    import importlib

    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def phase_data() -> dict:
    """The machine's image tools, the native loader built from the shared
    source, and the fixtures' batch on each path the machine has (native,
    PIL) held bit for bit to the JAX package's."""
    import ctypes.util
    import hashlib
    import shutil
    import warnings

    from admm_deconv_tpu_torch.data import ImageDataFeeder, native

    have = {"PIL": _importable("PIL"), "tensorboard": _importable("torch.utils.tensorboard"),
            "g++": shutil.which("g++"), "make": shutil.which("make"),
            "libpng": ctypes.util.find_library("png16") or ctypes.util.find_library("png"),
            "png.h": os.path.isfile("/usr/include/png.h")}
    print(f"[data] on this machine: {have}")
    t0 = time.perf_counter()
    built = native.available()
    build_s = time.perf_counter() - t0
    root = os.path.join(REPO, FIXTURES)
    if built:
        print(f"[data] native loader {native.library_path().name}, built from native/"
              f"imagefeeder.cpp by native/Makefile (CXXFLAGS {native.CXXFLAGS!r}) in "
              f"{build_s:.2f} s")
    else:
        import subprocess as sp

        try:
            native._build()
            reason = "the library built but does not load"
        except (sp.CalledProcessError, OSError) as e:
            reason = (getattr(e, "stderr", b"") or b"").decode(errors="replace")[-400:] or repr(e)
        print(f"[data] native loader NOT available (libpng {have['libpng']}, g++ {have['g++']}): "
              f"{reason.strip()}")
    paths = [p for p, ok in (("native", built), ("pil", have["PIL"])) if ok]
    check(bool(paths), "no PNG decoder on this machine: the native loader did not build and "
                       "PIL is missing")
    for path in paths:
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # the feeder's fall back to PIL warns: fail on it
            x, y = ImageDataFeeder(root, root, ".png", DATA_CROP, DATA_CROP,
                                   rng=np.random.default_rng(0), backend=path)[[0, 1, 2]]
        digest = hashlib.sha256(x.tobytes()).hexdigest()
        print(f"[data] the {path} path: fixtures {x.shape} crop batch SHA-256 {digest} (the JAX "
              f"package's {path} path: {FIXTURE_BATCH_SHA256[path]})")
        check(digest == FIXTURE_BATCH_SHA256[path], f"the {path} batch differs from the JAX "
                                                    f"package's")
        check(np.array_equal(x, y), "x and y crops of the same files differ")
    if len(paths) == 2:
        from PIL import Image

        files = sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".png"))
        whole, _ = native.load_pair_batch(files, files, 256, 256, 0)
        for i, f in enumerate(files):
            with Image.open(f) as im:
                u8 = np.asarray(im.convert("RGB"))
            check(np.array_equal(whole[i], u8.astype(np.float32) * np.float32(1 / 255)),
                  f"native decode of {f} differs from PIL's")
        print("[data] native decode of the three fixtures equals PIL's, bit for bit")
    path = paths[0]
    print(f"[data] the feeder's backend=\"auto\" takes the {path} path")
    loader_rng = np.random.default_rng(1)
    feeder = ImageDataFeeder(root, root, ".png", (256, 256), (256, 256), rng=loader_rng,
                             backend=path)
    feeder[[0, 1]]
    t0 = time.perf_counter()
    for i in range(10):
        feeder[[i % 3, (i + 1) % 3]]
    feeder_ms = 1e3 * (time.perf_counter() - t0) / 10
    print(f"[data] the {path} path: {feeder_ms:.3f} ms per batch of 2 x 256^2 (host clock, "
          f"10 batches)")
    return {"path": path, "pil": have["PIL"], "tensorboard": have["tensorboard"],
            "feeder_ms": feeder_ms, "build_s": build_s}


def _captured(fn, *args) -> str:
    """Run ``fn(*args)``, print its standard output indented, return it."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"    | {line}")
    return text


def phase_cli_train(dev, seed: int, data: dict, trainer_ms: float) -> dict:
    """The train CLI for one epoch of the production configuration from PNG
    files, and a resume; then ms per step fed by the feeder."""
    import csv
    import warnings

    from admm_deconv_tpu_torch.data import DataLoader, ImageDataFeeder
    from admm_deconv_tpu_torch.models import build_model, init_parameters
    from admm_deconv_tpu_torch.scripts import make_dataset, train
    from admm_deconv_tpu_torch.train import Trainer, load_config
    from admm_deconv_tpu_torch.train.prefetch import Prefetcher

    fixtures = os.path.join(REPO, FIXTURES)
    n_images = len([f for f in os.listdir(fixtures) if f.endswith(".png")])
    with tempfile.TemporaryDirectory() as tmp:
        if data["pil"]:
            _captured(make_dataset.main, ["--train-src", fixtures, "--test-src", fixtures,
                                          "--dest", os.path.join(tmp, "dsets")])
            dset = os.path.join(tmp, "dsets", "awgn_25_25")
            dirs = {f"{s}_{xy}": os.path.join(dset, s, xy) for s in ("train", "test")
                    for xy in ("x", "y")}
            for d in dirs.values():
                check(len(os.listdir(d)) == n_images, f"make_dataset wrote {os.listdir(d)}")
            source = "make_dataset's AWGN-25 pairs of the fixtures"
        else:
            dirs = {f"{s}_{xy}": fixtures for s in ("train", "test") for xy in ("x", "y")}
            source = ("x = y = tests/fixtures (PIL is missing: make_dataset cannot write PNGs)")
        with open(os.path.join(REPO, TRAIN_CFG)) as f:
            cfg = json.load(f)
        cfg |= {"train_data": {"x_path": dirs["train_x"], "y_path": dirs["train_y"]},
                "eval_data": {"x_path": dirs["test_x"], "y_path": dirs["test_y"]},
                "epochs": 1, "save_dir": os.path.join(tmp, "models")}
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        batches = -(-n_images // cfg["batch_size"])
        argv = ["-c", cfg_path, "-n", "smoke"]
        print(f"[cli_train] data: {source}, read by the {data['path']} loader")
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = _captured(train.main, argv)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts = read_counts()
        fell_back = [str(w.message) for w in caught if "fell back to PIL" in str(w.message)]
        want = expect_counts(fused_admm_stencil=FLAGSHIP_LAUNCHES * 2 * batches,
                             stencil_bwd=FLAGSHIP_LAUNCHES * batches)
        print(f"[cli_train] one epoch ({batches} train + {batches} eval batches of "
              f"{cfg['batch_size']} x {tuple(cfg['im_shape'])}) in {epoch_s:.3f} s, model build "
              f"and checkpoints included; launches {counts}")
        check(counts == want, f"train CLI launches {counts} != {want}")
        check(not fell_back, f"the feeder fell back from the native loader: {fell_back}")
        model_dir = os.path.join(cfg["save_dir"], "smoke")
        with open(os.path.join(model_dir, "train_eval_metrics_history.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 1 and all(np.isfinite(float(v)) for v in rows[0].values()),
              f"CSV rows {rows}")
        check(os.listdir(os.path.join(model_dir, "checkpoints")) == ["epoch_0.pt"],
              "epoch checkpoint")
        check(len(os.listdir(os.path.join(model_dir, "best"))) == 1, "best checkpoint")
        check(out.splitlines()[-1] == "DONE", "the train CLI's last line")
        with open(cfg_path, "w") as f:
            json.dump(cfg | {"epochs": 2}, f)
        out = _captured(train.main, argv)
        with open(os.path.join(model_dir, "train_eval_metrics_history.csv"), newline="") as f:
            epochs = [int(float(r["epoch"])) for r in csv.DictReader(f)]
        check("resumed from epoch 1" in out and epochs == [0, 1], f"resume: CSV epochs {epochs}")
        print(f"[cli_train] resumed from epoch 1 and trained epoch 2: CSV epochs {epochs}")

        # ms per step fed by the feeder (prefetch thread, drop-last batches
        # of 2) beside phase_trainer's steps on device-resident pairs.
        tc = load_config(cfg_path)
        model = build_model(tc.model, dataclasses.asdict(tc), device=dev)
        init_parameters(model, torch.Generator().manual_seed(seed))
        trainer = Trainer(model, tc)
        state = trainer.init_state()
        loader = DataLoader(ImageDataFeeder(dirs["train_x"], dirs["train_y"], ".png", tc.im_shape,
                                            tc.im_shape, rng=np.random.default_rng(seed)),
                            batch_size=tc.batch_size, shuffle=True, drop_last=True,
                            rng=np.random.default_rng(seed + 1))
        passes = 9

        def feed():
            for _ in range(passes):
                yield from loader

        steps = iter(Prefetcher(feed(), transform=trainer._to_device, depth=tc.prefetch_batches))
        trainer.train_step(state, *next(steps), trainer._zero_acc())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for x, y in steps:
            trainer.train_step(state, x, y, trainer._zero_acc())
            n += 1
        torch.cuda.synchronize()
        fed_ms = 1e3 * (time.perf_counter() - t0) / n
    print(f"[cli_train] train step fed by the {data['path']} loader through the prefetch "
          f"thread: {fed_ms:.3f} ms/step ({n} steps after one warm-up); on device-resident "
          f"pairs (phase_trainer): {trainer_ms:.3f} ms/step; the loader alone "
          f"{data['feeder_ms']:.3f} ms per batch")
    return {"launches": counts, "epoch_s": epoch_s, "fed_ms": fed_ms, "batches": batches}


def phase_data_parallel(dev, seed: int) -> dict:
    """Trainer(mesh_batch=0) in a one-rank NCCL group beside the trainer
    without a group, from the same parameters on the same batches."""
    import socket

    from admm_deconv_tpu_torch.models import build_model, init_parameters
    from admm_deconv_tpu_torch.parallel import distributed
    from admm_deconv_tpu_torch.train import Trainer, load_config

    check(not torch.distributed.is_initialized(), "a process group is left from an earlier phase")
    cfg = load_config(os.path.join(REPO, TRAIN_CFG))
    cfg.checkpointing = False
    pairs = training_pairs(seed + 3, DP_STEPS, cfg.batch_size, cfg.im_shape)

    def run(mesh_batch):
        model = build_model(cfg.model, dataclasses.asdict(cfg), device=dev)
        init_parameters(model, torch.Generator().manual_seed(seed))
        trainer = Trainer(model, dataclasses.replace(cfg, mesh_batch=mesh_batch))
        state = trainer.init_state()
        batches = [trainer._to_device(x, y) for x, y in pairs]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, y in batches:
            trainer.train_step(state, x, y, trainer._zero_acc())
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / len(batches)
        return trainer, [p.detach().clone() for p in model.parameters()], ms, read_counts()

    env = {"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "1", "RANK": "0"}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        env["MASTER_PORT"] = str(s.getsockname()[1])
    saved_env = {k: os.environ.get(k) for k in env}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, alone, ms_alone, _ = run(1)
        os.environ.update(env)
        distributed.initialize()
        check(torch.distributed.get_backend() == "nccl"
              and torch.distributed.get_world_size() == 1, "a one-rank NCCL group")
        # NCCL sets its communicator up at the first collective: do that here,
        # at the gradients' size, so that the timed steps see the steady cost.
        torch.distributed.all_reduce(torch.zeros(sum(a.numel() for a in alone), device=dev))
        torch.cuda.synchronize()
        trainer, grouped, ms_grouped, counts = run(0)
        check(trainer.data_parallel and trainer.world == 1, "the trainer joined the group")
        torch.distributed.destroy_process_group()
        want = expect_counts(fused_admm_stencil=FLAGSHIP_LAUNCHES * DP_STEPS,
                             stencil_bwd=FLAGSHIP_LAUNCHES * DP_STEPS)
        check(counts == want, f"data-parallel launches {counts} != {want}")
        equal = all(torch.equal(a, b) for a, b in zip(alone, grouped))
        worst = max(float((a - b).abs().max()) for a, b in zip(alone, grouped))
        print(f"[data_parallel] {cfg.model} {cfg.batch_size} x {cfg.im_shape}, {DP_STEPS} steps: "
              f"Trainer(mesh_batch=0) in a one-rank NCCL group (env://) {ms_grouped:.3f} "
              f"ms/step, without a group {ms_alone:.3f} ms/step; parameters equal bit for bit: "
              f"{equal} (max |d| {worst:.3e}); launches {counts}")
        if not equal:
            _, again, _, _ = run(1)
            spread = max(float((a - b).abs().max()) for a, b in zip(alone, again))
            print(f"[data_parallel] why: two runs without a group differ by {spread:.3e}, so the "
                  f"step itself is not deterministic on this card")
            check(spread > 0 and worst <= spread, "the grouped trainer differs from the trainer "
                                                 "without a group beyond the step's own spread")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"ms": ms_grouped, "alone_ms": ms_alone, "equal": equal, "launches": counts}


def phase_multi_world1() -> dict:
    """``chip_smoke_multi.py --world 1 --size cut`` as a subprocess: the
    multi-card launcher, ``env://`` and every phase at one rank, on NCCL, at
    the full widths with the depth cut.  Returns its summary."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke_multi.py"), "--world", "1", "--size",
         "cut", "--deadline", str(MULTI_WORLD1_DEADLINE)],
        cwd=REPO, capture_output=True, text=True, timeout=MULTI_WORLD1_DEADLINE + 60)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("[summary] {"):
            print(f"    | {line}")
    check(proc.returncode == 0 and lines, f"chip_smoke_multi.py --world 1 exited "
                                          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    last = json.loads(lines[-1])
    want = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    check(last["ok"] and last["device"] == want, f"its last line {last}")
    summary = json.loads(next(ln for ln in lines if ln.startswith("[summary] {"))[10:])
    print(f"[multi_world1] chip_smoke_multi.py --world 1 --size cut: exit 0 in {secs:.1f} s "
          f"(its own process and launcher); its last line {lines[-1]}")
    return summary


def phase_demo(dev) -> dict:
    """The demo CLI's run() on its synthetic frames, each of its six
    branches: PSNR beside the JAX package's, launches."""
    from admm_deconv_tpu_torch import peak_snr
    from admm_deconv_tpu_torch.scripts import demo_deconv

    imgs = demo_deconv.synthetic_images()
    ref = np.stack(imgs)
    stencil = _state_stencil()
    exact = {"plain": {"fused_admm_stencil": 99}, "bf16_state": {"fused_admm_stencil_mixed": 99},
             "l1": {"stencil_composite": 99}, "anderson": {"prox_dual": 99}}
    reached = {"adaptive": ("prox_dual",), "auto": (stencil, "prox_dual")}
    out = {}
    for name, argv in DEMO_BRANCHES.items():
        p = demo_deconv.parser()
        args = p.parse_args(argv)
        demo_deconv.check_args(p, args)
        reset_counts()
        restored, m = demo_deconv.run(args, imgs)
        counts = read_counts()
        db = peak_snr(restored, ref)  # a numpy pair: on the card, as float32
        check(db.device.type == "cuda", "the demo's PSNR ran on the card")
        db = float(db)
        if name in exact:
            ok = counts == expect_counts(**exact[name])
        else:
            ok = all(counts[k] > 0 for k in reached[name]) and all(
                v == 0 for k, v in counts.items() if k not in reached[name])
        print(f"[demo] {name:10s} ({' '.join(argv) or 'no flags'}): PSNR {db:.5f} dB, JAX on the "
              f"CPU {DEMO_PSNR_JAX[name]:.5f} (|d| {abs(db - DEMO_PSNR_JAX[name]):.5f}, bound "
              f"0.01); {m['seconds']:.3f} s{m['extra']}; per image "
              f"{[round(v, 2) for v in m['blurred_psnr']]} -> "
              f"{[round(v, 2) for v in m['restored_psnr']]} dB; launches {counts}")
        check(restored.shape == ref.shape and np.isfinite(restored).all(), f"demo {name} output")
        check(ok, f"demo {name} launches {counts}")
        check(abs(db - DEMO_PSNR_JAX[name]) <= 0.01, f"demo {name} PSNR {db} off JAX's")
        out[name] = {"psnr": db, "s": m["seconds"], "launches": counts}
    return out


def phase_tv_layer(dev) -> dict:
    """bench_suite.py's 1080p TV-layer train step through the kernels and
    through the plain composition."""
    from admm_deconv_tpu_torch.layers import ADMMDeconv
    from admm_deconv_tpu_torch.metrics import mse

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random(TV_SHAPE, dtype=np.float32)).to(dev)
    t = torch.from_numpy(rng.random(TV_SHAPE, dtype=np.float32)).to(dev)
    inputs = [x + 1e-3 * i for i in range(TV_REPEATS + 1)]
    n = TV_ITERS - 1
    cases = (("kernel fp32", {}, {"fused_admm_stencil": 2 * n, "stencil_bwd": n}),
             ("kernel bf16", {"state_dtype": "bfloat16"},
              {"fused_admm_stencil_mixed": 2 * n, "stencil_bwd": n}),
             ("plain fp32", {"prox_impl": "xla"}, {}))
    out, grads = {}, {}
    for name, kw, launches in cases:
        layer = ADMMDeconv(kernel_shape=(), iters=TV_ITERS, iso=False, remat=True,
                           lam_init=0.05, rho_init=0.5, trainable=("lam", "rho"), **kw).to(dev)
        mse(layer(x), t).backward()  # the gradient at the initial parameters
        grads[name] = torch.cat([layer.lam.grad, layer.rho.grad]).cpu()
        opt = torch.optim.Adam(layer.parameters(), lr=1e-3, eps=1e-8)

        def step(xi, layer=layer, opt=opt):
            loss = mse(layer(xi), t)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

        reset_counts()
        ms = timed_steps(step, inputs)
        per_step = {k: v / len(inputs) for k, v in read_counts().items()}
        want = {k: 0 for k in per_step} | launches
        check(per_step == want, f"TV layer {name} launches per step {per_step} != {want}")
        check(bool(torch.isfinite(layer.lam).all() and torch.isfinite(layer.rho).all()),
              f"TV layer {name} parameters not finite")
        out[name] = (step, inputs[-1], ms)
        print(f"[tv_layer] {TV_SHAPE}, {TV_ITERS} iterations, remat, Adam + mse, {name}: "
              f"{ms:.3f} ms/step; launches per step {per_step}; (dlam, drho) at init "
              f"{grads[name].tolist()}")
    rel = float((grads["kernel fp32"] - grads["plain fp32"]).abs().max()
                / grads["plain fp32"].abs().max())
    print(f"[tv_layer] kernel vs plain gradient at init: rel {rel:.2e} (tolerance 1e-3: "
          f"the same derivative, summed in another order)")
    check(rel <= 1e-3, "TV-layer kernel gradient off the plain path's")
    return out


def phase_kernel_times(dev, gen) -> dict:
    """The three kernels and their plain versions at the TV layer's planes;
    then Q2-1 at the 1080p batch's 12 planes, the stack the
    ``solve_1080p_b4`` and ``ttq_1080p_adaptive`` cells launch it at (keys
    ``fwd_fp32 (12, 1080, 1920)`` and ``fwd_bf16 ...``)."""
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _bwd_plain,
        _stencil_plain,
        fused_admm_stencil,
        fused_admm_stencil_bwd,
        fused_admm_stencil_mixed,
    )

    shape = (TV_SHAPE[0] * TV_SHAPE[3],) + TV_SHAPE[1:3]
    x = torch.rand(shape, generator=gen, device=dev)
    tau = torch.tensor(0.1, device=dev)
    times = {}
    for key, dual in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ux, uy, gq, gux, guy = ((0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
                                for _ in range(5))
        fwd = fused_admm_stencil if dual == torch.float32 else fused_admm_stencil_mixed
        narrow = dual == torch.bfloat16
        # (kernel, plain, bytes per pixel, operations per pixel)
        pairs = {
            f"fwd_{key}": (lambda: fwd(x, ux, uy, tau, mode="aniso"),
                           lambda: _stencil_plain(x, ux, uy, tau, "aniso"),
                           14 if narrow else 24, 21),
            f"bwd_{key}": (lambda: fused_admm_stencil_bwd(x, ux, uy, tau, gq, gux, guy, "aniso"),
                           lambda: _bwd_plain(x, ux, uy, tau, gq, gux, guy, "aniso"),
                           22 if narrow else 36, 40),
        }
        for name, (kernel, plain, bytes_px, flops_px) in pairs.items():
            p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kernel, kernel, plain))
            times[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                           "device_ms": device_ms(kernel, 20),
                           **bound(shape, bytes_px, flops_px)}
            t = times[name]
            print(f"[times] {shape} {name}, aniso: kernel {k1:.4f}/{k2:.4f} ms per call, "
                  f"device {t['device_ms']:.4f} ms ({t['bound_ms'] / t['device_ms']:.1%} of the "
                  f"{t['bound_ms']:.4f} ms HBM floor), plain {p1:.4f}/{p2:.4f} ms per call")
    for dual, t in phase_stencil_times(dev, gen, BENCH_STACK).items():
        times[f"fwd_{dual} {BENCH_STACK}"] = t
    return times | phase_flagship_stack_times(dev, gen)


def phase_flagship_stack_times(dev, gen) -> dict:
    """Q2-1 and Q2-2 alone at the flagship steps' denoiser-bank stacks
    (``FLAGSHIP_STACKS``), as the bank launches them: iso mode, a per-plane
    tau, fp32 and bf16 duals.  Keys ``fwd_fp32 (30, 112, 112) iso``,
    ``bwd_bf16 ...``."""
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _bwd_plain,
        _stencil_plain,
        fused_admm_stencil,
        fused_admm_stencil_bwd,
        fused_admm_stencil_mixed,
    )

    times = {}
    for shape in FLAGSHIP_STACKS:
        x = torch.rand(shape, generator=gen, device=dev)
        tau = torch.empty(shape[0], device=dev).uniform_(0.01, 0.1, generator=gen)
        for key, dual in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            ux, uy = ((0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
                      for _ in range(2))
            gq, gux, guy = (torch.randn(shape, generator=gen, device=dev).to(dual)
                            for _ in range(3))
            fwd = fused_admm_stencil if dual == torch.float32 else fused_admm_stencil_mixed
            narrow = dual == torch.bfloat16
            # (kernel, plain, bytes per pixel, operations per pixel)
            pairs = {
                "fwd": (lambda: fwd(x, ux, uy, tau, mode="iso"),
                        lambda: _stencil_plain(x, ux, uy, tau, "iso"), 14 if narrow else 24,
                        FWD_ISO_OPS),
                "bwd": (lambda: fused_admm_stencil_bwd(x, ux, uy, tau, gq, gux, guy, "iso"),
                        lambda: _bwd_plain(x, ux, uy, tau, gq, gux, guy, "iso"),
                        22 if narrow else 36, BWD_ISO_OPS),
            }
            for kind, (kernel, plain, bytes_px, flops_px) in pairs.items():
                p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kernel, kernel, plain))
                t = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "device_ms": device_ms(kernel, 20), "launches_a_step": FLAGSHIP_LAUNCHES,
                     **bound(shape, bytes_px, flops_px)}
                times[f"{kind}_{key} {shape} iso"] = t
                print(f"[times] {shape} {kind}_{key}, iso, tau per plane: kernel {k1:.4f}/"
                      f"{k2:.4f} ms per call, device {t['device_ms']:.4f} ms "
                      f"({t['bound_ms'] / t['device_ms']:.1%} of the {t['bound_ms']:.4f} ms HBM "
                      f"floor, {bytes_px} B/px), plain {p1:.4f}/{p2:.4f} ms per call; "
                      f"{FLAGSHIP_LAUNCHES} launches a flagship step")
    return times


def phase_train_profile(flagship: dict, tv: dict) -> None:
    from torch.profiler import ProfilerActivity, profile

    for label, (step, xi, wall_ms) in (("flagship fp32", flagship["steps"]["float32"]),
                                       ("tv_layer kernel fp32", tv["kernel fp32"])):
        step(xi)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(xi + 0.5)
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0)
        kernels = device_events(prof, label)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"[profile] {label} step: device busy {busy_ms:.3f} ms; wall {prof_ms:.3f} ms "
              f"profiled, {wall_ms:.3f} ms unprofiled; idle share "
              f"{1 - busy_ms / prof_ms:.3f} profiled, {1 - busy_ms / wall_ms:.3f} unprofiled")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
                  f"{e.key[:90]}")


def phase_prox_dual_kernel(dev, gen) -> float:
    """The prox-dual kernel against ``_prox_dual_plain`` on the same CUDA
    inputs; its gradient on the card against autograd through the plain
    composition."""
    from admm_deconv_tpu_torch.ops import prox as prox_lib
    from admm_deconv_tpu_torch.ops.kernels.prox_kernels import _prox_dual_plain, fused_prox_dual
    from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES, prox_vjp

    print("[prox_dual] tolerance: |kernel-plain| <= 1e-5 + 1e-5*|plain| (expected: equal)")
    worst = 0.0
    cases = [(s, k) for s in PROX_DUAL_SHAPES for k in ("scalar", "plane")]
    cases += [(s, "scalar") for s in PROX_DUAL_SCALAR_SHAPES]
    for shape, tau_kind in cases:
        arrays = [0.5 * torch.randn(shape, generator=gen, device=dev) for _ in range(4)]
        tau = (torch.tensor(0.3, device=dev) if tau_kind == "scalar" else
               torch.empty(shape[0], device=dev).uniform_(0.1, 0.5, generator=gen))
        for mode in MODES:
            before = fused_prox_dual.launches
            got = fused_prox_dual(*arrays, tau, mode=mode)
            want = _prox_dual_plain(*arrays, tau, mode)
            torch.cuda.synchronize()
            check(fused_prox_dual.launches == before + 1, "fused_prox_dual launched its kernel")
            err = 0.0
            for g, w in zip(got, want):
                check(g.shape == w.shape and g.dtype == torch.float32, f"{shape} output layout")
                check(bool(torch.isfinite(g).all()), f"prox_dual {shape} {mode} non-finite")
                err = max(err, float((g - w).abs().max()))
                check(fp32_close(g, w), f"prox_dual vs plain {shape} {mode} {tau_kind}: {err}")
            worst = max(worst, err)
            print(f"[prox_dual] {str(shape):16s} {mode:5s} tau={tau_kind:6s} "
                  f"max|kernel-plain|={err:.3e}")

    # The Function's gradient against autograd through the plain composition,
    # at v away from the thresholds (|v| or |v|_2 in [0.05, 0.2] or
    # [0.45, 1.0], tau = 0.3), where both are the same derivative.
    shape = (3, 37, 101)
    mag = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5,
                      torch.empty(shape, device=dev).uniform_(0.05, 0.2, generator=gen),
                      torch.empty(shape, device=dev).uniform_(0.45, 1.0, generator=gen))
    ang = torch.empty(shape, device=dev).uniform_(0, 2 * torch.pi, generator=gen)
    ux, uy = (0.3 * torch.randn(shape, generator=gen, device=dev) for _ in range(2))
    cts = [torch.randn(shape, generator=gen, device=dev) for _ in range(4)]
    for mode in MODES:
        if mode in ("aniso", "hard"):
            sx = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5, 1.0, -1.0)
            vx, vy = sx * mag, -sx * mag.flip(-1)
        else:
            vx, vy = mag * torch.cos(ang), mag * torch.sin(ang)
        for tau0 in (torch.tensor(0.3, device=dev), torch.full((3,), 0.3, device=dev)):
            grads = []
            for fn in (lambda *a: fused_prox_dual(*a[:4], a[4], mode=mode),
                       lambda *a: prox_lib.prox_dual_step(
                           *a[:4], a[4] if a[4].ndim == 0 else a[4][:, None, None],
                           prox_lib.resolve(mode))):
                leaves = [vx - ux, vy - uy, ux.clone(), uy.clone(), tau0.clone()]
                for t in leaves:
                    t.requires_grad_()
                sum((o * c).sum() for o, c in zip(fn(*leaves), cts)).backward()
                grads.append([torch.zeros_like(t) if t.grad is None else t.grad
                              for t in leaves])
            t = tau0 if tau0.ndim == 0 else tau0[:, None, None]
            _, _, terms = prox_vjp(mode, vx, vy, t, cts[0] - cts[2], cts[1] - cts[3])
            for name, g, w in zip(("dxx", "dxy", "ux", "uy", "tau"), *grads):
                # tau's gradient is a sum over the elements taken in another
                # order: held to 1e-5 of the sum of its terms' magnitudes.
                bound = 1e-5 * (float(terms.abs().sum()) if name == "tau"
                                else 1.0 + float(w.abs().max()))
                diff = float((g - w).abs().max())
                check(diff <= bound, f"prox_dual grad vs autograd {mode} d{name}: {diff} > {bound}")
        print(f"[prox_dual] Function gradient = autograd through the plain composition, "
              f"{mode}: ok")
    zeros = torch.zeros((1, 8, 8), device=dev)
    d = zeros.clone().requires_grad_()
    out = fused_prox_dual(d, zeros, zeros, zeros, 0.1, mode="iso")
    (out[0].sum() - 0.5 * out[2].sum()).backward()
    check(bool(torch.isfinite(d.grad).all()), "iso flat-region prox_dual gradient not finite")
    print("[prox_dual] an iso flat region (v = 0) gets a finite gradient on the card")
    return worst


def phase_composite_kernel(dev, gen) -> dict:
    """The composite kernel against ``_composite_plain`` on the same CUDA inputs."""
    from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _composite_plain,
        fused_admm_stencil_composite,
    )

    print("[composite] tolerance: fp32 |kernel-plain| <= 1e-5 + 1e-5*|plain|; bf16 equal or "
          "one bf16 ulp apart (expected: equal)")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in COMPOSITE_SHAPES:
        n = shape[0]
        x = 0.5 + 0.5 * torch.randn(shape, generator=gen, device=dev)
        d32 = [0.3 * torch.randn(shape, generator=gen, device=dev) for _ in range(3)]
        plane = [torch.empty(n, device=dev).uniform_(0.02, 0.3, generator=gen) for _ in range(3)]
        for dual in (torch.float32, torch.bfloat16):
            ux, uy, u2 = (d.to(dual) for d in d32)
            for mode in MODES:
                for bounds in (None, (0.0, 1.0)):
                    for tau_kind, table in (("scalar", (0.2, 0.05, 0.6)), ("plane", plane)):
                        before = fused_admm_stencil_composite.launches
                        got = fused_admm_stencil_composite(x, ux, uy, u2, *table, bounds, mode)
                        tab = torch.stack([torch.as_tensor(t, dtype=torch.float32, device=dev)
                                           .expand(n) for t in table], dim=1)
                        want = _composite_plain(x, ux, uy, u2, tab, bounds, mode)
                        torch.cuda.synchronize()
                        check(fused_admm_stencil_composite.launches == before + 1,
                              "fused_admm_stencil_composite launched its kernel")
                        what = f"{shape} {mode} {dual} box={bounds} tau={tau_kind}"
                        err = 0.0
                        for g, w in zip(got, want):
                            check(g.dtype == dual and g.shape == x.shape, f"{what} layout")
                            check(bool(torch.isfinite(g).all()), f"composite {what} non-finite")
                            err = max(err, float((g.float() - w.float()).abs().max()))
                            ok = fp32_close(g, w) if dual == torch.float32 else bf16_ulp_ok(g, w)
                            check(ok, f"composite vs plain {what}: {err}")
                        worst[dual] = max(worst[dual], err)
                        print(f"[composite] {str(shape):16s} {mode:5s} {str(dual)[6:]:8s} "
                              f"box={str(bounds):10s} tau={tau_kind:6s} "
                              f"max|kernel-plain|={err:.3e}")
    return worst


def phase_halo_kernel(dev, gen) -> dict:
    """The tile-halo kernel against ``_halo_plain`` on the same CUDA inputs
    with random halo rows; then over 2 and 4 tiles, each given its
    neighbours' rows, against the circular kernel on the whole stack."""
    from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _halo_plain,
        fused_admm_stencil,
        fused_admm_stencil_halo,
        fused_admm_stencil_mixed,
    )

    print("[halo] tolerance: kernel equal to the plain twin bit for bit (fp32 and bf16)")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in HALO_SHAPES:
        n, _, w = shape
        x = torch.randn(shape, generator=gen, device=dev)
        u32 = [0.5 * torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
        halos = [torch.randn((n, 1, w), generator=gen, device=dev) for _ in range(2)]
        halos += [0.5 * torch.randn((n, 1, w), generator=gen, device=dev) for _ in range(2)]
        tau_v = torch.empty(n, device=dev).uniform_(0.1, 0.5, generator=gen)
        for dual in (torch.float32, torch.bfloat16):
            ux, uy = (u.to(dual) for u in u32)
            for mode in MODES:
                for tau_kind, tau in (("scalar", torch.tensor(0.3, device=dev)),
                                      ("plane", tau_v)):
                    before = fused_admm_stencil_halo.launches
                    got = fused_admm_stencil_halo(x, ux, uy, *halos, tau, mode=mode)
                    want = _halo_plain(x, ux, uy, *halos, tau, mode)
                    torch.cuda.synchronize()
                    check(fused_admm_stencil_halo.launches == before + 1,
                          "fused_admm_stencil_halo launched its kernel")
                    what = f"{shape} {mode} {dual} tau={tau_kind}"
                    err = 0.0
                    for g, wnt in zip(got, want):
                        check(g.dtype == dual and g.shape == x.shape, f"halo {what} layout")
                        check(bool(torch.isfinite(g).all()), f"halo {what} non-finite")
                        err = max(err, float((g.float() - wnt.float()).abs().max()))
                        check(torch.equal(g, wnt), f"halo kernel vs plain {what}: {err}")
                    worst[dual] = max(worst[dual], err)
                    print(f"[halo] {str(shape):16s} {mode:5s} {str(dual)[6:]:8s} "
                          f"tau={tau_kind:6s} max|kernel-plain|={err:.3e}")
    # Misaligned storage: the element-wise accesses of the same kernel.
    for shape in MISALIGNED_SHAPES:
        n, _, w = shape
        x = misaligned(torch.randn(shape, generator=gen, device=dev))
        u32 = [0.5 * torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
        halos = [misaligned(torch.randn((n, 1, w), generator=gen, device=dev))
                 for _ in range(4)]
        for dual in (torch.float32, torch.bfloat16):
            ux, uy = (misaligned(u.to(dual)) for u in u32)
            for mode in MODES:
                tau = torch.tensor(0.3, device=dev)
                got = fused_admm_stencil_halo(x, ux, uy, *halos, tau, mode=mode)
                want = _halo_plain(x, ux, uy, *halos, tau, mode)
                for g, wnt in zip(got, want):
                    check(torch.equal(g, wnt), f"halo kernel vs plain {shape} {mode} {dual} "
                          f"misaligned")
        print(f"[halo] {str(shape):16s} misaligned storage, every mode, fp32 and bf16: "
              f"equal to the plain twin")
    # The tile decomposition: the tiles' kernel outputs, concatenated, are
    # the circular kernel's on the whole stack.
    shape = (BENCH_SHAPE[0] * BENCH_SHAPE[3],) + BENCH_SHAPE[1:3]
    n, h, _ = shape
    x = torch.randn(shape, generator=gen, device=dev)
    u32 = [0.5 * torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
    tau = torch.empty(n, device=dev).uniform_(0.1, 0.5, generator=gen)
    for dual in (torch.float32, torch.bfloat16):
        ux, uy = (u.to(dual) for u in u32)
        whole = fused_admm_stencil if dual == torch.float32 else fused_admm_stencil_mixed
        for mode in MODES:
            want = whole(x, ux, uy, tau, mode=mode)
            for tiles in HALO_TILES:
                ht = h // tiles
                outs = []
                for t in range(tiles):
                    rows, below = slice(t * ht, (t + 1) * ht), ((t + 1) * ht) % h
                    outs.append(fused_admm_stencil_halo(
                        x[:, rows], ux[:, rows], uy[:, rows], x[:, (t * ht - 1) % h, None],
                        x[:, below, None], ux[:, below, None].float(),
                        uy[:, below, None].float(), tau, mode=mode))
                for k in range(3):
                    check(torch.equal(torch.cat([o[k] for o in outs], dim=1), want[k]),
                          f"halo kernel over {tiles} tiles vs circular kernel {mode} {dual} out {k}")
            print(f"[halo] {shape} over {HALO_TILES} tiles, {mode}, {str(dual)[6:]}: the tiles' "
                  f"outputs equal the circular kernel's bit for bit")
    torch.cuda.synchronize()
    return worst


def phase_tiled(dev) -> dict:
    """The tiled solvers on a one-rank NCCL tile mesh, each beside the
    single-device solver on the same inputs in this run."""
    from admm_deconv_tpu_torch import (
        composite_tv_deconvolve,
        peak_snr,
        tv_deconvolve,
        tv_deconvolve_adaptive,
        tv_deconvolve_anderson,
    )
    from admm_deconv_tpu_torch.parallel import (
        make_mesh,
        tiled_composite_tv_deconvolve,
        tiled_tv_deconvolve,
        tiled_tv_deconvolve_anderson,
    )

    mesh = make_mesh({"tile": 1})
    check(torch.distributed.get_backend() == "nccl", "the tile mesh runs on NCCL")
    print(f"[tiled] mesh {mesh}, backend {torch.distributed.get_backend()}")
    psf = motion_psf(dev)
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random(BENCH_SHAPE, dtype=np.float64).astype(np.float32)).to(dev)
    kw = {"psf": psf, "lam": LAM, "rho": RHO}
    out = {}

    def rate(solve, v, iters):
        """Iterations/s over REPEATS fresh inputs after one warm-up, and the
        first solve's result."""
        first = solve(v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(REPEATS):
            solve(v + 0.001 * (i + 1))
        torch.cuda.synchronize()
        return iters * REPEATS / (time.perf_counter() - t0), first

    def run(label, tiled, single, v, iters, launches, tol, single_counts=None):
        reset_counts()
        r_tiled, x_tiled = rate(tiled, v, iters)
        counts = read_counts()
        want = expect_counts(stencil_halo=(REPEATS + 1) * launches)
        check(counts == want, f"{label} tiled launches {counts} != {want}")
        r_single, x_single = rate(single, v, iters)
        check(x_ok(x_tiled, v) and x_ok(x_single, v), f"{label} outputs")
        dx = float((x_tiled - x_single).abs().max())
        print(f"[tiled] {label}: tiled T=1 {r_tiled:.2f} it/s, single device {r_single:.2f} "
              f"it/s ({REPEATS} fresh inputs after one warm-up); max|x_tiled - x_single| "
              f"{dx:.3e} (bound {tol:.3e}); {launches} stencil_halo launches a solve")
        check(dx <= tol, f"{label}: tiled off the single-device solve by {dx} > {tol}")
        out[label] = {"it_s": r_tiled, "single_it_s": r_single, "dx": dx,
                      "launches": counts["stencil_halo"] // (REPEATS + 1)}
        return x_tiled, x_single

    solve_kw = {**kw, "iters": BENCH_ITERS}
    run("tiled_tile1_1080p fp32",
        lambda v: tiled_tv_deconvolve(v, mesh=mesh, **solve_kw),
        lambda v: tv_deconvolve(v, **solve_kw), y, BENCH_ITERS, BENCH_ITERS - 1, 1e-4)
    # bf16 state rounds the carry where the transforms differ in the last
    # fp32 bit: held to twice the single-device bf16-vs-fp32 gap.
    envelope = float((tv_deconvolve(y, state_dtype="bfloat16", **solve_kw)
                      - tv_deconvolve(y, **solve_kw)).abs().max())
    run("tiled_tile1_1080p bf16",
        lambda v: tiled_tv_deconvolve(v, mesh=mesh, state_dtype="bfloat16", **solve_kw),
        lambda v: tv_deconvolve(v, state_dtype="bfloat16", **solve_kw), y, BENCH_ITERS,
        BENCH_ITERS - 1, 2 * envelope + 1e-3)

    # bench_suite.py's tiled adaptive row against the single-device adaptive
    # solver at the same settings.
    n_it = TILED_ADAPTIVE_ITERS
    akw = {**kw, "check_every": CHECK_EVERY, "eps_abs": 0.0, "eps_rel": 0.0, "adapt_rho": True}
    reset_counts()
    xt, dt = tiled_tv_deconvolve(y, mesh=mesh, iters=n_it, early_stop=True,
                                 return_diagnostics=True, **akw)
    torch.cuda.synchronize()
    counts = read_counts()
    blocks = n_it // CHECK_EVERY
    want = expect_counts(stencil_halo=(CHECK_EVERY - 2) * blocks)
    check(counts == want, f"tiled adaptive launches {counts} != {want}")
    xs, ds = tv_deconvolve_adaptive(y, max_iters=n_it, **akw)
    dx = float((xt - xs).abs().max())
    same_rho = bool(torch.equal(dt.rho, ds.rho))
    sec_t, _ = timed_solves(lambda v: tiled_tv_deconvolve(
        v, mesh=mesh, iters=n_it, early_stop=True, return_diagnostics=True, **akw), y, TTQ_REPEATS)
    sec_s, _ = timed_solves(lambda v: tv_deconvolve_adaptive(v, max_iters=n_it, **akw), y,
                            TTQ_REPEATS)
    print(f"[tiled] tiled_adaptive_tile1_1080p_check8: tiled {int(dt.iterations)} iterations "
          f"{sec_t:.4f} s a solve, single device {int(ds.iterations)} iterations {sec_s:.4f} s "
          f"(median of {TTQ_REPEATS}); rho equal per plane: {same_rho} "
          f"({dt.rho.unique().tolist()}); max|dx| {dx:.3e}; launches {counts}")
    check(int(dt.iterations) == int(ds.iterations) == n_it, "tiled adaptive iterations")
    check(same_rho, "tiled adaptive rho off the single-device rho")
    check(dx <= 1e-4, f"tiled adaptive x off the single-device x by {dx}")
    out["tiled_adaptive_tile1_1080p_check8"] = {
        "s": sec_t, "single_s": sec_s, "dx": dx, "launches": counts["stencil_halo"]}

    rng4k = np.random.default_rng(0)
    y4k = torch.from_numpy(rng4k.random(FRAME_4K, dtype=np.float64).astype(np.float32)).to(dev)
    run("4K frame fp32", lambda v: tiled_tv_deconvolve(v, mesh=mesh, **solve_kw),
        lambda v: tv_deconvolve(v, **solve_kw), y4k, BENCH_ITERS, BENCH_ITERS - 1, 1e-4)
    del y4k

    ckw = {"psf": psf, "iters": BENCH_ITERS, **COMPOSITE_KW}
    x_tiled, _ = run("tiled composite fp32",
                     lambda v: tiled_composite_tv_deconvolve(v, mesh=mesh, **ckw),
                     lambda v: composite_tv_deconvolve(v, **ckw), y, BENCH_ITERS,
                     BENCH_ITERS - 1, 1e-4)
    check(float(x_tiled.min()) >= 0.0 and float(x_tiled.max()) <= 1.0, "tiled composite box")
    print(f"[tiled] tiled composite in [0, 1]: min {float(x_tiled.min())} max "
          f"{float(x_tiled.max())}")

    clean, blurred, bpsf = blocks_scenario()
    reset_counts()
    xq = tiled_tv_deconvolve(torch.from_numpy(blurred).to(dev), psf=torch.from_numpy(bpsf).to(dev),
                             lam=LAM, rho=RHO, iters=100, mesh=mesh)
    torch.cuda.synchronize()
    check(read_counts() == expect_counts(stencil_halo=99), "tiled quality-run launches")
    db = float(peak_snr(torch.clamp(xq, 0, 1), torch.from_numpy(clean).to(dev)))
    floor = QUALITY_FLOORS["tv_deconvolve fp32"]
    print(f"[tiled] blocks scenario, 100 iterations: PSNR {db:.5f} dB (floor {floor})")
    check(db >= floor, f"tiled blocks PSNR {db} below {floor}")
    reset_counts()
    x64 = tiled_tv_deconvolve(blurred.astype(np.float64), psf=bpsf.astype(np.float64), lam=LAM,
                              rho=RHO, iters=10, mesh=mesh)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[float64] tiled_tv_deconvolve: a float64 numpy y solves to {x64.dtype} on "
          f"{x64.device}; launches {counts}")
    check(x64.dtype == torch.float32 and x64.device.type == "cuda", "tiled float64 numpy input")
    check(counts == expect_counts(stencil_halo=9), f"tiled float64 launches {counts}")
    check(torch.equal(x64, tiled_tv_deconvolve(torch.from_numpy(blurred).to(dev),
                                               psf=torch.from_numpy(bpsf).to(dev), lam=LAM,
                                               rho=RHO, iters=10, mesh=mesh)),
          "tiled: the float64 array's solve differs from the float32 tensor's")

    # The tiled Anderson solver beside the single-device one: every outer
    # step, and every 8th (6 Q2-4 launches a block).
    for label, akw, halo in (
            (f"tiled anderson m={ANDERSON_M}", {"iters": BENCH_ITERS}, 0),
            (f"tiled anderson m={ANDERSON_M} aa_interval={AA_INTERVAL}",
             {"iters": BENCH_ITERS - 1, "aa_interval": AA_INTERVAL},
             (AA_INTERVAL - 2) * ((BENCH_ITERS - 2) // AA_INTERVAL))):
        akw = {**kw, "m": ANDERSON_M, **akw}
        reset_counts()
        tiled_tv_deconvolve_anderson(y, mesh=mesh, **akw)
        torch.cuda.synchronize()
        counts = read_counts()
        want = expect_counts(stencil_halo=halo)
        check(counts == want, f"{label} launches {counts} != {want}")
        sec_t, res_t = timed_solves(
            lambda v: tiled_tv_deconvolve_anderson(v, mesh=mesh, **akw), y, TTQ_REPEATS)
        sec_s, res_s = timed_solves(lambda v: tv_deconvolve_anderson(v, **akw), y, TTQ_REPEATS)
        (xt, dt), (xs, ds) = res_t[0], res_s[0]
        check(x_ok(xt, y) and x_ok(xs, y), f"{label} outputs")
        dx = float((xt - xs).abs().max())
        dr = float(((dt.r_norm - ds.r_norm).abs() / ds.r_norm).max())
        n_it = akw["iters"]
        print(f"[tiled] {label}, {n_it} iterations: tiled T=1 {n_it / sec_t:.2f} it/s, single "
              f"device {n_it / sec_s:.2f} it/s (median of {TTQ_REPEATS} fresh inputs): "
              f"{sec_s / sec_t:.3f}x; iterations {int(dt.iterations)} / {int(ds.iterations)}; "
              f"max|x_tiled - x_single| {dx:.3e} (bound 1e-3: the mixing solve amplifies the "
              f"transforms' last bit), r_norm rel {dr:.2e}; launches of one solve {counts}")
        check(int(dt.iterations) == int(ds.iterations) == n_it, f"{label} iterations")
        check(dx <= 1e-3, f"{label}: tiled off the single-device solve by {dx}")
        out[label] = {"it_s": n_it / sec_t, "single_it_s": n_it / sec_s, "dx": dx,
                      "launches": counts["stencil_halo"]}

    profile_tiled(lambda v: tiled_tv_deconvolve(v, mesh=mesh, **solve_kw),
                  lambda v: tv_deconvolve(v, **solve_kw), y)
    torch.distributed.destroy_process_group()
    return out


# Device-time groups of the tiled solve's profile, by kernel name.  On a
# one-rank NCCL group a collective is a device-to-device copy; the device
# time under the collectives' ``nccl:*`` ranges is reported beside.
TILED_PROFILE_GROUPS = (
    ("halo and row concatenations (torch.stack / torch.cat)", ("CatArrayBatchedCopy",)),
    ("copies (collectives' self-copies, re-shard permutes, c2r input clones)",
     ("copy", "Memcpy")),
    ("stencil kernels", ("stencil_halo_kernel", "stencil_fwd_kernel")),
    ("cuFFT", ("fft", "FFT")),
)


def profiled_solve(solve, y, label: str) -> dict:
    """One ``solve(y)`` under torch.profiler: its wall ms, its device work
    (``device_events``) and busy ms, and the device ms under each
    collective's ``nccl:*`` range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(y)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_events(prof, label)
    return {"wall_ms": wall_ms, "kernels": kernels,
            "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "collectives": {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA and e.key.startswith("nccl:")}}


def profile_tiled(tiled, single, y) -> None:
    """Device time by kernel group for one tiled and one single-device
    1080p solve under torch.profiler."""
    for label, solve in (("tiled T=1", tiled), ("single device", single)):
        solve(y)
        torch.cuda.synchronize()
        run = profiled_solve(solve, y + 1e-4 * (TTQ_REPEATS + 1), label)
        kernels, busy, wall_ms = run["kernels"], run["busy_ms"], run["wall_ms"]
        collectives = run["collectives"]
        coll_ms = sum(collectives.values())
        print(f"[tiled profile] {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
              f"idle share {1 - busy / wall_ms:.3f}; device time under the collectives "
              f"{coll_ms:.3f} ms ({coll_ms / busy:.1%} of busy): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in collectives.items()))
        seen = set()
        for group, keys in TILED_PROFILE_GROUPS:
            members = [e for e in kernels if e.key not in seen and any(k in e.key for k in keys)]
            seen |= {e.key for e in members}
            ms = sum(e.self_device_time_total for e in members) / 1e3
            print(f"[tiled profile]   {group}: {ms:.3f} ms ({ms / busy:.1%} of busy), "
                  f"{sum(e.count for e in members)} launches")
        ms = sum(e.self_device_time_total for e in kernels if e.key not in seen) / 1e3
        print(f"[tiled profile]   everything else: {ms:.3f} ms ({ms / busy:.1%})")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"[tiled profile]     {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
                  f"{e.key[:90]}")


def phase_halo_times(dev, gen) -> dict:
    """The tile-halo kernel at each stack of ``HALO_TIME_SHAPES`` with random
    halo rows, fp32 and bf16 duals: ms per call (CUDA events) and on the
    device alone; its plain twin at the first, the 1080p batch-4 stack, and
    at the four-card cell's tile."""
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _halo_plain,
        fused_admm_stencil_halo,
    )

    tau = torch.tensor(LAM / RHO, device=dev)
    times = {}
    for shape in HALO_TIME_SHAPES:
        n, h, w = shape
        x = torch.rand(shape, generator=gen, device=dev)
        halos = [torch.rand((n, 1, w), generator=gen, device=dev) for _ in range(4)]
        for key, dual in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            ux, uy = ((0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
                      for _ in range(2))

            def kernel(ux=ux, uy=uy):
                return fused_admm_stencil_halo(x, ux, uy, *halos, tau)

            def plain(ux=ux, uy=uy):
                return _halo_plain(x, ux, uy, *halos, tau, "aniso")

            # Bytes: x, ux, uy in and q, ux', uy' out per pixel, plus the four
            # fp32 halo rows (16 B per plane column); 21 operations a pixel.
            bytes_px = (14 if dual == torch.bfloat16 else 24) + 16 / h
            if shape in (HALO_TIME_SHAPES[0], TILE4_STACK):
                p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kernel, kernel, plain))
                plain_ms = min(p1, p2)
            else:
                k1, k2, plain_ms = cuda_ms(kernel, 20), cuda_ms(kernel, 20), None
            t = {"ms": min(k1, k2), "plain_ms": plain_ms,
                 "device_ms": device_ms(kernel, 20),
                 **bound(shape, bytes_px, 21)}
            times[f"halo_{key}" if shape == HALO_TIME_SHAPES[0] else f"halo_{key} {shape}"] = t
            plain_txt = "" if plain_ms is None else f", plain {p1:.4f}/{p2:.4f} ms per call"
            print(f"[times] {shape} halo_{key}, aniso: kernel {k1:.4f}/{k2:.4f} ms per call, "
                  f"device {t['device_ms']:.4f} ms{plain_txt}; HBM floor {t['bound_ms']:.4f} ms, "
                  f"kernel at {t['bound_ms'] / t['ms']:.1%} of it per call, "
                  f"{t['bound_ms'] / t['device_ms']:.1%} on the device")
    return times


def ttq_scene(dev, name: str):
    """``scripts/bench_suite.py``'s time-to-tolerance blocks scene (seed 1,
    7x7 motion blur), the blur on the card: only the PSF's middle row is
    nonzero, and adding the other rows' zero terms changes no value."""
    grid, px = TTQ[name][:2]
    rng = np.random.default_rng(1)
    tiles = rng.random(grid) > 0.5
    clean = np.clip(0.2 + np.repeat(np.repeat(tiles, px, 1), px, 2) * 0.4, 0, 1).astype(np.float32)
    clean = torch.from_numpy(clean).to(dev)
    psf = motion_psf(dev)
    blurred = torch.zeros_like(clean)
    for c in range(7):
        blurred = blurred + psf[3, c] * torch.roll(clean, c - 3, dims=2)
    return clean, blurred, psf


def timed_solves(solve, y, repeats: int):
    """Median seconds of ``repeats`` solves on fresh inputs (one warm-up),
    each ending in a synchronize; and each solve's result."""
    solve(y)
    torch.cuda.synchronize()
    secs, outs = [], []
    for i in range(repeats):
        v = y + 1e-4 * (i + 1)
        t0 = time.perf_counter()
        outs.append(solve(v))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return float(np.median(secs)), outs


def phase_adaptive(dev) -> dict:
    """``tv_deconvolve_adaptive`` on the ttq scenes: the kernel path against
    the plain path, launch counts, seconds to tolerance."""
    from admm_deconv_tpu_torch import tv_deconvolve_adaptive

    out = {}
    for name, (_, _, eps_abs, eps_rel, cap) in TTQ.items():
        clean, y, psf = ttq_scene(dev, name)
        kw = {"psf": psf, "lam": LAM, "rho": RHO, "max_iters": cap, "eps_abs": eps_abs,
              "eps_rel": eps_rel, "adapt_rho": True}
        reset_counts()
        xk, dk = tv_deconvolve_adaptive(y, check_every=CHECK_EVERY, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        xp, dp = tv_deconvolve_adaptive(y, check_every=CHECK_EVERY, prox_impl="xla", **kw)
        its = int(dk.iterations)
        blocks = its // CHECK_EVERY
        want = expect_counts(fused_admm_stencil=(CHECK_EVERY - 2) * blocks, prox_dual=2 * blocks)
        check(counts == want, f"{name} adaptive launches {counts} != {want}")
        check(x_ok(xk, y), f"{name} adaptive output")
        dx = float((xk - xp).abs().max())
        same_rho = bool(torch.equal(dk.rho, dp.rho))
        print(f"[adaptive] {name} {tuple(y.shape)} eps {eps_abs}/{eps_rel} check_every "
              f"{CHECK_EVERY}: kernel path {its} iterations, plain path {int(dp.iterations)}; "
              f"rho equal per plane: {same_rho} ({dk.rho.unique().tolist()}); max|dx| {dx:.3e}; "
              f"launches {counts}")
        check(its == int(dp.iterations), f"{name}: kernel vs plain iteration count")
        check(same_rho, f"{name}: kernel vs plain rho")
        check(dx <= 1e-4, f"{name}: adaptive kernel path off the plain path by {dx}")
        check(its < cap, f"{name}: no early stop")
        row = {"iterations": its, "launches": counts}
        for k, impl in ((CHECK_EVERY, "auto"), (1, "auto"), (CHECK_EVERY, "xla")):
            sec, res = timed_solves(
                lambda v, k=k, impl=impl: tv_deconvolve_adaptive(
                    v, check_every=k, prox_impl=impl, **kw), y, TTQ_REPEATS)
            row[f"s_check{k}_{impl}"] = sec
            print(f"[adaptive] {name} check_every={k} prox_impl={impl}: {sec:.4f} s to "
                  f"tolerance (median of {TTQ_REPEATS}, fresh inputs), iterations "
                  f"{[int(d.iterations) for _, d in res]}")
        out[name] = row
        if name == "ttq_1080p":
            kw_1080p, y_1080p = kw, y
    profile_solve("adaptive ttq_1080p check_every=8",
                  lambda v: tv_deconvolve_adaptive(v, check_every=CHECK_EVERY, **kw_1080p),
                  y_1080p)
    profile_solve("adaptive ttq_1080p check_every=1",
                  lambda v: tv_deconvolve_adaptive(v, check_every=1, **kw_1080p), y_1080p)
    return out


def profile_solve(label: str, solve, y) -> None:
    """Device time by kernel and the idle share of one solve of a fresh
    input near ``y`` under torch.profiler (after one unprofiled solve)."""
    from torch.profiler import ProfilerActivity, profile

    solve(y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve(y + 1e-4 * (TTQ_REPEATS + 1))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_events(prof, label)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    its = f"{int(res[1].iterations)} iterations, " if isinstance(res, tuple) else ""
    print(f"[profile] {label}: {its}wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x {e.key[:90]}")


def x_ok(x, y) -> bool:
    return x.shape == y.shape and bool(torch.isfinite(x).all())


def used_check_every(counts: dict, iterations: int) -> int:
    """The check_every an adaptive solve ran, from its launch counts: a
    block of k > 2 launches k - 2 Q2-1 and 2 Q2-5, a k = 1 solve one Q2-5 an
    iteration and no Q2-1; 0 when no Q2-5 ran."""
    stencil = counts["fused_admm_stencil"] + counts["fused_admm_stencil_mixed"]
    if stencil == 0 and counts["prox_dual"] == iterations:
        return 1
    blocks = counts["prox_dual"] // 2
    return iterations // blocks if blocks else 0


def phase_solve_auto(dev) -> dict:
    """``solve_auto``'s two branches on the card: a fixed budget on bench.py's
    1080p batch-4 inputs, timed with the policy's state dtype and with the
    other, and a tolerance on the ttq_1080p scene.  Each run is held, by its
    launch counts, to the stencil (``fused_admm_stencil`` for fp32 state,
    ``fused_admm_stencil_mixed`` for bf16) and the check_every the policy
    implies."""
    from admm_deconv_tpu_torch import solve_auto
    from admm_deconv_tpu_torch.ops.policy import overrides, policy
    from admm_deconv_tpu_torch.ops.solver import SOLVE_AUTO_MAX_ITERS, _auto_check_every

    def state(bf16: bool) -> str:
        return "bf16" if bf16 else "fp32"

    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random(BENCH_SHAPE, dtype=np.float64).astype(np.float32)).to(dev)
    psf = motion_psf(dev)
    default = policy().bf16_state_on_tpu
    print(f"[solve_auto] policy: bf16_state_on_tpu={default}, "
          f"check_every={policy().solve_auto_check_every}, deep_eps_abs={policy().deep_eps_abs}")
    out = {}
    for bf16 in (default, not default):
        label = (f"policy ({state(bf16)} state)" if bf16 == default
                 else f"bf16_state_on_tpu={bf16} ({state(bf16)} state)")
        with overrides(bf16_state_on_tpu=bf16):
            solve = lambda v: solve_auto(v, psf=psf, lam=LAM, rho=RHO, iters=BENCH_ITERS)  # noqa: E731
            reset_counts()
            x, d = solve(y)
            torch.cuda.synchronize()
            counts = read_counts()
            # The budget is one check_every=iters block.
            want = expect_counts(**{_state_stencil(bf16): BENCH_ITERS - 2}, prox_dual=2)
            check(counts == want, f"solve_auto(iters={BENCH_ITERS}) {label} launches {counts} "
                  f"!= {want}")
            used = used_check_every(counts, BENCH_ITERS)
            check(used == BENCH_ITERS, f"solve_auto(iters={BENCH_ITERS}) ran check_every="
                  f"{used}, want one block of {BENCH_ITERS}")
            check(x_ok(x, y) and int(d.iterations) == BENCH_ITERS, "solve_auto fixed budget")
            sec, _ = timed_solves(solve, y, REPEATS)
        out[label] = {"it_s": BENCH_ITERS / sec, "launches": counts}
        print(f"[solve_auto] iters={BENCH_ITERS} on {BENCH_SHAPE}, {label}: one "
              f"check_every={BENCH_ITERS} adaptive block, {BENCH_ITERS / sec:.2f} it/s "
              f"(median of {REPEATS}); final r {float(d.r_norm.max()):.4e}; launches {counts}")
    # The tolerance branch at the default eps (1e-4, not below deep_eps_abs)
    # and max_iters: the policy's check_every where it divides max_iters.
    implied = _auto_check_every(SOLVE_AUTO_MAX_ITERS)
    _, yt, psf = ttq_scene(dev, "ttq_1080p")
    solve = lambda v: solve_auto(v, psf=psf, lam=LAM, rho=RHO)  # noqa: E731
    reset_counts()
    x, d = solve(yt)
    torch.cuda.synchronize()
    counts = read_counts()
    its = int(d.iterations)
    used = used_check_every(counts, its)
    check(used == implied, f"solve_auto tolerance ran check_every={used}, the policy implies "
          f"{implied}")
    blocks = its // implied
    want = (expect_counts(**{_state_stencil(default): (implied - 2) * blocks},
                          prox_dual=2 * blocks)
            if implied > 1 else expect_counts(prox_dual=its))
    check(counts == want, f"solve_auto tolerance launches {counts} != {want}")
    check(x_ok(x, yt), "solve_auto tolerance output")
    sec, res = timed_solves(solve, yt, TTQ_REPEATS)
    out["tolerance"] = {"s": sec, "iterations": its, "launches": counts}
    print(f"[solve_auto] ttq_1080p tolerance branch ({state(default)} state and check_every="
          f"{used} by the policy): {sec:.4f} s to tolerance, iterations "
          f"{[int(r[1].iterations) for r in res]}, rho {d.rho.unique().tolist()}; launches "
          f"{counts}")
    return out


def phase_composite(dev) -> dict:
    """``composite_tv_deconvolve`` on the ttq_1080p scene through the kernel
    (fp32 and bf16 carry) and the plain path; the adaptive twin."""
    from admm_deconv_tpu_torch import (
        composite_tv_deconvolve,
        composite_tv_deconvolve_adaptive,
        peak_snr,
    )

    clean, y, psf = ttq_scene(dev, "ttq_1080p")
    iters = BENCH_ITERS
    kw = {"psf": psf, "iters": iters, **COMPOSITE_KW}
    plain = composite_tv_deconvolve(y, prox_impl="xla", **kw)
    db_plain = float(peak_snr(plain, clean))
    out = {}
    for carry, sdt in (("fp32", None), ("bf16", "bfloat16")):
        solve = lambda v, sdt=sdt: composite_tv_deconvolve(v, state_dtype=sdt, **kw)  # noqa: E731
        reset_counts()
        x = solve(y)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == expect_counts(stencil_composite=iters - 1),
              f"composite {carry} launches {counts}")
        check(x_ok(x, y), f"composite {carry} output")
        check(float(x.min()) >= 0.0 and float(x.max()) <= 1.0, f"composite {carry} box")
        dx = float((x - plain).abs().max())
        db = float(peak_snr(x, clean))
        sec, _ = timed_solves(solve, y, REPEATS)
        out[carry] = {"it_s": iters / sec, "psnr": db, "dx": dx, "launches": counts}
        print(f"[composite] ttq_1080p, {iters} iterations, {carry} carry: {iters / sec:.2f} it/s "
              f"(median of {REPEATS}); PSNR {db:.4f} dB (plain path {db_plain:.4f}); "
              f"max|x - plain| {dx:.3e}; in [0, 1]: min {float(x.min())} max {float(x.max())}; "
              f"launches {counts}")
        if sdt is None:
            check(dx <= 1e-4, "composite kernel fp32 off the plain path")
    reset_counts()
    xa, da = composite_tv_deconvolve_adaptive(y, psf=psf, **COMPOSITE_KW)
    torch.cuda.synchronize()
    check(read_counts() == expect_counts(), "the adaptive composite runs no kernel")
    check(x_ok(xa, y), "adaptive composite output")
    sec, res = timed_solves(
        lambda v: composite_tv_deconvolve_adaptive(v, psf=psf, **COMPOSITE_KW), y, TTQ_REPEATS)
    out["adaptive"] = {"s": sec, "iterations": int(da.iterations)}
    print(f"[composite] adaptive twin (plain torch, no kernel): {int(da.iterations)} iterations, "
          f"{sec:.4f} s (median of {TTQ_REPEATS}), PSNR {float(peak_snr(xa, clean)):.4f} dB")
    profile_solve("composite fp32 carry", lambda v: composite_tv_deconvolve(v, **kw), y)
    profile_solve("composite adaptive",
                  lambda v: composite_tv_deconvolve_adaptive(v, psf=psf, **COMPOSITE_KW), y)
    return out


# Floors of the blocks scenario (3 x 256^2 x 3, 7x7 motion PSF, lam 0.0041,
# rho 0.021, 100 iterations).  fp32 state: the JAX package's PSNR on the CPU
# less 0.01 dB.  bf16 state, which rounds the carry at other points in each
# implementation: the lowest of JAX's CPU value, the port's CPU value and
# this script's first H100 run, less 0.01 dB.  Values (dB):
#   solve_auto(iters=100): JAX 54.99967 (fp32, its tv_deconvolve); bf16 in
#     one check_every=100 block: JAX 54.93597, port CPU 54.93509, H100 54.92967;
#   solve_auto tolerance branch (eps 1e-4/1e-3, check_every 8, 40 iterations):
#     fp32 JAX 55.65547, port CPU 55.65547, H100 55.65540; bf16 JAX 55.61966,
#     port CPU 55.61136, H100 55.60950;
#   composite (lam_l1 0.002, rho1 = rho2 = 0.021, box [0, 1]): JAX 51.47631
#     fp32; bf16 JAX 51.39770, port CPU 51.39394, H100 51.39671;
#   tv_deconvolve fp32 (also the tiled solver's): JAX 54.9997.
QUALITY_FLOORS = {
    "tv_deconvolve fp32": 54.99,
    "solve_auto iters=100 fp32": 54.98967, "solve_auto iters=100 bf16": 54.91967,
    "solve_auto tolerance fp32": 55.64547, "solve_auto tolerance bf16": 55.59950,
    "composite fp32": 51.46631, "composite bf16": 51.38394,
}


def phase_quality_solvers(dev) -> None:
    """The blocks scenario through solve_auto and composite_tv_deconvolve."""
    from admm_deconv_tpu_torch import composite_tv_deconvolve, peak_snr, solve_auto
    from admm_deconv_tpu_torch.ops.policy import overrides

    clean, blurred, psf = blocks_scenario()
    ref = torch.from_numpy(clean).to(dev)
    y = torch.from_numpy(blurred).to(dev)
    p = torch.from_numpy(psf).to(dev)
    runs = {}
    for bf16 in (False, True):
        state = "bf16" if bf16 else "fp32"
        with overrides(bf16_state_on_tpu=bf16):
            runs[f"solve_auto iters=100 {state}"] = solve_auto(
                y, psf=p, lam=LAM, rho=RHO, iters=100)[0]
            x, d = solve_auto(y, psf=p, lam=LAM, rho=RHO)
        runs[f"solve_auto tolerance {state}"] = x
        print(f"[quality] solve_auto tolerance branch, {state} state: {int(d.iterations)} "
              f"iterations (JAX on the CPU: 40), rho {d.rho.unique().tolist()} (JAX: 0.168)")
    for carry, sdt in (("fp32", None), ("bf16", "bfloat16")):
        runs[f"composite {carry}"] = composite_tv_deconvolve(
            y, psf=p, iters=100, state_dtype=sdt, **COMPOSITE_KW)
    for name, x in runs.items():
        check(x_ok(x, y), f"{name} output")
        db = float(peak_snr(torch.clamp(x, 0, 1), ref))
        print(f"[quality] {name}: PSNR {db:.5f} dB (floor {QUALITY_FLOORS[name]})")
        check(db >= QUALITY_FLOORS[name], f"{name} PSNR {db} below {QUALITY_FLOORS[name]}")
    float64_numpy_inputs(dev)


def float64_numpy_inputs(dev) -> None:
    """Every solver on numpy's default float64: the input goes to the card
    as float32, through the solver's kernel, and the result equals the
    solve of the float32 tensor."""
    import admm_deconv_tpu_torch as adt

    _, blurred, psf = blocks_scenario()
    y64, p64 = blurred.astype(np.float64), psf.astype(np.float64)
    kw = {"lam": LAM, "rho": RHO}
    ckw = {k: v for k, v in COMPOSITE_KW.items() if k != "x_bounds"}
    stencil = _state_stencil()
    cases = (
        ("tv_deconvolve", lambda y, p: adt.tv_deconvolve(y, p, iters=10, **kw),
         {"fused_admm_stencil": 9}),
        ("tv_deconvolve_adaptive", lambda y, p: adt.tv_deconvolve_adaptive(
            y, p, max_iters=16, check_every=8, eps_abs=0.0, eps_rel=0.0, **kw)[0],
         {"fused_admm_stencil": 12, "prox_dual": 4}),
        ("solve_auto", lambda y, p: adt.solve_auto(y, p, iters=10, **kw)[0],
         {stencil: 8, "prox_dual": 2}),
        ("tv_deconvolve_anderson", lambda y, p: adt.tv_deconvolve_anderson(y, p, iters=9, **kw)[0],
         {"prox_dual": 8}),
        ("tv_deconvolve_implicit", lambda y, p: adt.tv_deconvolve_implicit(y, p, iters=8, **kw),
         {"prox_dual": 8}),
        ("composite_tv_deconvolve", lambda y, p: adt.composite_tv_deconvolve(
            y, p, iters=10, x_bounds=(0.0, 1.0), **ckw), {"stencil_composite": 9}),
        ("composite_tv_deconvolve_adaptive (plain torch, no kernel)",
         lambda y, p: adt.composite_tv_deconvolve_adaptive(y, p, max_iters=4, **ckw)[0], {}),
    )
    y32 = torch.from_numpy(blurred).to(dev)
    p32 = torch.from_numpy(psf).to(dev)
    for name, solve, launches in cases:
        reset_counts()
        x = solve(y64, p64)
        torch.cuda.synchronize()
        counts = read_counts()
        same = bool(torch.equal(x, solve(y32, p32)))
        print(f"[float64] {name}: a float64 numpy y {y64.shape} solves to {x.dtype} on {x.device}; "
              f"launches {counts}; equal to the float32 tensor's solve: {same}")
        check(x.dtype == torch.float32 and x.device.type == "cuda", f"{name} of float64 numpy")
        check(counts == expect_counts(**launches), f"{name} float64 launches {counts}")
        check(same, f"{name}: the float64 array's solve differs from the float32 tensor's")


def _policy():
    from admm_deconv_tpu_torch.ops.policy import policy

    return policy()


def _state_stencil(bf16: bool | None = None) -> str:
    """The Q2-1 counter a solve with bf16 loop state (``None``: the state
    the policy picks) launches."""
    bf16 = _policy().bf16_state_on_tpu if bf16 is None else bf16
    return "fused_admm_stencil_mixed" if bf16 else "fused_admm_stencil"


def phase_anderson(dev) -> dict:
    """``tv_deconvolve_anderson`` on ``bench_suite.py``'s Anderson rows."""
    from admm_deconv_tpu_torch import (
        anderson_history_bytes,
        peak_snr,
        tv_deconvolve,
        tv_deconvolve_adaptive,
        tv_deconvolve_anderson,
    )
    from admm_deconv_tpu_torch.utils import IterationTimer

    out = {}
    # (a) anderson_256: iterations to reach 100 plain iterations' residual.
    clean, blurred, bpsf = blocks_scenario()
    ref, yb = torch.from_numpy(clean).to(dev), torch.from_numpy(blurred).to(dev)
    kw = {"psf": torch.from_numpy(bpsf).to(dev), "lam": LAM, "rho": RHO}
    _, d_plain = tv_deconvolve(yb, iters=100, return_diagnostics=True, **kw)
    target = float(d_plain.r_norm.max())
    needed = None
    for it in ANDERSON_LADDER:
        reset_counts()
        x, d = tv_deconvolve_anderson(yb, iters=it, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == expect_counts(prox_dual=it - 1), f"anderson_256 launches {counts}")
        check(x_ok(x, yb) and int(d.iterations) == it, "anderson_256 output")
        r, db = float(d.r_norm.max()), float(peak_snr(torch.clamp(x, 0, 1), ref))
        print(f"[anderson] anderson_256 {it} iterations: max r_norm {r:.5f} (100 plain "
              f"iterations: {target:.5f}), PSNR {db:.4f} dB, {counts['prox_dual']} Q2-5 launches")
        if r <= target:
            needed = it
            break
    check(needed is not None and needed < 100,
          f"Anderson did not reach the plain residual {target} in under 100 iterations")
    x100, _ = tv_deconvolve_anderson(yb, iters=100, **kw)
    db100 = float(peak_snr(torch.clamp(x100, 0, 1), ref))
    floor = QUALITY_FLOORS["tv_deconvolve fp32"]
    print(f"[anderson] anderson_256: aa_iters_to_match {needed} (plain 100); PSNR at the match "
          f"{db:.4f} dB, at 100 Anderson iterations {db100:.4f} dB (tv_deconvolve's floor {floor}; "
          f"the matched solve is held to the floor less 0.1 dB: it matches the residual, "
          f"not the iterate)")
    check(db100 >= floor and db >= floor - 0.1, f"Anderson PSNR {db} / {db100} below {floor}")
    out["anderson_256"] = {"iters_to_match": needed, "psnr": db, "psnr_100": db100}

    # (b) anderson_1080p_overhead: per-iteration cost at the bench shape.
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random(BENCH_SHAPE, dtype=np.float64).astype(np.float32)).to(dev)
    psf = motion_psf(dev)
    kw = {"psf": psf, "lam": LAM, "rho": RHO, "iters": BENCH_ITERS}
    solve_aa = lambda v: tv_deconvolve_anderson(v, m=ANDERSON_M, **kw)  # noqa: E731
    history = anderson_history_bytes(BENCH_SHAPE, ANDERSON_M)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    x, d = solve_aa(y)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - held
    check(counts == expect_counts(prox_dual=BENCH_ITERS - 1),
          f"anderson 1080p launches {counts}: want {BENCH_ITERS - 1} Q2-5 and no Q2-1")
    check(x_ok(x, y) and int(d.iterations) == BENCH_ITERS, "anderson 1080p output")
    check(peak >= history, f"peak {peak} below the history's {history} bytes")
    aa = IterationTimer(lambda v: solve_aa(v)[0], lambda i: (y + 1e-3 * i,)).measure(repeats=3)
    tv = IterationTimer(lambda v: tv_deconvolve(v, **kw), lambda i: (y + 1e-3 * i,)).measure(repeats=3)
    aa_it_s, tv_it_s = (BENCH_ITERS / t["seconds_per_call"] for t in (aa, tv))
    print(f"[anderson] anderson_1080p_overhead {BENCH_SHAPE}, {BENCH_ITERS} iterations, "
          f"m={ANDERSON_M}: {aa_it_s:.2f} it/s ({aa['seconds_per_call']:.4f} s a solve) beside "
          f"tv_deconvolve {tv_it_s:.2f} it/s on the same inputs (IterationTimer, 3 fresh inputs "
          f"after one warm-up): {aa_it_s / tv_it_s:.3f}x; launches {counts}")
    print(f"[anderson] peak memory of one solve {peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB "
          f"held before it; anderson_history_bytes {history / 1e9:.3f} GB "
          f"({peak / history:.2f}x); final max r_norm {float(d.r_norm.max()):.4e}, "
          f"fixed-point residual {float(d.s_norm.max()):.4e}")
    out["anderson_1080p_overhead"] = {"it_s": aa_it_s, "tv_it_s": tv_it_s, "peak_bytes": peak,
                                      "history_bytes": history, "launches": counts}
    profile_anderson("anderson 1080p 50 it m=5", solve_aa, y)
    del x, y
    out["probe_contraction"] = probe_contraction_times(dev)

    # (c) ttq_1080p with early_stop at the adaptive solver's tolerances.
    clean, yt, psf = ttq_scene(dev, "ttq_1080p")
    _, _, eps_abs, eps_rel, cap = TTQ["ttq_1080p"]
    kw = {"psf": psf, "lam": LAM, "rho": RHO, "eps_abs": eps_abs, "eps_rel": eps_rel}
    sec_ad, res_ad = timed_solves(
        lambda v: tv_deconvolve_adaptive(v, max_iters=cap, check_every=CHECK_EVERY,
                                         adapt_rho=True, **kw), yt, TTQ_REPEATS)
    db_ad = float(peak_snr(torch.clamp(res_ad[0][0], 0, 1), clean))
    print(f"[anderson] ttq_1080p adaptive(check8): {sec_ad:.4f} s to tolerance (median of "
          f"{TTQ_REPEATS}), iterations {[int(r[1].iterations) for r in res_ad]}, "
          f"PSNR {db_ad:.4f} dB")
    for label, k, iters in ((f"anderson(m={ANDERSON_M},early_stop)", 1, cap),
                            (f"anderson(m={ANDERSON_M},k={AA_INTERVAL},early_stop)", AA_INTERVAL,
                             2 * cap + 1)):
        solve = lambda v, impl="auto", k=k, iters=iters: tv_deconvolve_anderson(  # noqa: E731
            v, iters=iters, m=ANDERSON_M, early_stop=True, aa_interval=k, prox_impl=impl, **kw)
        reset_counts()
        xk, dk = solve(yt)
        torch.cuda.synchronize()
        counts = read_counts()
        its = int(dk.iterations)
        outer = (its - 1) // k
        want = (expect_counts(prox_dual=outer) if k == 1 else
                expect_counts(fused_admm_stencil=(k - 2) * outer, prox_dual=2 * outer))
        check(counts == want, f"{label} launches {counts} != {want}")
        check(x_ok(xk, yt) and (its - 1) % k == 0 and its < iters, f"{label}: {its} iterations")
        xp, dp = solve(yt, impl="xla")
        dx = float((xk - xp).abs().max())
        db = float(peak_snr(torch.clamp(xk, 0, 1), clean))
        sec, res = timed_solves(solve, yt, TTQ_REPEATS)
        print(f"[anderson] ttq_1080p {label}: {its} iterations ({outer} outer steps), "
              f"{sec:.4f} s to tolerance (median of {TTQ_REPEATS}, fresh inputs, iterations "
              f"{[int(r[1].iterations) for r in res]}) beside the adaptive solver's "
              f"{sec_ad:.4f} s; "
              f"PSNR {db:.4f} dB; prox_impl='xla': {int(dp.iterations)} iterations, "
              f"max|x_kernel - x_xla| {dx:.3e} (bound 1e-3: the mixing solve amplifies the "
              f"last bit); launches {counts}")
        check(its == int(dp.iterations), f"{label}: kernel vs plain iteration count")
        check(dx <= 1e-3, f"{label}: kernel path off the plain path by {dx}")
        out[label] = {"iterations": its, "s": sec, "adaptive_s": sec_ad, "dx": dx,
                      "launches": counts}
    return out


def probe_contraction_times(dev) -> dict:
    """The mixer's probe contraction ``(m, N, D) x (2, N, D) -> (N, m, 2)`` at
    the 1080p batch-4 state, as one batched product per image and split over
    H chunks of D (what the solver runs), in turns, and the split at other
    chunk counts; CUDA events."""
    from admm_deconv_tpu_torch.ops.solver import _AndersonMixer

    n, h, w = BENCH_SHAPE[0] * BENCH_SHAPE[3], BENCH_SHAPE[1], BENCH_SHAPE[2]
    d = 4 * h * w
    gen = torch.Generator(device=dev).manual_seed(0)
    probe = torch.randn((2, n, d), generator=gen, device=dev)
    mixer = _AndersonMixer(n, d, ANDERSON_M, 1e-10, 1e6, torch.float32, dev, chunks=h)
    mixer.dF.normal_(generator=gen)

    def whole():
        return torch.einsum("knd,jnd->nkj", mixer.dF, probe)

    def split():
        return mixer._probe_ring(probe)

    rel = float((split() - whole()).abs().max() / whole().abs().max())
    # Why H chunks: the split's time over chunk counts around it.
    sweep = {}
    for c in (16, h // 8, h, 4 * h, 64 * h):
        mixer.chunks = c
        sweep[c] = cuda_ms(split, 3)
    mixer.chunks = h
    print("[anderson] probe contraction split over c chunks of D, ms: "
          + ", ".join(f"c={c} {ms:.3f}" for c, ms in sweep.items()))
    w1, s1, s2, w2 = (cuda_ms(f, 3) for f in (whole, split, split, whole))
    floor = 1e3 * 4 * (mixer.dF.numel() + probe.numel()) / HBM_BYTES_PER_S
    print(f"[anderson] probe contraction ({ANDERSON_M}, {n}, {d}) x (2, {n}, {d}): one product "
          f"an image {w1:.3f}/{w2:.3f} ms, split over {h} chunks of D {s1:.3f}/{s2:.3f} ms "
          f"(reading the ring and the probe once at {HBM_BYTES_PER_S / 1e12} TB/s: "
          f"{floor:.3f} ms); results agree to {rel:.2e} of the largest entry")
    check(rel <= 1e-4, f"split probe contraction off the whole one by {rel}")
    return {"whole_ms": min(w1, w2), "split_ms": min(s1, s2), "floor_ms": floor}


# Device-time groups of the Anderson solve's profile, by kernel name; the
# solver's three ``record_function`` ranges are reported beside.
ANDERSON_PROFILE_GROUPS = (
    ("the two contractions (cuBLAS)", ("gemm", "gemv", "cutlass", "splitK", "dot_kernel")),
    ("linalg.solve (LU and triangular solves)", ("getrf", "getrs", "trsm", "laswp", "lu_", "LU")),
    ("cuFFT", ("fft", "FFT")),
    ("Q2-5 prox_dual", ("prox_dual",)),
    ("concatenations (torch.stack)", ("CatArrayBatchedCopy",)),
)


def profile_anderson(label: str, solve, y) -> None:
    """Device time of one Anderson solve under torch.profiler: by the
    solver's ranges (map, ring writes, mixing) and by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve(y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(y + 1e-4 * (TTQ_REPEATS + 1))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_events(prof, label)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[anderson profile] {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {1 - busy / wall_ms:.3f}")
    events = prof.key_averages()
    for e in events:
        if e.key.startswith("admm/aa_"):
            where = "device" if e.device_type == DeviceType.CUDA else "host"
            t = e.self_device_time_total if where == "device" else e.cpu_time_total
            print(f"[anderson profile]   range {e.key} on the {where}: {t / 1e3:.3f} ms, "
                  f"{e.count} times")
    seen = set()
    for group, keys in ANDERSON_PROFILE_GROUPS:
        members = [e for e in kernels if e.key not in seen and any(k in e.key for k in keys)]
        seen |= {e.key for e in members}
        ms = sum(e.self_device_time_total for e in members) / 1e3
        print(f"[anderson profile]   {group}: {ms:.3f} ms ({ms / busy:.1%} of busy), "
              f"{sum(e.count for e in members)} launches")
    ms = sum(e.self_device_time_total for e in kernels if e.key not in seen) / 1e3
    print(f"[anderson profile]   everything else (elementwise passes: ring writes, D, D^T, "
          f"norms, the complex rhs): {ms:.3f} ms ({ms / busy:.1%})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[anderson profile]     {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}")
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.key in ("aten::linalg_solve_ex", "aten::bmm", "aten::_fft_r2c", "aten::_fft_c2r")]
    print("[anderson profile]   host time: " + ", ".join(
        f"{e.key} {e.cpu_time_total / 1e3:.3f} ms / {e.count}" for e in host))


def phase_implicit(dev, tv: dict) -> dict:
    """``tv_deconvolve_implicit``: the card's gradients against the CPU's, and
    the 1080p TV-layer step with ``diff_mode="implicit"`` beside the
    unrolled remat step (``tv``: :func:`phase_tv_layer`'s steps)."""
    from admm_deconv_tpu_torch import tv_deconvolve_implicit
    from admm_deconv_tpu_torch.layers import ADMMDeconv
    from admm_deconv_tpu_torch.metrics import mse

    # The card against the CPU: 2 x 48 x 64 x 3, 5x5 motion PSF, per-image lam.
    rng = np.random.default_rng(11)
    y = rng.random(IMPLICIT_GRAD_SHAPE).astype(np.float32)
    w = rng.standard_normal(y.shape).astype(np.float32)
    psf = np.zeros((5, 5), np.float32)
    psf[2, :] = 0.2
    iters = 40
    grads = {}
    for where in ("cpu", dev):
        leaves = [torch.tensor(a, device=where, requires_grad=True)
                  for a in (y, psf, np.asarray([0.005, 0.02], np.float32), np.float32(0.05))]
        reset_counts()
        x = tv_deconvolve_implicit(leaves[0], psf=leaves[1], lam=leaves[2], rho=leaves[3],
                                   iters=iters, bwd_iters=30)
        (x * torch.tensor(w, device=where)).sum().backward()
        counts = read_counts()
        want = expect_counts(prox_dual=iters) if where is dev else expect_counts()
        check(counts == want, f"implicit solve on {where} launches {counts} != {want}")
        grads[str(where)] = [leaf.grad.cpu() for leaf in leaves]
    print("[implicit] tolerance: each gradient on the card within 1e-3 of the CPU's largest "
          "entry (cuFFT and pocketfft round differently, carried through 30 VJPs)")
    for name, g, g_cpu in zip(("y", "psf", "lam", "rho"), grads[str(dev)], grads["cpu"]):
        check(bool(torch.isfinite(g).all()), f"implicit {name} gradient not finite")
        rel = float((g - g_cpu).abs().max() / g_cpu.abs().max())
        print(f"[implicit] d{name}: card vs cpu {rel:.2e} of the largest entry "
              f"({float(g_cpu.abs().max()):.4e})")
        check(rel <= 1e-3, f"implicit {name} gradient: card off the CPU by {rel}")
    print(f"[implicit] {iters} Q2-5 launches in the {iters}-iteration forward on the card, "
          f"none in the backward, none on the CPU")

    # The 1080p TV-layer step, implicit beside unrolled (remat, kernels).
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random(TV_SHAPE, dtype=np.float32)).to(dev)
    t = torch.from_numpy(rng.random(TV_SHAPE, dtype=np.float32)).to(dev)
    inputs = [x + 1e-3 * i for i in range(TV_REPEATS + 1)]
    layer = ADMMDeconv(kernel_shape=(), iters=TV_ITERS, iso=False, lam_init=0.05, rho_init=0.5,
                       trainable=("lam", "rho"), diff_mode="implicit").to(dev)
    opt = torch.optim.Adam(layer.parameters(), lr=1e-3, eps=1e-8)

    def step(xi):
        loss = mse(layer(xi), t)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    def peak_of(fn, xi):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(xi)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - held

    unrolled = tv["kernel fp32"][0]
    reset_counts()
    ms_i = timed_steps(step, inputs)
    per_step = {k: v / len(inputs) for k, v in read_counts().items()}
    want = {k: 0 for k in per_step} | {"prox_dual": TV_ITERS}
    check(per_step == want, f"implicit TV layer launches per step {per_step} != {want}")
    ms_u = timed_steps(unrolled, inputs)
    peak_i, peak_u = peak_of(step, inputs[0]), peak_of(unrolled, inputs[0])
    check(bool(torch.isfinite(layer.lam).all() and torch.isfinite(layer.rho).all()),
          "implicit TV layer parameters not finite")
    plane_set = 4 * float(np.prod(TV_SHAPE))
    print(f"[implicit] {TV_SHAPE}, {TV_ITERS} iterations, Adam + mse: diff_mode='implicit' "
          f"(bwd_iters {layer.bwd_iters}) {ms_i:.3f} ms/step, peak {peak_i / 1e9:.3f} GB above "
          f"what the step found allocated ({peak_i / plane_set:.1f} plane sets of "
          f"{plane_set / 1e6:.1f} MB); unrolled remat through the kernels {ms_u:.3f} ms/step, "
          f"peak {peak_u / 1e9:.3f} GB ({peak_u / plane_set:.1f} plane sets); launches per "
          f"implicit step {per_step}")
    # No per-iteration activations: the implicit step's peak must not grow
    # with the iteration count, so it stays under the unrolled step's, which
    # keeps a checkpoint per iteration.
    check(peak_i < peak_u, f"implicit peak {peak_i} not below the unrolled {peak_u}")
    layer.iters = 2 * TV_ITERS
    peak_2i = peak_of(step, inputs[1])
    print(f"[implicit] at {2 * TV_ITERS} iterations the implicit step's peak is "
          f"{peak_2i / 1e9:.3f} GB ({peak_2i / peak_i:.3f}x)")
    check(peak_2i <= 1.05 * peak_i, "the implicit step's memory grows with the iterations")
    return {"ms": ms_i, "unrolled_ms": ms_u, "peak": peak_i, "unrolled_peak": peak_u,
            "launches": per_step}


def phase_utils(dev) -> None:
    """utils on the card: solver-state save/load, a profiler trace, and which
    of the port's paths run under ``deterministic_mode()``."""
    from admm_deconv_tpu_torch import (
        composite_tv_deconvolve,
        tv_deconvolve,
        tv_deconvolve_adaptive,
        tv_deconvolve_anderson,
        tv_deconvolve_implicit,
    )
    from admm_deconv_tpu_torch.utils import (
        deterministic_mode,
        load_solver_state,
        save_solver_state,
    )
    from admm_deconv_tpu_torch.utils.profiling import profile_trace

    clean, blurred, bpsf = blocks_scenario()
    y, psf = torch.from_numpy(blurred).to(dev), torch.from_numpy(bpsf).to(dev)
    kw = {"psf": psf, "lam": LAM, "rho": RHO}
    with tempfile.TemporaryDirectory() as tmp:
        x7, state = tv_deconvolve(y, iters=7, return_state=True, **kw)
        path = os.path.join(tmp, "state", "s.npz")
        save_solver_state(path, state)
        back = load_solver_state(path)
        check(all(a.device.type == "cuda" and torch.equal(a, b) for a, b in zip(back, state)),
              "a saved state loads on the card, bit for bit")
        x12 = tv_deconvolve(y, iters=5, init_state=back, return_diagnostics=True, **kw)[0]
        x12_direct = tv_deconvolve(y, iters=12, return_diagnostics=True, **kw)[0]
        dx = float((x12 - x12_direct).abs().max())
        print(f"[utils] save_solver_state / load_solver_state on the card: 7 + 5 warm-started "
              f"iterations vs 12: max|dx| {dx:.3e}")
        check(dx <= 1e-6, f"warm start off by {dx}")
        profile_trace(lambda v: tv_deconvolve(v, iters=5, **kw), y, log_dir=os.path.join(tmp, "tr"))
        with open(os.path.join(tmp, "tr", "trace.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        check(any("stencil_fwd_kernel" in n for n in names), "profile_trace saw no device kernel")
        print(f"[utils] profile_trace wrote a Chrome trace with {len(names)} event names, "
              f"the stencil kernel among them")

    # Which paths run under torch.use_deterministic_algorithms(True) when
    # CUBLAS_WORKSPACE_CONFIG is not set: every path below must, and a
    # failure raises.
    check("CUBLAS_WORKSPACE_CONFIG" not in os.environ, "CUBLAS_WORKSPACE_CONFIG is set")

    def implicit_step():
        lam = torch.tensor(LAM, device=dev, requires_grad=True)
        tv_deconvolve_implicit(y, lam=lam, rho=RHO, psf=psf, iters=8, bwd_iters=4).sum().backward()

    def unrolled_step():
        lam = torch.tensor(LAM, device=dev, requires_grad=True)
        tv_deconvolve(y, lam=lam, rho=RHO, psf=psf, iters=8).sum().backward()

    paths = (
        ("tv_deconvolve (Q2-1)", lambda: tv_deconvolve(y, iters=8, **kw)),
        ("tv_deconvolve_adaptive check_every=8 (Q2-1, Q2-5)",
         lambda: tv_deconvolve_adaptive(y, max_iters=16, check_every=8, **kw)),
        ("composite_tv_deconvolve (Q2-3)",
         lambda: composite_tv_deconvolve(y, psf=psf, iters=8, **COMPOSITE_KW)),
        ("tv_deconvolve backward (Q2-2)", unrolled_step),
        ("tv_deconvolve_implicit forward + backward (Q2-5)", implicit_step),
        ("tv_deconvolve_anderson (torch.bmm, linalg.solve)",
         lambda: tv_deconvolve_anderson(y, iters=9, **kw)),
    )
    was = torch.are_deterministic_algorithms_enabled(), torch.is_anomaly_enabled()
    for name, fn in paths:
        with deterministic_mode():
            fn()
            torch.cuda.synchronize()
        print(f"[utils] under deterministic_mode(): {name}: runs")
    check((torch.are_deterministic_algorithms_enabled(), torch.is_anomaly_enabled()) == was,
          "deterministic_mode restored the settings")


def _bench_lines(argv: list[str], only: list[str]) -> list[dict]:
    """``bench_torch``'s command in this process, for the cells ``only``
    names: its exit code must be 0 and every line it prints must parse."""
    from bench_torch import __main__ as bench_main

    codes = []
    text = _captured(lambda: codes.append(bench_main.main(argv, only=only)))
    check(codes == [0], f"bench_torch {argv} exited {codes}")
    lines = []
    for line in text.splitlines():
        try:
            lines.append(json.loads(line))
        except json.JSONDecodeError:
            check(False, f"bench_torch printed a line that does not parse: {line!r}")
    check(lines[-1].get("ok") is True and all(line.get("card", {}).get("power_limit")
                                               for line in lines),
          f"bench_torch {argv}: its last line, or a line without the card's power limit")
    return lines


def phase_bench(dev) -> dict:
    """``bench_torch``'s one-card cells through its own ``main``, one timed
    repeat each; then their controls, 100 timed units each as in the cells
    (the Anderson cell's ``ANDERSON_CONTROL_REPEATS`` and the batch-8 step's
    ``TRAIN_B8_CONTROL_REPEATS``: each check reads only the last unit, and
    their units take ~0.45 s and ~0.2 s), which the cells' checks must all
    reject.  The four-card cell runs in ``chip_smoke_multi.py``'s phase
    H."""
    from bench_torch import cells, controls

    one_card = [c for c in cells.RUNS if cells.CHIPS[c] == 1]
    stacks = cells.plane_stacks()
    check(all(stacks[c] in KERNEL_SHAPES and stacks[c] in SPECTRAL_SHAPES for c in one_card)
          and stacks[cells.TILED] in HALO_SHAPES
          and all(stacks[c] in BWD_SHAPES for c, k in cells.KERNELS.items()
                  if "stencil_bwd" in k)
          and all(stacks[c] in PROX_DUAL_SHAPES for c, k in cells.KERNELS.items()
                  if "prox_dual" in k)
          and all(stacks[c] in COMPOSITE_SHAPES for c, k in cells.KERNELS.items()
                  if "stencil_composite" in k),
          f"the benchmark's plane stacks {stacks} are not all checked by the kernel phases")
    lines = _bench_lines(["--repeats", "1"], one_card)
    by = {key: {line[key]: line for line in lines if key in line}
          for key in ("correct", "launches", "metric", "breakdown")}
    for key in ("correct", "launches", "breakdown"):
        check(set(by[key]) == set(one_card), f"bench_torch's {key} lines: {sorted(by[key])}")
    check(all(by["correct"][c]["ok"] and by["launches"][c]["ok"] for c in one_card),
          "a bench_torch cell failed its check or its launch count")
    shares = {cells.MFU_METRICS[c] for c in one_card}
    names = {cells.METRICS[c][0] for c in one_card} | shares
    check(set(by["metric"]) == names, f"bench_torch's metrics: {sorted(by['metric'])}")
    check(all(0 < by["metric"][m]["value"] <= 1 for m in shares), "an mfu share outside (0, 1]")

    rejected = {}
    fewer = {cells.ANDERSON: ANDERSON_CONTROL_REPEATS, cells.FLAGSHIP_B8: TRAIN_B8_CONTROL_REPEATS}
    for repeats, only in ((100, [c for c in one_card if c not in fewer]),
                          *((n, [c]) for c, n in fewer.items())):
        rejected |= {line["control"]: line["rejected"] for line in
                     _bench_lines(["--controls", "--repeats", str(repeats)], only)
                     if "control" in line}
    want = [n for n in controls.CONTROLS if controls.cell_of(n) in one_card]
    check(sorted(rejected) == sorted(want) and all(rejected.values()),
          f"the benchmark's checks must reject every control: {rejected}")
    print(f"[bench] every control rejected by the cells' checks: {sorted(rejected)}")
    return {c: by["launches"][c]["counts"] for c in one_card}


def bound(shape, bytes_per_px: float, flops_per_px: float) -> dict:
    """The least time for a kernel's work: bytes over the HBM rate, operations
    over the fp32 peak; the larger bounds it."""
    from bench_torch.work import least_ms

    px = float(np.prod(shape))
    return least_ms({"bytes": px * bytes_per_px, "flops": px * flops_per_px})


def phase_new_kernel_times(dev, gen) -> dict:
    """The prox-dual and composite kernels and their plain twins at the
    1080p batch-4 solve's 12 planes of 1080x1920, CUDA events."""
    from admm_deconv_tpu_torch.ops.kernels.prox_kernels import _prox_dual_plain, fused_prox_dual
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _composite_plain,
        fused_admm_stencil_composite,
    )

    shape = (BENCH_SHAPE[0] * BENCH_SHAPE[3],) + BENCH_SHAPE[1:3]
    n = shape[0]
    tau = torch.tensor(LAM / RHO, device=dev)
    arrays = [0.05 * torch.randn(shape, generator=gen, device=dev) for _ in range(4)]
    x = torch.rand(shape, generator=gen, device=dev)
    # Device tensors, as the solver passes them: a Python float would be
    # copied to the card, and wait for it, on every call.
    table = tuple(torch.tensor(t, device=dev) for t in (LAM / RHO, 0.002 / RHO, 1.0))
    tab = torch.stack([t.expand(n) for t in table], dim=1)
    pairs = {"prox_dual_fp32": (lambda: fused_prox_dual(*arrays, tau, mode="aniso"),
                                lambda: _prox_dual_plain(*arrays, tau, "aniso"), 32, 14)}
    for key, dual, b in (("composite_fp32", torch.float32, 32),
                         ("composite_bf16", torch.bfloat16, 18)):
        ux, uy, u2 = (a.to(dual) for a in arrays[:3])
        pairs[key] = (
            lambda ux=ux, uy=uy, u2=u2: fused_admm_stencil_composite(
                x, ux, uy, u2, *table, (0.0, 1.0), "aniso"),
            lambda ux=ux, uy=uy, u2=u2: _composite_plain(x, ux, uy, u2, tab, (0.0, 1.0), "aniso"),
            b, 33)
    times = {}
    for name, (kernel, plain, bytes_px, flops_px) in pairs.items():
        p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kernel, kernel, plain))
        times[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                       "device_ms": device_ms(kernel, 20),
                       **bound(shape, bytes_px, flops_px)}
        t = times[name]
        print(f"[times] {shape} {name}, aniso: kernel {k1:.4f}/{k2:.4f} ms per call, device "
              f"{t['device_ms']:.4f} ms, plain {p1:.4f}/{p2:.4f} ms per call; HBM floor "
              f"{t['bound_ms']:.4f} ms ({bytes_px} B/px), kernel at "
              f"{t['bound_ms'] / min(k1, k2):.1%} of it per call, "
              f"{t['bound_ms'] / t['device_ms']:.1%} on the device")
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recompute-only", action="store_true",
                    help="run only the recompute detector (phase_step_recompute)")
    args = ap.parse_args()

    dev = phase_device()
    import admm_deconv_tpu_torch  # noqa: F401  (fails outside a checkout)

    check("jax" not in sys.modules, "the port imported jax")
    if args.recompute_only:
        out = phase_step_recompute(dev)
        print(f"[summary] nvidia-smi: {nvidia_smi()}")
        print(json.dumps({"ok": True, "recompute": {k: out[k] for k in (
            "steps", "disagreeing", "float64_failed", "agreeing_max", "forwards_differ")}}))
        return
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    phase_build()
    worst = phase_kernels(dev, gen)
    worst_bwd = phase_bwd_kernels(dev, gen)
    worst_prox = phase_prox_dual_kernel(dev, gen)
    worst_composite = phase_composite_kernel(dev, gen)
    worst_halo = phase_halo_kernel(dev, gen)
    worst_spectral = phase_spectral_kernel(dev, gen)
    phase_quality(dev)
    phase_quality_solvers(dev)
    solve_path = phase_main_path(dev, gen)
    frame_times = phase_stencil_times(dev, gen, FRAME_STACK, ("bf16",))
    spectral_times = phase_spectral_times(dev, gen)
    phase_profile(solve_path)
    adaptive = phase_adaptive(dev)
    auto = phase_solve_auto(dev)
    composite = phase_composite(dev)
    new_times = phase_new_kernel_times(dev, gen)
    anderson = phase_anderson(dev)
    tiled = phase_tiled(dev)
    new_times |= phase_halo_times(dev, gen)
    phase_train_parity(dev, args.seed)
    flagship = phase_flagship(dev, args.seed)
    phase_grad_routes(dev)
    phase_step_recompute(dev)
    trainer_ms = phase_trainer(dev, args.seed)
    data = phase_data()
    cli = phase_cli_train(dev, args.seed, data, trainer_ms)
    dp = phase_data_parallel(dev, args.seed)
    multi = phase_multi_world1()
    demo = phase_demo(dev)
    tv = phase_tv_layer(dev)
    times = phase_kernel_times(dev, gen)
    phase_train_profile(flagship, tv)
    implicit = phase_implicit(dev, tv)
    phase_utils(dev)
    bench = phase_bench(dev)
    check("admm_deconv_tpu" not in sys.modules, "the JAX package was imported")

    # Again at the end, beside the numbers: a log's tail keeps it.
    print(f"[summary] nvidia-smi: {nvidia_smi()}")
    print(f"[summary] flagship ms/step: fp32 state {flagship['steps']['float32'][2]:.3f}, "
          f"bf16 state {flagship['steps']['bfloat16'][2]:.3f}; production trainer "
          f"{trainer_ms:.3f} ms/step; TV layer ms/step: " + ", ".join(
              f"{k} {v[2]:.3f}" for k, v in tv.items()))
    print("[summary] seconds to tolerance (check_every=8 kernel / check_every=1 / plain): "
          + "; ".join(f"{k} {v['s_check8_auto']:.4f} / {v['s_check1_auto']:.4f} / "
                      f"{v['s_check8_xla']:.4f} ({v['iterations']} it)"
                      for k, v in adaptive.items())
          + f"; solve_auto tolerance {auto['tolerance']['s']:.4f} s; solve_auto iters=50 it/s: "
          + ", ".join(f"{k} {v['it_s']:.2f}" for k, v in auto.items() if "it_s" in v)
          + "; composite it/s: " + ", ".join(
              f"{k} {v['it_s']:.2f}" for k, v in composite.items() if "it_s" in v))
    print("[summary] tiled T=1 against the single device: " + "; ".join(
        f"{k} {v['it_s']:.2f} / {v['single_it_s']:.2f} it/s" if "it_s" in v else
        f"{k} {v['s']:.4f} / {v['single_s']:.4f} s" for k, v in tiled.items()))
    aa_over = anderson["anderson_1080p_overhead"]
    print(f"[summary] anderson: iterations to match 100 plain at 256^2: "
          f"{anderson['anderson_256']['iters_to_match']}; 1080p 50 it m={ANDERSON_M}: "
          f"{aa_over['it_s']:.2f} it/s beside tv_deconvolve {aa_over['tv_it_s']:.2f}; peak "
          f"{aa_over['peak_bytes'] / 1e9:.3f} GB, history "
          f"{aa_over['history_bytes'] / 1e9:.3f} GB; "
          + "; ".join(f"ttq_1080p {k}: {v['iterations']} it, {v['s']:.4f} s (adaptive "
                      f"{v['adaptive_s']:.4f} s)" for k, v in anderson.items() if "adaptive_s" in v))
    print(f"[summary] data path {data['path']} ({data['feeder_ms']:.3f} ms per batch); train CLI "
          f"epoch {cli['epoch_s']:.3f} s, {cli['fed_ms']:.3f} ms/step fed by the loader against "
          f"{trainer_ms:.3f} on device pairs; data-parallel world 1 {dp['ms']:.3f} ms/step "
          f"(without a group {dp['alone_ms']:.3f}), parameters equal: {dp['equal']}; demo PSNR: "
          + ", ".join(f"{k} {v['psnr']:.4f}" for k, v in demo.items()))
    print(f"[summary] implicit TV-layer step {implicit['ms']:.3f} ms, peak "
          f"{implicit['peak'] / 1e9:.3f} GB; unrolled remat {implicit['unrolled_ms']:.3f} ms, "
          f"peak {implicit['unrolled_peak'] / 1e9:.3f} GB")
    # The training path's launches for the stencil kernels; this slice's
    # main paths (the adaptive ttq_1080p solve, the fp32 composite solve)
    # for the prox-dual and composite kernels.
    launches = flagship["launches"] | {
        "prox_dual": adaptive["ttq_1080p"]["launches"]["prox_dual"],
        "stencil_composite": composite["fp32"]["launches"]["stencil_composite"],
        "stencil_halo": tiled["tiled_tile1_1080p fp32"]["launches"]}
    times |= new_times
    record = {"kernels": [
        {"name": name, "counter": counter, "route": "cuda", "source": f"{CSRC}/{src}.cu",
         "replaces": replaces, "launches": launches[counter], "max_abs_err": err,
         "ms": times[key]["ms"], "device_ms": times[key]["device_ms"],
         "plain_ms": times[key]["plain_ms"],
         "bound_ms": times[key]["bound_ms"], "bound_by": times[key]["bound_by"],
         "library_ms": None}
        for name, counter, src, replaces, err, key in (
            ("fused_admm_stencil", "fused_admm_stencil", "stencil_fwd", f"{TPU_KERNELS}:408",
             worst[torch.float32], "fwd_fp32"),
            ("fused_admm_stencil_mixed", "fused_admm_stencil_mixed", "stencil_fwd",
             f"{TPU_KERNELS}:820", worst[torch.bfloat16], "fwd_bf16"),
            ("stencil_bwd", "stencil_bwd", "stencil_bwd", f"{TPU_KERNELS}:438",
             max(worst_bwd.values()), "bwd_fp32"),
            ("fused_prox_dual", "prox_dual", "prox_dual", f"{TPU_PROX_KERNELS}:71",
             worst_prox, "prox_dual_fp32"),
            ("fused_admm_stencil_composite", "stencil_composite", "stencil_composite",
             f"{TPU_KERNELS}:260", max(worst_composite.values()), "composite_fp32"),
            ("fused_admm_stencil_halo", "stencil_halo", "stencil_halo", f"{TPU_KERNELS}:899",
             max(worst_halo.values()), "halo_fp32"),
        )
    ]}
    # The Anderson and implicit paths: launches of one solve or step, read
    # after each.
    aa8 = anderson[f"anderson(m={ANDERSON_M},k={AA_INTERVAL},early_stop)"]["launches"]
    by_kernel = {k["name"]: k for k in record["kernels"]}
    by_kernel["fused_admm_stencil"]["launches_by_path"] = {
        "anderson ttq_1080p aa_interval=8": aa8["fused_admm_stencil"]}
    by_kernel["fused_prox_dual"]["launches_by_path"] = {
        "anderson 1080p 50 it": aa_over["launches"]["prox_dual"],
        "anderson ttq_1080p aa_interval=8": aa8["prox_dual"],
        "implicit TV-layer step": int(implicit["launches"]["prox_dual"])}
    by_kernel["fused_admm_stencil_halo"]["launches_by_path"] = {
        "tiled anderson 49 it aa_interval=8":
            tiled[f"tiled anderson m={ANDERSON_M} aa_interval={AA_INTERVAL}"]["launches"]}
    # This slice's paths: the train CLI's epoch, the data-parallel steps and
    # the demo's branches, each read just after it ran.
    by_kernel["fused_admm_stencil"]["launches_by_path"] |= {
        "train CLI epoch": cli["launches"]["fused_admm_stencil"],
        f"data-parallel {DP_STEPS} steps": dp["launches"]["fused_admm_stencil"],
        "demo plain": demo["plain"]["launches"]["fused_admm_stencil"]}
    by_kernel["stencil_bwd"]["launches_by_path"] = {
        "train CLI epoch": cli["launches"]["stencil_bwd"],
        f"data-parallel {DP_STEPS} steps": dp["launches"]["stencil_bwd"]}
    demo_stencil = _state_stencil()
    by_kernel["fused_admm_stencil_mixed"]["launches_by_path"] = {
        "demo --bf16-state": demo["bf16_state"]["launches"]["fused_admm_stencil_mixed"]}
    by_kernel[demo_stencil]["launches_by_path"]["demo --auto"] = \
        demo["auto"]["launches"][demo_stencil]
    by_kernel["fused_admm_stencil_composite"]["launches_by_path"] = {
        "demo --l1": demo["l1"]["launches"]["stencil_composite"]}
    # bench_torch's cells, one timed unit each: every kernel a cell launches.
    from bench_torch.cells import KERNELS

    name_of = {k["counter"]: name for name, k in by_kernel.items()}
    for cell, kernels in KERNELS.items():
        if cell not in bench:  # the four-card cell: chip_smoke_multi.py's phase H
            continue
        for counter in kernels:
            by_kernel[name_of[counter]]["launches_by_path"][f"bench_torch {cell}"] = \
                bench[cell][counter]
    # chip_smoke_multi.py at one rank, read from its summary: the tiled fp32
    # solve on the 1080p batch and the data-parallel steps.
    tiled_fp32 = next(r for r in multi["C"] if r.get("solver") == "fp32")
    by_kernel["fused_admm_stencil_halo"]["launches_by_path"][
        f"chip_smoke_multi --world 1 --size cut tiled fp32 solve {tuple(tiled_fp32['shape'])}, "
        f"{tiled_fp32['iters']} it"] = tiled_fp32["launches"][0]
    dp = multi["F"]
    for name, counter in (("fused_admm_stencil", "fused_admm_stencil"),
                          ("stencil_bwd", "stencil_bwd")):
        by_kernel[name]["launches_by_path"][
            f"chip_smoke_multi --world 1 --size cut {DP_STEPS} data-parallel steps, {dp['model']} "
            f"{tuple(dp['crop'])} batch {dp['global_batch']}"] = dp["launches"][0][counter]
    by_kernel["fused_prox_dual"]["launches_by_path"] |= {
        f"demo {k}": demo[k]["launches"]["prox_dual"] for k in ("adaptive", "anderson", "auto")}
    # solve_auto's two branches at the policy's defaults, each read just after
    # its run.
    auto_stencil = _state_stencil()
    by_policy = next(v for k, v in auto.items() if k.startswith("policy"))
    for path, counts in ((f"solve_auto iters={BENCH_ITERS} {BENCH_SHAPE}", by_policy["launches"]),
                         ("solve_auto ttq_1080p tolerance", auto["tolerance"]["launches"])):
        by_kernel[auto_stencil]["launches_by_path"][path] = counts[auto_stencil]
        by_kernel["fused_prox_dual"]["launches_by_path"][path] = counts["prox_dual"]
    for name in ("fused_admm_stencil", "fused_admm_stencil_mixed", "stencil_bwd",
                 "fused_prox_dual", "fused_admm_stencil_composite", "fused_admm_stencil_halo"):
        check(all(v > 0 for v in by_kernel[name]["launches_by_path"].values()),
              f"{name} was not launched on one of its paths: {by_kernel[name]}")
    for name, key in (("stencil_bwd", "bwd_bf16"),
                      ("fused_admm_stencil_composite", "composite_bf16"),
                      ("fused_admm_stencil_halo", "halo_bf16")):
        bf16 = times[key]
        by_kernel[name] |= {"ms_bf16": bf16["ms"], "device_ms_bf16": bf16["device_ms"],
                            "plain_ms_bf16": bf16["plain_ms"], "bound_ms_bf16": bf16["bound_ms"]}
    # Q2-1 at the 1080p cells' 12 planes, and with bf16 duals at the 4K
    # cell's planes.
    by_kernel["fused_admm_stencil"]["by_stack"] = {
        str(BENCH_STACK): times[f"fwd_fp32 {BENCH_STACK}"]}
    by_kernel["fused_admm_stencil_mixed"]["by_stack"] = {
        str(BENCH_STACK): times[f"fwd_bf16 {BENCH_STACK}"], str(FRAME_STACK): frame_times["bf16"]}
    # Q2-1 and Q2-2 at the flagship steps' bank stacks, iso with a tau a
    # plane, as the steps launch them (fp32 and bf16 duals).
    for name, kind in (("fused_admm_stencil", "fwd_fp32"), ("fused_admm_stencil_mixed", "fwd_bf16"),
                       ("stencil_bwd", "bwd_fp32"), ("stencil_bwd", "bwd_bf16")):
        stacks = by_kernel[name].setdefault("by_stack", {})
        for shape in FLAGSHIP_STACKS:
            stacks[f"{shape} iso {kind[4:]}"] = times[f"{kind} {shape} iso"]
    # Q2-4 at the four-card cell's tile, and on the device alone at its other
    # timed stacks (fp32, bf16).
    by_kernel["fused_admm_stencil_halo"]["by_stack"] = {
        str(TILE4_STACK): times[f"halo_fp32 {TILE4_STACK}"]}
    by_kernel["fused_admm_stencil_halo"]["device_ms_by_stack"] = {
        str(shape): [times[f"halo_{d} {shape}"]["device_ms"] for d in ("fp32", "bf16")]
        for shape in HALO_TIME_SHAPES[1:]}
    # The complex-rhs pass: its launches on the main path (the 1080p batch-4
    # solves, both states), its times at the solve's 12 planes, and at the
    # other timed stacks.
    rhs_key, *rhs_more = spectral_times
    rhs = spectral_times[rhs_key]
    check(solve_path["launches"]["spectral_rhs"] > 0, "spectral_rhs was not launched on the "
          "main path")
    record["kernels"].append({
        "name": "spectral_rhs", "counter": "spectral_rhs.launches", "route": "cuda",
        "source": f"{CSRC}/spectral_rhs.cu", "replaces": TPU_X_UPDATE,
        "launches": solve_path["launches"]["spectral_rhs"], "max_abs_err": worst_spectral,
        "ms": rhs["ms"], "device_ms": rhs["device_ms"], "plain_ms": rhs["plain_ms"],
        "plain_device_ms": rhs["plain_device_ms"], "bound_ms": rhs["bound_ms"],
        "bound_by": rhs["bound_by"], "library_ms": None, "stack": rhs_key,
        "by_stack": {key: spectral_times[key] for key in rhs_more}})
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
