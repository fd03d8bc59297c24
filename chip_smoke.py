#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``admm_deconv_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure raises and exits non-zero:

1. device: a CUDA device must exist (otherwise exit 2 and print no result);
   prints ``nvidia-smi``'s name and power limit of the card;
2. build: compiles the port's CUDA kernels from ``admm_deconv_tpu_torch/csrc``,
   one nvcc per source, all at once;
3. kernels: the forward stencil against its plain torch version on the
   card, every prox mode, fp32 and bf16 duals, scalar and per-plane tau, at
   the TPU kernel's 1-, 2- and 3-row-block shapes, the bench shape and every
   training path's shape; a gradient on the card goes through the backward
   kernel; then the backward kernel against ``_bwd_plain`` at the training
   shapes (also with the outputs nobody asked for skipped), and the
   autograd Function against autograd through the plain forward;
4. quality: the 256^2 blocks scenario (3 RGB images, 7x7 motion PSF,
   100 iterations) through ``tv_deconvolve``; PSNR floors, agreement with
   the same solve on the CPU, and one kernel launch per loop iteration;
5. solve path: ``tv_deconvolve`` at 1080p RGB batch 4, 50 iterations, fp32
   and bf16 state, through the kernel (launches counted) and through the
   plain composition; iterations/s, then the stencil alone in ms per call;
6. profile: torch.profiler's device time by kernel for one solve per state
   dtype, and the device's idle share under the profiler;
7. train parity: one gmsd + AdaBelief step of the same seeded AdmmDenoiser
   on the card and on the CPU: loss, gradients and updated parameters;
8. training path: ``bench.py``'s flagship step (AdmmDenoiser, 2x112^2x3,
   gmsd, AdaBelief lr 1e-4), fp32 and bf16 state, ms/step and kernel
   launches per step;
9. production trainer: ``Trainer.fit`` for one epoch at
   ``configs/train_cfg.json`` (batch 2, 256^2 crops) on seeded blocks +
   motion blur + noise pairs, CSV history, checkpoint and resume, ms/step;
10. TV layer: the 1080p ``ADMMDeconv`` train step (2x1080x1920x3, 20
    iterations, remat, Adam, mse) through the kernels (fp32, bf16 state)
    and through the plain composition, ms/step;
11. kernel times: the three kernels and their plain versions at the TV
    layer's 6 planes of 1080x1920;
12. profile: device time by kernel and idle share for one flagship step and
    one TV-layer step.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LAM, RHO = 0.0041, 0.021
BENCH_SHAPE, BENCH_ITERS, REPEATS = (4, 1080, 1920, 3), 50, 4
# The training paths' plane stacks: the bench flagship's and the production
# crop's denoiser banks (5 branches x batch 2 x RGB), an odd shape, and the
# 1080p TV-layer step (batch 2 x RGB).  Both kernels are checked at these.
BWD_SHAPES = [(30, 112, 112), (30, 256, 256), (3, 37, 101), (6, 1080, 1920)]
# The forward kernel's further shapes: the TPU kernel's 1-, 2- and 3-row-block
# shapes and the 1080p batch-4 solve.
KERNEL_SHAPES = [(2, 24, 128), (1, 256, 2048), (1, 384, 2048), (12, 1080, 1920), *BWD_SHAPES]
KERNEL_SOURCES = ("stencil_fwd", "stencil_bwd")
CSRC = "admm_deconv_tpu_torch/csrc"
TPU_KERNELS = "admm_deconv_tpu/ops/pallas/stencil_kernels.py"
# bench.py's flagship step and bench_suite.py's 1080p TV-layer step.
FLAGSHIP_SHAPE, FLAGSHIP_REPEATS, FLAGSHIP_LAUNCHES = (2, 112, 112, 3), 8, 49
TV_SHAPE, TV_ITERS, TV_REPEATS = (2, 1080, 1920, 3), 20, 4
TRAIN_CFG = "configs/train_cfg.json"
TRAINER_BATCHES = (4, 2)  # train, eval batches of the production-trainer epoch


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

    from admm_deconv_tpu_torch.ops.kernels import _build, stencil_kernels

    t0 = time.perf_counter()
    # One nvcc per source, all started together: each thread waits on its own.
    loaders = (stencil_kernels._kernel_fn, stencil_kernels._bwd_kernel_fn)
    with ThreadPoolExecutor(len(loaders)) as pool:
        for future in [pool.submit(fn) for fn in loaders]:
            future.result()
    print(f"[build] {', '.join(KERNEL_SOURCES)} built/loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in map(_build.library_path, KERNEL_SOURCES):
        log = lib.with_name(lib.name + ".log")
        text = log.read_text() if log.is_file() else ""
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", text)})
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", text)))
        print(f"[build] {lib.name.split('-')[0]} ptxas: {len(regs) and regs[0]}-"
              f"{len(regs) and regs[-1]} registers per instantiation, spill stores {spills}")


def phase_kernels(dev, gen) -> dict:
    """Each kernel against ``_stencil_plain`` on the same CUDA inputs."""
    from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _stencil_plain,
        fused_admm_stencil,
        fused_admm_stencil_bwd,
        fused_admm_stencil_mixed,
    )

    print("[kernels] tolerance: fp32 |kernel-plain| <= 1e-5 + 1e-5*|plain|; "
          "bf16 equal or one bf16 ulp apart")
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
                        if dual == torch.float32:
                            ok = bool(((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all())
                        else:
                            ok = bf16_ulp_ok(g, w)
                        check(ok, f"kernel vs plain {shape} {mode} {dual} {tau_kind}: {err}")
                    worst[dual] = max(worst[dual], err)
                    print(f"[kernels] {str(shape):16s} {mode:5s} {str(dual)[6:]:8s} "
                          f"tau={tau_kind:6s} max|kernel-plain|={err:.3e}")
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


def _taub_abs_sum(x, ux, uy, tau, gq, gux, guy, mode):
    """Per-plane sum of |tau-cotangent terms|: the scale of the tau check."""
    from admm_deconv_tpu_torch.ops.diff import grad2d
    from admm_deconv_tpu_torch.ops.kernels.prox_math import prox_vjp

    t = tau if tau.ndim == 0 else tau[:, None, None]
    dxx, dxy = grad2d(x)
    wbx, wby = grad2d(gq.float())
    _, _, terms = prox_vjp(mode, dxx + ux.float(), dxy + uy.float(), t,
                           2.0 * wbx - gux.float(), 2.0 * wby - guy.float())
    return terms.abs().sum(dim=(-2, -1))


def phase_bwd_kernels(dev, gen) -> dict:
    """The backward kernel against ``_bwd_plain`` on the same CUDA inputs,
    then the autograd Function against autograd through ``_stencil_plain``."""
    from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _bwd_plain,
        _stencil_bwd_cuda,
        _stencil_plain,
        fused_admm_stencil,
        fused_admm_stencil_bwd,
    )

    def compare(got, want, scale, dual, what) -> float:
        """Each output the kernel wrote against the plain one; None where skipped."""
        err = 0.0
        for k, (g, w) in enumerate(zip(got[:3], want[:3])):
            if g is None:
                continue
            want_dtype = torch.float32 if k == 0 else dual
            check(g.dtype == want_dtype and g.shape == w.shape, f"bwd {what} output {k} layout")
            check(bool(torch.isfinite(g).all()), f"bwd {what} non-finite")
            err = max(err, float((g.float() - w.float()).abs().max()))
            if want_dtype == torch.float32:
                ok = bool(((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all())
            else:
                ok = bf16_ulp_ok(g, w)
            check(ok, f"bwd vs plain {what} out {k}: {err}")
        if got[3] is not None:
            check(got[3].shape == want[3].shape, f"taub shape {tuple(got[3].shape)}")
            terr = (got[3] - want[3]).abs()
            check(bool((terr <= 1e-5 * scale).all()), f"taub {what}: {float(terr.max())}")
        return err

    print("[bwd] tolerance: xbar and fp32 ubar |kernel-plain| <= 1e-5 + 1e-5*|plain|; "
          "bf16 ubar equal or one bf16 ulp apart; taub |kernel-plain| <= 1e-5 * "
          "sum|terms| per plane (the sums run in another order)")
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
                    got = fused_admm_stencil_bwd(*args)
                    want = _bwd_plain(*args)
                    scale = _taub_abs_sum(*args)
                    torch.cuda.synchronize()
                    check(all(g is not None for g in got), f"bwd {what}: an output is missing")
                    check(got[3].shape == (n,), f"taub shape {tuple(got[3].shape)}")
                    err = compare(got, want, scale, dual, what)
                    worst[dual] = max(worst[dual], err)
                    terr = (got[3] - want[3]).abs()
                    print(f"[bwd] {str(shape):16s} {mode:5s} {str(dual)[6:]:8s} "
                          f"tau={tau_kind:6s} max|kernel-plain|={err:.3e} "
                          f"taub rel={float((terr / scale.clamp_min(1e-30)).max()):.2e}")
            # The kernel's skip branches (null output pointers), as the
            # autograd Function takes them when some input needs no gradient.
            args = (x, ux, uy, tau_v, gq, gux, guy, "iso")
            want = _bwd_plain(*args)
            scale = _taub_abs_sum(*args)
            for need in ((False, True, True), (True, False, False), (False, False, True)):
                got = _stencil_bwd_cuda(*args, *need)
                torch.cuda.synchronize()
                check([g is not None for g in (got[0], got[1], got[2], got[3])]
                      == [need[0], need[1], need[1], need[2]],
                      f"bwd {shape} skip {need}: outputs {[g is None for g in got]}")
                worst[dual] = max(worst[dual], compare(got, want, scale, dual,
                                                       f"{shape} iso {dual} skip {need}"))
            print(f"[bwd] {str(shape):16s} iso   {str(dual)[6:]:8s} need (x, u, tau) in "
                  f"{{(F,T,T), (T,F,F), (F,F,T)}}: written outputs equal the plain ones, "
                  f"skipped ones None")

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
    for sdt, wrapper, floor in ((None, fused_admm_stencil, 54.99),
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


def phase_main_path(dev, gen) -> dict:
    """Time the 1080p batch-4 solve: kernel path (launches counted), plain path."""
    from admm_deconv_tpu_torch import tv_deconvolve
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        fused_admm_stencil,
        fused_admm_stencil_mixed,
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
    rate32, x32 = iters_per_s()
    rate16, x16 = iters_per_s(state_dtype="bfloat16")
    counts = read_counts()
    launches = {"fp32": counts["fused_admm_stencil"], "bf16": counts["fused_admm_stencil_mixed"]}
    want = (REPEATS + 1) * (BENCH_ITERS - 1)
    check(counts == {"fused_admm_stencil": want, "fused_admm_stencil_mixed": want,
                     "stencil_bwd": 0}, f"main-path launches {counts}, want {want} forward")

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


def phase_stencil_times(dev, gen) -> dict:
    """The stencil alone at the bench shape, kernel vs plain, ms per call."""
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _stencil_plain,
        fused_admm_stencil,
        fused_admm_stencil_mixed,
    )

    shape = (BENCH_SHAPE[0] * BENCH_SHAPE[3],) + BENCH_SHAPE[1:3]
    x = torch.rand(shape, generator=gen, device=dev)
    tau = torch.tensor(LAM / RHO, device=dev)
    times = {}
    for name, dual, wrapper in (("fp32", torch.float32, fused_admm_stencil),
                                ("bf16", torch.bfloat16, fused_admm_stencil_mixed)):
        ux = (0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
        uy = (0.05 * torch.randn(shape, generator=gen, device=dev)).to(dual)
        plain = lambda: _stencil_plain(x, ux, uy, tau, "aniso")  # noqa: E731
        kernel = lambda: wrapper(x, ux, uy, tau, mode="aniso")  # noqa: E731
        # plain, kernel, kernel, plain: one card, in turns.
        p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kernel, kernel, plain))
        times[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2)}
        print(f"[stencil] {shape} {name} duals, aniso: kernel {k1:.4f}/{k2:.4f} ms, "
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
    from torch.profiler import ProfilerActivity, profile

    for sdt in (None, "bfloat16"):
        main["solve"](main["y"], state_dtype=sdt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            main["solve"](main["y"] + 0.5, state_dtype=sdt)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = device_events(prof, f"state={sdt or 'float32'}")
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"[profile] state={sdt or 'float32'}: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
                  f"{e.key[:90]}")


def _counters() -> dict:
    from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk

    return {"fused_admm_stencil": sk.fused_admm_stencil,
            "fused_admm_stencil_mixed": sk.fused_admm_stencil_mixed,
            "stencil_bwd": sk.fused_admm_stencil_bwd}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


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

    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAIN_CFG))
    n_train, n_eval = TRAINER_BATCHES
    train = training_pairs(seed, n_train, cfg.batch_size, cfg.im_shape)
    evals = training_pairs(seed + 1, n_eval, cfg.batch_size, cfg.im_shape)

    def make(model_seed):
        model = build_model(cfg.model, dataclasses.asdict(cfg))
        init_parameters(model, torch.Generator().manual_seed(model_seed))
        trainer = Trainer(model.to(dev), cfg)
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
        want = {"fused_admm_stencil": FLAGSHIP_LAUNCHES * (n_train + n_eval),
                "fused_admm_stencil_mixed": 0, "stencil_bwd": FLAGSHIP_LAUNCHES * n_train}
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
    """The three kernels and their plain versions at the TV layer's planes."""
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
        pairs = {
            f"fwd_{key}": (lambda: fwd(x, ux, uy, tau, mode="aniso"),
                           lambda: _stencil_plain(x, ux, uy, tau, "aniso")),
            f"bwd_{key}": (lambda: fused_admm_stencil_bwd(x, ux, uy, tau, gq, gux, guy, "aniso"),
                           lambda: _bwd_plain(x, ux, uy, tau, gq, gux, guy, "aniso")),
        }
        for name, (kernel, plain) in pairs.items():
            p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kernel, kernel, plain))
            times[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2)}
            print(f"[times] {shape} {name}, aniso: kernel {k1:.4f}/{k2:.4f} ms, "
                  f"plain {p1:.4f}/{p2:.4f} ms per call")
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = phase_device()
    import admm_deconv_tpu_torch  # noqa: F401  (fails outside a checkout)

    check("jax" not in sys.modules, "the port imported jax")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    phase_build()
    worst = phase_kernels(dev, gen)
    worst_bwd = phase_bwd_kernels(dev, gen)
    phase_quality(dev)
    solve_path = phase_main_path(dev, gen)
    phase_stencil_times(dev, gen)
    phase_profile(solve_path)
    phase_train_parity(dev, args.seed)
    flagship = phase_flagship(dev, args.seed)
    trainer_ms = phase_trainer(dev, args.seed)
    tv = phase_tv_layer(dev)
    times = phase_kernel_times(dev, gen)
    phase_train_profile(flagship, tv)
    check("admm_deconv_tpu" not in sys.modules, "the JAX package was imported")

    # Again at the end, beside the numbers: a log's tail keeps it.
    print(f"[summary] nvidia-smi: {nvidia_smi()}")
    print(f"[summary] flagship ms/step: fp32 state {flagship['steps']['float32'][2]:.3f}, "
          f"bf16 state {flagship['steps']['bfloat16'][2]:.3f}; production trainer "
          f"{trainer_ms:.3f} ms/step; TV layer ms/step: " + ", ".join(
              f"{k} {v[2]:.3f}" for k, v in tv.items()))
    launches = flagship["launches"]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{CSRC}/{src}.cu",
         "replaces": f"{TPU_KERNELS}:{line}", "launches": launches[name], "max_abs_err": err,
         "ms": times[key]["ms"], "plain_ms": times[key]["plain_ms"]}
        for name, src, line, err, key in (
            ("fused_admm_stencil", "stencil_fwd", 408, worst[torch.float32], "fwd_fp32"),
            ("fused_admm_stencil_mixed", "stencil_fwd", 820, worst[torch.bfloat16], "fwd_bf16"),
            ("stencil_bwd", "stencil_bwd", 438, max(worst_bwd.values()), "bwd_fp32"),
        )
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
