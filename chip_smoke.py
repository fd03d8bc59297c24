#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``admm_deconv_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure raises and exits non-zero:

1. device: a CUDA device must exist (otherwise exit 2 and print no result);
   prints ``nvidia-smi``'s name and power limit of the card;
2. build: compiles the port's CUDA kernels from ``admm_deconv_tpu_torch/csrc``;
3. kernels: each kernel against its plain torch version on the card, every
   prox mode, fp32 and bf16 duals, scalar and per-plane tau, at the TPU
   kernel's 1-, 2- and 3-row-block shapes, an odd shape and the bench shape;
4. quality: the 256^2 blocks scenario (3 RGB images, 7x7 motion PSF,
   100 iterations) through ``tv_deconvolve``; PSNR floors, agreement with
   the same solve on the CPU, and one kernel launch per loop iteration;
5. main path: ``tv_deconvolve`` at 1080p RGB batch 4, 50 iterations, fp32
   and bf16 state, through the kernel (launches counted) and through the
   plain composition; iterations/s, then the stencil alone in ms per call;
6. profile: torch.profiler's device time by kernel for one main-path solve
   per state dtype, and the device's idle share under the profiler.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LAM, RHO = 0.0041, 0.021
BENCH_SHAPE, BENCH_ITERS, REPEATS = (4, 1080, 1920, 3), 50, 4
KERNEL_SHAPES = [(2, 24, 128), (1, 256, 2048), (1, 384, 2048), (3, 37, 101), (12, 1080, 1920)]
SOURCE = "admm_deconv_tpu_torch/csrc/stencil_fwd.cu"
TPU_KERNELS = "admm_deconv_tpu/ops/pallas/stencil_kernels.py"


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


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def phase_build() -> None:
    from admm_deconv_tpu_torch.ops.kernels import _build, stencil_kernels

    t0 = time.perf_counter()
    lib = _build.build("stencil_fwd")
    stencil_kernels._kernel_fn()
    print(f"[build] stencil_fwd built/loaded in {time.perf_counter() - t0:.2f} s: {lib.name}")
    log = lib.with_name(lib.name + ".log")
    for line in log.read_text().splitlines() if log.is_file() else ():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def phase_kernels(dev, gen) -> dict:
    """Each kernel against ``_stencil_plain`` on the same CUDA inputs."""
    from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES
    from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
        _stencil_plain,
        fused_admm_stencil,
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
    x = torch.zeros((1, 8, 8), device=dev, requires_grad=True)
    try:
        fused_admm_stencil(x, x.detach(), x.detach(), 0.1)
    except NotImplementedError:
        print("[kernels] a gradient request on the card raises NotImplementedError")
    else:
        raise RuntimeError("check failed: the kernel accepted a gradient request")
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

    fused_admm_stencil.launches = 0
    fused_admm_stencil_mixed.launches = 0
    rate32, x32 = iters_per_s()
    rate16, x16 = iters_per_s(state_dtype="bfloat16")
    launches = {"fp32": fused_admm_stencil.launches, "bf16": fused_admm_stencil_mixed.launches}
    want = (REPEATS + 1) * (BENCH_ITERS - 1)
    check(launches == {"fp32": want, "bf16": want}, f"main-path launches {launches} != {want}")

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


def phase_profile(main: dict) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for sdt in (None, "bfloat16"):
        main["solve"](main["y"], state_dtype=sdt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            main["solve"](main["y"] + 0.5, state_dtype=sdt)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"[profile] state={sdt or 'float32'}: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
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
    phase_quality(dev)
    main_path = phase_main_path(dev, gen)
    times = phase_stencil_times(dev, gen)
    phase_profile(main_path)
    check("admm_deconv_tpu" not in sys.modules, "the JAX package was imported")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": f"{TPU_KERNELS}:{line}",
         "launches": main_path["launches"][key], "max_abs_err": worst[dual],
         "ms": times[key]["ms"], "plain_ms": times[key]["plain_ms"]}
        for name, key, dual, line in (
            ("fused_admm_stencil", "fp32", torch.float32, 408),
            ("fused_admm_stencil_mixed", "bf16", torch.bfloat16, 820),
        )
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
