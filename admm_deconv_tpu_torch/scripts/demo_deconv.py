"""End-to-end solver demo — the reference's ``src/tests/admm_deconv_test.jl``
scenario: blur test images with a 7x7 horizontal motion PSF, deconvolve with
lam=0.0041, rho=0.021, anisotropic TV, 100 iterations, save before/after
PNGs and print SSIM/PSNR deltas.

Counterpart of ``scripts/demo_deconv.py``: the same six branches (plain,
``--adaptive``, ``--l1``, ``--anderson`` with ``--aa-interval``, ``--auto``,
``--bf16-state``), argument errors and printed lines.  ``--device`` (default
``cuda``) says where the solve runs, as ``JAX_PLATFORMS`` does for the JAX
script; the default never falls back to the CPU.  :func:`run` is the solve
alone (numpy in, numpy out), :func:`main` loads, saves and prints.

Usage::

    python -m admm_deconv_tpu_torch.scripts.demo_deconv [--src DIR] [--out DIR] \
        [--adaptive | --l1 LAM_L1 | --anderson | --auto] [--bf16-state] [--device cpu]
"""

import argparse
import glob
import os
import time

import numpy as np
import torch

import admm_deconv_tpu_torch as adt
from admm_deconv_tpu_torch.utils.arrays import as_tensor, default_device


def synthetic_images(n=3, size=256, seed=0):
    """Edge-rich piecewise-constant RGB frames in [0, 1]."""
    rng = np.random.default_rng(seed)
    imgs = []
    for _ in range(n):
        img = np.full((size, size, 3), 0.2, np.float32)
        for _ in range(12):
            r0, c0 = rng.integers(0, size // 2, 2)
            r1, c1 = rng.integers(size // 2, size, 2)
            img[r0:r1, c0:c1] += rng.random(3).astype(np.float32) * 0.25
        imgs.append(np.clip(img, 0, 1))
    return imgs


def motion_psf(k=7):
    psf = np.zeros((k, k), np.float32)
    psf[k // 2, :] = 1.0 / k
    return psf


def blur_circular(img, psf):
    """Centered circular convolution (the blur model the solver inverts)."""
    kh, kw = psf.shape
    ch, cw = (kh - 1) // 2, (kw - 1) // 2
    out = np.zeros_like(img)
    for a in range(kh):
        for b in range(kw):
            if psf[a, b]:
                out += psf[a, b] * np.roll(img, (a - ch, b - cw), axis=(0, 1))
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", help="directory of input images (default: synthetic)")
    p.add_argument("--out", default="demo_out", help="output directory")
    p.add_argument("--lam", type=float, default=0.0041)
    p.add_argument("--rho", type=float, default=0.021)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--iso", action="store_true", help="isotropic TV")
    p.add_argument("--adaptive", action="store_true", help="adaptive rho + early stop")
    p.add_argument(
        "--fft-mode", default="auto",
        help='x-update FFT mode name; every mode computes torch.fft (cuFFT on the card)',
    )
    p.add_argument(
        "--prox-impl", default="auto",
        help='"auto" (default) = the fused CUDA kernels on the card, their plain '
        "twins on the CPU; \"xla\" = the plain composition",
    )
    p.add_argument(
        "--l1", type=float, default=0.0, metavar="LAM_L1",
        help="add an L1 sparsity prior via the composite solver "
        "(TV + L1 + [0,1] box)",
    )
    p.add_argument(
        "--anderson", action="store_true",
        help="Anderson-accelerated solve (fewer iterations to a given "
        "residual; fixed rho)",
    )
    p.add_argument(
        "--aa-interval", type=int, default=1, metavar="K",
        help="with --anderson: extrapolate every K iterations (one history "
        "pass per K)",
    )
    p.add_argument(
        "--auto", action="store_true",
        help="let solve_auto pick the solver for the request (adaptive rho + "
        "block checking + the policy's state dtype)",
    )
    p.add_argument(
        "--bf16-state", dest="bf16_state", action="store_true",
        help="store the loop carry in bf16 (fp32 arithmetic in the kernel; "
        "plain and --adaptive solvers only)",
    )
    p.add_argument(
        "--device", default="cuda",
        help='where the solve runs: "cuda" (default, the card) or "cpu"',
    )
    return p


def check_args(p: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The JAX script's argument errors, with its texts."""
    if sum([args.adaptive, args.anderson, args.l1 > 0, args.auto]) > 1:
        p.error("--adaptive / --anderson / --l1 / --auto are mutually exclusive")
    if args.bf16_state and (args.anderson or args.l1 > 0 or args.auto):
        # --auto decides bf16 state on its own; the Anderson/composite
        # branches have no state_dtype surface — say so instead of silently
        # dropping the flag.
        p.error(
            "--bf16-state applies to the plain and --adaptive solvers only "
            "(--auto chooses it automatically; --anderson/--l1 do not "
            "support it)"
        )


def run(args: argparse.Namespace, imgs) -> tuple[np.ndarray, dict]:
    """Blur ``imgs`` (HWC float32 frames in [0, 1]), solve on ``args.device``
    with the branch ``args`` names, clip to [0, 1] and measure.

    Returns ``(restored, metrics)``: the ``(B, H, W, C)`` restored frames as
    numpy, and ``{"seconds", "extra", "blurred_ssim", "restored_ssim",
    "blurred_psnr", "restored_psnr", "mean_ssim"}`` with per-image lists.
    """
    device = default_device() if args.device == "cuda" else torch.device(args.device)
    psf_np = motion_psf(7)
    batch = as_tensor(np.stack([blur_circular(img, psf_np) for img in imgs]), device)
    ref = as_tensor(np.stack(imgs), device)
    psf = as_tensor(psf_np, device)
    prox = "iso" if args.iso else "aniso"
    sdt = "bfloat16" if args.bf16_state else None

    t0 = time.time()
    if args.auto:
        restored, diag = adt.solve_auto(
            batch, psf=psf, lam=args.lam, rho=args.rho,
            max_iters=args.iters * 4, prox=prox,
        )
        extra = f" (solve_auto: {int(diag.iterations)} iters)"
    elif args.adaptive:
        # bf16 state needs the fast mid-loop (check_every > 1); round the
        # cap up so the block length divides it.
        ck = 8 if sdt else 1
        mi = ((args.iters * 3 + ck - 1) // ck) * ck
        restored, diag = adt.tv_deconvolve_adaptive(
            batch, psf=psf, lam=args.lam, rho=args.rho,
            max_iters=mi, prox=prox, fft_mode=args.fft_mode,
            check_every=ck, state_dtype=sdt,
        )
        extra = f" (adaptive: {int(diag.iterations)} iters, rho[0]={float(diag.rho[0]):.4f})"
    elif args.l1 > 0:
        restored = adt.composite_tv_deconvolve(
            batch, psf=psf, lam_tv=args.lam, lam_l1=args.l1,
            rho1=args.rho, rho2=args.rho, iters=args.iters, prox=prox,
            x_bounds=(0.0, 1.0), fft_mode=args.fft_mode,
            prox_impl=args.prox_impl,
        )
        extra = f" (composite TV+L1, lam_l1={args.l1})"
    elif args.anderson:
        it = args.iters
        if (it - 1) % args.aa_interval:
            it += args.aa_interval - (it - 1) % args.aa_interval
        restored, diag = adt.tv_deconvolve_anderson(
            batch, psf=psf, lam=args.lam, rho=args.rho,
            iters=it, prox=prox, aa_interval=args.aa_interval,
            fft_mode=args.fft_mode, prox_impl=args.prox_impl,
        )
        extra = f" (anderson: r_norm={float(torch.max(diag.r_norm)):.5f})"
    else:
        restored = adt.tv_deconvolve(
            batch, psf=psf, lam=args.lam, rho=args.rho,
            iters=args.iters, prox=prox, fft_mode=args.fft_mode,
            prox_impl=args.prox_impl, state_dtype=sdt,
        )
        extra = ""
    restored = torch.clamp(restored, 0.0, 1.0)
    if restored.device.type == "cuda":
        torch.cuda.synchronize(restored.device)
    seconds = time.time() - t0

    metrics = {"seconds": seconds, "extra": extra}
    for name, fn in (("ssim", adt.ssim), ("psnr", adt.peak_snr)):
        for which, x in (("blurred", batch), ("restored", restored)):
            metrics[f"{which}_{name}"] = [float(fn(x[i:i + 1], ref[i:i + 1]))
                                          for i in range(len(imgs))]
    metrics["mean_ssim"] = float(adt.ssim(restored, ref))
    return restored.cpu().numpy(), metrics


def main(argv=None):
    from admm_deconv_tpu_torch.data import load_image, save_image

    p = parser()
    args = p.parse_args(argv)
    check_args(p, args)

    if args.src:
        paths = sorted(glob.glob(os.path.join(args.src, "*")))[:8]
        imgs = [load_image(path) for path in paths]
    else:
        imgs = synthetic_images()
    os.makedirs(args.out, exist_ok=True)

    psf = motion_psf(7)
    for i, img in enumerate(imgs):
        save_image(os.path.join(args.out, f"orig{i + 1}.png"), img)
        save_image(os.path.join(args.out, f"blurred{i + 1}.png"), blur_circular(img, psf))

    restored, m = run(args, imgs)
    for i in range(restored.shape[0]):
        save_image(os.path.join(args.out, f"restored{i + 1}.png"), restored[i])

    print(f"solver wall clock (incl. compile): {m['seconds']:.2f}s{m['extra']}")
    for i in range(restored.shape[0]):
        print(
            f"image {i + 1}: SSIM {m['blurred_ssim'][i]:.4f} -> "
            f"{m['restored_ssim'][i]:.4f}   PSNR {m['blurred_psnr'][i]:.2f} -> "
            f"{m['restored_psnr'][i]:.2f} dB"
        )
    print(f"mean restored SSIM: {m['mean_ssim']:.4f}")
    print("ADMM demo finished with no errors!")


if __name__ == "__main__":
    main()
