"""Dataset CLI — the reference's ``src/make_dataset.jl`` without its
hardcoded Windows paths: AWGN-degraded ``x/`` + clean-copy ``y/`` pairs from
any directory of clean images.

Counterpart of ``scripts/make_dataset.py``: the same arguments, errors,
printed line and files (the same seed gives the same bytes).

Usage::

    python -m admm_deconv_tpu_torch.scripts.make_dataset --src /data/clean \
        --dest /data/awgn_25_25 --min-sigma 25 --max-sigma 25

One-command dual-split build (the reference's ``add_gopro``,
``make_dataset.jl:54-96``, builds train+test in one run)::

    python -m admm_deconv_tpu_torch.scripts.make_dataset \
        --train-src /data/clean/train --test-src /data/clean/test --dest /data/dsets
"""

import argparse

from admm_deconv_tpu_torch.data import generate_awgn_dataset, generate_awgn_splits


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", help="directory of clean images (single split)")
    p.add_argument("--train-src", help="clean train images (dual-split mode)")
    p.add_argument("--test-src", help="clean test images (dual-split mode)")
    p.add_argument("--dest", required=True, help="output dataset directory")
    p.add_argument("--min-sigma", type=float, default=25.0)
    p.add_argument("--max-sigma", type=float, default=25.0)
    p.add_argument("--extension", default=".png")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.train_src or args.test_src:
        if not (args.train_src and args.test_src):
            p.error("--train-src and --test-src must be given together")
        counts = generate_awgn_splits(
            args.train_src, args.test_src, args.dest,
            args.min_sigma, args.max_sigma, args.extension, args.seed,
        )
        print(f"wrote {counts['train']} train + {counts['test']} test pairs under {args.dest}")
        return
    if not args.src:
        p.error("--src is required (or use --train-src/--test-src)")
    n = generate_awgn_dataset(
        args.src, args.dest, args.min_sigma, args.max_sigma, args.extension, args.seed
    )
    print(f"wrote {n} pairs to {args.dest}/x and {args.dest}/y")


if __name__ == "__main__":
    main()
