"""Synthetic dataset generation: AWGN-degraded copies of clean corpora.

Counterpart of ``admm_deconv_tpu/data/dataset.py``, a copy: the same seeds
give the same noise and the same files.

Capability parity with the reference's ``src/make_dataset.jl``: per-image
noise std drawn uniformly from [min_sigma, max_sigma] at 255 scale, added to
the clean target, clamped (``make_dataset.jl:15-24``), written to an ``x/``
dir alongside copied clean ``y/`` targets (``:54-96``) — without the
reference's hardcoded Windows paths.
"""

from __future__ import annotations

import glob as globlib
import os
import shutil

import numpy as np

from admm_deconv_tpu_torch.data.imageio import load_image, save_image


def add_awgn(
    img: np.ndarray,
    rng: np.random.Generator,
    min_sigma: float = 0.0,
    max_sigma: float = 50.0,
    max_val: float = 255.0,
) -> np.ndarray:
    """Add white Gaussian noise with a per-image std drawn from
    [min_sigma, max_sigma] (at ``max_val`` scale), clamped to [0, 1]."""
    sigma = float(rng.uniform(min_sigma, max_sigma))
    noisy = img * max_val + sigma * rng.standard_normal(img.shape)
    return np.clip(noisy / max_val, 0.0, 1.0).astype(np.float32)


def add_poisson_gaussian(
    img: np.ndarray,
    rng: np.random.Generator,
    peak: float = 255.0,
    sigma: float = 10.0,
    max_val: float = 255.0,
) -> np.ndarray:
    """Poisson-Gaussian degradation (BASELINE config 3's noise model; no
    reference counterpart): shot noise at ``peak`` photons for a unit-signal
    pixel plus AWGN of std ``sigma`` at ``max_val`` scale, clamped."""
    shot = rng.poisson(np.clip(img, 0.0, 1.0) * peak).astype(np.float64) / peak
    noisy = shot * max_val + sigma * rng.standard_normal(img.shape)
    return np.clip(noisy / max_val, 0.0, 1.0).astype(np.float32)


def generate_awgn_dataset(
    src_dir: str,
    dest_dir: str,
    min_sigma: float = 25.0,
    max_sigma: float = 25.0,
    extension: str = ".png",
    seed: int = 0,
) -> int:
    """Build an ``x/`` (noisy) + ``y/`` (clean copy) paired dataset from the
    clean images under ``src_dir``.  Returns the number of pairs written."""
    rng = np.random.default_rng(seed)
    x_dest = os.path.join(dest_dir, "x")
    y_dest = os.path.join(dest_dir, "y")
    os.makedirs(x_dest, exist_ok=True)
    os.makedirs(y_dest, exist_ok=True)

    paths = sorted(globlib.glob(os.path.join(src_dir, "*" + extension)))
    for idx, path in enumerate(paths):
        img = load_image(path)
        noisy = add_awgn(img, rng, min_sigma, max_sigma)
        name = f"{os.path.splitext(os.path.basename(path))[0]}_{idx}{extension}"
        save_image(os.path.join(x_dest, name), noisy)
        shutil.copy(path, os.path.join(y_dest, name))
    return len(paths)


def generate_awgn_splits(
    train_src: str,
    test_src: str,
    dest_root: str,
    min_sigma: float = 25.0,
    max_sigma: float = 25.0,
    extension: str = ".png",
    seed: int = 0,
) -> dict[str, int]:
    """One-command train+test dual-split build — the reference's
    ``add_gopro`` (``make_dataset.jl:54-96``) builds both splits in a single
    run under ``awgn_<min>_<max>/{train,test}/{x,y}``; same layout here,
    minus its hardcoded Windows source paths.  Returns pair counts per
    split."""
    dset_dir = os.path.join(
        dest_root, f"awgn_{min_sigma:g}_{max_sigma:g}"
    )
    counts = {}
    for split, src in (("train", train_src), ("test", test_src)):
        counts[split] = generate_awgn_dataset(
            src,
            os.path.join(dset_dir, split),
            min_sigma=min_sigma,
            max_sigma=max_sigma,
            extension=extension,
            seed=seed + (0 if split == "train" else 1),
        )
    return counts
