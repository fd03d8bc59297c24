"""Paired-image dataset with aligned random crops + a batching loader.

Counterpart of ``admm_deconv_tpu/data/feeder.py``, a copy: the same files
and the same seeded ``numpy.random.Generator`` give the same batches, bit
for bit, on the PIL path and on the native path.

Capability parity with the reference's ``ImageDataFeeder``
(``src/processing/datafeeder.jl:5-78``): glob-discovered x/y file pairs,
one random crop offset per sample applied to *both* images
(``datafeeder.jl:42-45``), oversized requests falling back to the whole
image with a warning (``:36-40``), batches stacked along a new batch axis.
Output layout is NHWC float32 in [0, 1] (the reference uses HWCB).

The loader adds what ``Flux.DataLoader`` provided there: batching, optional
shuffling, and deterministic seeding (the reference seeds Julia's global RNG;
here a ``numpy.random.Generator`` is owned by the loader).
"""

from __future__ import annotations

import glob as globlib
import os
import warnings
from typing import Iterator, Sequence

import numpy as np

from admm_deconv_tpu_torch.data.imageio import load_image


class ImageDataFeeder:
    """Paired (degraded x, clean y) image dataset with aligned random crops.

    ``backend="auto"`` uses the native C++ loader (libpng decode + threaded
    crop/batch assembly, ``native/imagefeeder.cpp``) when it is buildable and
    the request fits its fast path (PNG, equal fixed x/y crop shapes),
    falling back to the PIL path otherwise.
    """

    def __init__(
        self,
        x_dir: str,
        y_dir: str,
        extension: str = ".png",
        x_shape: tuple[int, int] | None = None,
        y_shape: tuple[int, int] | None = None,
        rng: np.random.Generator | None = None,
        backend: str = "auto",
    ):
        self.x_paths = sorted(globlib.glob(os.path.join(x_dir, "*" + extension)))
        self.y_paths = sorted(globlib.glob(os.path.join(y_dir, "*" + extension)))
        if not self.x_paths or not self.y_paths:
            warnings.warn(
                f"Provided paths resulted in an empty list of images. "
                f"X DATA: {len(self.x_paths)}; Y DATA: {len(self.y_paths)}"
            )
        self.x_shape = x_shape
        self.y_shape = y_shape
        self.rng = rng if rng is not None else np.random.default_rng()
        if backend not in ("auto", "native", "pil"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._native_ok = None  # resolved lazily

    @classmethod
    def from_pair_list(
        cls,
        list_path: str,
        root: str | None = None,
        x_shape: tuple[int, int] | None = None,
        y_shape: tuple[int, int] | None = None,
        rng: np.random.Generator | None = None,
        backend: str = "auto",
        x_col: int = 1,
        y_col: int = 0,
    ) -> "ImageDataFeeder":
        """Build a feeder from a RealBlur-style pair list file.

        The reference sketches (commented-out) ingestion of the RealBlur
        corpus via its ``*_train.txt`` list files — one pair per line,
        whitespace-separated paths relative to the dataset root, first
        token the ground truth, second the blurred frame
        (``src/make_dataset.jl:7-13,110-113``).  Here it is a working
        constructor: ``x`` (degraded) defaults to the second column,
        ``y`` (clean) to the first; override ``x_col``/``y_col`` for list
        files with swapped conventions.  Relative entries resolve against
        ``root`` (default: the list file's directory).  Lines that are
        empty or start with ``#`` are skipped; lines with fewer than two
        tokens raise.
        """
        root = root if root is not None else os.path.dirname(os.path.abspath(list_path))
        xs, ys = [], []
        with open(list_path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                toks = line.split()
                if len(toks) < 2:
                    raise ValueError(
                        f"{list_path}:{lineno}: expected at least 2 paths, "
                        f"got {line!r}"
                    )
                def resolve(tok):
                    return tok if os.path.isabs(tok) else os.path.join(root, tok)
                xs.append(resolve(toks[x_col]))
                ys.append(resolve(toks[y_col]))
        self = cls.__new__(cls)
        self.x_paths = xs
        self.y_paths = ys
        if not xs:
            warnings.warn(f"pair list {list_path} contains no entries")
        self.x_shape = x_shape
        self.y_shape = y_shape
        self.rng = rng if rng is not None else np.random.default_rng()
        if backend not in ("auto", "native", "pil"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._native_ok = None
        return self

    def _use_native(self) -> bool:
        if self.backend == "pil":
            return False
        if not (
            self.x_shape is not None
            and self.x_shape == self.y_shape
            and all(p.endswith(".png") for p in self.x_paths[:1] + self.y_paths[:1])
        ):
            if self.backend == "native":
                raise RuntimeError(
                    "native backend requires equal fixed x/y crop shapes and PNGs"
                )
            return False
        if self._native_ok is None:
            from admm_deconv_tpu_torch.data import native

            self._native_ok = native.available()
            if self.backend == "native" and not self._native_ok:
                raise RuntimeError("native image loader could not be built")
        return bool(self._native_ok)

    def __len__(self) -> int:
        return len(self.y_paths)

    def _get_pair(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        imgx = load_image(self.x_paths[idx])
        imgy = load_image(self.y_paths[idx])
        if self.y_shape is None:
            return imgx, imgy
        th, tw = self.y_shape
        ih, iw = imgy.shape[:2]
        if th > ih or tw > iw:
            warnings.warn(
                f"Desired target shape {self.y_shape} exceeds image size "
                f"{(ih, iw)}; returning the whole image"
            )
            return imgx, imgy
        # One offset, applied to both images (datafeeder.jl:42-45).
        r = int(self.rng.integers(0, ih - th + 1))
        c = int(self.rng.integers(0, iw - tw + 1))
        xh, xw = self.x_shape if self.x_shape is not None else (th, tw)
        return (
            imgx[r : r + xh, c : c + xw, :],
            imgy[r : r + th, c : c + tw, :],
        )

    def __getitem__(self, idxs) -> tuple[np.ndarray, np.ndarray]:
        if np.isscalar(idxs):
            idxs = [int(idxs)]
        idxs = [int(i) for i in idxs]
        if self._use_native():
            from admm_deconv_tpu_torch.data import native

            try:
                return native.load_pair_batch(
                    [self.x_paths[i] for i in idxs],
                    [self.y_paths[i] for i in idxs],
                    self.y_shape[0],
                    self.y_shape[1],
                    int(self.rng.integers(0, 2**63)),
                )
            except IOError as e:
                # e.g. crop larger than some image: the PIL path handles the
                # whole-image fallback with a warning.
                warnings.warn(f"native loader fell back to PIL: {e}")
        pairs = [self._get_pair(i) for i in idxs]
        batch_x = np.stack([p[0] for p in pairs], axis=0)
        batch_y = np.stack([p[1] for p in pairs], axis=0)
        return batch_x, batch_y


class DataLoader:
    """Minimal epoch iterator over an :class:`ImageDataFeeder`.

    Multi-host data parallelism (no reference counterpart, SURVEY.md §5.8):
    with ``process_count > 1``, ``batch_size`` is the GLOBAL batch size and
    each process yields only its contiguous ``batch_size/process_count``
    shard of every batch: the port's ``Trainer`` steps on the shard and
    averages the gradients over the ranks.  All processes must
    construct the loader with identically-seeded ``rng`` so the shuffled
    epoch order agrees.
    """

    def __init__(
        self,
        dataset: ImageDataFeeder,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        rng: np.random.Generator | None = None,
        process_count: int = 1,
        process_index: int = 0,
    ):
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError(
                f"global batch_size {batch_size} must be divisible by "
                f"process_count {process_count}"
            )
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        # A ragged final batch would give processes unequal shard sizes, so
        # multi-process always drops it.
        self.drop_last = drop_last or process_count > 1
        self.rng = rng if rng is not None else np.random.default_rng()
        self.process_count = process_count
        self.process_index = process_index

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        stop = (
            len(order) - len(order) % self.batch_size
            if self.drop_last
            else len(order)
        )
        local = self.batch_size // self.process_count
        lo = self.process_index * local
        for start in range(0, stop, self.batch_size):
            batch_idx = order[start : start + self.batch_size]
            if self.process_count > 1:
                batch_idx = batch_idx[lo : lo + local]
            yield self.dataset[batch_idx]
