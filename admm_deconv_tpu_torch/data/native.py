"""ctypes bindings for the native C++ image-loading runtime.

Counterpart of ``admm_deconv_tpu/data/native.py``, over the same shared
source: ``native/imagefeeder.cpp`` (libpng decode + threaded aligned-crop
batch assembly), built by the unedited ``native/Makefile`` at first use,
never at import, into the git-ignored ``admm_deconv_tpu_torch/_build/``.
The library's file name holds a hash of the source, the Makefile and the
flags, so an edited source builds anew.  The flags are the Makefile's less
``-march=native``: a checkout may be built on one host and run on another.
The tracked ``native/build/libimagefeeder.so`` is never loaded.  Without a
compiler or libpng, :func:`available` is False and the feeder takes the PIL
path, as in JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = "-O3 -fPIC -std=c++17 -Wall"

_ERROR_NAMES = {
    1: "could not open file",
    2: "PNG decode failed",
    3: "crop larger than image",
    4: "not a PNG file",
}

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    """Where the loader builds to, keyed by source, Makefile and flags."""
    digest = hashlib.sha256()
    for name in ("imagefeeder.cpp", "Makefile"):
        digest.update((NATIVE_DIR / name).read_bytes())
    digest.update(CXXFLAGS.encode())
    return BUILD_DIR / f"libimagefeeder-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """Run ``make -C native`` into a private directory under ``BUILD_DIR``
    and move the library into place (concurrent builds each finish with
    a whole file)."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        subprocess.run(
            ["make", "-C", str(NATIVE_DIR), f"BUILD={tmp}", f"CXXFLAGS={CXXFLAGS}"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(os.path.join(tmp, "libimagefeeder.so"), lib)
    return lib


def _load_library():
    """Build (if needed) and dlopen the native library; None on failure."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            lib = ctypes.CDLL(str(_build()))
        except (subprocess.SubprocessError, OSError):
            _build_failed = True
            return None
        lib.adtpu_image_size.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.adtpu_image_size.restype = ctypes.c_int
        lib.adtpu_load_image.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.adtpu_load_image.restype = ctypes.c_int
        lib.adtpu_load_pair_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.adtpu_load_pair_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native loader can be used (builds lazily on first call)."""
    return _load_library() is not None


def image_size(path: str) -> tuple[int, int]:
    """(H, W) of a PNG without full Python-side decode."""
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native image loader unavailable")
    h = ctypes.c_int()
    w = ctypes.c_int()
    err = lib.adtpu_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if err != 0:
        raise IOError(f"{path}: {_ERROR_NAMES.get(err, err)}")
    return h.value, w.value


def load_pair_batch(
    x_paths: list[str],
    y_paths: list[str],
    crop_h: int,
    crop_w: int,
    seed: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode + aligned-random-crop + batch n image pairs natively.

    Returns float32 NHWC ``(x, y)`` batches of shape ``(n, crop_h, crop_w, 3)``.
    """
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native image loader unavailable")
    n = len(x_paths)
    if n != len(y_paths):
        raise ValueError("x_paths and y_paths must have equal length")
    out_x = np.empty((n, crop_h, crop_w, 3), dtype=np.float32)
    out_y = np.empty((n, crop_h, crop_w, 3), dtype=np.float32)
    errs = (ctypes.c_int * n)()
    xp = (ctypes.c_char_p * n)(*[p.encode() for p in x_paths])
    yp = (ctypes.c_char_p * n)(*[p.encode() for p in y_paths])
    err = lib.adtpu_load_pair_batch(
        xp,
        yp,
        n,
        crop_h,
        crop_w,
        ctypes.c_uint64(seed & (2**64 - 1)),
        out_x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        errs,
    )
    if err != 0:
        bad = [
            f"{x_paths[i]}: {_ERROR_NAMES.get(errs[i], errs[i])}"
            for i in range(n)
            if errs[i] != 0
        ]
        raise IOError("; ".join(bad) or f"native loader error {err}")
    return out_x, out_y
