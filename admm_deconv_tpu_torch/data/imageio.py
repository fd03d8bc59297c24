"""Image <-> tensor conversion and file IO.

Counterpart of ``admm_deconv_tpu/data/imageio.py``, a copy (numpy and PIL):
the port never imports the JAX package, whose ``__init__`` imports jax.

Replaces the reference's Images.jl-based converters
(``src/utilities/base_funcs.jl:18-50``): images are float32 HWC tensors in
[0, 1]; files load via PIL.  (The reference's duplicate ``tensor2img``
method bug — grayscale variant unreachable, ``base_funcs.jl:38-45`` — has no
analogue here: channel count picks the mode.)
"""

from __future__ import annotations

import numpy as np

try:
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


def img_to_tensor(img) -> np.ndarray:
    """PIL image / uint8 array -> float32 HWC array in [0, 1]."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def tensor_to_img(arr: np.ndarray):
    """Float HWC array in [0, 1] -> PIL image (clamped, uint8)."""
    if not _HAS_PIL:
        raise RuntimeError("PIL is unavailable")
    arr = np.asarray(arr)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[:, :, 0]
    u8 = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return Image.fromarray(u8)


def load_image(path: str) -> np.ndarray:
    """Load an image file as a float32 HWC tensor in [0, 1]."""
    if not _HAS_PIL:
        raise RuntimeError("PIL is unavailable")
    with Image.open(path) as im:
        return img_to_tensor(im)


def save_image(path: str, arr: np.ndarray) -> None:
    """Save a float HWC tensor in [0, 1] to an image file."""
    tensor_to_img(arr).save(path)
