"""Array helpers, counterparts of ``admm_deconv_tpu/utils/arrays.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def expand_dims(arr: torch.Tensor, dim_idx: int) -> torch.Tensor:
    """Insert a singleton dimension at ``dim_idx`` (0-indexed)."""
    return torch.unsqueeze(arr, dim_idx)


def fftn_matlike(arr: torch.Tensor, out_shape: tuple[int, ...]) -> torch.Tensor:
    """N-D FFT of ``arr`` zero-padded (trailing) to ``out_shape``: MATLAB's
    ``fftn(X, sz)``."""
    if arr.ndim != len(out_shape):
        raise ValueError(
            "out_shape must have one entry per dimension of the input "
            f"(got {len(out_shape)} for ndim {arr.ndim})"
        )
    pads = [int(o) - int(s) for s, o in zip(arr.shape, out_shape)]
    if any(p < 0 for p in pads):
        raise ValueError(f"out_shape {tuple(out_shape)} smaller than input {tuple(arr.shape)}")
    # F.pad lists (before, after) pairs from the last dimension backwards.
    flat = [v for p in reversed(pads) for v in (0, p)]
    return torch.fft.fftn(F.pad(arr, flat))
