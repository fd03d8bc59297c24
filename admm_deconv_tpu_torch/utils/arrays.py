"""Array helpers, counterparts of ``admm_deconv_tpu/utils/arrays.py``, and
the rule by which the port's entry points take arrays that are not tensors."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def default_device() -> torch.device:
    """Where a non-tensor input goes: the card, as JAX puts a numpy array on
    its default device.  Raises where there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a non-tensor input goes to the CUDA device and none is available; "
            "pass a CPU torch.Tensor to solve on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def as_tensor(a, device: torch.device | str | None = None) -> torch.Tensor:
    """A ``torch.Tensor`` is returned as it is, on its device and in its
    dtype.  Anything else (a numpy array) becomes a tensor on ``device``
    (default: :func:`default_device`), a floating one as float32, as JAX
    makes it with x64 off: numpy's default float64 never reaches a kernel.

    A float64 *tensor* keeps its dtype: on the CPU the solvers then take
    their plain path at float64; on the card the kernels take float32 only
    and raise, naming the cure.  Integer arrays keep their dtype."""
    if isinstance(a, torch.Tensor):
        return a
    t = torch.as_tensor(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.float()
    return t.to(default_device() if device is None else device)


def as_tensor_pair(x, y) -> tuple[torch.Tensor, torch.Tensor]:
    """The operands of a metric: tensors stay as they are; a non-tensor
    beside a tensor takes that tensor's device and dtype; two non-tensors
    go to the card as float32, as the solvers' inputs do."""
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        return x, y
    if isinstance(x, torch.Tensor):
        return x, torch.as_tensor(np.asarray(y), dtype=x.dtype, device=x.device)
    if isinstance(y, torch.Tensor):
        return torch.as_tensor(np.asarray(x), dtype=y.dtype, device=y.device), y
    device = default_device()
    return as_tensor(x, device), as_tensor(y, device)


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
