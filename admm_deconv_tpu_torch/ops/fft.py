"""FFT-domain precompute for the ADMM x-update.

Counterpart of ``admm_deconv_tpu/ops/fft.py``.  The x-update solves the
circulant normal equations

    (H^T H + rho * D^T D) x = H^T y + rho * D^T (z - u)

in the rFFT domain from two cached spectra: the centred OTF of the PSF and
the closed-form spectrum of the circular first-difference Laplacian.  All
transforms are plain ``torch.fft`` calls (cuFFT on the card, pocketfft on
the CPU) at fp32.
"""

from __future__ import annotations

import numpy as np
import torch


def psf_center(shape: tuple[int, int]) -> tuple[int, int]:
    """Center tap of a PSF: 0-indexed ``floor((k-1)/2)`` along each axis,
    matching the reference's ceil/floor pad split."""
    kh, kw = shape
    return (kh - 1) // 2, (kw - 1) // 2


def psf_to_otf(psf: torch.Tensor, image_shape: tuple[int, int]) -> torch.Tensor:
    """Embed a small PSF into the image grid and return its rFFT2 spectrum.

    The centre tap is rolled to the origin, so the OTF carries no linear
    phase: ``H x = irfft2(otf * rfft2(x))`` is the centred circular
    convolution and ``irfft2(conj(otf) * rfft2(x))`` its exact adjoint.

    Returns a complex ``(H, W // 2 + 1)`` tensor on the PSF's device.
    """
    h, w = image_shape
    kh, kw = psf.shape
    if kh > h or kw > w:
        raise ValueError(f"PSF {tuple(psf.shape)} larger than image {image_shape}")
    ch, cw = psf_center((kh, kw))
    padded = torch.zeros((h, w), dtype=psf.dtype, device=psf.device)
    padded[:kh, :kw] = psf
    padded = torch.roll(padded, shifts=(-ch, -cw), dims=(0, 1))
    return torch.fft.rfft2(padded)


def laplacian_spectrum(
    image_shape: tuple[int, int],
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``|Lambda_x|^2 + |Lambda_y|^2`` for circular backward differences.

    Closed form: the DFT of ``delta - shift`` is ``1 - exp(-2 pi i k / N)``,
    whose squared magnitude is ``4 sin^2(pi k / N)``.  Computed with numpy
    in float64, then cast and moved to ``device``.

    Returns a real ``(H, W // 2 + 1)`` tensor.
    """
    h, w = image_shape
    fy = np.sin(np.pi * np.arange(h) / h) ** 2
    fx = np.sin(np.pi * np.arange(w // 2 + 1) / w) ** 2
    lap = 4.0 * (fy[:, None] + fx[None, :])
    return torch.as_tensor(lap, dtype=dtype, device=device)
