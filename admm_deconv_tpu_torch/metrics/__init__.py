"""Image-quality metrics and losses (PSNR / SSIM / GMSD / MSE)."""

from admm_deconv_tpu_torch.metrics.gmsd import gmsd, gmsd_loss
from admm_deconv_tpu_torch.metrics.iqa import (
    PREWITT_X,
    PREWITT_Y,
    SOBEL_X,
    SOBEL_Y,
    gradientsmag,
    imgrads,
)
from admm_deconv_tpu_torch.metrics.psnr import mse, peak_snr
from admm_deconv_tpu_torch.metrics.ssim import ssim, ssim_loss, ssim_loss_fast

__all__ = [
    "peak_snr", "mse", "ssim", "ssim_loss", "ssim_loss_fast", "gmsd", "gmsd_loss",
    "imgrads", "gradientsmag", "SOBEL_X", "SOBEL_Y", "PREWITT_X", "PREWITT_Y",
]
