"""Image-quality metrics."""

from admm_deconv_tpu_torch.metrics.psnr import peak_snr

__all__ = ["peak_snr"]
