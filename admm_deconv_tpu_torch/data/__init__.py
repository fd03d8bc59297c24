"""Data pipeline: paired-image dataset, loaders, dataset synthesis.

Counterpart of ``admm_deconv_tpu/data``: numpy, PIL and the shared native
loader (``native/imagefeeder.cpp``), no torch.  Imported as
``admm_deconv_tpu_torch.data``; the package's ``__init__`` does not import it.
"""

from admm_deconv_tpu_torch.data.imageio import load_image, save_image, img_to_tensor, tensor_to_img
from admm_deconv_tpu_torch.data.feeder import ImageDataFeeder, DataLoader
from admm_deconv_tpu_torch.data.dataset import (
    add_awgn,
    add_poisson_gaussian,
    generate_awgn_dataset,
    generate_awgn_splits,
)

__all__ = [
    "load_image",
    "save_image",
    "img_to_tensor",
    "tensor_to_img",
    "ImageDataFeeder",
    "DataLoader",
    "add_awgn",
    "add_poisson_gaussian",
    "generate_awgn_dataset",
    "generate_awgn_splits",
]
