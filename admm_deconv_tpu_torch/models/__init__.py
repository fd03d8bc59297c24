"""Model zoo: restoration networks composing ADMM layers with conv blocks."""

from admm_deconv_tpu_torch.models.blocks import (
    Activation,
    Chain,
    DownBlock,
    Parallel,
    SkipConnection,
    UpBlock,
    UpDownBlock,
    UpDownResidualBlock,
    chcat,
    init_parameters,
    normalise,
    relu1,
    relu6,
)
from admm_deconv_tpu_torch.models.zoo import (
    AdmmDenoiser,
    Autoencoder,
    DeconvBank,
    DenoiserBank,
    MultistageUpDownscale,
    build_model,
)

__all__ = [
    "Activation",
    "Chain",
    "Parallel",
    "SkipConnection",
    "UpDownBlock",
    "DownBlock",
    "UpBlock",
    "UpDownResidualBlock",
    "chcat",
    "init_parameters",
    "normalise",
    "relu1",
    "relu6",
    "AdmmDenoiser",
    "Autoencoder",
    "DenoiserBank",
    "MultistageUpDownscale",
    "DeconvBank",
    "build_model",
]
