"""Model zoo: restoration networks composing ADMM layers with conv blocks."""

from admm_deconv.models.blocks import (
    Activation,
    Chain,
    Parallel,
    SkipConnection,
    UpDownBlock,
    DownBlock,
    UpBlock,
    UpDownResidualBlock,
    normalise,
    relu1,
    relu6,
)
from admm_deconv.models.zoo import (
    AdmmDenoiser,
    Autoencoder,
    DenoiserBank,
    MultistageUpDownscale,
    DeconvBank,
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
