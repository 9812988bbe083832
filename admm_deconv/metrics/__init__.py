"""Image-quality metrics and losses (PSNR / SSIM / GMSD).

Parity targets: reference ``src/metrics/{psnr,ssim,gmsd,iqa_utils}.jl`` —
same kernels and constants, NHWC layout, jit/grad-compatible.
"""

from admm_deconv.metrics.psnr import peak_snr
from admm_deconv.metrics.ssim import ssim, ssim_loss, ssim_loss_fast
from admm_deconv.metrics.gmsd import gmsd, gmsd_loss
from admm_deconv.metrics.iqa import (
    PREWITT_X,
    PREWITT_Y,
    SOBEL_X,
    SOBEL_Y,
    gradientsmag,
    imgrads,
)

__all__ = [
    "peak_snr", "ssim", "ssim_loss", "ssim_loss_fast", "gmsd", "gmsd_loss",
    "imgrads", "gradientsmag", "SOBEL_X", "SOBEL_Y", "PREWITT_X", "PREWITT_Y",
]
