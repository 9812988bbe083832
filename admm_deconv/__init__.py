"""admm-deconv: an ADMM image-deconvolution framework for accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
georgegrosu1/admm-deconv (Julia/Flux/CUDA reference): TV-regularized non-blind
image deconvolution by split-variable ADMM (closed-form rFFT-domain x-update,
shrinkage z-update, scaled dual ascent), exposed both as a jit-compiled batch
solver and as a differentiable learnable layer, plus metrics, model zoo, data
pipeline, training harness, and multi-chip sharding the reference lacks.

Layout convention: NHWC ``(batch, height, width, channels)`` everywhere
vs the reference's Julia ``(H, W, C, B)``.
"""

from admm_deconv.ops.solver import (
    solve_auto,
    tv_deconvolve,
    tv_deconvolve_adaptive,
    anderson_history_bytes,
    tv_deconvolve_anderson,
    ADMMState,
    ADMMDiagnostics,
)
from admm_deconv.ops.composite import (
    composite_tv_deconvolve,
    composite_tv_deconvolve_adaptive,
)
from admm_deconv.ops.implicit import tv_deconvolve_implicit
from admm_deconv.ops import prox
from admm_deconv.metrics import peak_snr, ssim, ssim_loss, gmsd, gmsd_loss

__version__ = "0.1.0"

__all__ = [
    "solve_auto",
    "tv_deconvolve",
    "tv_deconvolve_adaptive",
    "anderson_history_bytes",
    "tv_deconvolve_anderson",
    "composite_tv_deconvolve",
    "composite_tv_deconvolve_adaptive",
    "tv_deconvolve_implicit",
    "ADMMState",
    "ADMMDiagnostics",
    "prox",
    "peak_snr",
    "ssim",
    "ssim_loss",
    "gmsd",
    "gmsd_loss",
]
