"""Solver core: FFT precompute, difference stencils, prox operators, ADMM loop.

JAX replacement for the reference's ``src/ops/ops.jl`` (CPU/GPU twin
implementations collapse into one jit-compiled, backend-agnostic path).
"""

from admm_deconv.ops.fft import psf_to_otf, laplacian_spectrum
from admm_deconv.ops.diff import grad2d, grad2d_adjoint
from admm_deconv.ops import prox
from admm_deconv.ops.solver import (
    tv_deconvolve,
    tv_deconvolve_adaptive,
    anderson_history_bytes,
    tv_deconvolve_anderson,
)
from admm_deconv.ops.composite import (
    composite_tv_deconvolve,
    composite_tv_deconvolve_adaptive,
)
from admm_deconv.ops.implicit import tv_deconvolve_implicit

__all__ = [
    "psf_to_otf",
    "laplacian_spectrum",
    "grad2d",
    "grad2d_adjoint",
    "prox",
    "tv_deconvolve",
    "tv_deconvolve_adaptive",
    "anderson_history_bytes",
    "tv_deconvolve_anderson",
    "composite_tv_deconvolve",
    "composite_tv_deconvolve_adaptive",
    "tv_deconvolve_implicit",
]
