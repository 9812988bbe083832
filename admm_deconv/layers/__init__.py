"""Learned-layer API: the differentiable unrolled-ADMM module."""

from admm_deconv.layers.deconv import (
    ADMMDeconv,
    ADMMDeconvF1,
    ADMMDeconvF2,
    ADMMDeconvF3,
)

__all__ = ["ADMMDeconv", "ADMMDeconvF1", "ADMMDeconvF2", "ADMMDeconvF3"]
