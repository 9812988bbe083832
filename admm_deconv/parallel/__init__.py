"""Multi-chip parallelism: device meshes, batch sharding, spatial tiling.

No reference counterpart — the reference is strictly single-GPU (SURVEY.md
§5.8); this package is the BASELINE's multi-chip capability surface
(configs 3/5): batch-axis data parallelism under GSPMD and exact
H-axis spatial tiling with a transpose-based distributed rFFT2, halo-exchange
difference stencils, and psum'd residual norms for shared rho adaptation.
"""

from admm_deconv.parallel.mesh import make_mesh, shard_batch, replicate
from admm_deconv.parallel.tiling import (
    tiled_composite_tv_deconvolve,
    tiled_tv_deconvolve,
    tiled_tv_deconvolve_anderson,
)
from admm_deconv.parallel import distributed

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "tiled_composite_tv_deconvolve",
    "tiled_tv_deconvolve",
    "tiled_tv_deconvolve_anderson",
    "distributed",
]
