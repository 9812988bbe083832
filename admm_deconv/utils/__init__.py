"""Utilities: array helpers, 3-D differences, profiling, debug flags."""

from admm_deconv.utils.arrays import expand_dims, fftn_matlike
from admm_deconv.utils.diff3d import forward_diff3d, divergence3d
from admm_deconv.utils.profiling import IterationTimer, trace_annotation
from admm_deconv.utils.debug import enable_nan_checks, deterministic_mode
from admm_deconv.utils.state_io import save_solver_state, load_solver_state

__all__ = [
    "save_solver_state",
    "load_solver_state",
    "expand_dims",
    "fftn_matlike",
    "forward_diff3d",
    "divergence3d",
    "IterationTimer",
    "trace_annotation",
    "enable_nan_checks",
    "deterministic_mode",
]
