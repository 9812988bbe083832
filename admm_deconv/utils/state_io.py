"""Solver warm-start state persistence.

SURVEY.md §5.4's plan includes solver iterate (x, z, u) save/restore —
a capability the reference lacks entirely.  Together with
``tv_deconvolve(..., init_state=..., return_state=True)`` this enables
checkpointed long solves and warm-started parameter sweeps / video streams.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from admm_deconv.ops.solver import ADMMState


def save_solver_state(path: str, state: ADMMState) -> None:
    """Persist an :class:`ADMMState` to an ``.npz`` file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        **{name: np.asarray(value) for name, value in state._asdict().items()},
    )


def load_solver_state(path: str) -> ADMMState:
    """Load an :class:`ADMMState` saved by :func:`save_solver_state`."""
    with np.load(path) as data:
        return ADMMState(
            **{name: jax.numpy.asarray(data[name]) for name in ADMMState._fields}
        )
