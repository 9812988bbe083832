"""Debug / sanitizer flags.

The reference has no sanitizer subsystem (SURVEY.md §5.2).  JAX-native
equivalents: JAX's NaN-propagation checks and deterministic execution.
"""

from __future__ import annotations

import contextlib

import jax


def enable_nan_checks(enable: bool = True) -> None:
    """Globally raise on NaN-producing jitted computations
    (``jax_debug_nans``): the closest analogue of a memory sanitizer for
    numerical code.  Slows execution; use while debugging divergence."""
    jax.config.update("jax_debug_nans", enable)


@contextlib.contextmanager
def deterministic_mode():
    """Context with deterministic XLA reductions + NaN checks enabled, for
    bit-reproducible debugging runs."""
    prev_nans = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nans)
