"""Circular first-difference stencils D / D^T as roll-based ops.

The reference implements these as grouped 2x2 convolutions with hand-built
``W``/``W^T`` kernels over circularly padded inputs (``src/ops/ops.jl:51-65``).
A conv of a 2-tap stencil wastes the matrix units; ``jnp.roll`` + subtract
is a pure bandwidth operation that XLA fuses with the surrounding prox and
dual updates.  Both are exactly circular.

Convention (matching the reference's filters, ``src/ops/ops.jl:32-34``):
    (D_x x)[i, j] = x[i, j] - x[i, j-1]   (circular, along W, last axis)
    (D_y x)[i, j] = x[i, j] - x[i-1, j]   (circular, along H, second-to-last)
with exact adjoints
    (D_x^T z)[i, j] = z[i, j] - z[i, j+1]
    (D_y^T z)[i, j] = z[i, j] - z[i+1, j]
"""

from __future__ import annotations

import jax.numpy as jnp


def grad2d(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Circular backward differences ``(D_x x, D_y x)`` over the last 2 axes."""
    dx = x - jnp.roll(x, 1, axis=-1)
    dy = x - jnp.roll(x, 1, axis=-2)
    return dx, dy


def grad2d_adjoint(zx: jnp.ndarray, zy: jnp.ndarray) -> jnp.ndarray:
    """Exact adjoint ``D^T z = D_x^T z_x + D_y^T z_y`` (negative divergence)."""
    return (zx - jnp.roll(zx, -1, axis=-1)) + (zy - jnp.roll(zy, -1, axis=-2))
