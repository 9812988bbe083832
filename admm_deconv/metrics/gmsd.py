"""Gradient Magnitude Similarity Deviation (GMSD) metric / training loss.

Parity with reference ``src/metrics/gmsd.jl`` + ``src/metrics/iqa_utils.jl``:
Sobel gradients (kernels normalized by 8, ``iqa_utils.jl:12-17``) via
circularly padded per-channel convolution (``iqa_utils.jl:44-47``), gradient
magnitude with 1e-16 epsilon (``iqa_utils.jl:53-55``), similarity map with
``t=0.0026``, ``alpha=0`` (``gmsd.jl:5-13``), score = batch mean of the
per-image standard deviation of the GMS map (``gmsd.jl:22-26``).  Used as a
training loss by the reference's trainer v1 (``src/train.jl:191``).
"""

from __future__ import annotations

import jax.numpy as jnp

from admm_deconv.metrics.iqa import (
    SOBEL_X,
    SOBEL_Y,
    gradientsmag as _gradient_magnitude,
    imgrads as _sobel_grads,
)


def gmsd(
    x: jnp.ndarray,
    y: jnp.ndarray,
    t: float = 0.0026,
    alpha: float = 0.0,
) -> jnp.ndarray:
    """GMSD score between NHWC batches (lower is better; scalar)."""
    if x.ndim == 3:
        x, y = x[None], y[None]
    gxx, gxy = _sobel_grads(x)
    gyx, gyy = _sobel_grads(y)
    map_x = _gradient_magnitude(gxx, gxy)
    map_y = _gradient_magnitude(gyx, gyy)

    num = 2.0 * map_x * map_y - alpha * map_x * map_y + t
    den = map_x * map_x + map_y * map_y - alpha * map_x * map_y + t
    gms = num / den

    mean_gms = jnp.mean(gms, axis=(1, 2, 3), keepdims=True)
    score = jnp.mean((gms - mean_gms) ** 2, axis=(1, 2, 3))
    return jnp.mean(jnp.sqrt(score))


def gmsd_loss(x: jnp.ndarray, y: jnp.ndarray, **kwargs) -> jnp.ndarray:
    """Alias of :func:`gmsd` (reference ``gmsd.jl:30``)."""
    return gmsd(x, y, **kwargs)
