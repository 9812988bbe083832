"""Image-gradient utilities for IQA metrics — reference ``iqa_utils.jl``.

Public equivalents of the reference's surface (``src/metrics/iqa_utils.jl``):
``SOBEL_X/Y`` and ``PREWITT_X/Y`` kernel constants (``iqa_utils.jl:5-17``;
the Prewitt pair is defined there but never consumed — exposed here for
parity), :func:`imgrads` (``:24-50``) and :func:`gradientsmag` (``:53-55``).
Convolution is per-channel (grouped) over circularly padded NHWC input at
HIGHEST precision (an f32 conv at DEFAULT precision may run in TF32 on the
GPU, keeping ~10 mantissa bits, which breaks variance-based metrics).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Rows [1 2 1; 0 0 0; -1 -2 -1]/8 — the reference's SOBEL_KERNEL_X
# (iqa_utils.jl:12-16, columns cat'ed along dim 2); "_Y" is its transpose.
SOBEL_X = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=np.float64) / 8.0
SOBEL_Y = SOBEL_X.T

# Prewitt pair (iqa_utils.jl:5-10): rows [1 1 1; 0 0 0; -1 -1 -1]/3.
PREWITT_X = np.array([[1, 1, 1], [0, 0, 0], [-1, -1, -1]], dtype=np.float64) / 3.0
PREWITT_Y = PREWITT_X.T

KERNELS = {
    "sobel": (SOBEL_X, SOBEL_Y),
    "prewitt": (PREWITT_X, PREWITT_Y),
}


def imgrads(
    x: jnp.ndarray, kernel: str = "sobel"
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-channel (x, y) gradient responses with circular padding, NHWC.

    Reference ``imgrads`` (``iqa_utils.jl:24-50``), which hardcodes Sobel;
    ``kernel="prewitt"`` selects the reference's unused Prewitt pair.
    """
    kx_np, ky_np = KERNELS[kernel]
    c = x.shape[-1]
    kx = jnp.tile(jnp.asarray(kx_np[:, :, None, None], dtype=x.dtype), (1, 1, 1, c))
    ky = jnp.tile(jnp.asarray(ky_np[:, :, None, None], dtype=x.dtype), (1, 1, 1, c))
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="wrap")

    def conv(inp, k):
        return jax.lax.conv_general_dilated(
            inp,
            k,
            window_strides=(1, 1),
            padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=c,
            precision=jax.lax.Precision.HIGHEST,
        )

    return conv(xp, kx), conv(xp, ky)


def gradientsmag(gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    """Gradient magnitude with the reference's 1e-16 epsilon
    (``iqa_utils.jl:53-55``)."""
    return jnp.sqrt(gx * gx + gy * gy + 1e-16)
