"""Structural similarity (SSIM) metric and loss.

Parity with reference ``src/metrics/ssim.jl``: the same hardcoded 11-tap
sigma=1.5 Gaussian window (``ssim.jl:6-17``) outer-producted to 2-D, applied
per-channel via grouped convolution (``ssim.jl:94-97,112-119``), constants
``C1, C2 = (0.01, 0.03)^2 * peakval^2`` (``ssim.jl:100-101``), ``crop=True``
-> valid convolution, ``crop=False`` -> symmetric padding
(``ssim.jl:105-110``), map averaged per image then over the batch
(``ssim.jl:121-123``).  Differentiable and jit-friendly.

Layout: NHWC ``(B, H, W, C)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Gaussian kernel std=1.5, length=11 — bit-identical to reference ssim.jl:6-17.
SSIM_KERNEL_1D = np.array(
    [
        0.00102838008447911,
        0.007598758135239185,
        0.03600077212843083,
        0.10936068950970002,
        0.2130055377112537,
        0.26601172486179436,
        0.2130055377112537,
        0.10936068950970002,
        0.03600077212843083,
        0.007598758135239185,
        0.00102838008447911,
    ],
    dtype=np.float64,
)


def ssim_kernel(dtype=jnp.float32) -> jnp.ndarray:
    """2-D 11x11 Gaussian window, shape ``(11, 11, 1, 1)`` (HWIO)."""
    k2d = np.outer(SSIM_KERNEL_1D, SSIM_KERNEL_1D)
    return jnp.asarray(k2d[:, :, None, None], dtype=dtype)


def _depthwise_conv(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Per-channel valid convolution, NHWC x HWIO(groups=C)."""
    c = x.shape[-1]
    if kernel.shape[-1] != c:
        kernel = jnp.tile(kernel, (1, 1, 1, c))
    # HIGHEST precision: at DEFAULT an f32 conv may run in TF32 on the GPU
    # (~10 mantissa bits), which makes the E[x^2] - mu^2 variance terms
    # cancel catastrophically (SSIM > 1).
    return jax.lax.conv_general_dilated(
        x,
        kernel,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c,
        precision=jax.lax.Precision.HIGHEST,
    )


def ssim(
    x: jnp.ndarray,
    y: jnp.ndarray,
    kernel: jnp.ndarray | None = None,
    peakval: float = 1.0,
    crop: bool = True,
) -> jnp.ndarray:
    """SSIM between NHWC image batches (scalar, batch-averaged)."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {x.shape} vs {y.shape}")
    if x.ndim == 3:
        x, y = x[None], y[None]
    if kernel is None:
        kernel = ssim_kernel(x.dtype)

    c1 = (0.01 * peakval) ** 2
    c2 = (0.03 * peakval) ** 2

    if not crop:
        kh, kw = kernel.shape[0], kernel.shape[1]
        # Flux calc_padding split: ceil on the leading side (ssim.jl:107).
        pad = (
            (0, 0),
            (-(-(kh - 1) // 2), (kh - 1) // 2),
            (-(-(kw - 1) // 2), (kw - 1) // 2),
            (0, 0),
        )
        x = jnp.pad(x, pad, mode="symmetric")
        y = jnp.pad(y, pad, mode="symmetric")

    mu_x = _depthwise_conv(x, kernel)
    mu_y = _depthwise_conv(y, kernel)
    mu_x2 = mu_x * mu_x
    mu_y2 = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x2 = _depthwise_conv(x * x, kernel) - mu_x2
    sigma_y2 = _depthwise_conv(y * y, kernel) - mu_y2
    sigma_xy = _depthwise_conv(x * y, kernel) - mu_xy

    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2)
    )
    per_image = jnp.mean(ssim_map, axis=(1, 2, 3))
    return jnp.mean(per_image)


def ssim_loss(x: jnp.ndarray, y: jnp.ndarray, **kwargs) -> jnp.ndarray:
    """``1 - ssim(x, y)`` (reference ``ssim.jl:148``)."""
    return 1.0 - ssim(x, y, **kwargs)


def ssim_loss_fast(
    x: jnp.ndarray, y: jnp.ndarray, kernel_length: int = 5, **kwargs
) -> jnp.ndarray:
    """SSIM loss with a normalized box window (reference ``ssim.jl:160-164``)."""
    k = jnp.ones((kernel_length, kernel_length, 1, 1), dtype=x.dtype)
    k = k / (kernel_length * kernel_length)
    return ssim_loss(x, y, kernel=k, **kwargs)
