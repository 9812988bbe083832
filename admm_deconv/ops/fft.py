"""FFT-domain precompute for the ADMM x-update.

The x-update solves the circulant normal equations

    (H^T H + rho * D^T D) x = H^T y + rho * D^T (z - u)

in the rFFT domain.  This module builds the two cached spectra:

* ``psf_to_otf``: the optical transfer function Sigma of the blur operator H
  (centered circular convolution with the PSF).  Mirrors the semantics of the
  reference's spatial ``H``/``H^T`` closures built from ceil/floor circular
  padding + flipped-kernel conv (reference ``src/ops/ops.jl:67-82``) and its
  ``Sigma = rfft(pad(h))`` precompute (``src/ops/ops.jl:25-27``), but keeps a
  single consistent *centered* OTF so that both ``|Sigma|^2`` (denominator)
  and ``conj(Sigma)`` (the H^T application) come from one array held in HBM.

* ``laplacian_spectrum``: ``|Lambda_x|^2 + |Lambda_y|^2`` for the circular
  first-difference filters.  The reference materializes full-size difference
  filters and FFTs them (``src/ops/ops.jl:32-36``); here the spectrum is
  computed in closed form: the DFT of ``delta - shift`` is
  ``1 - exp(-2*pi*i*k/N)`` whose squared magnitude is ``4*sin^2(pi*k/N)``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def psf_center(shape: tuple[int, int]) -> tuple[int, int]:
    """Center tap of a PSF, matching the reference's ceil/floor pad split.

    The reference pads by ``ceil((k-1)/2)`` on the leading side
    (``src/ops/ops.jl:73-74``), which anchors the kernel's center at 0-indexed
    ``floor((k-1)/2)`` along each axis.
    """
    kh, kw = shape
    return (kh - 1) // 2, (kw - 1) // 2


def psf_to_otf(psf: jnp.ndarray, image_shape: tuple[int, int]) -> jnp.ndarray:
    """Embed a small PSF into the image grid and return its rFFT2 spectrum.

    ``H x = irfft2(otf * rfft2(x))`` is then exactly the reference's centered
    circular convolution; ``H^T x = irfft2(conj(otf) * rfft2(x))`` its exact
    adjoint (reference applies these as spatial grouped convs,
    ``src/ops/ops.jl:80-81``).

    Args:
      psf: real blur kernel, shape ``(kh, kw)``; kernel must fit the image.
      image_shape: ``(H, W)`` of the target image grid.

    Returns:
      Complex spectrum of shape ``(H, W // 2 + 1)``.
    """
    h, w = image_shape
    kh, kw = psf.shape
    if kh > h or kw > w:
        raise ValueError(f"PSF {psf.shape} larger than image {image_shape}")
    ch, cw = psf_center((kh, kw))
    padded = jnp.zeros((h, w), dtype=psf.dtype).at[:kh, :kw].set(psf)
    # Shift the center tap to the origin so the OTF carries no linear phase.
    padded = jnp.roll(padded, shift=(-ch, -cw), axis=(0, 1))
    return rfft2_exact(padded)


def rfft2_exact(x: jnp.ndarray, precision=None) -> jnp.ndarray:
    """Exact-grade ``rfft2`` for precompute: the native FFT, or — with the
    backend policy's ``precompute_fft_mxu`` — the DFT by matmul (HIGHEST
    by default, ~1e-6 relative of the fp32 FFT).  Callers on error budgets
    that tolerate ~1e-4 (the HIGH-ladder solve modes) pass
    ``precision=HIGH``.
    """
    import jax

    from admm_deconv.ops.policy import policy

    if not policy().precompute_fft_mxu:
        return jnp.fft.rfft2(x)
    from admm_deconv.ops.fft_mxu import rfft2_mxu

    re, im = rfft2_mxu(
        x, precision=precision or jax.lax.Precision.HIGHEST
    )
    return jax.lax.complex(re, im)


def irfft2_exact(c: jnp.ndarray, s: tuple[int, int], precision=None) -> jnp.ndarray:
    """Exact-grade ``irfft2`` twin of :func:`rfft2_exact`."""
    import jax

    from admm_deconv.ops.policy import policy

    if not policy().precompute_fft_mxu:
        return jnp.fft.irfft2(c, s=s)
    from admm_deconv.ops.fft_mxu import irfft2_mxu

    return irfft2_mxu(
        jnp.real(c), jnp.imag(c), s,
        precision=precision or jax.lax.Precision.HIGHEST,
    )


def laplacian_spectrum(
    image_shape: tuple[int, int], dtype=jnp.float32, full: bool = False
) -> jnp.ndarray:
    """``|Lambda_x|^2 + |Lambda_y|^2`` for circular backward differences.

    Closed form of the reference's ``abs2.(rfft(dx_filter)) .+
    abs2.(rfft(dy_filter))`` (``src/ops/ops.jl:32-37``) without building or
    FFT-ing full-size filter images.

    Returns:
      Real array of shape ``(H, W // 2 + 1)``, or ``(H, W)`` with
      ``full=True`` (all W bins, for full-C2C transform paths).
    """
    h, w = image_shape
    # rfft frequencies: rows are full DFT bins, cols only the first w//2+1.
    fy = np.sin(np.pi * np.arange(h) / h) ** 2
    wcols = np.arange(w) if full else np.arange(w // 2 + 1)
    fx = np.sin(np.pi * wcols / w) ** 2
    lap = 4.0 * (fy[:, None] + fx[None, :])
    return jnp.asarray(lap, dtype=dtype)


def psf_to_otf_full(psf: jnp.ndarray, image_shape: tuple[int, int]) -> jnp.ndarray:
    """Full-grid OTF (all W bins): ``fft2`` of the centered embedded PSF.

    The ``(H, W)`` counterpart of :func:`psf_to_otf` for full-C2C paths.
    """
    h, w = image_shape
    kh, kw = psf.shape
    if kh > h or kw > w:
        raise ValueError(f"PSF {psf.shape} larger than image {image_shape}")
    ch, cw = psf_center((kh, kw))
    padded = jnp.zeros((h, w), dtype=psf.dtype).at[:kh, :kw].set(psf)
    padded = jnp.roll(padded, shift=(-ch, -cw), axis=(0, 1))
    return jnp.fft.fft2(padded)
