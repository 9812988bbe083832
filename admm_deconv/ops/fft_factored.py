"""Four-step (Cooley-Tukey) factored 2-D FFT by matmul, with plane packing.

The second-generation FFT path (after :mod:`admm_deconv.ops.fft_mxu`'s
full-DFT matmuls).  Two ideas:

1. **Four-step factorization.**  A length-``N = N1*N2`` DFT decomposes into
   an ``N1``-point DFT stage (a matmul with an ``N1 x N1`` matrix), a
   twiddle multiply, and an ``N2``-point DFT stage — O(N*(N1+N2)) FLOPs
   instead of O(N^2).  Factors are chosen matmul-friendly (the first factor
   >= 128 when the size allows, e.g. 1920 = 128*15, 1080 = 135*8), so the
   big contraction runs at high matrix-unit utilization.  The output
   bins come out in a permuted ``[k1, k2]`` block layout (global bin
   ``k = k2*N1 + k1``); rather than un-permuting, callers convert their
   cached spectra into this layout once (:func:`spectrum_to_layout`) — the
   solver's Wiener multiply is elementwise, so the order never matters.

2. **Complex plane packing.**  The solver's x-update multiplies the
   spectrum by a REAL array ``C``.  For real C, filtering two real planes
   packed as one complex plane ``z = a + i b`` is exact: ``IFFT(C * FFT(z))
   = filter(a) + i filter(b)``.  Packing halves the transform work versus
   per-plane rFFTs with none of rFFT's hermitian bookkeeping — and image
   batches here always carry many planes (channels ride the batch dim).

Complex arithmetic is expanded into real matmuls (split re/im).  All
transform matrices and twiddles are built host-side in float64 at trace
time and cached.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

Precision = jax.lax.Precision


def best_factorization(n: int) -> tuple[int, int] | None:
    """Pick ``(n1, n2)`` with ``n = n1*n2`` for the four-step transform.

    ``n1`` is the SMALL factor (cheap low-utilization stage-1 contraction),
    ``n2`` the LARGE one — preferred >= 128 so the expensive stage-2 batched
    GEMM contracts a full-MXU-width axis and, on the minor array axis, keeps
    >= 128 lanes busy.  Among n2 >= 128 choices the most balanced pair
    minimizes FLOPs.  ``None`` for primes / tiny sizes (caller falls back to
    a full DFT matmul for that axis).
    """
    if n < 16:
        return None
    divisors = [d for d in range(2, n) if n % d == 0]
    if not divisors:
        return None
    big = [d for d in divisors if d >= 128]
    if big:
        n2 = min(big)  # smallest >= 128 minimizes n1 + n2
        return n // n2, n2
    n1 = min(divisors, key=lambda d: d + n // d)
    n1 = min(n1, n // n1)
    return n1, n // n1


@functools.lru_cache(maxsize=64)
def _dft_mat(n: int, sign: int, dtype=np.float32):
    """(cos, sin) of the ``n x n`` DFT matrix ``exp(sign * 2i*pi*j*k/n)``."""
    j = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    ang = sign * 2.0 * np.pi * j * k / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=64)
def _twiddle(n1: int, n2: int, sign: int, dtype=np.float32):
    """(cos, sin) of ``exp(sign * 2i*pi * k1*n2' / (n1*n2))``, shape (n1, n2)."""
    k1 = np.arange(n1)[:, None].astype(np.float64)
    m2 = np.arange(n2)[None, :].astype(np.float64)
    ang = sign * 2.0 * np.pi * k1 * m2 / (n1 * n2)
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=64)
def _stage2_fwd(n1: int, n2: int, dtype=np.float32):
    """Twiddle-folded forward stage-2 tensor, shape ``(n1, n2, n2)``:
    ``E2T[k1, b, c] = exp(-2i*pi*k1*b/(n1*n2)) * exp(-2i*pi*b*c/n2)``."""
    k1 = np.arange(n1)[:, None, None].astype(np.float64)
    b = np.arange(n2)[None, :, None].astype(np.float64)
    c = np.arange(n2)[None, None, :].astype(np.float64)
    ang = -2.0 * np.pi * (k1 * b / (n1 * n2) + b * c / n2)
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=64)
def _stage2_inv(n1: int, n2: int, dtype=np.float32):
    """Twiddle-folded inverse stage-2 tensor, shape ``(n1, n2, n2)``:
    ``E2Tinv[k1, c, b] = exp(+2i*pi*b*c/n2) * exp(+2i*pi*k1*b/(n1*n2))``."""
    k1 = np.arange(n1)[:, None, None].astype(np.float64)
    c = np.arange(n2)[None, :, None].astype(np.float64)
    b = np.arange(n2)[None, None, :].astype(np.float64)
    ang = 2.0 * np.pi * (b * c / n2 + k1 * b / (n1 * n2))
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def _cmul(ar, ai, br, bi):
    """Complex multiply in split representation."""
    return ar * br - ai * bi, ar * bi + ai * br


def _cmm(ar, ai, eq, cr, ci, precision):
    """Complex matmul via 4 real einsums: (a) x (c) with einsum eq."""
    rr = jnp.einsum(eq, ar, cr, precision=precision)
    ri = jnp.einsum(eq, ar, ci, precision=precision)
    ir = jnp.einsum(eq, ai, cr, precision=precision)
    ii = jnp.einsum(eq, ai, ci, precision=precision)
    return rr - ii, ri + ir


def _axis_transform(zr, zi, axis_from_last: int, n: int, inverse: bool, precision):
    """C2C DFT along one axis (0 = last, 1 = second-to-last), four-step when
    the size factors, full DFT matmul otherwise.

    Forward leaves the axis in permuted bin order (global bin
    ``k = k2*n1 + k1`` stored at position ``k1*n2 + k2``); inverse consumes
    exactly that layout by reversing the stage chain with conjugated
    matrices, returning natural spatial order.  No 1/n scaling here.

    Layout discipline: the target axis is split IN PLACE with a free
    reshape (never transposed to the end); stage-1 contracts the small
    factor at full precision (its FLOPs are negligible), stage-2 is a
    twiddle-folded batched GEMM contracting the large (>=128) factor, so
    the expensive work runs at high MXU utilization and the minor array
    axis keeps >= 128 lanes.
    """
    if axis_from_last not in (0, 1):
        raise ValueError("axis_from_last must be 0 (last) or 1 (second-to-last)")
    fac = best_factorization(n)
    sign = 1 if inverse else -1
    last = axis_from_last == 0
    if fac is None:
        cr, ci = (jnp.asarray(m) for m in _dft_mat(n, sign))
        eq = "...n,nk->...k" if last else "...nw,nk->...kw"
        return _cmm(zr, zi, eq, cr, ci, precision)

    n1, n2 = fac
    if last:
        shape = zr.shape[:-1]
        zr = zr.reshape(*shape, n1, n2)
        zi = zi.reshape(*shape, n1, n2)
        eq1_fwd, eq2_fwd = "...ab,ak->...kb", "...kb,kbc->...kc"
        eq2_inv, eq1_inv = "...kc,kcb->...kb", "...kb,ak->...ab"
    else:
        w = zr.shape[-1]
        shape = zr.shape[:-2]
        zr = zr.reshape(*shape, n1, n2, w)
        zi = zi.reshape(*shape, n1, n2, w)
        eq1_fwd, eq2_fwd = "...abw,ak->...kbw", "...kbw,kbc->...kcw"
        eq2_inv, eq1_inv = "...kcw,kcb->...kbw", "...kbw,ak->...abw"

    e1r, e1i = (jnp.asarray(m) for m in _dft_mat(n1, sign))
    if not inverse:
        s2r, s2i = (jnp.asarray(m) for m in _stage2_fwd(n1, n2))
        # Stage 1: tiny contraction — run at HIGHEST, cost is negligible.
        zr, zi = _cmm(zr, zi, eq1_fwd, e1r, e1i, Precision.HIGHEST)
        zr, zi = _cmm(zr, zi, eq2_fwd, s2r, s2i, precision)
    else:
        s2r, s2i = (jnp.asarray(m) for m in _stage2_inv(n1, n2))
        zr, zi = _cmm(zr, zi, eq2_inv, s2r, s2i, precision)
        zr, zi = _cmm(zr, zi, eq1_inv, e1r, e1i, Precision.HIGHEST)

    if last:
        zr = zr.reshape(*shape, n)
        zi = zi.reshape(*shape, n)
    else:
        zr = zr.reshape(*shape, n, w)
        zi = zi.reshape(*shape, n, w)
    return zr, zi


def _axis_perm(n: int) -> np.ndarray:
    """Global-bin order produced by :func:`_axis_transform` along a size-n
    axis: position ``k1*n2 + k2`` holds global bin ``k2*n1 + k1``."""
    fac = best_factorization(n)
    if fac is None:
        return np.arange(n)
    n1, n2 = fac
    k1 = np.arange(n1)[:, None]
    k2 = np.arange(n2)[None, :]
    return (k2 * n1 + k1).reshape(n * 1)


def fft2_c2c(zr, zi, inverse: bool = False, precision=Precision.HIGH):
    """2-D C2C DFT over the last two axes in split re/im representation.

    Output bins are in the permuted layout of :func:`_axis_perm` per axis;
    the inverse consumes that same layout, so
    ``fft2_c2c(*fft2_c2c(zr, zi), inverse=True)`` is the identity (up to
    matmul rounding).  Use :func:`spectrum_to_layout` to convert standard
    ``fft2``-ordered spectra for elementwise work in this layout.
    """
    h, w = zr.shape[-2], zr.shape[-1]
    zr, zi = _axis_transform(zr, zi, 0, w, inverse, precision)
    zr, zi = _axis_transform(zr, zi, 1, h, inverse, precision)
    if inverse:
        scale = 1.0 / (h * w)
        zr = zr * scale
        zi = zi * scale
    return zr, zi


def spectrum_to_layout(spec: jnp.ndarray) -> jnp.ndarray:
    """Permute a standard-ordered full 2-D spectrum ``(..., H, W)`` into the
    internal bin layout of :func:`fft2_c2c` (inverse: the layouts are
    self-inverse only per-axis permutation — apply ``layout_to_spectrum``)."""
    h, w = spec.shape[-2], spec.shape[-1]
    ph = _axis_perm(h)
    pw = _axis_perm(w)
    return spec[..., ph, :][..., :, pw]


def pack_planes(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(N, H, W) real -> ((ceil(N/2), H, W) re, im): planes 2i / 2i+1 become
    the real / imaginary parts of one complex plane (zero-padded if N odd)."""
    n = x.shape[0]
    if n % 2:
        x = jnp.concatenate([x, jnp.zeros((1,) + x.shape[1:], x.dtype)], axis=0)
        n += 1
    pairs = x.reshape(n // 2, 2, *x.shape[1:])
    return pairs[:, 0], pairs[:, 1]


def unpack_planes(zr: jnp.ndarray, zi: jnp.ndarray, n: int) -> jnp.ndarray:
    """Inverse of :func:`pack_planes` back to ``(n, H, W)`` real planes."""
    stacked = jnp.stack([zr, zi], axis=1).reshape(-1, *zr.shape[1:])
    return stacked[:n]


def real_filter2d_packed(
    x: jnp.ndarray,
    c_layout: jnp.ndarray,
    precision=Precision.HIGH,
) -> jnp.ndarray:
    """Apply a real frequency-domain filter to a stack of real planes:
    ``irfft2(C * rfft2(x))`` computed as packed-complex four-step
    transforms.  ``c_layout`` is the full real spectrum already permuted by
    :func:`spectrum_to_layout`.
    """
    n = x.shape[0]
    zr, zi = pack_planes(x)
    zr, zi = fft2_c2c(zr, zi, inverse=False, precision=precision)
    zr = zr * c_layout
    zi = zi * c_layout
    zr, zi = fft2_c2c(zr, zi, inverse=True, precision=precision)
    return unpack_planes(zr, zi, n)
