"""Matmul 2-D real FFT: DFTs as dense cos/sin matrix products.

A DFT is a matrix product, so this module implements ``rfft2``/``irfft2``
as batched real matmuls against precomputed cos/sin matrices, in split
re/im representation (no complex dtype anywhere; complex arithmetic is
expanded into real contractions).  These are the ``fft_mode`` values other
than ``"xla"`` (``ops/solver.py``).

Cost: O(H*W*(H+Wf)) FLOPs per image instead of O(H*W*log(H*W)) — a
FLOPs-for-bandwidth trade that pays only where the native FFT runs far
below memory bandwidth and the matrix units idle.  On the H100 cuFFT wins
(PERF.md), so the GPU policy never selects these modes.  Transform matrices
are built host-side in float64 at trace time (shapes are static) and live
as on-device constants.

Accuracy: matmul precision is configurable; the default ``HIGHEST``
matches the fp32 FFT to ~1e-6 relative; ``HIGH`` and ``DEFAULT`` are
faster with ~1e-4..1e-3 relative error (on the H100 both run in TF32).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

Precision = jax.lax.Precision


@functools.lru_cache(maxsize=32)
def _w_fwd(w: int, dtype=np.float32):
    """Real->complex forward matrices along W: (W, Wf) cos and -sin."""
    wf = w // 2 + 1
    n = np.arange(w)[:, None].astype(np.float64)
    k = np.arange(wf)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / w
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)


@functools.lru_cache(maxsize=32)
def _w_inv(w: int, dtype=np.float32):
    """Complex->real inverse matrices along W: (Wf, W) weighted cos / -sin.

    Hermitian reconstruction: x[n] = (1/W)(X[0] + 2 sum_mid Re[X e^{+i..}]
    + (-1)^n X[W/2]); the per-bin weight (1, 2, ..., 2, 1) and 1/W scale are
    folded into the matrices.
    """
    wf = w // 2 + 1
    k = np.arange(wf)[:, None].astype(np.float64)
    n = np.arange(w)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * n / w
    wt = np.full((wf, 1), 2.0)
    wt[0] = 1.0
    if w % 2 == 0:
        wt[-1] = 1.0
    a = (wt * np.cos(ang)) / w
    b = (-wt * np.sin(ang)) / w
    return a.astype(dtype), b.astype(dtype)


@functools.lru_cache(maxsize=32)
def _h_mats(h: int, dtype=np.float32):
    """Symmetric (H, H) cos/sin DFT matrices for the H axis."""
    n = np.arange(h)[:, None].astype(np.float64)
    k = np.arange(h)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / h
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


# Note on a rejected design: fusing the re/im planes into matmuls with a
# concatenated ~2*Wf minor axis cuts the op count from ~18 to ~10, but
# compiles very slowly at deep contractions; the separate-matmul
# formulation below is kept.


def rfft2_mxu(
    x: jnp.ndarray, precision=Precision.HIGHEST
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """2-D real-to-complex DFT over the last two axes via MXU matmuls.

    Returns the spectrum as a ``(re, im)`` pair of shape ``(..., H, W//2+1)``
    matching ``jnp.fft.rfft2``.
    """
    h, w = x.shape[-2], x.shape[-1]
    cw, sw = (jnp.asarray(m) for m in _w_fwd(w))
    ch, sh = (jnp.asarray(m) for m in _h_mats(h))
    # W direction (real input): 2 matmuls.
    re1 = jnp.einsum("...hw,wk->...hk", x, cw, precision=precision)
    im1 = jnp.einsum("...hw,wk->...hk", x, sw, precision=precision)
    # H direction (complex): e^{-i a}(r + i m) -> 4 matmuls.
    re2 = (
        jnp.einsum("...hk,hm->...mk", re1, ch, precision=precision)
        + jnp.einsum("...hk,hm->...mk", im1, sh, precision=precision)
    )
    im2 = (
        jnp.einsum("...hk,hm->...mk", im1, ch, precision=precision)
        - jnp.einsum("...hk,hm->...mk", re1, sh, precision=precision)
    )
    return re2, im2


def irfft2_mxu(
    re: jnp.ndarray,
    im: jnp.ndarray,
    s: tuple[int, int],
    precision=Precision.HIGHEST,
) -> jnp.ndarray:
    """Inverse of :func:`rfft2_mxu` back to a real array of spatial shape
    ``s`` (matches ``jnp.fft.irfft2`` for hermitian-consistent input)."""
    h, w = s
    ch, sh = (jnp.asarray(m) for m in _h_mats(h))
    aw, bw = (jnp.asarray(m) for m in _w_inv(w))
    inv_h = 1.0 / h
    # Inverse H (complex): e^{+i a}(r + i m), scaled by 1/H.
    ar = (
        jnp.einsum("...mk,mh->...hk", re, ch, precision=precision)
        - jnp.einsum("...mk,mh->...hk", im, sh, precision=precision)
    ) * inv_h
    ai = (
        jnp.einsum("...mk,mh->...hk", im, ch, precision=precision)
        + jnp.einsum("...mk,mh->...hk", re, sh, precision=precision)
    ) * inv_h
    # Inverse W (hermitian -> real): 2 matmuls, weights/scale folded in.
    return jnp.einsum("...hk,kw->...hw", ar, aw, precision=precision) + jnp.einsum(
        "...hk,kw->...hw", ai, bw, precision=precision
    )


# --------------------------------------------------------------------------
# Folded half-H representation.
#
# After the W-direction rFFT, the H-direction transform acts on two *real*
# arrays re1/im1, and the H-DFT of a real signal is Hermitian — only
# Hf = H//2+1 rows carry information.  Storing the spectrum as the two half
# Hermitian spectra
#
#     A = DFT_H(re1),  B = DFT_H(im1)      (full spectrum S = A + i B)
#
# halves the H-direction matmul FLOPs in BOTH directions (H x Hf matrices
# instead of H x H) at the same op count, and halves the size of every
# elementwise op in the spectral epilogue.  Multiplying S by a *real*
# denominator c (the ADMM normal-equation inverse) is closed over this
# representation via the even/odd split c = ce + co in the H index:
# ce*Hermitian stays Hermitian, co*Hermitian is anti-Hermitian =
# i*(Hermitian), and linearity folds all four products into exactly two
# Hermitian irfft_H arguments (see `spectral_scale_folded`).  Net per-image
# rfft2+scale+irfft2 cost: 4*H*W*(Hf+Wf) MACs — the symmetry-optimal dense
# DFT — vs 4*H*W*(H+Wf) for the unfolded path (~26% fewer at 1080p).
# --------------------------------------------------------------------------


def rfft2_mxu_folded(
    x: jnp.ndarray, precision=Precision.HIGHEST, out_dtype=None
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """2-D real DFT in the folded half-H representation.

    Returns ``(a_re, a_im, b_re, b_im)``, each ``(..., H//2+1, W//2+1)``:
    the Hermitian H-spectra of the real/imag parts of the W-direction rFFT.
    The full ``jnp.fft.rfft2`` spectrum is ``S[m] = A[m] + i*B[m]`` extended
    by ``A[H-m] = conj(A[m])``.

    ``out_dtype`` (e.g. bf16) narrows the STORAGE of the W-DFT intermediate
    and the returned spectra — numerically free at DEFAULT precision, where
    every consuming matmul casts its operands to bf16 anyway (the casts
    fuse into the producing matmuls' epilogues); the MXU still accumulates
    fp32.  Do not combine with the HIGH/HIGHEST ladders (they split fp32
    operands into bf16 pieces and need the fp32 inputs).
    """
    h, w = x.shape[-2], x.shape[-1]
    cw, sw = (jnp.asarray(m) for m in _w_fwd(w))
    chf, shf = (jnp.asarray(m) for m in _w_fwd(h))  # (H, Hf) cos / -sin
    re1 = jnp.einsum("...hw,wk->...hk", x, cw, precision=precision)
    im1 = jnp.einsum("...hw,wk->...hk", x, sw, precision=precision)
    if out_dtype is not None:
        re1, im1 = re1.astype(out_dtype), im1.astype(out_dtype)
    a_re = jnp.einsum("...hk,hm->...mk", re1, chf, precision=precision)
    a_im = jnp.einsum("...hk,hm->...mk", re1, shf, precision=precision)
    b_re = jnp.einsum("...hk,hm->...mk", im1, chf, precision=precision)
    b_im = jnp.einsum("...hk,hm->...mk", im1, shf, precision=precision)
    if out_dtype is not None:
        a_re, a_im, b_re, b_im = (
            t.astype(out_dtype) for t in (a_re, a_im, b_re, b_im)
        )
    return a_re, a_im, b_re, b_im


def irfft2_mxu_folded(
    pr_re: jnp.ndarray,
    pr_im: jnp.ndarray,
    pi_re: jnp.ndarray,
    pi_im: jnp.ndarray,
    s: tuple[int, int],
    precision=Precision.HIGHEST,
    inner_dtype=None,
) -> jnp.ndarray:
    """Inverse 2-D real DFT from two half-stored Hermitian H-arguments.

    ``(pr_re, pr_im)`` / ``(pi_re, pi_im)`` are the Hermitian half H-spectra
    whose inverse H-DFTs give the real/imag parts fed to the W-direction
    Hermitian-to-real inverse (see :func:`spectral_scale_folded` for how a
    real spectral multiply lands in this form).  Output spatial shape ``s``.
    ``inner_dtype`` narrows the H-inverse intermediate's storage (same
    rationale and DEFAULT-precision-only caveat as
    :func:`rfft2_mxu_folded`); the returned spatial array is always the
    matmuls' accumulation dtype (fp32).
    """
    h, w = s
    ah, bh = (jnp.asarray(m) for m in _w_inv(h))  # (Hf, H), weights folded
    aw, bw = (jnp.asarray(m) for m in _w_inv(w))
    ar = jnp.einsum("...mk,mh->...hk", pr_re, ah, precision=precision) + jnp.einsum(
        "...mk,mh->...hk", pr_im, bh, precision=precision
    )
    ai = jnp.einsum("...mk,mh->...hk", pi_re, ah, precision=precision) + jnp.einsum(
        "...mk,mh->...hk", pi_im, bh, precision=precision
    )
    if inner_dtype is not None:
        ar, ai = ar.astype(inner_dtype), ai.astype(inner_dtype)
    return jnp.einsum("...hk,kw->...hw", ar, aw, precision=precision) + jnp.einsum(
        "...hk,kw->...hw", ai, bw, precision=precision
    )


def fold_hermitian(
    spec: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fold a full ``rfft2`` spectrum ``(..., H, Wf)`` complex into the
    half-H ``(a_re, a_im, b_re, b_im)`` representation of
    :func:`rfft2_mxu_folded` (used to cache the rhs spectrum once)."""
    h = spec.shape[-2]
    hf = h // 2 + 1
    flip = jnp.roll(spec[..., ::-1, :], 1, axis=-2)  # index (H - m) % H
    a = 0.5 * (spec + jnp.conj(flip))
    b = -0.5j * (spec - jnp.conj(flip))
    a, b = a[..., :hf, :], b[..., :hf, :]
    return jnp.real(a), jnp.imag(a), jnp.real(b), jnp.imag(b)


def fold_even_odd(c: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Even/odd split of a real spectral multiplier along the H bin axis:
    ``ce[m] = (c[m] + c[(H-m)%H])/2``, ``co`` the odd half; both truncated
    to ``H//2+1`` rows."""
    h = c.shape[-2]
    hf = h // 2 + 1
    flip = jnp.roll(c[..., ::-1, :], 1, axis=-2)
    ce = 0.5 * (c + flip)
    co = 0.5 * (c - flip)
    return ce[..., :hf, :], co[..., :hf, :]


def spectral_scale_folded(
    folded: tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray],
    ce: jnp.ndarray,
    co: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Multiply a folded spectrum by a real multiplier ``c = ce + co``.

    Derivation: with ``S = A + iB`` (A, B Hermitian) and real ``c``,
    ``cS = ceA + coA + i(ceB + coB)``; ``ce*Hermitian`` is Hermitian and
    ``co*Hermitian = i*(Hermitian)``, so the inverse H-transform's complex
    input has real part ``irfft_H(ceA - (-i co B))`` and imaginary part
    ``irfft_H(-i co A + ce B)`` — two Hermitian half-arguments, returned
    here as ``(pr_re, pr_im, pi_re, pi_im)`` for :func:`irfft2_mxu_folded`.
    The ``co`` rows at m=0 and m=H/2 are identically zero, which keeps both
    arguments exactly Hermitian-consistent.
    """
    a_re, a_im, b_re, b_im = folded
    pr_re = ce * a_re - co * b_im
    pr_im = ce * a_im + co * b_re
    pi_re = co * a_im + ce * b_re
    pi_im = ce * b_im - co * a_re
    return pr_re, pr_im, pi_re, pi_im
