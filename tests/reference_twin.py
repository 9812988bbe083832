"""Slow, loop/roll-based numpy re-derivation of the reference algorithm.

Used as an independent oracle in tests: mirrors the *semantics* of the Julia
reference (``src/ops/ops.jl:17-96``) — corner-anchored FFT denominator,
centered spatial circular H/H^T convs with ceil/floor pad split, roll-style
D/D^T, soft/block thresholding — implemented from the math, not translated.
Single-image (H, W), float64 for tight tolerances.
"""

from __future__ import annotations

import numpy as np


def circ_conv_centered(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Circular convolution with h's center tap at floor((k-1)/2)."""
    kh, kw = h.shape
    ch, cw = (kh - 1) // 2, (kw - 1) // 2
    out = np.zeros_like(x)
    for a in range(kh):
        for b in range(kw):
            out += h[a, b] * np.roll(x, (a - ch, b - cw), axis=(0, 1))
    return out


def circ_corr_centered(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Adjoint of circ_conv_centered (circular correlation)."""
    kh, kw = h.shape
    ch, cw = (kh - 1) // 2, (kw - 1) // 2
    out = np.zeros_like(x)
    for a in range(kh):
        for b in range(kw):
            out += h[a, b] * np.roll(x, (-(a - ch), -(b - cw)), axis=(0, 1))
    return out


def grad2d(x):
    return x - np.roll(x, 1, axis=1), x - np.roll(x, 1, axis=0)


def grad2d_adjoint(zx, zy):
    return (zx - np.roll(zx, -1, axis=1)) + (zy - np.roll(zy, -1, axis=0))


def soft(v, tau):
    return np.sign(v) * np.maximum(np.abs(v) - tau, 0.0)


def block(vx, vy, tau):
    r = np.sqrt(vx**2 + vy**2)
    scale = np.maximum(1.0 - tau / np.maximum(r, 1e-12), 0.0)
    return scale * vx, scale * vy


def hard(v, tau):
    return v * (np.abs(v) > tau)


def gauss(vx, vy, tau):
    scale = 0.5 - 0.5 * np.exp(-(vx**2 + vy**2) / (2.0 * tau**2))
    return scale * vx, scale * vy


def prox_pair(mode, vx, vy, tau):
    """The four threshold operators of ``src/ops/ops.jl:8-11`` on a pair."""
    if mode == "aniso":
        return soft(vx, tau), soft(vy, tau)
    if mode == "iso":
        return block(vx, vy, tau)
    if mode == "hard":
        return hard(vx, tau), hard(vy, tau)
    if mode == "gauss":
        return gauss(vx, vy, tau)
    raise ValueError(mode)


def admm_stencil(x, ux, uy, tau, mode="aniso"):
    """One plain-ADMM stencil section on one (H, W) plane:
    ``v = D x + u``, ``z = prox(v)``, ``u' = v - z``, ``q = D^T (z - u')``.
    Returns ``(q, u'x, u'y)``."""
    dxx, dxy = grad2d(x)
    vx, vy = dxx + ux, dxy + uy
    zx, zy = prox_pair(mode, vx, vy, tau)
    ux2, uy2 = vx - zx, vy - zy
    return grad2d_adjoint(zx - ux2, zy - uy2), ux2, uy2


def admm_tv_reference(y, psf=None, lam=0.1, rho=1.0, iters=50, isotropic=False):
    """Fixed-iteration ADMM exactly as the reference runs it (one image)."""
    m, n = y.shape
    tau = lam / rho

    # Denominator spectra from corner-anchored filters (ops.jl:25-37); the
    # squared magnitude is identical to the centered convention.
    if psf is None:
        denom_h = np.ones((m, n))
    else:
        hh = np.zeros((m, n))
        hh[: psf.shape[0], : psf.shape[1]] = psf
        denom_h = np.abs(np.fft.fft2(hh)) ** 2
    dxf = np.zeros((m, n))
    dxf[0, 0], dxf[0, 1] = 1.0, -1.0
    dyf = np.zeros((m, n))
    dyf[0, 0], dyf[1, 0] = 1.0, -1.0
    lap = np.abs(np.fft.fft2(dxf)) ** 2 + np.abs(np.fft.fft2(dyf)) ** 2
    C = 1.0 / (denom_h + rho * lap)

    if psf is None:
        hty = y.copy()
    else:
        hty = circ_corr_centered(y, psf)

    x = np.zeros((m, n))
    zx = np.zeros((m, n))
    zy = np.zeros((m, n))
    ux = np.zeros((m, n))
    uy = np.zeros((m, n))

    for _ in range(iters):
        rhs = hty + rho * grad2d_adjoint(zx - ux, zy - uy)
        x = np.real(np.fft.ifft2(C * np.fft.fft2(rhs)))
        dxx, dxy = grad2d(x)
        vx, vy = dxx + ux, dxy + uy
        if isotropic:
            zx, zy = block(vx, vy, tau)
        else:
            zx, zy = soft(vx, tau), soft(vy, tau)
        ux, uy = vx - zx, vy - zy

    return x
