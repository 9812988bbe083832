"""Proximal / shrinkage operator library for the ADMM z-update.

Covers the reference's four thresholding operators (``src/ops/ops.jl:8-11``):
soft (ST, anisotropic TV), block (BT, isotropic TV), hard (HT) and Gaussian
(GT), plus a box projection the reference lacks (BASELINE config 2).  All act
on the stacked gradient pair ``(vx, vy)`` and return ``(zx, zy)``.

Divergence from the reference (documented, deliberate): the reference's
``pixelnorm`` reduces over its combined batch+channel axes
(``src/ops/ops.jl:6``: ``sum(x.^2, dims=(3,4))`` on an ``(M,N,2B,P)``
tensor), coupling shrinkage across *all images and channels in the batch*.
Here the isotropic norm is the per-pixel, per-channel 2-norm of the
``(dx, dy)`` gradient vector — the textbook isotropic TV prox — so results
are batch-size invariant.

The fused z-update + dual-ascent step (``prox_dual_step``) is the memory-bound
hot elementwise section of the ADMM loop; the q-carry loops fuse it with the
difference stencils in ``admm_deconv.ops.stencil``.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

ProxFn = Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray]]

_EPS = 1e-12


def soft(vx: jnp.ndarray, vy: jnp.ndarray, tau) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Anisotropic (elementwise) soft-thresholding — reference ``ST``."""
    zx = jnp.sign(vx) * jnp.maximum(jnp.abs(vx) - tau, 0.0)
    zy = jnp.sign(vy) * jnp.maximum(jnp.abs(vy) - tau, 0.0)
    return zx, zy


def block(vx: jnp.ndarray, vy: jnp.ndarray, tau) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Isotropic block (group) soft-thresholding — reference ``BT``.

    Shrinks the per-pixel gradient magnitude ``r = sqrt(vx^2 + vy^2)``.
    """
    r = jnp.sqrt(vx * vx + vy * vy)
    scale = jnp.maximum(1.0 - tau / jnp.maximum(r, _EPS), 0.0)
    return scale * vx, scale * vy


def hard(vx: jnp.ndarray, vy: jnp.ndarray, tau) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Elementwise hard-thresholding — reference ``HT`` (never selected there)."""
    zx = vx * (jnp.abs(vx) > tau)
    zy = vy * (jnp.abs(vy) > tau)
    return zx, zy


def gauss(vx: jnp.ndarray, vy: jnp.ndarray, tau) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gaussian shrinkage on the gradient magnitude — reference ``GT``.

    ``scale = 0.5 - 0.5 * exp(-r^2 / (2 tau^2))`` (reference
    ``src/ops/ops.jl:11`` with the per-pixel norm convention above).
    """
    r2 = vx * vx + vy * vy
    scale = 0.5 - 0.5 * jnp.exp(-r2 / (2.0 * tau * tau))
    return scale * vx, scale * vy


PROX_FNS: dict[str, ProxFn] = {
    "aniso": soft,
    "soft": soft,
    "iso": block,
    "block": block,
    "hard": hard,
    "gauss": gauss,
}


def resolve(prox: str | ProxFn) -> ProxFn:
    """Look up a prox operator by name, or pass a callable through."""
    if callable(prox):
        return prox
    try:
        return PROX_FNS[prox]
    except KeyError:
        raise ValueError(
            f"Unknown prox {prox!r}; expected one of {sorted(PROX_FNS)} or a callable"
        ) from None


def prox_dual_step(
    dxx: jnp.ndarray,
    dxy: jnp.ndarray,
    ux: jnp.ndarray,
    uy: jnp.ndarray,
    tau,
    prox_fn: ProxFn,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused z-update + scaled dual ascent.

    Computes ``v = Dx + u``, ``z = prox(v, tau)``, ``u_new = v - z`` — one
    elementwise pass over the gradient-pair state, replacing the reference's
    separate broadcast kernels (``src/ops/ops.jl:89-91``).

    Returns ``(zx, zy, ux_new, uy_new)``.
    """
    vx = dxx + ux
    vy = dxy + uy
    zx, zy = prox_fn(vx, vy, tau)
    return zx, zy, vx - zx, vy - zy
