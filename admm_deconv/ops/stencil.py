"""The ADMM stencil section — D, prox, dual ascent, D^T — written once.

After each x-update, plain ADMM (``alpha = 1``) computes

    v   = D x + u                    (circular backward differences)
    z   = prox(v, tau)
    u'  = v - z                      (scaled dual ascent)
    q   = D^T (z - u')               (the next x-update's rhs)

and the next iterate depends on ``z`` only through ``q``, so the solvers'
fast loops carry ``(q, ux, uy)`` and ``z`` never reaches device memory.
:func:`stencil_step` is that composition, written once as
:func:`section` over shifted views of the inputs: in plain ``jnp`` (XLA
fuses it) and, on the GPU, as a Pallas-Triton kernel
(``ops/stencil_triton.py``) that reads each plane once.  Every q-carry loop
calls it: the fixed-iteration solver, the adaptive solver's mid-loop,
Anderson's inner loop, the composite prior (:func:`composite_stencil_step`)
and the tiled solvers (with ``halo``).

Arithmetic always runs in float32; results are stored in the carry dtype
(``ux.dtype``), so a bfloat16 carry halves the section's stored bytes
without bfloat16 arithmetic.  Differentiable by ordinary autodiff.

The reference runs this section as separate CUDA broadcast/conv kernels
(``src/ops/ops.jl:86-91``).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from admm_deconv.ops import prox as prox_lib
from admm_deconv.ops.policy import policy

_F32 = jnp.float32


def _plane_param(t):
    """A scalar stays a scalar; a per-plane ``(N,)`` vector broadcasts over
    ``(N, H, W)`` as ``(N, 1, 1)``; ``(N, 1, 1)`` passes through."""
    t = jnp.asarray(t, _F32)
    return t.reshape(-1, 1, 1) if t.ndim == 1 else t


def section(view, tau, prox_fn):
    """The stencil arithmetic, in float32, from shifted views of the inputs.

    ``view(name, dr, dc)`` returns ``name[i + dr, j + dc]`` (``name`` one of
    ``"x"``, ``"ux"``, ``"uy"``) as float32 over the output pixels.  ``q``
    needs ``w = z - u'`` at ``(i, j)``, ``(i, j+1)`` and ``(i+1, j)``; each
    is recomputed from the inputs instead of shifting a stored ``w``, so
    the section is elementwise in shifted views of ``x``, ``ux``, ``uy``
    and one pass can read each plane once.  Returns ``(q, ux', uy')``.
    """

    def v_at(dr, dc):
        """v = D x + u at pixel (i + dr, j + dc)."""
        xc = view("x", dr, dc)
        return (
            xc - view("x", dr, dc - 1) + view("ux", dr, dc),
            xc - view("x", dr - 1, dc) + view("uy", dr, dc),
        )

    vx, vy = v_at(0, 0)
    zx, zy = prox_fn(vx, vy, tau)
    ux_new, uy_new = vx - zx, vy - zy
    vxr, vyr = v_at(0, 1)
    zxr, _ = prox_fn(vxr, vyr, tau)
    vxd, vyd = v_at(1, 0)
    _, zyd = prox_fn(vxd, vyd, tau)
    q = ((zx - ux_new) - (2.0 * zxr - vxr)) + ((zy - uy_new) - (2.0 * zyd - vyd))
    return q, ux_new, uy_new


def _stencil_f32(x, ux, uy, tau, prox_fn, halo):
    """float32 ``(q, ux', uy')`` of the block ``x`` given its halo rows.

    ``halo = (x_top, x_bot, ux_bot, uy_bot)``, each ``(N, 1, W)``: the row
    above the first row of ``x`` and the rows below its last row; ``None``
    wraps around (the circular image).  The rows are joined to the block
    once; every row view is a slice of that, and column views are rolls.
    """
    if halo is None:
        halo = (x[:, -1:], x[:, :1], ux[:, :1], uy[:, :1])
    x_top, x_bot, ux_bot, uy_bot = halo
    x_ext = jnp.concatenate([x_top, x, x_bot], axis=-2).astype(_F32)
    ux_ext = jnp.concatenate([ux, ux_bot], axis=-2).astype(_F32)
    uy_ext = jnp.concatenate([uy, uy_bot], axis=-2).astype(_F32)
    rows = {
        "x": {-1: x_ext[:, :-2], 0: x_ext[:, 1:-1], 1: x_ext[:, 2:]},
        "ux": {0: ux_ext[:, :-1], 1: ux_ext[:, 1:]},
        "uy": {0: uy_ext[:, :-1], 1: uy_ext[:, 1:]},
    }

    def view(name, dr, dc):
        a = rows[name][dr]
        return jnp.roll(a, -dc, axis=-1) if dc else a

    return section(view, _plane_param(tau), prox_fn)


def _jnp_stencil_step(x, ux, uy, tau, prox, halo=None):
    """:func:`stencil_step` as plain jnp, left to XLA to fuse."""
    with jax.named_scope("admm/stencil"):
        q, ux2, uy2 = _stencil_f32(x, ux, uy, tau, prox_lib.resolve(prox), halo)
        cdt = ux.dtype
        return q.astype(cdt), ux2.astype(cdt), uy2.astype(cdt)


def stencil_step(
    x: jnp.ndarray,
    ux: jnp.ndarray,
    uy: jnp.ndarray,
    tau,
    prox: str | Callable = "aniso",
    halo: tuple | None = None,
):
    """One D -> prox -> dual -> D^T pass over ``(N, H, W)`` planes.

    Equal to::

        dxx, dxy = grad2d(x)
        zx, zy, ux2, uy2 = prox_dual_step(dxx, dxy, ux, uy, tau, prox)
        return grad2d_adjoint(zx - ux2, zy - uy2), ux2, uy2

    with float32 arithmetic and outputs in ``ux.dtype``.  ``tau`` is a
    scalar or per-plane ``(N,)`` / ``(N, 1, 1)``.  ``halo=None`` is the
    circular image; a tuple ``(x_top, x_bot, ux_bot, uy_bot)`` of
    ``(N, 1, W)`` rows replaces the H wrap (the tiled solver's neighbour
    rows).  Returns ``(q, ux', uy')``.

    Where the backend policy's ``stencil_kernel`` is set (the GPU), the
    circular image with a named prox runs the hand-written kernel of
    :mod:`admm_deconv.ops.stencil_triton` (same arithmetic); everything
    else runs the jnp expression, which XLA fuses.
    """
    if x.ndim != 3:
        raise ValueError(f"expected (N, H, W), got {x.shape}")
    if halo is None and isinstance(prox, str) and policy().stencil_kernel:
        from admm_deconv.ops.stencil_triton import stencil_step_triton

        with jax.named_scope("admm/stencil"):
            return stencil_step_triton(x, ux, uy, jnp.reshape(tau, (-1,)), prox)
    return _jnp_stencil_step(x, ux, uy, tau, prox, halo)


def composite_stencil_step(
    x, ux, uy, u2, tau_tv, tau_l1, ratio,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    halo: tuple | None = None,
):
    """The composite prior's (TV + L1 + box) whole non-FFT section: the TV
    stencil of :func:`stencil_step`, the identity split
    ``z2 = clip(soft(x + u2, tau_l1))`` with ``u2' = x + u2 - z2``, and the
    combined rhs ``q = D^T(z1 - u1') + ratio * (z2 - u2')``
    (``ops/composite.py``).  Returns ``(q, ux', uy', u2')`` in the carry
    dtype."""
    with jax.named_scope("admm/stencil"):
        q, ux2, uy2 = _stencil_f32(x, ux, uy, tau_tv, prox_lib.resolve(prox), halo)
        v2 = x.astype(_F32) + u2.astype(_F32)
        z2 = jnp.sign(v2) * jnp.maximum(jnp.abs(v2) - _plane_param(tau_l1), 0.0)
        if x_bounds is not None:
            z2 = jnp.clip(z2, x_bounds[0], x_bounds[1])
        u2_new = v2 - z2
        q = q + _plane_param(ratio) * (z2 - u2_new)
        cdt = ux.dtype
        return tuple(a.astype(cdt) for a in (q, ux2, uy2, u2_new))
