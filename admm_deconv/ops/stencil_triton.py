"""The stencil section as one hand-written GPU kernel (Pallas, Triton route).

Same arithmetic as :func:`admm_deconv.ops.stencil.stencil_step` — the
shared :func:`~admm_deconv.ops.stencil.section` — on the circular image:
one program per (plane, row block, column block) of power-of-two size,
with the shifted views read by overlapping, wrapped loads, so each input
plane crosses device memory once and nothing is carried between programs.
The backward pass is the plain ``jnp`` stencil's VJP.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from admm_deconv.ops import prox as prox_lib
from admm_deconv.ops.stencil import _jnp_stencil_step, section

_F32 = jnp.float32


def _kernel(tau_ref, x_ref, ux_ref, uy_ref, q_ref, uxo_ref, uyo_ref, *,
            h, w, bm, bn, mode):
    p = pl.program_id(0)
    rows = pl.program_id(1) * bm + jnp.arange(bm)
    cols = pl.program_id(2) * bn + jnp.arange(bn)
    mask = (rows < h)[:, None] & (cols < w)[None, :]
    refs = {"x": x_ref, "ux": ux_ref, "uy": uy_ref}

    def view(name, dr, dc):
        r = (rows + (dr + h)) % h
        c = (cols + (dc + w)) % w
        return plgpu.load(
            refs[name].at[p, r[:, None], c[None, :]], mask=mask, other=0.0
        ).astype(_F32)

    tau = plgpu.load(tau_ref.at[p])
    q, ux_new, uy_new = section(view, tau, prox_lib.resolve(mode))
    out = (p, rows[:, None], cols[None, :])
    plgpu.store(q_ref.at[out], q.astype(q_ref.dtype), mask=mask)
    plgpu.store(uxo_ref.at[out], ux_new.astype(uxo_ref.dtype), mask=mask)
    plgpu.store(uyo_ref.at[out], uy_new.astype(uyo_ref.dtype), mask=mask)


def _forward(x, ux, uy, tau, mode, bm, bn, num_warps, interpret):
    n, h, w = x.shape
    tau_n = jnp.broadcast_to(jnp.asarray(tau, _F32).reshape(-1), (n,))
    out = jax.ShapeDtypeStruct((n, h, w), ux.dtype)
    return pl.pallas_call(
        functools.partial(_kernel, h=h, w=w, bm=bm, bn=bn, mode=mode),
        out_shape=(out, out, out),
        grid=(n, pl.cdiv(h, bm), pl.cdiv(w, bn)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="admm_stencil",
    )(tau_n, x, ux, uy)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8))
def stencil_step_triton(x, ux, uy, tau, mode="aniso", bm=16, bn=128,
                        num_warps=4, interpret=False):
    """Kernel twin of :func:`~admm_deconv.ops.stencil.stencil_step` on the
    circular image: ``(q, ux', uy')`` in ``ux.dtype``.  ``tau`` is a scalar
    or per-plane ``(N,)``.  ``interpret=True`` runs the kernel in the Pallas
    interpreter (tests on the CPU)."""
    return _forward(x, ux, uy, tau, mode, bm, bn, num_warps, interpret)


def _fwd(x, ux, uy, tau, mode, bm, bn, num_warps, interpret):
    out = _forward(x, ux, uy, tau, mode, bm, bn, num_warps, interpret)
    return out, (x, ux, uy, tau)


def _bwd(mode, bm, bn, num_warps, interpret, res, cts):
    x, ux, uy, tau = res
    _, vjp = jax.vjp(lambda *a: _jnp_stencil_step(*a, mode), x, ux, uy, tau)
    return vjp(cts)


stencil_step_triton.defvjp(_fwd, _bwd)
