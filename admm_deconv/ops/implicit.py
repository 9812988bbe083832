"""Implicit-function-theorem gradients through the ADMM fixed point.

The reference differentiates its solver only by Zygote reverse-mode through
the fully unrolled loop (``src/layers/deconv_admm.jl:221`` +
``src/train.jl:51-53``), paying O(iters) activation memory.  This module
adds the alternative the unrolled path can't offer: treat the converged
iterate as a fixed point ``s* = F(s*, theta)`` and differentiate with the
implicit function theorem —

    dx*/dtheta = dX/ds (I - dF/ds)^-1 dF/dtheta + dX/dtheta

with the inverse applied by a truncated Neumann series (the standard
deep-equilibrium adjoint):

    w_{k+1} = (dF/ds)^T w_k + (dX/ds)^T xbar ,   theta_bar = (dF/dtheta)^T w_K + (dX/dtheta)^T xbar

Properties vs the unrolled VJP:
  * O(1) memory — only the final state is saved for the backward pass
    (unroll stores or rematerializes all ``iters`` iterates);
  * backward cost is ``bwd_iters`` VJPs of ONE iteration, decoupled from the
    forward iteration count;
  * exact in the limit of forward convergence + Neumann convergence; for a
    loosely-converged forward it is an approximation (the unrolled gradient
    is then the "exact gradient of the approximate solver" instead).

ADMM's fixed-point map is nonexpansive rather than strictly contractive, so
the Neumann series is truncated at ``bwd_iters`` (practical DEQ-style
training does the same).  Gradient agreement with the unrolled path is
tested in ``tests/test_implicit.py``.

A mathematically expected divergence from the unrolled gradient: at the
exact fixed point the solution does not depend on the penalty ``rho`` at all
(ADMM converges to the same minimizer for any ``rho > 0``), so the implicit
``rho`` gradient is ~0 by construction, while the unrolled path reports the
finite-iteration sensitivity (how moving ``rho`` changes the iterate after
exactly ``iters`` steps).  Both are "correct" answers to different
questions; for learned-``rho`` layers (reference ``ADMMDeconvF2``-style
training) the unrolled gradient is the meaningful one — keep
``diff_mode="unroll"`` there.

State convention: the fixed point lives in ``s = (zx, zy, ux, uy)`` (the
split gradient pair and scaled duals, folded planes); the output image is
``x* = X(s*, theta)`` — one spectral solve.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from admm_deconv.ops import prox as prox_lib
from admm_deconv.ops.diff import grad2d, grad2d_adjoint
from admm_deconv.ops.solver import (
    _fold,
    _form_cspec,
    _normalize_input,
    _prepare,
    _prepare_delta,
    _solve_spectral,
    resolve_fft_mode,
    tv_deconvolve,
)


def _step(s, y, psf, lam, rho, prox_name, fft_mode, x_bounds):
    """One ADMM iteration as a pure function of (state, theta).

    Returns ``(s_next, x)`` — the image ``x`` is both the per-iteration
    primal update and, at the fixed point, the solver output.
    """
    zx, zy, ux, uy = s
    y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c) = _prepare(
        y, psf, lam, rho, fft_mode
    )
    tau = lam_f / rho_f
    if fft_mode == "fold1":
        # fold1's _solve_spectral consumes the delta-form precompute
        # (x_B + folded rho*C), not the plain c_spec.
        b_f, c_spec = _prepare_delta(b_f, denom_h, lap, rho_f, h, w)
    else:
        c_spec = _form_cspec(denom_h, lap, rho_f, fft_mode)
    q = grad2d_adjoint(zx - ux, zy - uy)
    x = _solve_spectral(b_f, c_spec, rho_f, q, h, w, fft_mode)
    if x_bounds is not None:
        x = jnp.clip(x, x_bounds[0], x_bounds[1])
    dxx, dxy = grad2d(x)
    zx, zy, ux, uy = prox_lib.prox_dual_step(
        dxx, dxy, ux, uy, tau, prox_lib.resolve(prox_name)
    )
    return (zx, zy, ux, uy), x


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8))
def _tv_deconvolve_implicit(y, psf, lam, rho, iters, prox, bwd_iters, fft_mode, x_bounds):
    x, _ = _fwd_run(y, psf, lam, rho, iters, prox, fft_mode, x_bounds)
    return x


def _fwd_run(y, psf, lam, rho, iters, prox, fft_mode, x_bounds):
    x, state = tv_deconvolve(
        y,
        psf=psf,
        lam=lam,
        rho=rho,
        iters=iters,
        prox=prox,
        x_bounds=x_bounds,
        fft_mode=fft_mode,
        return_state=True,
    )
    return x, (state.zx, state.zy, state.ux, state.uy)


def _fwd(y, psf, lam, rho, iters, prox, bwd_iters, fft_mode, x_bounds):
    x, s = _fwd_run(y, psf, lam, rho, iters, prox, fft_mode, x_bounds)
    return x, (s, y, psf, lam, rho)


@functools.partial(
    jax.jit,
    static_argnames=("prox", "bwd_iters", "fft_mode", "x_bounds"),
)
def _bwd_impl(s, y, psf, lam, rho, xbar, *, prox, bwd_iters, fft_mode, x_bounds):
    # Jitted so the Neumann adjoint never dispatches eagerly — users may call
    # ``jax.grad`` without an enclosing jit, and eager per-op execution of
    # the Neumann loop would launch every operation separately.
    y4, _ = _normalize_input(jnp.asarray(y))
    # The public output is the unfolded image; _step's x lives in the folded
    # (B*C, H, W) view, so the incoming cotangent is folded likewise (the
    # fold is a pure transpose/reshape — its adjoint is the fold itself).
    xbar_f = _fold(xbar.reshape(y4.shape))

    def G(s, y, psf, lam, rho):
        s_next, x = _step(s, y, psf, lam, rho, prox, fft_mode, x_bounds)
        return s_next, x

    _, vjp_G = jax.vjp(G, s, y, psf, lam, rho)

    def neumann_body(w, _):
        w_next = vjp_G((w, xbar_f))[0]
        return w_next, None

    w0 = jax.tree_util.tree_map(jnp.zeros_like, s)
    w, _ = jax.lax.scan(neumann_body, w0, None, length=bwd_iters)
    _, ybar, psfbar, lambar, rhobar = vjp_G((w, xbar_f))
    return ybar, psfbar, lambar, rhobar


def _bwd(iters, prox, bwd_iters, fft_mode, x_bounds, residuals, xbar):
    s, y, psf, lam, rho = residuals
    return _bwd_impl(
        s,
        y,
        psf,
        lam,
        rho,
        xbar,
        prox=prox,
        bwd_iters=bwd_iters,
        fft_mode=fft_mode,
        x_bounds=x_bounds,
    )


_tv_deconvolve_implicit.defvjp(_fwd, _bwd)


def tv_deconvolve_implicit(
    y: jnp.ndarray,
    psf: jnp.ndarray | None = None,
    lam=0.1,
    rho=1.0,
    iters: int = 100,
    prox: str = "aniso",
    bwd_iters: int = 30,
    fft_mode: str = "auto",
    x_bounds: tuple[float, float] | None = None,
):
    """ADMM TV deconvolution with implicit (fixed-point) differentiation.

    Forward is identical to :func:`tv_deconvolve`; backward applies the
    implicit function theorem at the converged state with a
    ``bwd_iters``-term Neumann adjoint instead of backpropagating through
    the unrolled loop.  Use when ``iters`` is large (memory) or when
    forward and backward depth should be decoupled.

    ``fft_mode="auto"`` (default) takes the backend policy's mode (see
    ``resolve_fft_mode``).

    Differentiable in ``y``, ``psf``, ``lam`` and ``rho``.
    """
    fft_mode = resolve_fft_mode(fft_mode)
    y = jnp.asarray(y)
    lam = jnp.asarray(lam, y.dtype)
    rho = jnp.asarray(rho, y.dtype)
    if psf is not None and getattr(psf, "size", 1) == 0:
        psf = None
    if psf is not None:
        psf = jnp.asarray(psf, y.dtype)
    if callable(prox):
        raise ValueError("implicit mode requires a named prox operator")
    return _tv_deconvolve_implicit(
        y, psf, lam, rho, iters, prox, bwd_iters, fft_mode, x_bounds
    )
