"""Composite-prior ADMM deconvolution: TV + L1 + box (two splittings).

BASELINE config 3 capability ("L1+TV composite prior") with no reference
counterpart: solve

    min_x  0.5*||H x - y||^2 + lam_tv*||D x||  + lam_l1*||x||_1
                                              (+ indicator of [lo, hi])

by ADMM with two split variables: ``z1 = D x`` (TV prox, as in the core
solver) and ``z2 = x`` (elementwise prox of ``lam_l1*|.|_1 + box``, which is
exactly ``clip(soft(v, lam_l1/rho2), lo, hi)``).  The x-update stays a
single closed-form rFFT division with denominator
``|Sigma|^2 + rho1*|Lambda|^2 + rho2`` — same 2 FFTs per iteration as the
pure-TV loop.

Returns the feasible/sparse iterate ``z2`` (it satisfies the box constraint
exactly and carries the L1 shrinkage); at convergence ``x == z2``.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from admm_deconv.ops import prox as prox_lib
from admm_deconv.ops.diff import grad2d, grad2d_adjoint
from admm_deconv.ops.solver import (
    _FFT_MODES,
    ADMMDiagnostics,
    _normalize_input,
    _prepare,
    _solve_spectral,
    _unfold,
    resolve_fft_mode,
)
from admm_deconv.ops.stencil import composite_stencil_step


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters", "prox", "x_bounds", "fft_mode", "remat", "state_dtype",
    ),
)
def composite_tv_deconvolve(
    y: jnp.ndarray,
    psf: jnp.ndarray | None = None,
    lam_tv=0.01,
    lam_l1=0.0,
    rho1=0.1,
    rho2=0.1,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    fft_mode: str = "auto",
    remat: bool = False,
    state_dtype: str | None = None,
):
    """ADMM with a TV + L1 + box composite prior (differentiable).

    Args:
      y: degraded image(s), NHWC (or 2-D/3-D variants).
      psf: blur kernel or None for denoising.
      lam_tv: TV weight; ``prox`` selects aniso/iso (as in the core solver).
      lam_l1: elementwise sparsity weight (0 disables shrinkage but keeps
        the projection split when ``x_bounds`` is given).
      rho1 / rho2: penalties of the gradient and identity splittings.
      x_bounds: exact box constraint enforced through the z2 prox.
      remat: rematerialize the loop body under autodiff.
      state_dtype: optional bf16 STORAGE for the loop carry
        ``(q, u1x, u1y, u2)`` — the composite twin of
        :func:`~admm_deconv.ops.solver.tv_deconvolve`'s ``state_dtype``
        (fp32 arithmetic; the carried planes are residual-scale, so bf16
        rounding stays difference-scale).

    The loop carries ``(q, u1x, u1y, u2)``: the whole non-FFT section (TV
    stencil, identity-split prox, combined rhs) is one
    :func:`~admm_deconv.ops.stencil.composite_stencil_step`, and neither
    split variable is stored.  Differentiable.

    Returns the restored image(s) (the feasible ``z2`` iterate).
    """
    fft_mode = resolve_fft_mode(fft_mode)
    if fft_mode not in _FFT_MODES:
        raise ValueError(f"fft_mode must be one of {_FFT_MODES}, got {fft_mode!r}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    y = jnp.asarray(y)
    _, orig_shape = _normalize_input(y)
    y_f, b_f, denom_h, lap, lam_f, rho1_f, (b, h, w, c) = _prepare(
        y, psf, lam_tv, rho1, fft_mode
    )
    rho2_f = jnp.asarray(rho2, y_f.dtype)
    tau_tv = lam_f / rho1_f
    tau_l1 = jnp.asarray(lam_l1, y_f.dtype) / rho2_f
    # Identity-split penalty adds rho2 to the Wiener denominator.
    c_spec = 1.0 / (denom_h + rho1_f * lap + rho2_f)
    if fft_mode in ("fold", "fold_precise"):
        from admm_deconv.ops.fft_mxu import fold_even_odd

        c_spec = fold_even_odd(c_spec)
    elif fft_mode == "fold1":
        # Delta-form precompute (ops/solver.py fold1): x_B once exactly,
        # rho1*C folded for the DEFAULT-precision loop matmuls — valid since both
        # penalties are fixed for the whole solve.
        from admm_deconv.ops.fft_mxu import fold_even_odd
        from admm_deconv.ops.solver import _delta_hoist_irfft2

        x_b = _delta_hoist_irfft2(c_spec * b_f, h, w)
        c_spec = fold_even_odd(rho1_f * c_spec)
        b_f = x_b

    n = b * c
    sdt = jnp.dtype(state_dtype) if state_dtype is not None else y_f.dtype
    z0 = jnp.zeros((n, h, w), dtype=sdt)
    ratio = rho2_f / rho1_f

    def body(carry, _):
        # x-update solves (H^T H + rho1 D^T D + rho2 I) x =
        #   H^T y + rho1 D^T(z1-u1) + rho2 (z2-u2); the identity term rides
        # the carried q as rho1*q = rho1*D^T(...) + rho2*(z2-u2).
        q, ux, uy, u2 = carry
        x = _solve_spectral(b_f, c_spec, rho1_f, q, h, w, fft_mode)
        return composite_stencil_step(
            x, ux, uy, u2, tau_tv, tau_l1, ratio, prox, x_bounds
        ), None

    if remat:
        body = jax.checkpoint(body)

    (q_fin, _, _, u2_fin), _ = jax.lax.scan(
        body, (z0, z0, z0, z0), None, length=iters - 1
    )
    # fold1: the post-loop solve producing the output runs at HIGH.
    final_prec = jax.lax.Precision.HIGH if fft_mode == "fold1" else None
    x = _solve_spectral(
        b_f, c_spec, rho1_f, q_fin, h, w, fft_mode, precision=final_prec
    )
    v = x + u2_fin.astype(x.dtype)
    z2 = jnp.sign(v) * jnp.maximum(jnp.abs(v) - tau_l1, 0.0)
    if x_bounds is not None:
        z2 = jnp.clip(z2, x_bounds[0], x_bounds[1])
    return _unfold(z2, b, c).reshape(orig_shape)


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iters", "prox", "x_bounds", "adapt_rho", "fft_mode",
    ),
)
def composite_tv_deconvolve_adaptive(
    y: jnp.ndarray,
    psf: jnp.ndarray | None = None,
    lam_tv=0.01,
    lam_l1=0.0,
    rho1=0.1,
    rho2=0.1,
    max_iters: int = 200,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    adapt_rho: bool = True,
    mu: float = 10.0,
    tau_scale: float = 2.0,
    fft_mode: str = "auto",
):
    """Composite-prior ADMM with residual balancing and early stopping.

    The two-split analogue of :func:`~admm_deconv.ops.solver.
    tv_deconvolve_adaptive`: Boyd-style stopping on the STACKED primal
    residual ``(D x - z1, x - z2)`` and dual residual
    ``rho1 D^T(z1 - z1') + rho2 (z2 - z2')``, with penalty adaptation
    scaling BOTH rhos by a common per-image factor (their ratio is part of
    the splitting geometry and is preserved; both scaled duals are rescaled
    accordingly).  ``C`` is re-formed from the cached spectra per iteration.

    ``fft_mode='fold1'`` is rejected (its x_B hoist needs fixed penalties) —
    use 'fold'; the 'pack' modes are rejected for the same per-image-rho
    reason as in the core solver.

    Returns ``(z2, ADMMDiagnostics)`` — the feasible iterate plus the true
    final residual norms, iteration count, and per-image final ``rho1``
    (``rho2 = rho1 * rho2_0/rho1_0``).
    """
    fft_mode = resolve_fft_mode(fft_mode, adaptive=True)
    if fft_mode not in _FFT_MODES:
        raise ValueError(f"fft_mode must be one of {_FFT_MODES}, got {fft_mode!r}")
    if fft_mode == "fold1":
        raise ValueError(
            "fft_mode='fold1' hoists x_B out of the loop, which requires the "
            "penalties fixed for the whole solve; use 'fold' here"
        )
    if fft_mode in ("pack", "pack_precise"):
        raise ValueError(
            "fft_mode='pack' requires a scalar rho; the adaptive composite "
            "solver re-balances per-image rho — use 'mxu' or 'fold'"
        )
    tv_prox = prox_lib.resolve(prox)
    y = jnp.asarray(y)
    _, orig_shape = _normalize_input(y)
    y_f, b_f, denom_h, lap, lam_f, rho1_f, (b, h, w, c) = _prepare(
        y, psf, lam_tv, rho1, fft_mode
    )
    n = b * c
    rho2_f = jnp.asarray(rho2, y_f.dtype)
    ratio0 = jnp.broadcast_to(rho2_f / rho1_f, jnp.broadcast_shapes(
        jnp.shape(rho2_f), jnp.shape(rho1_f)
    ))
    lam_l1_f = jnp.asarray(lam_l1, y_f.dtype)
    lo, hi = (None, None) if x_bounds is None else x_bounds

    rho1_0 = jnp.ones((n, 1, 1), y_f.dtype) * rho1_f
    lam0 = jnp.ones((n, 1, 1), y_f.dtype) * lam_f
    ratio = jnp.ones((n, 1, 1), y_f.dtype) * ratio0
    zeros = jnp.zeros((n, h, w), y_f.dtype)
    # A = [D; I] maps the image into 3 planes (2 gradient + 1 identity).
    sqrt_pri = jnp.sqrt(jnp.asarray(3.0 * h * w, y_f.dtype))
    sqrt_dual = jnp.sqrt(jnp.asarray(1.0 * h * w, y_f.dtype))

    def cond(carry):
        _s, _rho, it, done, _r, _sn = carry
        return jnp.logical_and(it < max_iters, jnp.logical_not(jnp.all(done)))

    def body(carry):
        (z1x, z1y, u1x, u1y, z2, u2), rho1_cur, it, _done, _r, _sn = carry
        rho2_cur = ratio * rho1_cur
        tau_tv = lam0 / rho1_cur
        tau_l1 = lam_l1_f / rho2_cur
        c_spec = 1.0 / (denom_h + rho1_cur * lap + rho2_cur)
        if fft_mode in ("fold", "fold_precise"):
            from admm_deconv.ops.fft_mxu import fold_even_odd

            c_spec = fold_even_odd(c_spec)
        q = grad2d_adjoint(z1x - u1x, z1y - u1y) + ratio * (z2 - u2)
        x = _solve_spectral(b_f, c_spec, rho1_cur, q, h, w, fft_mode)
        dxx, dxy = grad2d(x)
        z1x_n, z1y_n, u1x_n, u1y_n = prox_lib.prox_dual_step(
            dxx, dxy, u1x, u1y, tau_tv, tv_prox
        )
        v = x + u2
        z2_n = jnp.sign(v) * jnp.maximum(jnp.abs(v) - tau_l1, 0.0)
        if x_bounds is not None:
            z2_n = jnp.clip(z2_n, lo, hi)
        u2_n = v - z2_n

        # Stacked primal residual over both splittings.
        r_norm = jnp.sqrt(
            jnp.sum(
                (dxx - z1x_n) ** 2 + (dxy - z1y_n) ** 2, axis=(-2, -1)
            )
            + jnp.sum((x - z2_n) ** 2, axis=(-2, -1))
        )
        # Dual residual: rho1 D^T dz1 + rho2 dz2 land in the SAME image
        # space, so they sum before the norm.
        dz = rho1_cur * grad2d_adjoint(z1x_n - z1x, z1y_n - z1y) + rho2_cur * (
            z2_n - z2
        )
        s_norm = jnp.sqrt(jnp.sum(dz * dz, axis=(-2, -1)))

        ax_norm = jnp.sqrt(
            jnp.sum(dxx * dxx + dxy * dxy, axis=(-2, -1))
            + jnp.sum(x * x, axis=(-2, -1))
        )
        z_norm = jnp.sqrt(
            jnp.sum(z1x_n**2 + z1y_n**2, axis=(-2, -1))
            + jnp.sum(z2_n**2, axis=(-2, -1))
        )
        dual = rho1_cur * grad2d_adjoint(u1x_n, u1y_n) + rho2_cur * u2_n
        dual_norm = jnp.sqrt(jnp.sum(dual * dual, axis=(-2, -1)))

        eps_pri = sqrt_pri * eps_abs + eps_rel * jnp.maximum(ax_norm, z_norm)
        eps_dual = sqrt_dual * eps_abs + eps_rel * dual_norm
        done = jnp.logical_and(r_norm <= eps_pri, s_norm <= eps_dual)

        if adapt_rho:
            grow = r_norm > mu * s_norm
            shrink = s_norm > mu * r_norm
            factor = jnp.where(
                grow, tau_scale, jnp.where(shrink, 1.0 / tau_scale, 1.0)
            )
            factor = jnp.where(done, 1.0, factor)[:, None, None]
            rho1_new = rho1_cur * factor
            u1x_n = u1x_n / factor
            u1y_n = u1y_n / factor
            u2_n = u2_n / factor
        else:
            rho1_new = rho1_cur

        return (
            (z1x_n, z1y_n, u1x_n, u1y_n, z2_n, u2_n),
            rho1_new,
            it + 1,
            done,
            r_norm,
            s_norm,
        )

    norms0 = jnp.full((n,), jnp.inf, y_f.dtype)
    init = (
        (zeros, zeros, zeros, zeros, zeros, zeros),
        rho1_0,
        jnp.asarray(0),
        jnp.zeros((n,), bool),
        norms0,
        norms0,
    )
    (state, rho1_fin, it, _done, r_norm, s_norm) = jax.lax.while_loop(
        cond, body, init
    )
    z2 = state[4]
    diags = ADMMDiagnostics(
        r_norm=r_norm,
        s_norm=s_norm,
        iterations=it,
        rho=rho1_fin[:, 0, 0],
    )
    return _unfold(z2, b, c).reshape(orig_shape), diags
