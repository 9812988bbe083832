"""Spatially-tiled ADMM deconvolution across a device mesh (exact).

BASELINE config 5 capability: a single frame too large (or too numerous) for
one chip is sharded along its H axis over a ``tile`` mesh axis — and, for
multi-frame 4K batches, simultaneously along the batch axis over a ``data``
mesh axis (2-D ``data x tile`` mesh).  The per-iteration pipeline runs fully
distributed:

* **x-update** — an *exact* distributed rFFT2 by transpose decomposition:
  local rFFT along the (unsharded) W axis, an ``all_to_all`` that re-shards
  from H-tiles to frequency-column groups, a local full-length FFT along H,
  the Wiener-type elementwise solve against column-sharded cached spectra,
  then the inverse path.  Two ``all_to_all`` collectives per iteration.  (SURVEY.md §7 lists distributed 2-D rFFT as the hard part;
  the transpose method avoids any halo/overlap approximation.)
* **D / D^T stencils** — circular 1-pixel halo exchange between neighbor
  tiles via ``ppermute`` (the tile partition is circular, matching the
  operators' circular boundary).
* **residual norms** — per-image, ``psum``'d over the tile axis, so rho
  adaptation and stopping decisions are *shared* across tiles (consensus),
  identical to the single-chip solve.

Feature parity with the single-chip solver (``ops/solver.py``, the contract
``tests/test_parallel.py`` checks against): per-image ``lam``/``rho``,
Boyd-style early stopping (``lax.while_loop`` on the psum'd residuals),
warm start via ``init_state`` + ``return_state``, and returned
:class:`~admm_deconv.ops.solver.ADMMDiagnostics`.

The result is numerically identical to :func:`admm_deconv.ops.solver.
tv_deconvolve` / ``tv_deconvolve_adaptive`` on the gathered image (up to FFT
rounding).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from admm_deconv.ops import prox as prox_lib
from admm_deconv.ops.fft import laplacian_spectrum, psf_to_otf
from admm_deconv.ops.fft_mxu import (
    _w_fwd,
    _w_inv,
    fold_even_odd,
    fold_hermitian,
    spectral_scale_folded,
)
from admm_deconv.ops.solver import (
    ADMMDiagnostics,
    ADMMState,
    _make_prox_step,
    resolve_fft_mode,
)
from admm_deconv.ops.stencil import composite_stencil_step, stencil_step


def _roll_p1_h(x, axis_name):
    """Global circular roll(+1) along the sharded H axis (row i-1)."""
    n = jax.lax.axis_size(axis_name)
    last = x[:, -1:, :]
    perm = [(i, (i + 1) % n) for i in range(n)]
    prev_last = jax.lax.ppermute(last, axis_name, perm)
    return jnp.concatenate([prev_last, x[:, :-1, :]], axis=1)


def _roll_m1_h(x, axis_name):
    """Global circular roll(-1) along the sharded H axis (row i+1)."""
    n = jax.lax.axis_size(axis_name)
    first = x[:, :1, :]
    perm = [(i, (i - 1) % n) for i in range(n)]
    next_first = jax.lax.ppermute(first, axis_name, perm)
    return jnp.concatenate([x[:, 1:, :], next_first], axis=1)


def _grad2d_tiled(x, axis_name):
    dx = x - jnp.roll(x, 1, axis=-1)  # W unsharded: local roll
    dy = x - _roll_p1_h(x, axis_name)
    return dx, dy


def _grad2d_adjoint_tiled(zx, zy, axis_name):
    return (zx - jnp.roll(zx, -1, axis=-1)) + (zy - _roll_m1_h(zy, axis_name))


def _halo_exchange(x, ux, uy, axis_name):
    """Fetch :func:`~admm_deconv.ops.stencil.stencil_step`'s neighbour-tile
    rows ``(x_top, x_bot, ux_bot, uy_bot)``: the previous tile's last x row
    and the next tile's first (x, ux, uy) rows — two ``ppermute``s (the
    three 'below' rows ride one collective)."""
    n_dev = jax.lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    x_top = jax.lax.ppermute(x[:, -1:, :], axis_name, fwd)
    below = jax.lax.ppermute(
        jnp.concatenate([x[:, :1, :], ux[:, :1, :], uy[:, :1, :]], axis=1),
        axis_name,
        bwd,
    )
    return x_top, below[:, 0:1], below[:, 1:2], below[:, 2:3]


def _dist_rfft2(q, axis_name, wp):
    """H-tiled (N, Ht, W) real -> column-sharded (N, H, Wp/T) complex."""
    if q.dtype not in (jnp.float32, jnp.float64):
        q = q.astype(jnp.float32)  # XLA's RFFT rejects the bf16 carry
    qf = jnp.fft.rfft(q, axis=-1)
    wf = qf.shape[-1]
    qf = jnp.pad(qf, ((0, 0), (0, 0), (0, wp - wf)))
    # Re-shard: split the padded frequency columns over devices, gather H.
    cols = jax.lax.all_to_all(qf, axis_name, split_axis=2, concat_axis=1, tiled=True)
    return jnp.fft.fft(cols, axis=-2)


def _dist_irfft2(xhat_cols, axis_name, w, wf):
    """Inverse of :func:`_dist_rfft2`: back to H-tiled real (N, Ht, W)."""
    cols = jnp.fft.ifft(xhat_cols, axis=-2)
    qf = jax.lax.all_to_all(cols, axis_name, split_axis=1, concat_axis=2, tiled=True)
    qf = qf[:, :, :wf]
    return jnp.fft.irfft(qf, n=w, axis=-1)


def _dist_rfft2_fold(q, axis_name, wp, prec, out_dtype=None):
    """Folded matmul variant of :func:`_dist_rfft2` (the multi-device
    analogue of the single-device ``fft_mode="fold"`` path,
    `ops/fft_mxu.py`).

    Local W-direction rFFT as 2 matmuls, then the tile re-shard, then the
    half-H Hermitian DFT of the two real intermediates as 4 half-height
    matmuls.  On a real mesh (T > 1) the re/im pair is stacked on a plane
    axis and rides ONE ``all_to_all`` — same bytes as two, half the
    per-iteration collective dispatches.  At T = 1 the all_to_alls are
    self-sends, so the stack copy would be pure overhead and the unpacked
    form is kept there.  Returns the column-sharded folded spectrum
    ``(a_re, a_im, b_re, b_im)``, each ``(N, Hf, Wp/T)``.
    """
    t = jax.lax.axis_size(axis_name)
    h = q.shape[1] * t
    w = q.shape[-1]
    cw, sw = (jnp.asarray(m) for m in _w_fwd(w))
    chf, shf = (jnp.asarray(m) for m in _w_fwd(h))
    re1 = jnp.einsum("nhw,wk->nhk", q, cw, precision=prec)
    im1 = jnp.einsum("nhw,wk->nhk", q, sw, precision=prec)
    if out_dtype is not None:
        # Narrow intermediate storage (see fft_mxu.rfft2_mxu_folded): also
        # HALVES the re-shard collective's bytes on real meshes.
        re1, im1 = re1.astype(out_dtype), im1.astype(out_dtype)
    wf = re1.shape[-1]
    if t > 1:
        pk = jnp.stack([re1, im1], axis=1)  # (N, 2, Ht, Wf)
        if wp != wf:
            pk = jnp.pad(pk, ((0, 0), (0, 0), (0, 0), (0, wp - wf)))
        pk = jax.lax.all_to_all(
            pk, axis_name, split_axis=3, concat_axis=2, tiled=True
        )  # (N, 2, H, Wp/T)
        re1, im1 = pk[:, 0], pk[:, 1]
    else:
        pad = ((0, 0), (0, 0), (0, wp - wf))
        re1 = jax.lax.all_to_all(
            jnp.pad(re1, pad), axis_name, split_axis=2, concat_axis=1,
            tiled=True,
        )
        im1 = jax.lax.all_to_all(
            jnp.pad(im1, pad), axis_name, split_axis=2, concat_axis=1,
            tiled=True,
        )
    a_re = jnp.einsum("nhk,hm->nmk", re1, chf, precision=prec)
    a_im = jnp.einsum("nhk,hm->nmk", re1, shf, precision=prec)
    b_re = jnp.einsum("nhk,hm->nmk", im1, chf, precision=prec)
    b_im = jnp.einsum("nhk,hm->nmk", im1, shf, precision=prec)
    if out_dtype is not None:
        a_re, a_im, b_re, b_im = (
            v.astype(out_dtype) for v in (a_re, a_im, b_re, b_im)
        )
    return a_re, a_im, b_re, b_im


def _dist_irfft2_fold(pr_re, pr_im, pi_re, pi_im, axis_name, h, w, wf, prec,
                      inner_dtype=None):
    """Inverse of :func:`_dist_rfft2_fold` from the two half-stored Hermitian
    H-arguments (see ``spectral_scale_folded``) back to H-tiled real.  The
    two real H-inverse intermediates ride ONE ``all_to_all`` back to the
    H-tiled layout when T > 1 (same packing rationale — and same T = 1
    exception — as the forward)."""
    ah, bh = (jnp.asarray(m) for m in _w_inv(h))
    aw, bw = (jnp.asarray(m) for m in _w_inv(w))
    ar = jnp.einsum("nmk,mh->nhk", pr_re, ah, precision=prec) + jnp.einsum(
        "nmk,mh->nhk", pr_im, bh, precision=prec
    )
    ai = jnp.einsum("nmk,mh->nhk", pi_re, ah, precision=prec) + jnp.einsum(
        "nmk,mh->nhk", pi_im, bh, precision=prec
    )
    if inner_dtype is not None:
        ar, ai = ar.astype(inner_dtype), ai.astype(inner_dtype)
    if jax.lax.axis_size(axis_name) > 1:
        pk = jnp.stack([ar, ai], axis=1)  # (N, 2, H, Wp/T)
        pk = jax.lax.all_to_all(
            pk, axis_name, split_axis=2, concat_axis=3, tiled=True
        )  # (N, 2, Ht, Wp)
        # Drop the padded (possibly non-finite) frequency columns BEFORE
        # the column-contracting W-inverse matmul.
        ar, ai = pk[:, 0, :, :wf], pk[:, 1, :, :wf]
    else:
        ar = jax.lax.all_to_all(
            ar, axis_name, split_axis=1, concat_axis=2, tiled=True
        )[:, :, :wf]
        ai = jax.lax.all_to_all(
            ai, axis_name, split_axis=1, concat_axis=2, tiled=True
        )[:, :, :wf]
    return jnp.einsum("nhk,kw->nhw", ar, aw, precision=prec) + jnp.einsum(
        "nhk,kw->nhw", ai, bw, precision=prec
    )


def _col_slice(arr, axis_name, wp):
    """Slice this device's frequency-column group out of a full-width array
    (zero-padding the tail columns)."""
    t = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    wf = arr.shape[-1]
    arr = jnp.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, wp - wf)])
    per = wp // t
    return jax.lax.dynamic_slice_in_dim(arr, idx * per, per, axis=-1)


def _make_x_from_q(
    y_tile, lap_full, otf_full, rho_l, axis_name, wp, h, w, wf,
    fft_mode, prec, has_psf, x_bounds, rho2_l=0.0,
):
    """Per-tile spectral precompute (column-sharded cached spectra; the
    fold1 delta-form x_B/rho*C hoist uses ``rho_l``) shared by the tiled
    solvers.  Returns ``x_from_q(q, rho_c, prec_x)`` computing the
    distributed closed-form x-update from the spatial rhs term ``q``.

    ``rho2_l`` adds the composite solver's identity-split penalty to the
    denominator (``|Sigma|^2 + rho1 |Lambda|^2 + rho2`` — ops/composite.py);
    0 recovers the pure-TV solve.  ``x_bounds`` clips the returned x (the
    pure-TV solvers' box projection); composite callers pass None here (the
    box rides the z2 prox instead)."""
    folded = fft_mode in ("fold", "fold1", "fold_precise")
    delta = fft_mode == "fold1"
    lap_cols = _col_slice(lap_full, axis_name, wp)
    if not has_psf:
        denom_h = jnp.ones((), y_tile.dtype)
        b_cols = _dist_rfft2(y_tile, axis_name, wp)
    else:
        otf_cols = _col_slice(otf_full, axis_name, wp)
        denom_h = jnp.abs(otf_cols) ** 2
        b_cols = jnp.conj(otf_cols) * _dist_rfft2(y_tile, axis_name, wp)
    if folded and not delta:
        b_fold = fold_hermitian(b_cols)
    if delta:
        # Delta-form precompute (rho fixed for the whole solve): the
        # image-scale x_B = irfft2(C * B) once via the exact XLA FFT path,
        # and the folded rho*C loop multiplier — the distributed analogue of
        # the single-chip fold1 mode (ops/solver.py).
        c_cols0 = 1.0 / (denom_h + rho_l * lap_cols + rho2_l)
        x_b = _dist_irfft2(c_cols0 * b_cols, axis_name, w, wf)
        ce_d, co_d = fold_even_odd(rho_l * c_cols0)

    def x_from_q(q, rho_c, prec_x=prec):
        if delta:
            nt = (
                q.dtype
                if q.dtype == jnp.bfloat16
                and prec_x == jax.lax.Precision.DEFAULT
                else None
            )
            f = _dist_rfft2_fold(q, axis_name, wp, prec_x, out_dtype=nt)
            scaled = spectral_scale_folded(f, ce_d, co_d)
            if nt is not None:
                scaled = tuple(v.astype(nt) for v in scaled)
            x = x_b + _dist_irfft2_fold(
                *scaled, axis_name, h, w, wf, prec_x, inner_dtype=nt,
            )
        elif folded:
            c_cols = 1.0 / (denom_h + rho_c * lap_cols + rho2_l)
            qa_re, qa_im, qb_re, qb_im = _dist_rfft2_fold(
                q, axis_name, wp, prec_x
            )
            rhs = (
                b_fold[0] + rho_c * qa_re,
                b_fold[1] + rho_c * qa_im,
                b_fold[2] + rho_c * qb_re,
                b_fold[3] + rho_c * qb_im,
            )
            ce, co = fold_even_odd(c_cols)
            x = _dist_irfft2_fold(
                *spectral_scale_folded(rhs, ce, co), axis_name, h, w, wf, prec_x
            )
        else:
            c_cols = 1.0 / (denom_h + rho_c * lap_cols + rho2_l)
            qhat = _dist_rfft2(q, axis_name, wp)
            xhat = c_cols * (b_cols + rho_c * qhat)
            x = _dist_irfft2(xhat, axis_name, w, wf)
        if x_bounds is not None:
            x = jnp.clip(x, x_bounds[0], x_bounds[1])
        return x

    return x_from_q


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters",
        "prox",
        "x_bounds",
        "mesh",
        "axis_name",
        "data_axis_name",
        "adapt_rho",
        "early_stop",
        "fft_mode",
        "alpha",
        "fast",
        "check_every",
        "fast_mid",
        "state_dtype",
    ),
)
def _tiled_solve(
    y,
    psf,
    lam,
    rho,
    state0,
    iters,
    prox,
    x_bounds,
    mesh,
    axis_name,
    data_axis_name,
    adapt_rho,
    early_stop,
    eps_abs=1e-4,
    eps_rel=1e-3,
    mu=10.0,
    tau_scale=2.0,
    fft_mode="xla",
    alpha=1.0,
    fast=False,
    check_every=1,
    fast_mid=False,
    state_dtype=None,
):
    n, h, w = y.shape
    narrow = state_dtype is not None and jnp.dtype(state_dtype) != y.dtype
    sdt = jnp.dtype(state_dtype) if narrow else None
    t = mesh.shape[axis_name]
    wf = w // 2 + 1
    wp = -(-wf // t) * t  # padded frequency-column count, divisible by T

    lap_full = laplacian_spectrum((h, w), dtype=y.dtype)  # (H, Wf)
    has_psf = psf is not None
    otf_full = (
        psf_to_otf(psf, (h, w)) if has_psf else jnp.ones((h, wf), jnp.complex64)
    )

    # The standard (diagnostics / early-stop / adaptive) loop runs the
    # 5-plane form; the fixed-iteration q-carry loop (`fast=True`) and, with
    # ``check_every > 1``, the mid-loop INSIDE the adaptive/early-stop while
    # loop (`fast_mid=True`) run stencil_step on each tile with its
    # neighbour rows: residual psums and rho adaptation happen only at
    # block boundaries, exactly like the single-device adaptive solver.
    prox_step = _make_prox_step(prox)
    d_ax = data_axis_name
    in_spec = P(d_ax, axis_name, None)
    img_spec = P(d_ax)  # per-image vectors follow the batch sharding
    rep = P()  # replicated
    # Mesh axes every shard-local value may vary over (for psum'd consensus).
    all_axes = (axis_name,) if d_ax is None else (axis_name, d_ax)
    folded = fft_mode in ("fold", "fold1", "fold_precise")
    delta = fft_mode == "fold1"  # delta-form x-update, DEFAULT-precision loop matmuls
    if fft_mode == "fold1":
        prec = jax.lax.Precision.DEFAULT
    elif fft_mode == "fold":
        prec = jax.lax.Precision.HIGH
    else:
        prec = jax.lax.Precision.HIGHEST
    sqrt_dim = jnp.sqrt(jnp.asarray(2.0 * h * w, dtype=y.dtype))

    def tile_fn(y_tile, lap_full, otf_full, lam, rho, state0):
        nl = y_tile.shape[0]  # local batch (n / data-axis size)
        lam_l = lam[:, None, None]
        rho_l = rho[:, None, None]
        x_from_q = _make_x_from_q(
            y_tile, lap_full, otf_full, rho_l, axis_name, wp, h, w, wf,
            fft_mode, prec, has_psf, x_bounds,
        )

        if fast:
            # q-carry fast loop (the single-device solver's default
            # execution, ops/solver.py): carry (q, ux, uy) — z and x never
            # materialize — and run the D -> prox -> dual -> D^T section as
            # one stencil_step per iteration on the tile, with its
            # neighbour rows fetched by two ppermutes.
            tau = lam_l / rho_l
            q0 = _grad2d_adjoint_tiled(
                state0.zx - state0.ux, state0.zy - state0.uy, axis_name
            )
            ux0, uy0 = state0.ux, state0.uy
            if narrow:
                # Mixed-precision carry (see ops/solver.py state_dtype):
                # bf16 STORAGE for (q, ux, uy); stencil arithmetic stays
                # fp32.
                q0, ux0, uy0 = q0.astype(sdt), ux0.astype(sdt), uy0.astype(sdt)

            def fast_body(carry, _):
                q, ux, uy = carry
                x = x_from_q(q, rho_l)
                halo = _halo_exchange(x, ux, uy, axis_name)
                return stencil_step(x, ux, uy, tau, prox, halo), None

            carry, _ = jax.lax.scan(
                fast_body, (q0, ux0, uy0), None, length=iters - 1
            )
            final_prec = jax.lax.Precision.HIGH if delta else prec
            return x_from_q(carry[0], rho_l, final_prec)

        def one_iter(state, rho_c, prec_x=prec):
            q = _grad2d_adjoint_tiled(
                state.zx - state.ux, state.zy - state.uy, axis_name
            )
            x = x_from_q(q, rho_c, prec_x)
            dxx, dxy = _grad2d_tiled(x, axis_name)
            if alpha != 1.0:
                # Over-relaxation (Boyd sec. 3.4.3), as in the single-chip
                # solver: blend D x with the previous z before the z/dual
                # updates.
                rxx = alpha * dxx + (1.0 - alpha) * state.zx
                rxy = alpha * dxy + (1.0 - alpha) * state.zy
            else:
                rxx, rxy = dxx, dxy
            tau = lam_l / rho_c
            zx, zy, ux, uy = prox_step(rxx, rxy, state.ux, state.uy, tau)
            return ADMMState(x, zx, zy, ux, uy), dxx, dxy, q

        def residuals(state, z_prev_x, z_prev_y, dxx, dxy, rho_c):
            """Per-image primal/dual residual + feasibility norms, psum'd
            over the tile axis — one fused collective for all five."""
            zx, zy, ux, uy = state.zx, state.zy, state.ux, state.uy
            dz = _grad2d_adjoint_tiled(zx - z_prev_x, zy - z_prev_y, axis_name)
            dual = _grad2d_adjoint_tiled(ux, uy, axis_name)
            sums = jnp.stack(
                [
                    jnp.sum((dxx - zx) ** 2 + (dxy - zy) ** 2, axis=(-2, -1)),
                    jnp.sum(dz * dz, axis=(-2, -1)),
                    jnp.sum(dxx * dxx + dxy * dxy, axis=(-2, -1)),
                    jnp.sum(zx * zx + zy * zy, axis=(-2, -1)),
                    jnp.sum(dual * dual, axis=(-2, -1)),
                ]
            )  # (5, nl)
            sums = jax.lax.psum(sums, axis_name)
            rho_v = rho_c[:, 0, 0]
            r_norm = jnp.sqrt(sums[0])
            s_norm = rho_v * jnp.sqrt(sums[1])
            dx_norm, z_norm = jnp.sqrt(sums[2]), jnp.sqrt(sums[3])
            dual_norm = rho_v * jnp.sqrt(sums[4])
            eps_pri = sqrt_dim * eps_abs + eps_rel * jnp.maximum(dx_norm, z_norm)
            eps_dual = sqrt_dim * eps_abs + eps_rel * dual_norm
            done = jnp.logical_and(r_norm <= eps_pri, s_norm <= eps_dual)
            return r_norm, s_norm, done

        # Varying-type discipline: the state is tile-sharded (varying over
        # both mesh axes); per-image quantities (rho, residual norms, done)
        # are tile-REPLICATED consensus values (psum over the tile axis) and
        # vary only over the data axis.  Fresh initializers get pcast to the
        # data axis so while-loop carry types line up.
        def varying_data(v):
            if d_ax is None or d_ax in jax.typeof(v).vma:
                return v
            return jax.lax.pcast(v, (d_ax,), to="varying")

        st0 = state0
        rho0 = varying_data(jnp.broadcast_to(rho_l, (nl, 1, 1)))

        if not early_stop and not adapt_rho:
            # Fixed-iteration scan (differentiable), residuals once at the
            # end; the LAST iteration runs outside the scan so fold1 can
            # produce the output x at HIGH precision (matching the
            # single-chip fold1 post-loop solve).
            def body(carry, _):
                state, _, _, _ = one_iter(carry[0], rho0)
                return (state, carry[0].zx, carry[0].zy), None

            (state, _, _), _ = jax.lax.scan(
                body, (st0, st0.zx, st0.zy), None, length=iters - 1
            )
            zpx, zpy = state.zx, state.zy
            final_prec = jax.lax.Precision.HIGH if delta else prec
            state, dxx, dxy, _ = one_iter(state, rho0, prec_x=final_prec)
            r_norm, s_norm, _ = residuals(state, zpx, zpy, dxx, dxy, rho0)
            it_img = varying_data(jnp.full((nl,), iters, jnp.int32))
            return state.x, r_norm, s_norm, it_img, rho0[:, 0, 0], state

        def cond(carry):
            it, done = carry[2], carry[3]
            unfinished = jnp.sum(jnp.logical_not(done).astype(jnp.int32))
            if d_ax is not None:
                # Data shards must agree on the trip count (collectives in
                # the body would deadlock otherwise).
                unfinished = jax.lax.psum(unfinished, d_ax)
            return jnp.logical_and(it < iters, unfinished > 0)

        # fold1 runs its loop solves at DEFAULT precision; the while-loop carry tracks
        # the q that produced state.x so one post-loop HIGH re-solve can
        # replace the returned image (same q, better transform precision) —
        # the documented final-solve-at-HIGH behavior, matching the
        # single-chip solver's track_q path (ops/solver.py).  fold1's
        # residual-CHECK iterations (the last two of each block) also run
        # at HIGH so stopping decisions never see DEFAULT-precision transform noise
        # (ops/solver.py round-4; tiled fold1 requires early_stop without
        # adapt_rho, where the same argument applies).
        check_prec = jax.lax.Precision.HIGH if delta else prec

        def body(carry):
            state, rho_c, it = carry[0], carry[1], carry[2]
            # check_every - 1 cheap iterations: rho (hence c_spec / tau) is
            # fixed between checks and no residual psums are issued.
            if fast_mid:
                tau_mid = lam_l / rho_c
                q0 = _grad2d_adjoint_tiled(
                    state.zx - state.ux, state.zy - state.uy, axis_name
                )
                ux0_m, uy0_m = state.ux, state.uy
                if narrow:
                    q0 = q0.astype(sdt)
                    ux0_m, uy0_m = ux0_m.astype(sdt), uy0_m.astype(sdt)

                def mid(carry2, _):
                    q, ux, uy = carry2
                    x = x_from_q(q, rho_c)
                    halo = _halo_exchange(x, ux, uy, axis_name)
                    return stencil_step(x, ux, uy, tau_mid, prox, halo), None

                (q, ux, uy), _ = jax.lax.scan(
                    mid, (q0, ux0_m, uy0_m), None,
                    length=check_every - 2,
                )
                if narrow:
                    ux, uy = ux.astype(y.dtype), uy.astype(y.dtype)
                x = x_from_q(q, rho_c, check_prec)
                dxx, dxy = _grad2d_tiled(x, axis_name)
                zx, zy, ux, uy = prox_step(dxx, dxy, ux, uy, lam_l / rho_c)
                state = ADMMState(x, zx, zy, ux, uy)
            else:
                for i in range(check_every - 1):
                    state, _, _, _ = one_iter(
                        state, rho_c,
                        prec_x=check_prec if i == check_every - 2 else prec,
                    )
            z_prev_x, z_prev_y = state.zx, state.zy
            state, dxx, dxy, q_used = one_iter(state, rho_c, prec_x=check_prec)
            r_norm, s_norm, done = residuals(
                state, z_prev_x, z_prev_y, dxx, dxy, rho_c
            )
            if not early_stop:
                done = jnp.zeros_like(done)
            if adapt_rho:
                grow = r_norm > mu * s_norm
                shrink = s_norm > mu * r_norm
                factor = jnp.where(
                    grow, tau_scale, jnp.where(shrink, 1.0 / tau_scale, 1.0)
                )
                factor = jnp.where(done, 1.0, factor)[:, None, None]
                rho_c = rho_c * factor
                # Rescaling rho rescales the *scaled* dual u = (1/rho) dual.
                state = ADMMState(
                    state.x, state.zx, state.zy, state.ux / factor, state.uy / factor
                )
            out = (state, rho_c, it + check_every, done, r_norm, s_norm)
            return out + (q_used,) if delta else out

        norms0 = varying_data(jnp.full((nl,), jnp.inf, dtype=y.dtype))
        init = (
            st0,
            rho0,
            jnp.asarray(0),
            varying_data(jnp.zeros((nl,), bool)),
            norms0,
            norms0,
        )
        if delta:
            init = init + (
                _grad2d_adjoint_tiled(
                    st0.zx - st0.ux, st0.zy - st0.uy, axis_name
                ),
            )
        res = jax.lax.while_loop(cond, body, init)
        state, rho_fin, it, done, r_norm, s_norm = res[:6]
        if delta:
            state = state._replace(
                x=x_from_q(res[6], rho_fin, jax.lax.Precision.HIGH)
            )
        it_img = varying_data(jnp.full((nl,), 1, jnp.int32)) * it
        return state.x, r_norm, s_norm, it_img, rho_fin[:, 0, 0], state

    state_spec = ADMMState(in_spec, in_spec, in_spec, in_spec, in_spec)
    out_specs = (
        in_spec
        if fast
        else (in_spec, img_spec, img_spec, img_spec, img_spec, state_spec)
    )
    return jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(in_spec, rep, rep, img_spec, img_spec, state_spec),
        out_specs=out_specs,
    )(y, lap_full, otf_full, lam, rho, state0)


def tiled_tv_deconvolve(
    y: jnp.ndarray,
    psf: jnp.ndarray | None = None,
    lam=0.1,
    rho=1.0,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    adapt_rho: bool = False,
    early_stop: bool = False,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    check_every: int = 1,
    mesh: Mesh | None = None,
    axis_name: str = "tile",
    data_axis_name: str | None = None,
    fft_mode: str = "auto",
    alpha: float = 1.0,
    init_state: "ADMMState | None" = None,
    return_diagnostics: bool = False,
    return_state: bool = False,
    state_dtype: str | None = None,
):
    """ADMM TV deconvolution with the image H axis sharded over ``mesh``.

    Args:
      y: NHWC batch ``(B, H, W, C)`` (or ``(H, W)`` / ``(H, W, C)``).
        ``H`` must divide by the tile-axis size; ``W`` must be even.
      lam, rho: TV weight / penalty — scalar or per-image ``(B,)`` /
        per-channel ``(B, C)``, same broadcast rules as the single-chip
        solver.
      mesh: device mesh containing ``axis_name`` (and ``data_axis_name`` if
        given); required.
      adapt_rho: per-image residual-balanced rho (consensus via tile-psum).
      early_stop: Boyd-style stopping on the psum'd per-image residuals
        (``iters`` becomes the max); implies the ``lax.while_loop`` path.
      check_every: with ``early_stop``/``adapt_rho``, compute the psum'd
        residual norms / stopping / rho adaptation only every k-th
        iteration (``iters`` must divide evenly) — the distributed twin of
        the single-device adaptive solver's block checking.  Between checks
        rho is fixed, so with ``alpha=1`` the ``check_every - 2`` mid-block
        iterations run the q-carry fast loop with NO collective beyond the two halo ppermutes and the x-update's
        two ``all_to_all``s (no per-iteration residual psum).  k=1 (default)
        checks every iteration; ignored by the fixed-iteration scan path.
      data_axis_name: optional second mesh axis sharding the folded
        batch*channel axis — BASELINE config 5's multi-frame tiled case
        (``B*C`` must divide by its size).
      fft_mode: "xla" (native FFTs), "fold"/"fold_precise" — the matmul
        DFT in the folded half-H representation (same collective bytes, DFT
        FLOPs in matmuls) — or "fold1", the delta-form DEFAULT-precision variant
        (x_B hoisted and computed once exactly, loop matmuls at DEFAULT,
        final solve at HIGH; see ``ops/solver.py``).  "fold1" requires a
        fixed rho and is rejected with ``adapt_rho=True``.
      A fixed-iteration solve (no ``early_stop``/``adapt_rho``, no
      diagnostics/state request, ``alpha=1``) runs the q-carry fast loop
      with :func:`~admm_deconv.ops.stencil.stencil_step` on each tile
      (halo rows exchanged by ppermute) — the distributed analogue of the
      single-device fast path.
      alpha: over-relaxation factor (Boyd sec. 3.4.3); 1.0 = plain ADMM.
      init_state: warm-start :class:`ADMMState` from a previous
        ``return_state=True`` tiled solve (arrays in the folded
        ``(B*C, H, W)`` layout).
      return_diagnostics: also return per-image :class:`ADMMDiagnostics`.
      return_state: also return the final state for warm restarts.
      state_dtype: optional bf16 STORAGE for the tile-local loop carry
        ``(q, ux, uy)`` (and the halo rows riding the ppermutes) — the
        distributed twin of the single-device ``state_dtype`` (fp32
        arithmetic, HIGH-precision residual decisions, inference-only);
        requires the fast q-carry path or the ``check_every`` fast
        mid-loop.

    Returns ``x`` (same shape as input, H-sharded), optionally followed by
    diagnostics and/or state.
    """
    fft_mode = resolve_fft_mode(fft_mode, adaptive=adapt_rho)
    if fft_mode not in ("xla", "fold", "fold1", "fold_precise"):
        raise ValueError(
            f"tiled solver fft_mode must be xla/fold/fold1/fold_precise, "
            f"got {fft_mode!r}"
        )
    if fft_mode == "fold1" and adapt_rho:
        # The single-device adaptive solver supports fold1 via a
        # per-check-block x_B re-hoist (ops/solver.py); the tiled solver has
        # no distributed re-hoist, so fold1 needs a fixed rho here.
        raise ValueError(
            "tiled fft_mode='fold1' hoists x_B out of the loop, which "
            "requires rho fixed for the whole tiled solve; use 'fold' with "
            "adapt_rho (or the single-chip tv_deconvolve_adaptive, which "
            "supports fold1 explicitly)"
        )
    if mesh is None:
        raise ValueError("tiled_tv_deconvolve requires a mesh")
    y = jnp.asarray(y)
    orig_shape = y.shape
    if y.ndim == 2:
        y4 = y[None, :, :, None]
    elif y.ndim == 3:
        y4 = y[None]
    else:
        y4 = y
    b, h, w, c = y4.shape
    t = mesh.shape[axis_name]
    if h % t != 0:
        raise ValueError(f"H={h} must divide by tile axis size {t}")
    if w % 2 != 0:
        raise ValueError(f"W={w} must be even")
    n = b * c
    if data_axis_name is not None:
        d = mesh.shape[data_axis_name]
        if n % d != 0:
            raise ValueError(
                f"batch*channels={n} must divide by data axis size {d}"
            )
    y_f = jnp.transpose(y4, (0, 3, 1, 2)).reshape(n, h, w)
    psf_arr = None if psf is None else jnp.asarray(psf, y_f.dtype)

    def fold_param(p):
        p = jnp.asarray(p, y_f.dtype)
        if p.ndim == 0 or p.size == 1:
            return jnp.broadcast_to(p.reshape(()), (n,))
        if p.shape == (b,):
            return jnp.repeat(p, c)
        if p.shape == (b, c):
            return p.reshape(n)
        raise ValueError(
            f"parameter shape {p.shape} not broadcastable over batch={b}, channels={c}"
        )

    if init_state is None:
        zeros = jnp.zeros((n, h, w), y_f.dtype)
        state0 = ADMMState(zeros, zeros, zeros, zeros, zeros)
    else:
        state0 = init_state

    # Fast q-carry eligibility (mirrors the single-device solver's
    # fast-path gate, ops/solver.py): fixed iterations, plain ADMM, no
    # diagnostics/state request.
    fast = (
        not early_stop
        and not adapt_rho
        and not return_diagnostics
        and not return_state
        and alpha == 1.0
        and iters >= 1
    )

    # Block-checked adaptive/early-stop path: validate the cadence and
    # decide fast-mid eligibility (mirrors the single-device use_fast_mid
    # gate, ops/solver.py).
    uses_while = early_stop or adapt_rho
    if check_every < 1 or (
        uses_while
        and (iters < check_every or iters % check_every != 0)
    ):
        raise ValueError(
            f"check_every ({check_every}) must be >= 1 and divide "
            f"iters ({iters}), with iters >= check_every"
        )
    fast_mid = uses_while and check_every > 1 and alpha == 1.0

    if state_dtype is not None and jnp.dtype(state_dtype) != y_f.dtype and not (
        fast or fast_mid
    ):
        raise ValueError(
            "state_dtype requires the fast q-carry path (fixed iterations) "
            "or the check_every fast mid-loop (early_stop/adapt_rho with "
            "check_every > 1), with alpha=1"
        )
    result = _tiled_solve(
        y_f,
        psf_arr,
        fold_param(lam),
        fold_param(rho),
        state0,
        iters,
        prox,
        x_bounds,
        mesh,
        axis_name,
        data_axis_name,
        adapt_rho,
        early_stop,
        eps_abs=eps_abs,
        eps_rel=eps_rel,
        fft_mode=fft_mode,
        alpha=alpha,
        fast=fast,
        check_every=check_every,
        fast_mid=fast_mid,
        state_dtype=state_dtype,
    )
    if fast:
        x = result
        x = jnp.transpose(x.reshape(b, c, h, w), (0, 2, 3, 1))
        return x.reshape(orig_shape)
    x, r_norm, s_norm, it_img, rho_fin, state = result
    x = jnp.transpose(x.reshape(b, c, h, w), (0, 2, 3, 1))
    out = (x.reshape(orig_shape),)
    if return_diagnostics:
        out = out + (
            ADMMDiagnostics(
                r_norm=r_norm,
                s_norm=s_norm,
                iterations=jnp.max(it_img),
                rho=rho_fin,
            ),
        )
    if return_state:
        out = out + (state,)
    return out if len(out) > 1 else out[0]


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters",
        "prox",
        "x_bounds",
        "m",
        "early_stop",
        "mesh",
        "axis_name",
        "data_axis_name",
        "fft_mode",
        "aa_interval",
    ),
)
def _tiled_anderson_solve(
    y,
    psf,
    lam,
    rho,
    iters,
    prox,
    x_bounds,
    m,
    aa_reg,
    safeguard_factor,
    early_stop,
    eps_abs,
    eps_rel,
    mesh,
    axis_name,
    data_axis_name,
    fft_mode,
    aa_interval=1,
):
    n, h, w = y.shape
    t = mesh.shape[axis_name]
    wf = w // 2 + 1
    wp = -(-wf // t) * t
    lap_full = laplacian_spectrum((h, w), dtype=y.dtype)
    has_psf = psf is not None
    otf_full = (
        psf_to_otf(psf, (h, w)) if has_psf else jnp.ones((h, wf), jnp.complex64)
    )
    prox_fn = prox_lib.resolve(prox)
    d_ax = data_axis_name
    in_spec = P(d_ax, axis_name, None)
    img_spec = P(d_ax)
    rep = P()
    delta = fft_mode == "fold1"
    if fft_mode == "fold1":
        prec = jax.lax.Precision.DEFAULT
    elif fft_mode == "fold":
        prec = jax.lax.Precision.HIGH
    else:
        prec = jax.lax.Precision.HIGHEST
    sqrt_dim = jnp.sqrt(jnp.asarray(2.0 * h * w, dtype=y.dtype))

    # Every-k mixing fast inner loop (mirrors the single-device g_map,
    # ops/solver.py): the k-2 leading steps of each block run the q-carry
    # loop.
    use_fast_inner = aa_interval > 2

    def tile_fn(y_tile, lap_full, otf_full, lam, rho):
        nl, ht = y_tile.shape[0], y_tile.shape[1]
        lam_l = lam[:, None, None]
        rho_l = rho[:, None, None]
        tau = lam_l / rho_l
        x_from_q = _make_x_from_q(
            y_tile, lap_full, otf_full, rho_l, axis_name, wp, h, w, wf,
            fft_mode, prec, has_psf, x_bounds,
        )
        d_loc = 4 * ht * w  # per-image LOCAL state size (history is sharded)

        def psum_img(v):
            return jax.lax.psum(v, axis_name)

        def t_map(s):
            """One plain distributed ADMM iteration on s = (nl, 4, Ht, W)."""
            zx, zy, ux, uy = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
            q = _grad2d_adjoint_tiled(zx - ux, zy - uy, axis_name)
            x = x_from_q(q, rho_l)
            dxx, dxy = _grad2d_tiled(x, axis_name)
            zx2, zy2, ux2, uy2 = prox_lib.prox_dual_step(
                dxx, dxy, ux, uy, tau, prox_fn
            )
            r = jnp.sqrt(
                psum_img(
                    jnp.sum((dxx - zx2) ** 2 + (dxy - zy2) ** 2, axis=(-2, -1))
                )
            )
            return jnp.stack([zx2, zy2, ux2, uy2], axis=1), r

        def one_step(zx, zy, ux, uy):
            q = _grad2d_adjoint_tiled(zx - ux, zy - uy, axis_name)
            x = x_from_q(q, rho_l)
            dxx, dxy = _grad2d_tiled(x, axis_name)
            zx2, zy2, ux2, uy2 = prox_lib.prox_dual_step(
                dxx, dxy, ux, uy, tau, prox_fn
            )
            return zx2, zy2, ux2, uy2, dxx, dxy

        def g_map(s):
            """G = T^aa_interval -> (G(s), r_norm, consecutive z_prev pair);
            the distributed twin of the single-chip g_map."""
            zx, zy, ux, uy = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
            if aa_interval == 1:
                t_s, r = t_map(s)
                return t_s, r, zx, zy
            if use_fast_inner:
                q0 = _grad2d_adjoint_tiled(zx - ux, zy - uy, axis_name)

                def inner(c, _):
                    q, ux_c, uy_c = c
                    x = x_from_q(q, rho_l)
                    halo = _halo_exchange(x, ux_c, uy_c, axis_name)
                    return stencil_step(x, ux_c, uy_c, tau, prox, halo), None

                (q, ux, uy), _ = jax.lax.scan(
                    inner, (q0, ux, uy), None, length=aa_interval - 2
                )
                x = x_from_q(q, rho_l)
                dxx, dxy = _grad2d_tiled(x, axis_name)
                zx, zy, ux, uy = prox_lib.prox_dual_step(
                    dxx, dxy, ux, uy, tau, prox_fn
                )
            else:
                for _ in range(aa_interval - 1):
                    zx, zy, ux, uy, _, _ = one_step(zx, zy, ux, uy)
            zpx, zpy = zx, zy
            zx, zy, ux, uy, dxx, dxy = one_step(zx, zy, ux, uy)
            r = jnp.sqrt(
                psum_img(
                    jnp.sum((dxx - zx) ** 2 + (dxy - zy) ** 2, axis=(-2, -1))
                )
            )
            return jnp.stack([zx, zy, ux, uy], axis=1), r, zpx, zpy

        s0 = jnp.zeros((nl, 4, ht, w), y_tile.dtype)
        hist0 = jnp.zeros((m, nl, d_loc), y_tile.dtype)

        def aa_core(s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, k):
            """Windowed type-II extrapolation, distributed: the (m, m) Gram
            and rhs are psum'd over the tile axis, so every tile solves the
            SAME per-image mixing problem — consensus gamma — while the
            m-slot difference rings stay tile-local (footprint divided by
            the tile count) and are updated IN PLACE.  Ring traffic is
            minimized exactly as in the single-chip aa_core
            (ops/solver.py): the second ring stores ``dSF = dS + dF``
            (slot update = difference of consecutive map outputs, and the
            correction is one ring contraction), and the psum'd Gram is
            carried and refreshed RANK-1 — one fused probe contraction per
            iteration yields both the new Gram row/column and the rhs, in
            one pass over the local ``dF`` ring and ONE psum instead of
            two."""
            t_s, r_norm, zpx, zpy = g_map(s)
            f = (t_s - s).reshape(nl, d_loc)
            res = jnp.sqrt(psum_img(jnp.sum(f * f, axis=-1)))
            res0 = jnp.where(res0 < 0, res, res0)
            t_flat = t_s.reshape(nl, d_loc)
            idx = (k - 1) % m
            new_df = f - f_prev
            dSF = jax.lax.dynamic_update_slice(
                dSF, (t_flat - t_prev)[None], (idx, 0, 0)
            )
            dF = jax.lax.dynamic_update_slice(dF, new_df[None], (idx, 0, 0))
            cnt = jnp.where(k >= 1, jnp.minimum(cnt + 1, m), cnt)
            ages = (k - 1 - jnp.arange(m)) % m + 1
            valid = ages[None, :] <= cnt[:, None]  # (nl, m)
            # fp32 contractions (see ops/solver.py aa_core): bf16 Gram /
            # correction terms degrade the mixing at large D.  Staleness is
            # masked on the tiny psum'd Gram/rhs, not the rings — invalid
            # slots get an exactly-zero gamma through the regularization
            # diagonal, so the raw tile-local rings feed the correction
            # contraction (same traffic saving as the single-chip aa_core).
            hi = jax.lax.Precision.HIGHEST
            probe = jnp.stack([new_df, f], axis=1)  # (nl, 2, d_loc)
            rv = jax.lax.psum(
                jnp.einsum("knd,njd->nkj", dF, probe, precision=hi), axis_name
            )
            row = rv[:, :, 0]
            gram = jax.lax.dynamic_update_slice(
                gram, row[:, None, :], (0, idx, 0)
            )
            gram = jax.lax.dynamic_update_slice(
                gram, row[:, :, None], (0, 0, idx)
            )
            g = jnp.where(valid[:, :, None] & valid[:, None, :], gram, 0.0)
            g = g + aa_reg * (
                jnp.trace(g, axis1=-2, axis2=-1)[:, None, None] + 1.0
            ) * jnp.eye(m, dtype=g.dtype)
            rhs = jnp.where(valid, rv[:, :, 1], 0.0)
            gamma = jnp.linalg.solve(g, rhs[..., None])[..., 0]
            s_aa = t_flat - jnp.einsum("knd,nk->nd", dSF, gamma, precision=hi)
            # Per-image decay safeguard on the psum'd (global) residual; the
            # decision is identical on every tile, as in ops/solver.py.
            bound = safeguard_factor * res0 * (k_acc + 1.0) ** -(1.0 + 1e-6)
            take = (cnt >= 1) & (res <= bound)
            k_acc = jnp.where(take, k_acc + 1.0, k_acc)
            cnt = jnp.where(take, cnt, 0)
            s_next = jnp.where(take[:, None], s_aa, t_flat)
            return (
                s_next.reshape(nl, 4, ht, w), dSF, dF, gram, t_flat, f, cnt,
                k_acc, res0, r_norm, res, t_s, zpx, zpy,
            )

        res0_init = jnp.full((nl,), -1.0, y_tile.dtype)
        k_acc_init = jnp.zeros((nl,), y_tile.dtype)
        flat0 = jnp.zeros((nl, d_loc), y_tile.dtype)
        gram0 = jnp.zeros((nl, m, m), y_tile.dtype)
        rho_v = rho

        if early_stop:
            def cond(carry):
                it, done = carry[-2], carry[-1]
                unfinished = jnp.sum(jnp.logical_not(done).astype(jnp.int32))
                if d_ax is not None:
                    unfinished = jax.lax.psum(unfinished, d_ax)
                return jnp.logical_and(
                    it < (iters - 1) // aa_interval, unfinished > 0
                )

            def wbody(carry):
                (s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, _r,
                 _res, it, _done) = carry
                (s2, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, r_norm,
                 res, t_s, zpx, zpy) = aa_core(
                    s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, it
                )
                dz = _grad2d_adjoint_tiled(
                    t_s[:, 0] - zpx, t_s[:, 1] - zpy, axis_name
                )
                s_norm = rho_v * jnp.sqrt(
                    psum_img(jnp.sum(dz * dz, axis=(-2, -1)))
                )
                z_norm = jnp.sqrt(
                    psum_img(
                        jnp.sum(t_s[:, 0] ** 2 + t_s[:, 1] ** 2, axis=(-2, -1))
                    )
                )
                dual = _grad2d_adjoint_tiled(t_s[:, 2], t_s[:, 3], axis_name)
                dual_norm = rho_v * jnp.sqrt(
                    psum_img(jnp.sum(dual * dual, axis=(-2, -1)))
                )
                eps_pri = sqrt_dim * eps_abs + eps_rel * z_norm
                eps_dual = sqrt_dim * eps_abs + eps_rel * dual_norm
                done = jnp.logical_and(r_norm <= eps_pri, s_norm <= eps_dual)
                return (
                    s2, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0,
                    r_norm, res, it + 1, done,
                )

            carry0 = (
                s0, hist0, hist0, gram0, flat0, flat0,
                jnp.zeros((nl,), jnp.int32), k_acc_init, res0_init,
                res0_init, res0_init, jnp.asarray(0),
                jnp.zeros((nl,), bool),
            )
            out = jax.lax.while_loop(cond, wbody, carry0)
            s, r_norm, fp_res, it_fin = out[0], out[9], out[10], out[11]
            iters_run = it_fin * aa_interval + 1
        else:
            def body(carry, k):
                (s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, _r,
                 _res) = carry
                (s2, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, r_norm,
                 res, _t, _zpx, _zpy) = aa_core(
                    s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, k
                )
                return (
                    s2, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0,
                    r_norm, res,
                ), None

            carry0 = (
                s0, hist0, hist0, gram0, flat0, flat0,
                jnp.zeros((nl,), jnp.int32), k_acc_init, res0_init,
                res0_init, res0_init,
            )
            out, _ = jax.lax.scan(
                body, carry0, jnp.arange((iters - 1) // aa_interval)
            )
            s, r_norm, fp_res = out[0], out[9], out[10]
            iters_run = jnp.asarray(iters)
        q_fin = _grad2d_adjoint_tiled(
            s[:, 0] - s[:, 2], s[:, 1] - s[:, 3], axis_name
        )
        final_prec = jax.lax.Precision.HIGH if delta else prec
        x = x_from_q(q_fin, rho_l, final_prec)
        it_img = jnp.full((nl,), 1, jnp.int32) * iters_run
        return x, r_norm, fp_res, it_img

    # check_vma=False: the Anderson consensus values (gamma, take, filled)
    # are made tile-identical by explicit psums; no mixed-initializer
    # while_loop state needs the vma discipline.
    return jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(in_spec, rep, rep, img_spec, img_spec),
        out_specs=(in_spec, img_spec, img_spec, img_spec),
        check_vma=False,
    )(y, lap_full, otf_full, lam, rho)


def tiled_tv_deconvolve_anderson(
    y: jnp.ndarray,
    psf: jnp.ndarray | None = None,
    lam=0.1,
    rho=1.0,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    m: int = 5,
    aa_reg: float = 1e-10,
    safeguard_factor: float = 1e6,
    early_stop: bool = False,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    aa_interval: int = 1,
    mesh: Mesh | None = None,
    axis_name: str = "tile",
    data_axis_name: str | None = None,
    fft_mode: str = "auto",
):
    """Anderson-accelerated ADMM with the image H axis sharded over ``mesh``.

    The distributed twin of :func:`admm_deconv.ops.solver.
    tv_deconvolve_anderson` (same type-II windowed extrapolation, per-image
    mixing, and Zhang-O'Donoghue-Boyd decay safeguard): the fixed-point state
    and both ``(m+1, N, 4*H*W)`` histories live tile-sharded — dividing
    Anderson's dominant memory cost by the tile count, which is what makes
    AA usable on 4K frames — while the per-image Gram/rhs reductions are
    psum'd over the tile axis so every tile applies identical mixing
    coefficients and safeguard decisions.

    Same argument semantics as :func:`tiled_tv_deconvolve`; ``rho`` is fixed
    for the whole solve (any ``fft_mode`` including ``fold1``).

    Returns ``(x, ADMMDiagnostics)`` (``s_norm`` = fixed-point residual).

    ``fft_mode="auto"`` resolves to "fold" (not fold1): AA needs a low-noise
    fixed-point map — see :func:`admm_deconv.ops.solver.
    tv_deconvolve_anderson`.  ``aa_interval=k > 1`` extrapolates ``G = T^k``
    (one sharded ring write / psum'd Gram refresh per k distributed
    iterations; the leading k-2 steps of each block run the q-carry loop) —
    the same every-k mixing as the single-device solver.
    """
    fft_mode = resolve_fft_mode(fft_mode, adaptive=True)
    if fft_mode not in ("xla", "fold", "fold1", "fold_precise"):
        raise ValueError(
            f"tiled solver fft_mode must be xla/fold/fold1/fold_precise, "
            f"got {fft_mode!r}"
        )
    if mesh is None:
        raise ValueError("tiled_tv_deconvolve_anderson requires a mesh")
    if m < 1:
        raise ValueError(f"Anderson window m must be >= 1, got {m}")
    if iters < 2:
        raise ValueError("tiled_tv_deconvolve_anderson needs iters >= 2")
    if aa_interval < 1 or (iters - 1) % aa_interval != 0:
        raise ValueError(
            f"aa_interval ({aa_interval}) must be >= 1 and divide "
            f"iters - 1 ({iters - 1})"
        )
    y = jnp.asarray(y)
    orig_shape = y.shape
    if y.ndim == 2:
        y4 = y[None, :, :, None]
    elif y.ndim == 3:
        y4 = y[None]
    else:
        y4 = y
    b, h, w, c = y4.shape
    t = mesh.shape[axis_name]
    if h % t != 0:
        raise ValueError(f"H={h} must divide by tile axis size {t}")
    if w % 2 != 0:
        raise ValueError(f"W={w} must be even")
    n = b * c
    if data_axis_name is not None:
        d = mesh.shape[data_axis_name]
        if n % d != 0:
            raise ValueError(
                f"batch*channels={n} must divide by data axis size {d}"
            )
    y_f = jnp.transpose(y4, (0, 3, 1, 2)).reshape(n, h, w)
    psf_arr = None if psf is None else jnp.asarray(psf, y_f.dtype)

    def fold_param(p):
        p = jnp.asarray(p, y_f.dtype)
        if p.ndim == 0 or p.size == 1:
            return jnp.broadcast_to(p.reshape(()), (n,))
        if p.shape == (b,):
            return jnp.repeat(p, c)
        if p.shape == (b, c):
            return p.reshape(n)
        raise ValueError(
            f"parameter shape {p.shape} not broadcastable over batch={b}, channels={c}"
        )

    x, r_norm, fp_res, it_img = _tiled_anderson_solve(
        y_f,
        psf_arr,
        fold_param(lam),
        fold_param(rho),
        iters,
        prox,
        x_bounds,
        m,
        aa_reg,
        safeguard_factor,
        early_stop,
        eps_abs,
        eps_rel,
        mesh,
        axis_name,
        data_axis_name,
        fft_mode,
        aa_interval=aa_interval,
    )
    x = jnp.transpose(x.reshape(b, c, h, w), (0, 2, 3, 1))
    diags = ADMMDiagnostics(
        r_norm=r_norm,
        s_norm=fp_res,
        iterations=jnp.max(it_img),
        rho=fold_param(rho),
    )
    return x.reshape(orig_shape), diags


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters",
        "prox",
        "x_bounds",
        "mesh",
        "axis_name",
        "data_axis_name",
        "fft_mode",
    ),
)
def _tiled_composite_solve(
    y,
    psf,
    lam_tv,
    lam_l1,
    rho1,
    rho2,
    iters,
    prox,
    x_bounds,
    mesh,
    axis_name,
    data_axis_name,
    fft_mode,
):
    n, h, w = y.shape
    t = mesh.shape[axis_name]
    wf = w // 2 + 1
    wp = -(-wf // t) * t
    lap_full = laplacian_spectrum((h, w), dtype=y.dtype)
    has_psf = psf is not None
    otf_full = (
        psf_to_otf(psf, (h, w)) if has_psf else jnp.ones((h, wf), jnp.complex64)
    )
    d_ax = data_axis_name
    in_spec = P(d_ax, axis_name, None)
    img_spec = P(d_ax)
    rep = P()
    delta = fft_mode == "fold1"
    if fft_mode == "fold1":
        prec = jax.lax.Precision.DEFAULT
    elif fft_mode == "fold":
        prec = jax.lax.Precision.HIGH
    else:
        prec = jax.lax.Precision.HIGHEST
    lo, hi = (None, None) if x_bounds is None else x_bounds

    def tile_fn(y_tile, lap_full, otf_full, lam_tv, lam_l1, rho1, rho2):
        nl, ht = y_tile.shape[0], y_tile.shape[1]
        rho1_l = rho1[:, None, None]
        rho2_l = rho2[:, None, None]
        tau_tv = (lam_tv / rho1)[:, None, None]
        tau_l1 = (lam_l1 / rho2)[:, None, None]
        ratio = rho2_l / rho1_l
        # The box constraint rides the z2 prox (exact), not the x-update.
        x_from_q = _make_x_from_q(
            y_tile, lap_full, otf_full, rho1_l, axis_name, wp, h, w, wf,
            fft_mode, prec, has_psf, None, rho2_l=rho2_l,
        )

        def z2_step(x, u2):
            v2 = x + u2
            z2 = jnp.sign(v2) * jnp.maximum(jnp.abs(v2) - tau_l1, 0.0)
            if x_bounds is not None:
                z2 = jnp.clip(z2, lo, hi)
            return z2, v2 - z2

        zeros = jnp.zeros((nl, ht, w), y_tile.dtype)

        def body(carry, _):
            q, u1x, u1y, u2 = carry
            x = x_from_q(q, rho1_l)
            halo = _halo_exchange(x, u1x, u1y, axis_name)
            return composite_stencil_step(
                x, u1x, u1y, u2, tau_tv, tau_l1, ratio, prox, x_bounds, halo
            ), None

        (q, _, _, u2), _ = jax.lax.scan(
            body, (zeros, zeros, zeros, zeros), None, length=iters - 1
        )
        final_prec = jax.lax.Precision.HIGH if delta else prec
        x = x_from_q(q, rho1_l, final_prec)
        z2, _ = z2_step(x, u2)
        return z2

    return jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(in_spec, rep, rep, img_spec, img_spec, img_spec, img_spec),
        out_specs=in_spec,
        check_vma=False,
    )(y, lap_full, otf_full, lam_tv, lam_l1, rho1, rho2)


def tiled_composite_tv_deconvolve(
    y: jnp.ndarray,
    psf: jnp.ndarray | None = None,
    lam_tv=0.01,
    lam_l1=0.0,
    rho1=0.1,
    rho2=0.1,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    mesh: Mesh | None = None,
    axis_name: str = "tile",
    data_axis_name: str | None = None,
    fft_mode: str = "auto",
):
    """Composite-prior (TV + L1 + box) ADMM with the H axis tile-sharded.

    The distributed twin of :func:`admm_deconv.ops.composite.
    composite_tv_deconvolve` in q-carry form: the TV split runs
    ``composite_stencil_step`` on each tile with its neighbour rows, the
    identity split (``clip(soft(x + u2))``) is elementwise and needs no
    halo, and the x-update's denominator carries the extra ``rho2`` term
    through the distributed transform.  Same argument semantics as
    :func:`tiled_tv_deconvolve`; penalties are fixed for the whole solve.

    Returns the feasible ``z2`` iterate (H-sharded, input shape).
    """
    fft_mode = resolve_fft_mode(fft_mode)
    if fft_mode not in ("xla", "fold", "fold1", "fold_precise"):
        raise ValueError(
            f"tiled solver fft_mode must be xla/fold/fold1/fold_precise, "
            f"got {fft_mode!r}"
        )
    if mesh is None:
        raise ValueError("tiled_composite_tv_deconvolve requires a mesh")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    y = jnp.asarray(y)
    orig_shape = y.shape
    if y.ndim == 2:
        y4 = y[None, :, :, None]
    elif y.ndim == 3:
        y4 = y[None]
    else:
        y4 = y
    b, h, w, c = y4.shape
    t = mesh.shape[axis_name]
    if h % t != 0:
        raise ValueError(f"H={h} must divide by tile axis size {t}")
    if w % 2 != 0:
        raise ValueError(f"W={w} must be even")
    n = b * c
    if data_axis_name is not None:
        d = mesh.shape[data_axis_name]
        if n % d != 0:
            raise ValueError(
                f"batch*channels={n} must divide by data axis size {d}"
            )
    y_f = jnp.transpose(y4, (0, 3, 1, 2)).reshape(n, h, w)
    psf_arr = None if psf is None else jnp.asarray(psf, y_f.dtype)

    def fold_param(p):
        p = jnp.asarray(p, y_f.dtype)
        if p.ndim == 0 or p.size == 1:
            return jnp.broadcast_to(p.reshape(()), (n,))
        if p.shape == (b,):
            return jnp.repeat(p, c)
        if p.shape == (b, c):
            return p.reshape(n)
        raise ValueError(
            f"parameter shape {p.shape} not broadcastable over batch={b}, channels={c}"
        )

    z2 = _tiled_composite_solve(
        y_f,
        psf_arr,
        fold_param(lam_tv),
        fold_param(lam_l1),
        fold_param(rho1),
        fold_param(rho2),
        iters,
        prox,
        x_bounds,
        mesh,
        axis_name,
        data_axis_name,
        fft_mode,
    )
    z2 = jnp.transpose(z2.reshape(b, c, h, w), (0, 2, 3, 1))
    return z2.reshape(orig_shape)
