"""ADMM TV deconvolution solver — the framework's compute core.

One jit-compiled, backend-agnostic implementation replacing the reference's
hand-duplicated CPU/GPU twins (``src/ops/ops.jl:17-96`` / ``:99-178``).

Problem (reference contract, ``src/ops/ops.jl``): given blurred/noisy ``y``
and PSF ``h``, solve

    min_x  0.5 * ||H x - y||^2 + lam * ||D x||

with ``||.||`` the anisotropic l1 or isotropic l2,1 norm of the circular
image gradient ``D``.  Split ``z = D x`` with scaled dual ``u`` and penalty
``rho``; threshold ``tau = lam / rho``.

Per-iteration hot loop (vs reference ``src/ops/ops.jl:84-92``):

    x   = irfft2( C * (B_f + rho * rfft2(q)) )   # closed-form x-update
    q   = D^T (z - u)  after  z,u = prox/dual(D x + u)   # one stencil pass

The default execution uses a *q-carry* formulation: since plain ADMM's next
iterate depends on (z - u) only through ``q = D^T(z - u)``, the scan carries
``(q, u)`` and neither ``z`` nor ``x`` ever materializes in HBM during the
loop (the output image is one extra spectral solve after the scan — same
total solve count, numerically identical by induction).  The stencil
section (D, prox, dual ascent, D^T) is one function,
:func:`admm_deconv.ops.stencil.stencil_step`, which XLA fuses.  The
reference-shaped 5-plane-state loop remains for diagnostics / final-state
requests.

Design deltas from the reference:
  * ``H^T y`` is precomputed once in the rFFT domain (``B_f``) and cached —
    the reference recomputes the spatial ``H^T(y)`` conv every iteration
    (known inefficiency at ``src/ops/ops.jl:86``).
  * 2 FFTs per iteration total; D/D^T/H are never materialized as convs.
  * The denominator pieces ``|Sigma|^2`` and ``|Lambda|^2`` are cached
    separately so adaptive-rho re-forms ``C`` with one elementwise op.
  * ``lax.scan`` over iterations (optionally rematerialized) keeps the loop
    a single XLA computation and makes the solver differentiable end-to-end.
  * An adaptive variant (``tv_deconvolve_adaptive``) adds per-image residual
    balancing of rho and early stopping via ``lax.while_loop`` —
    capabilities beyond the reference's fixed-iteration loop.

Layout: public API is NHWC ``(B, H, W, C)`` (also accepts ``(H, W)`` and
``(H, W, C)``).  Channels are deconvolved independently with the same PSF, so
internally they fold into the batch dim — the analogue of the reference's
``permutedims(y, (1,2,4,3))`` channel-to-batch move (``src/ops/ops.jl:19``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from admm_deconv.ops import prox as prox_lib
from admm_deconv.ops.policy import policy
from admm_deconv.ops.diff import grad2d, grad2d_adjoint
from admm_deconv.ops.stencil import stencil_step
from admm_deconv.ops.fft import (
    irfft2_exact,
    laplacian_spectrum,
    psf_to_otf,
    psf_to_otf_full,
    rfft2_exact,
)
from admm_deconv.ops.fft_factored import real_filter2d_packed, spectrum_to_layout
from admm_deconv.ops.fft_mxu import (
    fold_even_odd,
    fold_hermitian,
    irfft2_mxu,
    irfft2_mxu_folded,
    rfft2_mxu,
    rfft2_mxu_folded,
    spectral_scale_folded,
)

# FFT execution modes for the x-update:
#   "xla"          — jnp.fft (XLA FftOp; cuFFT on the GPU), exact fp32.
#   "mxu"          — full DFT-by-matmul at HIGH matmul precision, ~1e-4
#                    relative error.
#   "mxu_precise"  — DFT-by-matmul at HIGHEST precision (fp32-exact).
#   "fold"         — DFT-by-matmul in the folded half-H Hermitian
#                    representation (`ops/fft_mxu.py`): ~26% fewer matmul
#                    FLOPs than "mxu", HIGH precision.
#   "fold1"        — the folded DFT at DEFAULT precision made accuracy-viable
#                    by a *delta-form* x-update: x = x_B + irfft2(rho*C .
#                    rfft2(q)) with x_B = irfft2(C . B) hoisted out of the
#                    loop and computed once exactly.  The per-iteration
#                    matmuls then only touch the small zero-mean divergence
#                    field q, so low-precision relative error lands on
#                    residual-scale signal instead of image-scale B (the
#                    final post-loop solve runs at HIGH).
#   "fold_precise" — the same at HIGHEST precision.
#   "pack"         — four-step factored C2C with complex plane packing
#                    (requires scalar rho), HIGH precision.
#   "pack_precise" — the same at HIGHEST precision.
_FFT_MODES = (
    "xla", "mxu", "mxu_precise", "fold", "fold1", "fold_precise", "pack",
    "pack_precise",
)


def resolve_fft_mode(fft_mode: str, adaptive: bool = False) -> str:
    """Resolve ``"auto"`` to the backend's policy entry
    (``ops/policy.py``): ``fft_mode``, or ``fft_mode_adaptive`` when
    ``adaptive=True`` — passed by solvers whose loop cannot carry fold1's
    delta form safely (Anderson, the tiled adaptive-rho solver, the
    adaptive solver at short check blocks or deep tolerances).  Any
    explicit mode passes through untouched.
    """
    if fft_mode != "auto":
        return fft_mode
    p = policy()
    return p.fft_mode_adaptive if adaptive else p.fft_mode


def _fft_precision(fft_mode: str):
    if fft_mode == "fold1":
        return jax.lax.Precision.DEFAULT
    return (
        jax.lax.Precision.HIGH
        if fft_mode in ("mxu", "pack", "fold")
        else jax.lax.Precision.HIGHEST
    )


def _make_prox_step(prox):
    """Return a ``(dxx, dxy, ux, uy, tau) -> (zx, zy, ux', uy')`` step."""
    return functools.partial(prox_lib.prox_dual_step, prox_fn=prox_lib.resolve(prox))


class ADMMState(NamedTuple):
    """Solver iterate: primal image, split gradient pair, scaled duals."""

    x: jnp.ndarray
    zx: jnp.ndarray
    zy: jnp.ndarray
    ux: jnp.ndarray
    uy: jnp.ndarray


class ADMMDiagnostics(NamedTuple):
    """Per-solve observability the reference never surfaces.

    ``r_norm``/``s_norm`` are per-image primal/dual residual norms,
    ``iterations`` the number of iterations actually run (== ``iters`` for the
    fixed path), ``rho`` the final penalty (per image for the adaptive path).
    """

    r_norm: jnp.ndarray
    s_norm: jnp.ndarray
    iterations: jnp.ndarray
    rho: jnp.ndarray


def _normalize_input(y: jnp.ndarray) -> tuple[jnp.ndarray, tuple[int, ...]]:
    """Promote ``(H,W)``/``(H,W,C)``/``(B,H,W,C)`` to ``(B,H,W,C)``."""
    orig_shape = y.shape
    if y.ndim == 2:
        y = y[None, :, :, None]
    elif y.ndim == 3:
        y = y[None]
    elif y.ndim != 4:
        raise ValueError(f"expected 2/3/4-dim input, got shape {orig_shape}")
    return y, orig_shape


def _fold(y: jnp.ndarray) -> jnp.ndarray:
    """(B,H,W,C) -> (B*C, H, W): channels ride the batch dim."""
    b, h, w, c = y.shape
    return jnp.transpose(y, (0, 3, 1, 2)).reshape(b * c, h, w)


def _unfold(x: jnp.ndarray, b: int, c: int) -> jnp.ndarray:
    """(B*C, H, W) -> (B,H,W,C)."""
    n, h, w = x.shape
    return jnp.transpose(x.reshape(b, c, h, w), (0, 2, 3, 1))


def _fold_param(p, b: int, c: int, dtype) -> jnp.ndarray:
    """Broadcast a scalar / (1,) / (B,) / (B,C) parameter to (B*C, 1, 1)."""
    p = jnp.asarray(p, dtype=dtype)
    if p.ndim == 0 or p.size == 1:
        return p.reshape(())
    if p.shape == (b,):
        p = jnp.repeat(p, c)
    elif p.shape == (b, c):
        p = p.reshape(b * c)
    else:
        raise ValueError(
            f"parameter shape {p.shape} not broadcastable over batch={b}, channels={c}"
        )
    return p[:, None, None]


def _prepare(y, psf, lam, rho, fft_mode="xla"):
    """Shared precompute: folding, OTF, spectra, cached rhs.

    ``b_f`` (the cached ``rfft2(H^T y)``) is a complex array in "xla" mode
    and a ``(re, im)`` pair of real arrays in the matmul modes.
    """
    y4, _ = _normalize_input(y)
    b, h, w, c = y4.shape
    dtype = y4.dtype
    y_f = _fold(y4)

    lam_f = _fold_param(lam, b, c, dtype)
    rho_f = _fold_param(rho, b, c, dtype)

    packed = fft_mode in ("pack", "pack_precise")
    if packed and rho_f.ndim != 0:
        raise ValueError(
            "fft_mode='pack' packs plane pairs through one complex transform, "
            "which requires a single (scalar) rho; use 'mxu' for per-image rho"
        )

    no_psf = psf is None or (hasattr(psf, "size") and psf.size == 0)
    if not no_psf:
        psf = jnp.asarray(psf, dtype=dtype)
        if psf.ndim != 2:
            psf = psf.reshape(psf.shape[0], psf.shape[1])

    if packed:
        # Full-grid spectra, pre-permuted into the four-step bin layout, and
        # the rhs cached SPATIALLY: x = IFFT(C . FFT(H^T y + rho q)).
        lap = spectrum_to_layout(laplacian_spectrum((h, w), dtype=dtype, full=True))
        if no_psf:
            denom_h = jnp.ones((), dtype=dtype)
            b_f = y_f
        else:
            otf_full = psf_to_otf_full(psf, (h, w))
            denom_h = spectrum_to_layout(jnp.abs(otf_full) ** 2)
            otf = psf_to_otf(psf, (h, w))
            b_f = irfft2_exact(jnp.conj(otf) * rfft2_exact(y_f), (h, w))
        return y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c)

    lap = laplacian_spectrum((h, w), dtype=dtype)
    # Precompute precision ladder: "xla" keeps the native FFT (it is the
    # fp32-exact comparator); the HIGHEST-ladder modes get a HIGHEST
    # (~1e-6) precompute; the HIGH/DEFAULT modes tolerate ~1e-4 everywhere
    # else, so their precompute runs HIGH when it runs as matmuls.
    if fft_mode == "xla":
        y_hat = jnp.fft.rfft2(y_f)
    else:
        y_hat = rfft2_exact(
            y_f,
            precision=(
                jax.lax.Precision.HIGHEST
                if fft_mode.endswith("_precise")
                else jax.lax.Precision.HIGH
            ),
        )
    if no_psf:
        # Pure TV denoising: H = identity (reference `src/ops/ops.jl:22,67-69`).
        denom_h = jnp.ones((), dtype=dtype)
        b_c = y_hat
    else:
        otf = psf_to_otf(psf, (h, w))
        denom_h = jnp.abs(otf) ** 2
        b_c = jnp.conj(otf) * y_hat
    if fft_mode in ("xla", "fold1"):
        # "fold1" keeps the complex spectrum: its delta-form precompute
        # (x_B, rho*C) is derived downstream once rho is final.
        b_f = b_c
    elif fft_mode in ("fold", "fold_precise"):
        # Cache the rhs spectrum already folded into the half-H Hermitian
        # representation consumed by `_solve_spectral`'s fold branch.
        b_f = fold_hermitian(b_c)
    else:
        b_f = (jnp.real(b_c), jnp.imag(b_c))
    return y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c)


def _form_cspec(denom_h, lap, rho, fft_mode):
    """Normal-equation inverse ``1/(|Sigma|^2 + rho |Lambda|^2)`` in the
    representation the selected FFT mode consumes: the plain ``(H, Wf)``
    (or per-image ``(N, H, Wf)``) array, or its even/odd half-H fold."""
    c_spec = 1.0 / (denom_h + rho * lap)
    if fft_mode in ("fold", "fold_precise"):
        return fold_even_odd(c_spec)
    return c_spec


def _delta_hoist_irfft2(spec, h, w):
    """``irfft2`` of a full complex spectrum for the delta-form ``x_B``
    hoist: the native FFT, or — with policy ``precompute_fft_mxu`` — the
    folded half-H matmul inverse at HIGH precision (~1e-4 relative, inside
    the DEFAULT-precision loop's own error envelope)."""
    if not policy().precompute_fft_mxu:
        return jnp.fft.irfft2(spec, s=(h, w))
    return irfft2_mxu_folded(
        *fold_hermitian(spec), (h, w), precision=jax.lax.Precision.HIGH
    )


def _prepare_delta(b_c, denom_h, lap, rho, h, w):
    """Delta-form precompute for ``fft_mode='fold1'`` (done ONCE per solve
    — and once per rho block in the adaptive solver — at exact grade):
    the constant image-scale part of the x-update ``x_B = irfft2(C . B)``
    and the folded loop multiplier ``rho * C`` (rho folded in so the loop
    skips the per-iteration scale)."""
    c_spec = 1.0 / (denom_h + rho * lap)
    x_b = _delta_hoist_irfft2(c_spec * b_c, h, w)
    return x_b, fold_even_odd(rho * c_spec)


def _solve_spectral(b_f, c_spec, rho, q, h, w, fft_mode="xla", precision=None):
    """Closed-form normal-equation solve given the spatial rhs term ``q``:
    ``irfft2(c_spec * (B + rho * rfft2(q)))`` under the selected FFT mode.

    For ``fft_mode='fold1'`` the arguments are the delta-form precompute:
    ``b_f`` is the spatial ``x_B`` and ``c_spec`` the folded ``rho * C``
    (see :func:`_prepare_delta`); ``precision`` optionally overrides the
    mode's matmul precision (the fold1 post-loop solve runs at HIGH).
    """
    if fft_mode == "xla":
        if q.dtype not in (jnp.float32, jnp.float64):
            # XLA's RFFT rejects bf16 (the state_dtype carry); the matmul
            # modes consume it natively.
            q = q.astype(jnp.float32)
        return jnp.fft.irfft2(c_spec * (b_f + rho * jnp.fft.rfft2(q)), s=(h, w))
    if fft_mode == "fold1":
        prec = precision if precision is not None else _fft_precision(fft_mode)
        ce, co = c_spec
        # Narrow-state solves (bf16 q at DEFAULT precision) store every
        # transform intermediate in bf16 too, trading precision for memory
        # traffic (casts fuse into producer epilogues; fp32 accumulate).
        # HIGH-precision check/final solves keep fp32 intermediates.
        nt = (
            q.dtype
            if q.dtype == jnp.bfloat16 and prec == jax.lax.Precision.DEFAULT
            else None
        )
        f = rfft2_mxu_folded(q, precision=prec, out_dtype=nt)
        scaled = spectral_scale_folded(f, ce, co)
        if nt is not None:
            scaled = tuple(t.astype(nt) for t in scaled)
        return b_f + irfft2_mxu_folded(
            *scaled, (h, w), precision=prec, inner_dtype=nt
        )
    if fft_mode in ("pack", "pack_precise"):
        # b_f is the spatial H^T y cache; c_spec is in the four-step layout.
        return real_filter2d_packed(
            b_f + rho * q, c_spec, precision=_fft_precision(fft_mode)
        )
    if fft_mode in ("fold", "fold_precise"):
        # Folded half-H path: b_f is a 4-tuple of half Hermitian spectra,
        # c_spec the (ce, co) even/odd pair; every elementwise op here runs
        # on half-size arrays.
        prec = _fft_precision(fft_mode)
        ce, co = c_spec
        qa_re, qa_im, qb_re, qb_im = rfft2_mxu_folded(q, precision=prec)
        ba_re, ba_im, bb_re, bb_im = b_f
        rhs = (
            ba_re + rho * qa_re,
            ba_im + rho * qa_im,
            bb_re + rho * qb_re,
            bb_im + rho * qb_im,
        )
        return irfft2_mxu_folded(
            *spectral_scale_folded(rhs, ce, co), (h, w), precision=prec
        )
    prec = _fft_precision(fft_mode)
    br, bi = b_f
    qr, qi = rfft2_mxu(q, precision=prec)
    return irfft2_mxu(
        c_spec * (br + rho * qr),
        c_spec * (bi + rho * qi),
        (h, w),
        precision=prec,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters",
        "prox",
        "x_bounds",
        "return_diagnostics",
        "remat",
        "fft_mode",
        "alpha",
        "return_state",
        "state_dtype",
    ),
)
def tv_deconvolve(
    y: jnp.ndarray,
    psf: jnp.ndarray | None = None,
    lam=0.1,
    rho=1.0,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    return_diagnostics: bool = False,
    remat: bool = False,
    fft_mode: str = "auto",
    alpha: float = 1.0,
    init_state: "ADMMState | None" = None,
    return_state: bool = False,
    state_dtype: str | None = None,
):
    """Fixed-iteration ADMM TV deconvolution (differentiable).

    API twin of the reference dispatcher ``tvd_fft(y, lam, rho, h, isotropic,
    maxit)`` (``src/ops/ops.jl:181-188``); ``prox='aniso'|'iso'`` maps to its
    ``isotropic`` flag, with 'hard'/'gauss' exposing the reference's unused
    HT/GT operators.  Output is not clamped unless ``x_bounds`` is given,
    matching the reference (callers clamp).

    Args:
      y: degraded image(s), ``(B,H,W,C)`` (or 2-D/3-D variants), float32.
      psf: blur kernel ``(kh,kw)`` or None for pure TV denoising.
      lam: TV weight — scalar or per-image ``(B,)`` / per-channel ``(B,C)``.
      rho: ADMM penalty, same broadcast rules.
      iters: number of ADMM iterations (static).
      prox: z-update operator name or callable.
      x_bounds: optional box constraint projected in the x-update.
      return_diagnostics: also return per-iteration residual norms.
      remat: rematerialize the loop body under autodiff (memory vs FLOPs).
      alpha: over-relaxation factor (Boyd sec. 3.4.3); 1.0 = plain ADMM,
        1.5-1.8 typically converges in noticeably fewer iterations.
      init_state: warm-start iterate from a previous ``return_state=True``
        solve (e.g. the same frame at a different lam, or video frames).
      return_state: also return the final :class:`ADMMState` for warm
        restarts.
      state_dtype: optional narrower STORAGE dtype ("bfloat16") for the
        loop carry ``(q, ux, uy)``.  The stencil section is bound by device
        memory bandwidth, so halving the carried state's bytes can buy
        throughput; all stencil arithmetic still runs fp32
        (:func:`~admm_deconv.ops.stencil.stencil_step`), so the only new
        error is the per-iteration bf16 rounding of the carried state.
        Differentiable: cotangents of the carried state are stored bf16
        across the scan too, adding a gradient error of the same order as
        the forward's.  Requires the fast q-carry path (plain ADMM
        ``alpha=1``, no diagnostics/state request).

    ``fft_mode`` defaults to ``"auto"``: the backend's policy entry
    (:func:`resolve_fft_mode`, ``ops/policy.py``).

    Returns:
      Restored image(s) with the input's shape; with flags set, a tuple
      ``(x[, diagnostics][, state])`` in that order.
    """
    fft_mode = resolve_fft_mode(fft_mode)
    if fft_mode not in _FFT_MODES:
        raise ValueError(f"fft_mode must be one of {_FFT_MODES}, got {fft_mode!r}")
    y = jnp.asarray(y)
    _, orig_shape = _normalize_input(y)
    # named_scope annotations mark the solver phases in jax.profiler traces
    # (SURVEY §5.1): capture with `with jax.profiler.trace(logdir): ...` and
    # the phase names show up on the XLA op metadata in TensorBoard/xprof.
    with jax.named_scope("admm/precompute"):
        y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c) = _prepare(
            y, psf, lam, rho, fft_mode
        )
        tau = lam_f / rho_f
        prox_step = _make_prox_step(prox)
        if fft_mode == "fold1":
            b_f, c_spec = _prepare_delta(b_f, denom_h, lap, rho_f, h, w)
        else:
            c_spec = _form_cspec(denom_h, lap, rho_f, fft_mode)

    n = b * c
    if state_dtype is not None and (
        return_diagnostics or return_state or iters < 1
    ):
        raise ValueError(
            "state_dtype requires the fast q-carry path: no "
            "return_diagnostics/return_state, iters >= 1"
        )

    # ---- fast path: q-carry loop, z and x never materialized in HBM -----
    # The iteration state is fully described by (q = D^T(z - u), u) when no
    # per-iteration diagnostics or final z/u state are requested (and by
    # (q, z, u) under over-relaxation, which blends with the previous z).
    # Each scan step does one spectral solve + one fused stencil pass; the
    # output image is produced by a single extra spectral solve after the
    # loop — same number of solves, one fewer stencil pass, and a 3-plane
    # carry instead of 6.  Numerically identical to the reference-shaped
    # loop below (same q/x sequence by induction).
    if not return_diagnostics and not return_state and iters >= 1:
        narrow = (
            state_dtype is not None
            and jnp.dtype(state_dtype) != jnp.dtype(y_f.dtype)
        )
        if narrow and alpha != 1.0:
            raise ValueError(
                "state_dtype requires plain ADMM (alpha=1): the over-relaxed "
                "loop carries z"
            )

        if init_state is not None:
            q0 = grad2d_adjoint(
                init_state.zx - init_state.ux, init_state.zy - init_state.uy
            )
            zx0, zy0 = init_state.zx, init_state.zy
            ux0, uy0 = init_state.ux, init_state.uy
        else:
            zeros = jnp.zeros((n, h, w), dtype=y_f.dtype)
            q0 = zeros
            zx0 = zy0 = ux0 = uy0 = zeros
        if narrow:
            sdt = jnp.dtype(state_dtype)
            q0, ux0, uy0 = q0.astype(sdt), ux0.astype(sdt), uy0.astype(sdt)

        carry0 = (q0, ux0, uy0) if alpha == 1.0 else (q0, zx0, zy0, ux0, uy0)

        def fast_body(carry, _):
            if alpha == 1.0:
                q, ux, uy = carry
            else:
                q, zx_prev, zy_prev, ux, uy = carry
            with jax.named_scope("admm/x_update"):
                x = _solve_spectral(b_f, c_spec, rho_f, q, h, w, fft_mode)
                if x_bounds is not None:
                    x = jnp.clip(x, x_bounds[0], x_bounds[1])
            if alpha == 1.0:
                return stencil_step(x, ux, uy, tau, prox), None
            dxx, dxy = grad2d(x)
            rxx = alpha * dxx + (1.0 - alpha) * zx_prev
            rxy = alpha * dxy + (1.0 - alpha) * zy_prev
            zx, zy, ux, uy = prox_step(rxx, rxy, ux, uy, tau)
            q = grad2d_adjoint(zx - ux, zy - uy)
            return (q, zx, zy, ux, uy), None

        if remat:
            fast_body = jax.checkpoint(fast_body)

        with jax.named_scope("admm/loop"):
            carry, _ = jax.lax.scan(fast_body, carry0, None, length=iters - 1)
        q_fin = carry[0]
        # fold1: the one post-loop solve producing the output runs at HIGH —
        # near-free, and it removes the last transform's DEFAULT-precision error from
        # the returned image (loop error lives only in the converged q/u).
        final_prec = jax.lax.Precision.HIGH if fft_mode == "fold1" else None
        with jax.named_scope("admm/final_solve"):
            x = _solve_spectral(
                b_f, c_spec, rho_f, q_fin, h, w, fft_mode, precision=final_prec
            )
            if x_bounds is not None:
                x = jnp.clip(x, x_bounds[0], x_bounds[1])
        return _unfold(x, b, c).reshape(orig_shape)

    if init_state is not None:
        state = init_state
    else:
        zeros = jnp.zeros((n, h, w), dtype=y_f.dtype)
        state = ADMMState(zeros, zeros, zeros, zeros, zeros)

    # fold1 runs its loop solves at DEFAULT precision; the carry tracks the q that
    # produced state.x so one post-loop HIGH-precision re-solve can replace
    # the returned image (same q, better transform precision) — matching the
    # fast path's documented final-solve-at-HIGH behavior.
    track_q = fft_mode == "fold1" and iters >= 1

    def body(carry, _):
        state, _ = carry
        q = grad2d_adjoint(state.zx - state.ux, state.zy - state.uy)
        x = _solve_spectral(b_f, c_spec, rho_f, q, h, w, fft_mode)
        if x_bounds is not None:
            x = jnp.clip(x, x_bounds[0], x_bounds[1])
        dxx, dxy = grad2d(x)
        if alpha != 1.0:
            # Over-relaxation: blend D x with the previous z before the
            # z/dual updates (Boyd sec. 3.4.3).
            rxx = alpha * dxx + (1.0 - alpha) * state.zx
            rxy = alpha * dxy + (1.0 - alpha) * state.zy
        else:
            rxx, rxy = dxx, dxy
        zx, zy, ux, uy = prox_step(rxx, rxy, state.ux, state.uy, tau)
        new_state = ADMMState(x, zx, zy, ux, uy)
        if return_diagnostics:
            r = jnp.sqrt(
                jnp.sum((dxx - zx) ** 2 + (dxy - zy) ** 2, axis=(-2, -1))
            )
            dz = grad2d_adjoint(zx - state.zx, zy - state.zy)
            s = jnp.squeeze(rho_f, axis=(-2, -1)) if rho_f.ndim else rho_f
            s = s * jnp.sqrt(jnp.sum(dz**2, axis=(-2, -1)))
            return (new_state, q), (r, s)
        return (new_state, q), None

    if remat:
        body = jax.checkpoint(body)

    q0 = jnp.zeros((n, h, w), dtype=y_f.dtype)
    (state, q_last), ys = jax.lax.scan(body, (state, q0), None, length=iters)
    if track_q:
        x_hi = _solve_spectral(
            b_f, c_spec, rho_f, q_last, h, w, fft_mode,
            precision=jax.lax.Precision.HIGH,
        )
        if x_bounds is not None:
            x_hi = jnp.clip(x_hi, x_bounds[0], x_bounds[1])
        state = state._replace(x=x_hi)
    x = _unfold(state.x, b, c).reshape(orig_shape)

    out = (x,)
    if return_diagnostics:
        r_hist, s_hist = ys
        diags = ADMMDiagnostics(
            r_norm=r_hist[-1],
            s_norm=s_hist[-1],
            iterations=jnp.asarray(iters),
            rho=jnp.broadcast_to(jnp.squeeze(rho_f), (n,)),
        )
        out = out + (diags,)
    if return_state:
        out = out + (state,)
    return out if len(out) > 1 else x


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iters",
        "prox",
        "x_bounds",
        "adapt_rho",
        "check_every",
        "fft_mode",
        "alpha",
        "return_state",
        "state_dtype",
        # eps_abs is static: "auto" fft-mode resolution branches on it (the
        # deep-tolerance fold switch), and tolerances are config constants.
        "eps_abs",
    ),
)
def tv_deconvolve_adaptive(
    y: jnp.ndarray,
    psf: jnp.ndarray | None = None,
    lam=0.1,
    rho=1.0,
    max_iters: int = 200,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    adapt_rho: bool = True,
    mu: float = 10.0,
    tau_scale: float = 2.0,
    check_every: int = 1,
    fft_mode: str = "auto",
    alpha: float = 1.0,
    init_state: "ADMMState | None" = None,
    return_state: bool = False,
    state_dtype: str | None = None,
):
    """ADMM with per-image residual-balanced rho and early stopping.

    Inference-path extension beyond the reference's fixed-iteration loop
    (BASELINE configs 2/3): Boyd-style stopping
    (``r <= eps_pri``, ``s <= eps_dual``) and penalty adaptation
    (``rho *= tau`` when ``r > mu*s``, with the scaled dual rescaled
    accordingly).  ``C`` is re-formed from the cached spectra on the fly.

    ``check_every > 1`` computes residual norms / stopping / rho adaptation
    only every k-th iteration (``max_iters`` must divide evenly), cutting the
    per-iteration norm reductions and letting the cached ``c_spec`` serve k
    iterations between rho updates.  With ``check_every > 1`` and plain
    ADMM (``alpha=1``), the ``check_every - 2`` iterations between checks
    run as the q-carry fast loop (rho is fixed between checks, which is
    exactly the fast path's regime; the last two iterations of each block
    run the 5-plane form so the residual check sees the true
    ``z_prev``/``z`` pair).  At ``check_every=2`` the fast mid-loop's scan
    length is 0, so both iterations of every block run the 5-plane form.

    ``fft_mode="fold1"`` (the delta-form DEFAULT-precision DFT) is
    supported here by re-deriving its hoisted ``x_B = irfft2(C*B)`` each
    time rho changes — one exact solve per ``check_every`` block — and the
    returned image gets the fixed path's final solve at HIGH.  Stopping and
    rho-adaptation decisions never see low-precision transform noise: the
    last TWO iterations of each check block (the ones producing ``z_prev``
    and ``z``/``D x`` for the residual norms) run their spectral solves at
    HIGH.  ``"auto"`` takes the policy's ``fft_mode`` only when
    ``check_every`` reaches ``adaptive_fold1_min_check_every`` and
    ``eps_abs`` is not below ``deep_eps_abs`` (``ops/policy.py``), and
    ``fft_mode_adaptive`` otherwise; the returned ``diag.rho`` lets callers
    monitor drift.

    ``state_dtype="bfloat16"`` narrows the STORAGE dtype of the
    ``(q, ux, uy)`` carry inside the fast mid-loop (arithmetic stays fp32;
    block-boundary state and residual decisions stay fp32 — see
    :func:`tv_deconvolve`'s ``state_dtype``); requires the fast mid-loop
    configuration.  Inference-only.

    Not differentiable (``lax.while_loop``); use :func:`tv_deconvolve` as the
    learned-layer path.

    Returns ``(x, ADMMDiagnostics)`` where the diagnostics carry the TRUE
    final primal and dual residual norms from the last convergence check.
    """
    fft_mode = resolve_fft_mode(
        fft_mode,
        adaptive=(
            check_every < policy().adaptive_fold1_min_check_every
            or eps_abs < policy().deep_eps_abs
        ),
    )
    if fft_mode not in _FFT_MODES:
        raise ValueError(f"fft_mode must be one of {_FFT_MODES}, got {fft_mode!r}")
    if check_every < 1 or max_iters < check_every or max_iters % check_every != 0:
        # max_iters >= check_every also rejects max_iters=0, which would
        # otherwise skip the loop yet still run the fold1 post-loop re-solve
        # from q=0 (replacing init_state.x with clipped x_B).
        raise ValueError(
            f"check_every ({check_every}) must be >= 1 and divide "
            f"max_iters ({max_iters}), with max_iters >= check_every"
        )
    prox_step = _make_prox_step(prox)
    y = jnp.asarray(y)
    _, orig_shape = _normalize_input(y)
    y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c) = _prepare(
        y, psf, lam, rho, fft_mode
    )
    n = b * c
    rho0 = jnp.ones((n, 1, 1), dtype=y_f.dtype) * rho_f
    lam0 = jnp.ones((n, 1, 1), dtype=y_f.dtype) * lam_f

    zeros = jnp.zeros((n, h, w), dtype=y_f.dtype)
    sqrt_n = jnp.sqrt(jnp.asarray(2.0 * h * w, dtype=y_f.dtype))

    def cond(carry):
        it, done = carry[2], carry[3]
        return jnp.logical_and(it < max_iters, jnp.logical_not(jnp.all(done)))

    def solve_ctx(rho_cur):
        """Per-rho-block spectral solve context ``(b_like, c_like)`` for
        :func:`_solve_spectral`.  For ``fold1`` this re-derives the
        delta-form hoist — the exact ``x_B = irfft2(C*B)`` (XLA fp32 FFT)
        plus the folded ``rho*C`` — each time rho changes, i.e. once per
        ``check_every`` block, so the DEFAULT-precision delta-form loop matmuls stay
        valid under adaptive rho (one exact solve amortized over the
        block)."""
        if fft_mode == "fold1":
            return _prepare_delta(b_f, denom_h, lap, rho_cur, h, w)
        return b_f, _form_cspec(denom_h, lap, rho_cur, fft_mode)

    def one_iter(state, rho_cur, tau, sb, sc, prec_x=None):
        """One plain ADMM iteration (no residuals); also returns the q that
        produced its x (for the fold1 final-solve-at-HIGH).  ``prec_x``
        overrides the spectral-solve matmul precision (the fold1 residual
        -check iterations run at HIGH, see ``body``)."""
        q = grad2d_adjoint(state.zx - state.ux, state.zy - state.uy)
        x = _solve_spectral(sb, sc, rho_cur, q, h, w, fft_mode, precision=prec_x)
        if x_bounds is not None:
            x = jnp.clip(x, x_bounds[0], x_bounds[1])
        dxx, dxy = grad2d(x)
        if alpha != 1.0:
            rxx = alpha * dxx + (1.0 - alpha) * state.zx
            rxy = alpha * dxy + (1.0 - alpha) * state.zy
        else:
            rxx, rxy = dxx, dxy
        zx, zy, ux, uy = prox_step(rxx, rxy, state.ux, state.uy, tau)
        return ADMMState(x, zx, zy, ux, uy), dxx, dxy, q

    # Fast mid-block eligibility: between residual checks rho is fixed, so
    # the q-carry loop (the fixed-iteration solver's default execution) is
    # exact there.  The last of the check_every - 1 cheap iterations runs
    # the 5-plane form to rematerialize z (the residual check needs z_prev).
    use_fast_mid = check_every > 1 and alpha == 1.0
    # Mixed-precision mid-loop storage (same contract as tv_deconvolve's
    # state_dtype): the (q, ux, uy) carried ACROSS the mid scan lives in
    # bf16, while block-boundary state (z, u at check iterations) stays
    # fp32 and residual decisions read HIGH-precision solves.
    narrow = (
        state_dtype is not None
        and jnp.dtype(state_dtype) != jnp.dtype(y_f.dtype)
    )
    if narrow and not use_fast_mid:
        raise ValueError(
            "state_dtype requires the fast mid-loop: check_every > 1 and "
            "plain ADMM (alpha=1)"
        )

    # fold1 decision de-noising: stopping / rho adaptation read residuals off
    # the LAST TWO iterations of each check block (z_prev from iteration k-1,
    # z and D x from iteration k), so those two spectral solves run at HIGH
    # while the check_every - 2 mid-block iterations keep DEFAULT precision.
    check_prec = jax.lax.Precision.HIGH if fft_mode == "fold1" else None

    def body(carry):
        state, rho_cur, it, _done, _r, _s, _q, _rho_used = carry
        tau = lam0 / rho_cur
        sb, sc = solve_ctx(rho_cur)
        # check_every - 1 cheap iterations: rho (and hence c_spec / tau)
        # stays fixed between checks, so no norms are computed.
        if use_fast_mid:
            q0 = grad2d_adjoint(state.zx - state.ux, state.zy - state.uy)
            ux0, uy0 = state.ux, state.uy
            if narrow:
                sdt = jnp.dtype(state_dtype)
                q0, ux0, uy0 = q0.astype(sdt), ux0.astype(sdt), uy0.astype(sdt)

            def mid(carry2, _):
                q, ux, uy = carry2
                x = _solve_spectral(sb, sc, rho_cur, q, h, w, fft_mode)
                if x_bounds is not None:
                    x = jnp.clip(x, x_bounds[0], x_bounds[1])
                return stencil_step(x, ux, uy, tau, prox), None

            with jax.named_scope("admm/mid_loop"):
                (q, ux, uy), _ = jax.lax.scan(
                    mid, (q0, ux0, uy0), None, length=check_every - 2
                )
            if narrow:
                ux = ux.astype(y_f.dtype)
                uy = uy.astype(y_f.dtype)
            with jax.named_scope("admm/check_iter"):
                x = _solve_spectral(
                    sb, sc, rho_cur, q, h, w, fft_mode, precision=check_prec
                )
                if x_bounds is not None:
                    x = jnp.clip(x, x_bounds[0], x_bounds[1])
                dxx, dxy = grad2d(x)
                zx, zy, ux, uy = prox_step(dxx, dxy, ux, uy, tau)
                state = ADMMState(x, zx, zy, ux, uy)
        else:
            for i in range(check_every - 1):
                state, _, _, _ = one_iter(
                    state, rho_cur, tau, sb, sc,
                    prec_x=check_prec if i == check_every - 2 else None,
                )
        z_prev_x, z_prev_y = state.zx, state.zy
        state, dxx, dxy, q_x = one_iter(
            state, rho_cur, tau, sb, sc, prec_x=check_prec
        )
        zx, zy, ux, uy = state.zx, state.zy, state.ux, state.uy

        # Per-image residual norms (psum-able across spatial tiles).
        r_norm = jnp.sqrt(jnp.sum((dxx - zx) ** 2 + (dxy - zy) ** 2, axis=(-2, -1)))
        dz = grad2d_adjoint(zx - z_prev_x, zy - z_prev_y)
        rho_v = rho_cur[:, 0, 0]
        s_norm = rho_v * jnp.sqrt(jnp.sum(dz * dz, axis=(-2, -1)))

        dx_norm = jnp.sqrt(jnp.sum(dxx * dxx + dxy * dxy, axis=(-2, -1)))
        z_norm = jnp.sqrt(jnp.sum(zx * zx + zy * zy, axis=(-2, -1)))
        dual = grad2d_adjoint(ux, uy)
        dual_norm = rho_v * jnp.sqrt(jnp.sum(dual * dual, axis=(-2, -1)))

        eps_pri = sqrt_n * eps_abs + eps_rel * jnp.maximum(dx_norm, z_norm)
        eps_dual = sqrt_n * eps_abs + eps_rel * dual_norm
        done = jnp.logical_and(r_norm <= eps_pri, s_norm <= eps_dual)

        if adapt_rho:
            grow = r_norm > mu * s_norm
            shrink = s_norm > mu * r_norm
            factor = jnp.where(grow, tau_scale, jnp.where(shrink, 1.0 / tau_scale, 1.0))
            factor = jnp.where(done, 1.0, factor)[:, None, None]
            rho_new = rho_cur * factor
            # Rescaling rho rescales the *scaled* dual u = (1/rho) * dual.
            ux = ux / factor
            uy = uy / factor
            state = ADMMState(state.x, zx, zy, ux, uy)
        else:
            rho_new = rho_cur

        return (
            state, rho_new, it + check_every, done, r_norm, s_norm, q_x,
            rho_cur,
        )

    state0 = (
        init_state
        if init_state is not None
        else ADMMState(zeros, zeros, zeros, zeros, zeros)
    )
    norms0 = jnp.full((n,), jnp.inf, dtype=y_f.dtype)
    init = (
        state0, rho0, jnp.asarray(0), jnp.zeros((n,), dtype=bool), norms0,
        norms0, zeros, rho0,
    )
    (state, rho_fin, it, done, r_norm, s_norm, q_last,
     rho_used) = jax.lax.while_loop(cond, body, init)

    if fft_mode == "fold1":
        # Re-solve the final image at HIGH from the SAME q (and the rho that
        # produced it) — the loop solves ran at DEFAULT precision; this removes the last
        # transform's low-precision error from the returned image exactly as
        # the fixed-iteration fast path does.
        sb, sc = solve_ctx(rho_used)
        x_hi = _solve_spectral(
            sb, sc, rho_used, q_last, h, w, fft_mode,
            precision=jax.lax.Precision.HIGH,
        )
        if x_bounds is not None:
            x_hi = jnp.clip(x_hi, x_bounds[0], x_bounds[1])
        state = state._replace(x=x_hi)

    x = _unfold(state.x, b, c).reshape(orig_shape)
    diags = ADMMDiagnostics(
        r_norm=r_norm,
        s_norm=s_norm,
        iterations=it,
        rho=rho_fin[:, 0, 0],
    )
    if return_state:
        return x, diags, state
    return x, diags


def anderson_history_bytes(
    shape: tuple[int, ...], m: int = 5, itemsize: int = 4
) -> int:
    """Device-memory footprint of Anderson's history state — two ``(m, N, 4*H*W)``
    difference rings (``dF`` and ``dSF``) plus two ``(N, 4*H*W)`` snapshot
    buffers (previous map output / previous residual), i.e.
    ``2*(m+1)*N*4*H*W`` floats total — for an input of the given NHWC (or
    HW/HWC) shape.  Budget ``m`` with this before solving large frames (a
    3-channel 4K frame at m=5 is ~4.8 GB).  For frames where this does not
    fit, use :func:`admm_deconv.parallel.tiled_tv_deconvolve_anderson`,
    which shards the rings over the tile mesh axis (footprint / tile
    count), or let ``tv_deconvolve_anderson(m="auto")`` size the window
    from the backend's memory.
    """
    if len(shape) == 2:
        n, h, w = 1, *shape
    elif len(shape) == 3:
        n, (h, w) = shape[2], shape[:2]
    else:
        n, h, w = shape[0] * shape[3], shape[1], shape[2]
    return 2 * (m + 1) * n * 4 * h * w * itemsize


# Memory budget m="auto" sizes against on the CPU backend, which reports no
# device memory limit.
_CPU_MEMORY_BUDGET = 16 << 30


def _resolve_anderson_m(m, shape) -> int:
    """Resolve ``m="auto"``: the largest window in [2, 5] whose history
    state (:func:`anderson_history_bytes`) fits in ~25% of the default
    device's memory — the accelerator's reported ``bytes_limit``, or
    ``_CPU_MEMORY_BUDGET`` on the CPU.  m=5 is the preferred window when
    memory allows; shrinking it trades a few extra iterations for fitting
    large frames instead of running out of memory."""
    if m != "auto":
        return m
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        limit = _CPU_MEMORY_BUDGET
    else:
        limit = (dev.memory_stats() or {}).get("bytes_limit")
        if not limit:
            raise RuntimeError(
                f"{dev.device_kind} reports no bytes_limit; pass an explicit m"
            )
    mm = 5
    while mm > 2 and anderson_history_bytes(shape, mm) > limit // 4:
        mm -= 1
    return mm


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters", "prox", "x_bounds", "m", "fft_mode", "early_stop",
        "aa_interval",
    ),
)
def tv_deconvolve_anderson(
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
    fft_mode: str = "auto",
):
    """ADMM with type-II Anderson acceleration of the (z, u) fixed point.

    Capability beyond the reference (and beyond plain ADMM): the ADMM
    iteration is a fixed-point map ``s -> T(s)`` on ``s = (zx, zy, ux, uy)``
    (equivalent to Douglas-Rachford splitting), and Anderson extrapolation
    over a window of the last ``m`` residual differences reaches a given
    residual in fewer iterations on the reference blocks scenario
    (accelerating the full (z, u) state gives lower residuals at equal
    iterations than the reduced (q, u) state, so the extra history plane is
    kept).  Mixing coefficients are solved
    **per image** (batched (m, m) least squares), so images stay independent
    exactly as in the plain solver.

    Safeguarding costs no extra map evaluations: an AA candidate is taken
    only while the per-image residual norm stays below
    ``safeguard_factor * ||f_0|| * (k_acc + 1)^-(1+1e-6)`` (the decay
    condition of Zhang-O'Donoghue-Boyd type-I safeguarding); a violating
    image falls back to its plain ADMM step and restarts its window.

    ``early_stop=True`` adds Boyd-style per-image stopping (``eps_abs`` /
    ``eps_rel``, same criteria as :func:`tv_deconvolve_adaptive`) via
    ``lax.while_loop`` with ``iters`` as the cap — the accelerated sequence
    simply reaches the tolerance in fewer iterations.

    ``aa_interval=k > 1`` applies the extrapolation to ``G = T^k`` — one
    ring write, rank-1 Gram refresh, and mixing per k ADMM iterations
    instead of per iteration (AA's wall-clock cost at 1080p+ is the
    per-iteration history machinery).  The k-2 leading iterations of each
    block run the q-carry fast loop (z never materializes; rho fixed makes it exact — the same block
    structure as the adaptive solver's ``check_every``), the last two run
    the 5-plane form so the dual residual sees a true consecutive-z pair.
    Plain Anderson theory applies unchanged to the composed map;
    ``(iters - 1)`` must divide by ``aa_interval``.

    Memory: two ``(m, N, 4*H*W)`` difference rings plus two ``(N, 4*H*W)``
    snapshot buffers (= ``2*(m+1)*N*4*H*W`` floats total) — estimate with
    :func:`anderson_history_bytes` and budget ``m`` accordingly for large
    frames (``m="auto"`` does this against the device's reported memory
    limit, see :func:`_resolve_anderson_m`), or use the tile-sharded
    :func:`~admm_deconv.parallel.tiled_tv_deconvolve_anderson` (history
    divided by the tile count).  ``rho`` is fixed for the whole solve (any
    ``fft_mode`` including ``fold1`` works).  Inference path: not intended
    for differentiation (use :func:`tv_deconvolve`).

    Returns ``(x, ADMMDiagnostics)`` (``s_norm`` reports the fixed-point
    residual norm ``||T(s)-s||``; ``r_norm`` the primal residual).

    fft_mode note: ``"auto"`` resolves to the policy's
    ``fft_mode_adaptive`` — AA extrapolates differences of the fixed-point
    map, and fold1's DEFAULT-precision per-iteration transform noise sets a
    residual floor the accelerated sequence cannot cross.  Explicit "fold1"
    still works for loose tolerances.
    """
    fft_mode = resolve_fft_mode(fft_mode, adaptive=True)
    if fft_mode not in _FFT_MODES:
        raise ValueError(f"fft_mode must be one of {_FFT_MODES}, got {fft_mode!r}")
    m = _resolve_anderson_m(m, jnp.shape(y))
    if m < 1:
        raise ValueError(f"Anderson window m must be >= 1, got {m}")
    if iters < 2:
        raise ValueError("tv_deconvolve_anderson needs iters >= 2")
    if aa_interval < 1 or (iters - 1) % aa_interval != 0:
        raise ValueError(
            f"aa_interval ({aa_interval}) must be >= 1 and divide "
            f"iters - 1 ({iters - 1})"
        )
    y = jnp.asarray(y)
    _, orig_shape = _normalize_input(y)
    y_f, b_f, denom_h, lap, lam_f, rho_f, (b, h, w, c) = _prepare(
        y, psf, lam, rho, fft_mode
    )
    tau = lam_f / rho_f
    prox_step = _make_prox_step(prox)
    if fft_mode == "fold1":
        b_f, c_spec = _prepare_delta(b_f, denom_h, lap, rho_f, h, w)
    else:
        c_spec = _form_cspec(denom_h, lap, rho_f, fft_mode)
    n = b * c
    d = 4 * h * w  # per-image state: (zx, zy, ux, uy) planes

    def t_map(s):
        """One plain ADMM iteration on s = (N, 4, H, W) -> (s', r_norm)."""
        zx, zy, ux, uy = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
        q = grad2d_adjoint(zx - ux, zy - uy)
        x = _solve_spectral(b_f, c_spec, rho_f, q, h, w, fft_mode)
        if x_bounds is not None:
            x = jnp.clip(x, x_bounds[0], x_bounds[1])
        dxx, dxy = grad2d(x)
        zx2, zy2, ux2, uy2 = prox_step(dxx, dxy, ux, uy, tau)
        r = jnp.sqrt(
            jnp.sum((dxx - zx2) ** 2 + (dxy - zy2) ** 2, axis=(-2, -1))
        )
        return jnp.stack([zx2, zy2, ux2, uy2], axis=1), r

    # Every-k mixing: the extrapolated map is G = T^aa_interval.  The k-2
    # leading steps of each block run the q-carry fast loop; the last two
    # materialize z so the caller gets a true consecutive (z_prev, z) pair
    # for the dual residual.
    use_fast_inner = aa_interval > 2

    def one_step(zx, zy, ux, uy):
        q = grad2d_adjoint(zx - ux, zy - uy)
        x = _solve_spectral(b_f, c_spec, rho_f, q, h, w, fft_mode)
        if x_bounds is not None:
            x = jnp.clip(x, x_bounds[0], x_bounds[1])
        dxx, dxy = grad2d(x)
        zx2, zy2, ux2, uy2 = prox_step(dxx, dxy, ux, uy, tau)
        return zx2, zy2, ux2, uy2, dxx, dxy

    def g_map(s):
        """G(s) = T^k(s) -> (s', r_norm_of_last_step, z_prev pair)."""
        zx, zy, ux, uy = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
        if aa_interval == 1:
            t, r = t_map(s)
            return t, r, zx, zy
        if use_fast_inner:
            q0 = grad2d_adjoint(zx - ux, zy - uy)

            def inner(c, _):
                q, ux_c, uy_c = c
                x = _solve_spectral(b_f, c_spec, rho_f, q, h, w, fft_mode)
                if x_bounds is not None:
                    x = jnp.clip(x, x_bounds[0], x_bounds[1])
                return stencil_step(x, ux_c, uy_c, tau, prox), None

            (q, ux, uy), _ = jax.lax.scan(
                inner, (q0, ux, uy), None, length=aa_interval - 2
            )
            # Rematerialize z for the penultimate step: one 5-plane step
            # from the (q, u) carry.
            x = _solve_spectral(b_f, c_spec, rho_f, q, h, w, fft_mode)
            if x_bounds is not None:
                x = jnp.clip(x, x_bounds[0], x_bounds[1])
            dxx, dxy = grad2d(x)
            zx, zy, ux, uy = prox_step(dxx, dxy, ux, uy, tau)
        else:
            for _ in range(aa_interval - 1):
                zx, zy, ux, uy, _, _ = one_step(zx, zy, ux, uy)
        zpx, zpy = zx, zy
        zx, zy, ux, uy, dxx, dxy = one_step(zx, zy, ux, uy)
        r = jnp.sqrt(
            jnp.sum((dxx - zx) ** 2 + (dxy - zy) ** 2, axis=(-2, -1))
        )
        return jnp.stack([zx, zy, ux, uy], axis=1), r, zpx, zpy

    s0 = jnp.zeros((n, 4, h, w), dtype=y_f.dtype)
    hist0 = jnp.zeros((m, n, d), dtype=y_f.dtype)

    def aa_core(s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, k):
        """One T evaluation + windowed extrapolation.

        The m-slot DIFFERENCE rings are updated IN PLACE at slot
        ``(k-1) mod m`` (``dynamic_update_slice`` aliases the loop carry) —
        the previous snapshot-history formulation shifted two full
        ``(m+1, N, D)`` buffers every iteration, ~5 GB of pure copy traffic
        per iteration at 1080p batch-4.  The least-squares mixing problem is
        invariant to column order, so validity is tracked by slot AGE
        against the per-image count ``cnt`` of non-stale pairs (stale =
        pre-restart or never written).  Staleness is masked on the TINY
        ``(N, m, m)`` Gram / ``(N, m)`` rhs — NOT on the ``(m, N, D)``
        rings: zeroing an invalid slot's Gram row+column decouples it from
        the solve, whose regularization diagonal then yields an EXACT zero
        gamma for that slot, so the raw rings feed the correction
        contraction directly (``0 * stale = 0``, bit-identical to
        contracting masked ring copies).

        Ring-traffic minimization (this is AA's entire overhead at 1080p+
        scale, where the base iteration is HBM-bound):
          * ``dS`` is never needed alone — the correction is
            ``(dS + dF) . gamma`` — so the second ring stores the SUM
            ``dSF = dS + dF`` directly.  Since ``s + f = T(s)``, its slot
            update is just the difference of consecutive map outputs
            ``t_k - t_{k-1}``: one ring read per iteration for the
            correction instead of two.
          * The Gram matrix is carried and updated RANK-1: only slot
            ``idx`` changed, so one ``(m, D) x (D, 2)`` contraction against
            the probe ``[dF_new, f]`` refreshes both the Gram row/column
            and the full rhs ``dF . f`` in a single pass over the ``dF``
            ring (the carried Gram stays consistent with ring contents —
            every slot write refreshes its row/column, and untouched
            entries refer to untouched slots).
        Net: ~2 ring reads + 2 slot writes per iteration where a snapshot
        history would do ~5 full ring reads (many times the base iteration at
        1080p batch-4).
        """
        with jax.named_scope("admm/aa_map"):
            t, r_norm, zpx, zpy = g_map(s)
        f = (t - s).reshape(n, d)
        res = jnp.linalg.norm(f, axis=-1)  # (N,)
        res0 = jnp.where(res0 < 0, res, res0)  # first-iteration residual

        t_flat = t.reshape(n, d)
        idx = (k - 1) % m  # slot; the k=0 write is garbage but never valid
        new_df = f - f_prev
        dSF = jax.lax.dynamic_update_slice(dSF, (t_flat - t_prev)[None], (idx, 0, 0))
        dF = jax.lax.dynamic_update_slice(dF, new_df[None], (idx, 0, 0))
        cnt = jnp.where(k >= 1, jnp.minimum(cnt + 1, m), cnt)  # (N,)
        ages = (k - 1 - jnp.arange(m)) % m + 1  # (m,) slot ages, 1 = newest
        valid = ages[None, :] <= cnt[:, None]  # (N, m)
        # fp32 contractions are mandatory here: a DEFAULT-precision f32 dot
        # may run in TF32 on the GPU (bf16 passes elsewhere), putting ~0.1%
        # relative error on difference-scale Gram/correction terms, which
        # degrades the mixing coefficients at large D.
        hi = jax.lax.Precision.HIGHEST
        with jax.named_scope("admm/aa_mix"):
            probe = jnp.stack([new_df, f], axis=1)  # (N, 2, D)
            rv = jnp.einsum("knd,njd->nkj", dF, probe, precision=hi)  # (N, m, 2)
            row = rv[:, :, 0]  # dF . dF[idx] — the refreshed Gram row/column
            gram = jax.lax.dynamic_update_slice(gram, row[:, None, :], (0, idx, 0))
            gram = jax.lax.dynamic_update_slice(gram, row[:, :, None], (0, 0, idx))
            g = jnp.where(valid[:, :, None] & valid[:, None, :], gram, 0.0)
            g = g + aa_reg * (
                jnp.trace(g, axis1=-2, axis2=-1)[:, None, None] + 1.0
            ) * jnp.eye(m, dtype=g.dtype)
            rhs = jnp.where(valid, rv[:, :, 1], 0.0)
            gamma = jnp.linalg.solve(g, rhs[..., None])[..., 0]  # (N, m)
            s_aa = t_flat - jnp.einsum("knd,nk->nd", dSF, gamma, precision=hi)

        # Per-image decay safeguard (no extra T evaluations): while residuals
        # keep decaying, extrapolate; a blow-up falls back to the plain step
        # AND restarts that image's window (cnt reset to 0, so extrapolation
        # resumes from fresh post-fallback differences —
        # Zhang-O'Donoghue-Boyd type-I restart).
        bound = safeguard_factor * res0 * (k_acc + 1.0) ** -(1.0 + 1e-6)
        take = (cnt >= 1) & (res <= bound)
        k_acc = jnp.where(take, k_acc + 1.0, k_acc)
        cnt = jnp.where(take, cnt, 0)
        s_next = jnp.where(take[:, None], s_aa, t_flat)
        return (
            s_next.reshape(n, 4, h, w), dSF, dF, gram, t_flat, f, cnt, k_acc,
            res0, r_norm, res, t, zpx, zpy,
        )

    res0_init = jnp.full((n,), -1.0, dtype=y_f.dtype)
    k_acc_init = jnp.zeros((n,), dtype=y_f.dtype)

    if early_stop:
        # Boyd-style stopping on the (extrapolated) iterate sequence: the
        # dual residual uses consecutive z's and the dual variable exactly as
        # in tv_deconvolve_adaptive; once every image satisfies both
        # tolerances the loop exits.  rho stays fixed (AA requires it).
        sqrt_dim = jnp.sqrt(jnp.asarray(2.0 * h * w, dtype=y_f.dtype))
        rho_v = jnp.broadcast_to(jnp.squeeze(rho_f), (n,)).astype(y_f.dtype)

        outer_cap = (iters - 1) // aa_interval

        def cond(carry):
            it, done = carry[-2], carry[-1]
            return jnp.logical_and(
                it < outer_cap, jnp.logical_not(jnp.all(done))
            )

        def wbody(carry):
            (s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, _r, _res,
             it, _done) = carry
            (s2, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, r_norm,
             res, t, zpx, zpy) = aa_core(
                s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, it
            )
            dz = grad2d_adjoint(t[:, 0] - zpx, t[:, 1] - zpy)
            s_norm = rho_v * jnp.sqrt(jnp.sum(dz * dz, axis=(-2, -1)))
            z_norm = jnp.sqrt(jnp.sum(t[:, 0] ** 2 + t[:, 1] ** 2, axis=(-2, -1)))
            dual = grad2d_adjoint(t[:, 2], t[:, 3])
            dual_norm = rho_v * jnp.sqrt(jnp.sum(dual * dual, axis=(-2, -1)))
            eps_pri = sqrt_dim * eps_abs + eps_rel * z_norm
            eps_dual = sqrt_dim * eps_abs + eps_rel * dual_norm
            done = jnp.logical_and(r_norm <= eps_pri, s_norm <= eps_dual)
            return (
                s2, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, r_norm,
                res, it + 1, done,
            )

        flat0 = jnp.zeros((n, d), dtype=y_f.dtype)
        gram0 = jnp.zeros((n, m, m), dtype=y_f.dtype)
        carry0 = (
            s0, hist0, hist0, gram0, flat0, flat0, jnp.zeros((n,), jnp.int32),
            k_acc_init, res0_init, res0_init, res0_init, jnp.asarray(0),
            jnp.zeros((n,), bool),
        )
        out = jax.lax.while_loop(cond, wbody, carry0)
        s, r_norm, fp_res, it_fin = out[0], out[9], out[10], out[11]
        iters_run = it_fin * aa_interval + 1  # + the final output solve below
    else:
        def body(carry, k):
            s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, _r, _res = carry
            (s2, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, r_norm,
             res, _t, _zpx, _zpy) = aa_core(
                s, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, k
            )
            return (
                s2, dSF, dF, gram, t_prev, f_prev, cnt, k_acc, res0, r_norm,
                res,
            ), None

        flat0 = jnp.zeros((n, d), dtype=y_f.dtype)
        gram0 = jnp.zeros((n, m, m), dtype=y_f.dtype)
        carry0 = (
            s0, hist0, hist0, gram0, flat0, flat0, jnp.zeros((n,), jnp.int32),
            k_acc_init, res0_init, res0_init, res0_init,
        )
        out, _ = jax.lax.scan(
            body, carry0, jnp.arange((iters - 1) // aa_interval)
        )
        s, r_norm, fp_res = out[0], out[9], out[10]
        iters_run = jnp.asarray(iters)
    # One final solve produces the output image from the accelerated state —
    # same total solve count as tv_deconvolve (iters-1 loop + 1); residual
    # diagnostics are from the last loop iteration.  fold1: final at HIGH.
    final_prec = jax.lax.Precision.HIGH if fft_mode == "fold1" else None
    q_fin = grad2d_adjoint(s[:, 0] - s[:, 2], s[:, 1] - s[:, 3])
    x = _solve_spectral(
        b_f, c_spec, rho_f, q_fin, h, w, fft_mode, precision=final_prec
    )
    if x_bounds is not None:
        x = jnp.clip(x, x_bounds[0], x_bounds[1])
    diags = ADMMDiagnostics(
        r_norm=r_norm,
        s_norm=fp_res,
        iterations=iters_run,
        rho=jnp.broadcast_to(jnp.squeeze(rho_f), (n,)),
    )
    return _unfold(x, b, c).reshape(orig_shape), diags


def solve_auto(
    y: jnp.ndarray,
    psf: jnp.ndarray | None = None,
    lam=0.1,
    rho=1.0,
    *,
    iters: int | None = None,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    max_iters: int = 400,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
):
    """Solve with the policy's configuration for the request.

      * ``iters`` given (a fixed iteration budget): the whole budget runs
        as ONE ``check_every=iters`` block of :func:`tv_deconvolve_adaptive`
        — the q-carry fast mid-loop with true final residual diagnostics
        from the single end-of-run check, and the mid-loop carry stored
        bf16 when the backend's policy says so (``bf16_state``).
      * tolerance given (default): :func:`tv_deconvolve_adaptive` with
        residual-balanced rho and ``check_every`` (policy
        ``solve_auto_check_every``) block checking.  At DEEP tolerances
        (``eps_abs`` below the policy's ``deep_eps_abs``) the carry stays
        fp32 and the adaptive solver's ``"auto"`` takes the policy's
        ``fft_mode_adaptive``: low-precision iterate noise would floor
        above the stopping threshold there.

    Anderson (:func:`tv_deconvolve_anderson`) is never selected: it reaches
    tolerance in the fewest ADMM *iterations*, but its per-iteration history
    costs more than it saves in wall-clock — use it directly when iteration
    count itself is the budget, preferably with ``aa_interval=8``.

    Returns ``(x, ADMMDiagnostics)`` for every branch.
    """
    p = policy()
    if iters is not None:
        # One check_every=iters block: the whole budget runs the q-carry
        # fast mid-loop (requesting diagnostics from tv_deconvolve would
        # fall back to its 5-plane loop) and the single end-of-run check
        # yields TRUE final residual norms for free.  A one-iteration budget
        # has no mid-loop and runs the scan-based fixed solver.
        if iters <= 1:
            return tv_deconvolve(
                y, psf, lam, rho, iters=iters, prox=prox, x_bounds=x_bounds,
                return_diagnostics=True,
            )
        return tv_deconvolve_adaptive(
            y, psf, lam, rho, max_iters=iters, prox=prox, x_bounds=x_bounds,
            eps_abs=0.0, eps_rel=0.0, adapt_rho=False, check_every=iters,
            state_dtype="bfloat16" if p.bf16_state else None,
        )
    deep = eps_abs < p.deep_eps_abs
    k = p.solve_auto_check_every
    check_every = k if max_iters % k == 0 and max_iters >= k else 1
    narrow = not deep and p.bf16_state and check_every > 1
    return tv_deconvolve_adaptive(
        y, psf, lam, rho, max_iters=max_iters, prox=prox, x_bounds=x_bounds,
        eps_abs=eps_abs, eps_rel=eps_rel, adapt_rho=True,
        check_every=check_every,
        state_dtype="bfloat16" if narrow else None,
    )


def tv_objective(
    x: jnp.ndarray,
    y: jnp.ndarray,
    psf: jnp.ndarray | None,
    lam,
    isotropic: bool = False,
) -> jnp.ndarray:
    """TV-regularized objective ``0.5||Hx - y||^2 + lam * ||Dx||``.

    Correctness note: the reference's ``objfun_iso/aniso``
    (``src/ops/ops.jl:13-14``) use ``||x - y||^2`` — i.e. they omit H — and
    are never called.  This implements the actual objective the solver
    minimizes, for logging/validation.
    """
    x4, _ = _normalize_input(jnp.asarray(x))
    y4, _ = _normalize_input(jnp.asarray(y))
    xf, yf = _fold(x4), _fold(y4)
    h, w = xf.shape[-2:]
    if psf is None:
        hx = xf
    else:
        otf = psf_to_otf(jnp.asarray(psf, dtype=xf.dtype), (h, w))
        hx = jnp.fft.irfft2(otf * jnp.fft.rfft2(xf), s=(h, w))
    data = 0.5 * jnp.sum((hx - yf) ** 2)
    dxx, dxy = grad2d(xf)
    if isotropic:
        tv = jnp.sum(jnp.sqrt(dxx * dxx + dxy * dxy))
    else:
        tv = jnp.sum(jnp.abs(dxx) + jnp.abs(dxy))
    return data + lam * tv
