"""Benchmark suite for the solver's capability surface on an NVIDIA GPU
(SURVEY.md §7.7).

`bench.py` at the repo root prints the headline lines; this suite measures
the rest:

  1080p   — batch-4 RGB, 7x7 motion PSF, aniso TV, 50 iters (native-FFT
            path and the policy's "auto" path, fp32 and bf16 carry)
  4k      — single-frame RGB, same scenario (``--full``)
  parity  — 256^2 reference scenario (lam=0.0041, rho=0.021, 100 iters):
            PSNR of the auto path vs the fp32-exact native-FFT path
  adaptive— iterations/adapted-rho of the early-stopping solver
  train   — flagship AdmmDenoiser train step (``--train``)

Each result prints as one JSON line; pass ``--out FILE`` to also write a
JSON array.  Timing: fresh inputs per repeat, every call ended by
``block_until_ready`` (``utils/profiling.py``).  Needs a GPU.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, ".")

import numpy as np
from admm_deconv.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp

from admm_deconv.metrics import peak_snr
from admm_deconv.ops.solver import (
    resolve_fft_mode,
    tv_deconvolve,
    tv_deconvolve_adaptive,
)
from admm_deconv.utils.profiling import IterationTimer

LAM, RHO, ITERS = 0.0041, 0.021, 50


def motion_psf():
    psf = np.zeros((7, 7), np.float32)
    psf[3, :] = 1.0 / 7.0
    return jnp.asarray(psf)


def time_solve(shape, fft_mode, iters=ITERS, repeats=3,
               state_dtype=None):
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random(shape), jnp.float32)
    psf = motion_psf()

    def solve(y):
        return tv_deconvolve(
            y, psf=psf, lam=LAM, rho=RHO, iters=iters,
            fft_mode=fft_mode, state_dtype=state_dtype,
        )

    timer = IterationTimer(solve, lambda i: (img + 1e-3 * i,))
    stats = timer.measure(repeats=repeats)
    return {
        "s_per_solve": round(stats["seconds_per_call"], 4),
        "iters_per_s": round(iters / stats["seconds_per_call"], 2),
    }


def emit(results, rec):
    print(json.dumps(rec), flush=True)
    results.append(rec)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="include the 4K workload")
    ap.add_argument("--train", action="store_true", help="include the flagship train step (slow compile)")
    ap.add_argument("--anderson", action="store_true",
                    help="Anderson-accelerated solver: iterations-to-residual "
                         "vs plain + per-iteration overhead")
    ap.add_argument("--tiled", action="store_true",
                    help="tiled solver on a tile=1 mesh vs the single-chip "
                         "fast path: shard_map overhead quantification")
    ap.add_argument("--tiled-adaptive", dest="tiled_adaptive", action="store_true",
                    help="tiled adaptive/early-stop solver with check_every=8 "
                         "block checking on a tile=1 mesh (q-carry mid-loop)")
    ap.add_argument("--ttq", action="store_true",
                    help="time-to-tolerance: plain fixed vs adaptive vs "
                         "Anderson at 1080p (honest wall-clock comparison)")
    ap.add_argument("--ttq-4k", dest="ttq_4k", action="store_true",
                    help="time-to-tolerance at 4K single frame (Anderson "
                         "histories ~4.8 GB at m=5)")
    ap.add_argument("--ttq-deep", dest="ttq_deep", action="store_true",
                    help="time-to-DEEP-tolerance (eps 1e-5/1e-4) at 512^2 "
                         "batch-4 — the iteration-dominated regime where "
                         "Anderson's fewer iterations can win wall-clock")
    ap.add_argument("--adaptive-fast", dest="adaptive_fast", action="store_true",
                    help="adaptive solver check_every=8: q-carry fast "
                         "mid-loop iters/s")
    ap.add_argument("--train-scaling", dest="train_scaling", action="store_true",
                    help="flagship train step at batch 2/4/8 (3 slow compiles)")
    ap.add_argument("--train-layer", dest="train_layer", action="store_true",
                    help="learned TV-layer train step at 1080p batch-2: the "
                         "regime where the stencil/DFT kernels (not per-op "
                         "dispatch) dominate the step — fp32 vs bf16 state")
    ap.add_argument("--train-io", dest="train_io", action="store_true",
                    help="epoch throughput with REAL PNG decode at batch 8: "
                         "background-prefetched loader + on-device metric "
                         "accumulation vs the synchronous per-step-fetch loop")
    ap.add_argument("--skip-solves", dest="skip_solves", action="store_true",
                    help="skip the 1080p/parity/adaptive solve benches")
    ap.add_argument("--out", default=None, help="also write a JSON array here")
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_suite.py needs a GPU; JAX found {dev.platform}")
    fast_fft = resolve_fft_mode("auto")
    adaptive_fft = resolve_fft_mode("auto", adaptive=True)
    results = []

    if not args.skip_solves:
        # 1080p batch-4, both paths.
        shape = (4, 1080, 1920, 3)
        emit(results, {"bench": "1080p_batch4", "path": "xla",
                       **time_solve(shape, "xla")})
        emit(results, {"bench": "1080p_batch4", "path": fast_fft,
                       **time_solve(shape, fast_fft)})
        # bf16 STORAGE for the loop carry (fp32 stencil arithmetic).
        emit(results, {"bench": "1080p_batch4",
                       "path": f"{fast_fft}+bf16state",
                       **time_solve(shape, fast_fft, state_dtype="bfloat16")})

    if args.full:
        shape4k = (1, 2160, 3840, 3)
        emit(results, {"bench": "4k_frame", "path": fast_fft,
                       **time_solve(shape4k, fast_fft)})
        emit(results, {"bench": "4k_frame",
                       "path": f"{fast_fft}+bf16state",
                       **time_solve(shape4k, fast_fft, state_dtype="bfloat16")})

    # Quality parity: reference scenario on a synthetic blocks image —
    # 16x16 piecewise-constant tiles, the regime TV regularization is FOR.
    # (An iid-per-pixel binary image is wrong here: tau = lam/rho ~ 0.195
    # soft-thresholds away single-pixel gradients and the converged ADMM
    # solution sits at ~15.7 dB however many iterations run.)
    if not args.skip_solves:
        rng = np.random.default_rng(1)
        tiles = rng.random((3, 16, 16, 3)) > 0.5
        clean = np.clip(
            0.2 + np.kron(tiles, np.ones((1, 16, 16, 1))) * 0.4, 0, 1
        ).astype(np.float32)
        psf_np = np.asarray(motion_psf())
        blurred = sum(
            psf_np[a, c] * np.roll(clean, (a - 3, c - 3), (1, 2))
            for a in range(7) for c in range(7)
        )
        y = jnp.asarray(blurred)
        kw = dict(psf=motion_psf(), lam=LAM, rho=RHO, iters=100)
        x_exact = jnp.clip(tv_deconvolve(y, fft_mode="xla", **kw), 0, 1)
        x_fast = jnp.clip(tv_deconvolve(y, fft_mode=fast_fft, **kw), 0, 1)
        ref = jnp.asarray(clean)
        emit(results, {
            "bench": "parity_256",
            "psnr_blurred_db": round(float(peak_snr(y, ref)), 3),
            "psnr_exact_db": round(float(peak_snr(x_exact, ref)), 3),
            "psnr_fast_db": round(float(peak_snr(x_fast, ref)), 3),
            "max_abs_path_diff": float(jnp.max(jnp.abs(x_exact - x_fast))),
        })

        # Adaptive solver: early stop + residual-balanced rho.
        xa, diag = tv_deconvolve_adaptive(y, psf=motion_psf(), lam=LAM, max_iters=200)
        emit(results, {
            "bench": "adaptive_256",
            "iterations": int(diag.iterations),
            "rho_final_range": [round(float(jnp.min(diag.rho)), 4),
                                round(float(jnp.max(diag.rho)), 4)],
        })

    if args.anderson:
        # How many iterations does Anderson acceleration save, and what does
        # it cost per iteration?  Reference blocks scenario at 256^2.
        from admm_deconv.ops.solver import tv_deconvolve_anderson

        rng = np.random.default_rng(1)
        tiles = rng.random((3, 16, 16, 3)) > 0.5
        clean = np.clip(
            0.2 + np.kron(tiles, np.ones((1, 16, 16, 1))) * 0.4, 0, 1
        ).astype(np.float32)
        psf_np = np.asarray(motion_psf())
        blurred = sum(
            psf_np[a, c] * np.roll(clean, (a - 3, c - 3), (1, 2))
            for a in range(7) for c in range(7)
        )
        ya = jnp.asarray(blurred)
        kw = dict(psf=motion_psf(), lam=LAM, rho=RHO)
        _, d_plain = tv_deconvolve(ya, iters=100, return_diagnostics=True, **kw)
        target = float(jnp.max(d_plain.r_norm))
        aa_needed, aa_res = None, None
        for it in (20, 30, 40, 50, 75, 100):
            _, d_aa = tv_deconvolve_anderson(ya, iters=it, **kw)
            aa_res = float(jnp.max(d_aa.r_norm))
            if aa_res <= target:
                aa_needed = it
                break
        emit(results, {
            "bench": "anderson_256",
            "plain_iters": 100, "plain_r_norm": round(target, 5),
            "aa_iters_to_match": aa_needed,
            "aa_r_norm": round(aa_res, 5) if aa_res is not None else None,
        })
        if not args.skip_solves:
            # Per-iteration overhead at the 1080p bench shape (m=5 window).
            img = jnp.asarray(
                np.random.default_rng(0).random((4, 1080, 1920, 3)), jnp.float32
            )
            # AA runs "fold" (not fold1): the bf16x1 map noise floors its
            # convergence (see tv_deconvolve_anderson docstring).
            fa = lambda v: tv_deconvolve_anderson(
                v, psf=motion_psf(), lam=LAM, rho=RHO, iters=ITERS,
                fft_mode=adaptive_fft,
            )[0]
            timer = IterationTimer(fa, lambda i: (img + 1e-3 * i,))
            stats = timer.measure(repeats=3)
            emit(results, {
                "bench": "anderson_1080p_overhead",
                "path": fast_fft,
                "s_per_solve": round(stats["seconds_per_call"], 4),
                "iters_per_s": round(ITERS / stats["seconds_per_call"], 2),
            })

    if args.tiled:
        # The closest a 1-chip environment gets to scaling evidence: run the
        # FULL distributed machinery (shard_map, all_to_all re-shards,
        # ppermute halos, fused halo-stencil kernel) on a tile=1 mesh and
        # compare against the plain single-chip fast path.  The gap IS the
        # per-iteration collective+shard_map overhead a 2nd chip would have
        # to amortize (the collectives are self-sends at T=1).
        from admm_deconv.parallel import make_mesh, tiled_tv_deconvolve

        mesh1 = make_mesh({"tile": 1})
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.random((4, 1080, 1920, 3)), jnp.float32)
        psf = motion_psf()
        for fm in (fast_fft, "xla"):
            def tiled_solve(y, fm=fm):
                return tiled_tv_deconvolve(
                    y, psf=psf, lam=LAM, rho=RHO, iters=ITERS, mesh=mesh1,
                    fft_mode=fm,
                )
            timer = IterationTimer(tiled_solve, lambda i: (img + 1e-3 * i,))
            stats = timer.measure(repeats=3)
            emit(results, {
                "bench": "tiled_tile1_1080p", "path": fm,
                "s_per_solve": round(stats["seconds_per_call"], 4),
                "iters_per_s": round(ITERS / stats["seconds_per_call"], 2),
            })

    if args.tiled_adaptive:
        # The tiled adaptive/early-stop path
        # with block checking — residual psums and rho adaptation only at
        # check_every boundaries, the mid-block iterations on the q-carry +
        # fused-halo-stencil fast loop.  tile=1 mesh, tolerances zeroed so
        # every config runs exactly n_it iterations; the single-chip
        # adaptive check8 numbers (--adaptive-fast) are the comparators.
        from admm_deconv.parallel import make_mesh, tiled_tv_deconvolve

        mesh1 = make_mesh({"tile": 1})
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.random((4, 1080, 1920, 3)), jnp.float32)
        psf = motion_psf()
        n_it = 96
        configs = [
            # (fft_mode, adapt_rho) — fold1 requires fixed rho in the tiled
            # solver (no distributed per-block x_B re-hoist).
            (adaptive_fft, True),
            (fast_fft, False),
        ]
        for fm, adapt in configs:
            def tsolve(v, fm=fm, adapt=adapt):
                x, _ = tiled_tv_deconvolve(
                    v, psf=psf, lam=LAM, rho=RHO, iters=n_it, mesh=mesh1,
                    adapt_rho=adapt, early_stop=True, check_every=8,
                    eps_abs=0.0, eps_rel=0.0, fft_mode=fm, return_diagnostics=True,
                )
                return x
            stats = IterationTimer(
                tsolve, lambda i: (img + 1e-3 * i,)
            ).measure(repeats=3)
            emit(results, {
                "bench": "tiled_adaptive_tile1_1080p_check8",
                "path": fm, "adapt_rho": adapt,
                "s_per_solve": round(stats["seconds_per_call"], 4),
                "iters_per_s": round(n_it / stats["seconds_per_call"], 2),
            })

    def run_ttq(tag, tile_grid, tile_px, eps_abs=1e-4, eps_rel=1e-3, cap=200):
        # Honest wall-clock: seconds to reach a FIXED residual tolerance on
        # a TV-friendly blocks scene (piecewise-constant tiles + motion
        # blur), for (a) the plain fixed-iteration fast path run for exactly
        # the iteration count that meets the tolerance, (b) the adaptive
        # early-stopping solver, (c) Anderson with early stop.  Iteration
        # counts alone are not a perf claim — this is.
        from admm_deconv.ops.solver import tv_deconvolve_anderson

        rng = np.random.default_rng(1)
        tiles = rng.random(tile_grid) > 0.5
        clean = np.clip(
            0.2 + np.kron(tiles, np.ones((1, tile_px, tile_px, 1))) * 0.4, 0, 1
        ).astype(np.float32)
        psf_np = np.asarray(motion_psf())
        blurred = sum(
            psf_np[a, c] * np.roll(clean, (a - 3, c - 3), (1, 2))
            for a in range(7) for c in range(7)
        )
        y = jnp.asarray(blurred)
        psf = motion_psf()
        eps = dict(eps_abs=eps_abs, eps_rel=eps_rel)

        # (b) adaptive: let IT define the reference tolerance point.
        def part_adaptive():
            def solve_adaptive(v):
                x, _ = tv_deconvolve_adaptive(
                    v, psf=psf, lam=LAM, rho=RHO, max_iters=cap,
                    check_every=8, adapt_rho=True,
                    fft_mode=adaptive_fft, **eps,
                )
                return x
            _, d_ad = tv_deconvolve_adaptive(
                y, psf=psf, lam=LAM, rho=RHO, max_iters=cap, check_every=8,
                adapt_rho=True, fft_mode=adaptive_fft, **eps,
            )
            t_ad = IterationTimer(
                solve_adaptive, lambda i: (y + 1e-4 * i,)
            ).measure(repeats=3)
            emit(results, {
                "bench": tag, "solver": "adaptive(check8)",
                "iterations": int(d_ad.iterations),
                "s_to_tol": round(t_ad["seconds_per_call"], 4),
            })
        part_adaptive()

        if fast_fft == "fold1":
            # Adaptive + fold1 (delta-form bf16x1, per-block x_B
            # re-hoist, HIGH-precision residual-check iterations) — the
            # production configuration at check_every >= 4.
            def part_fold1():
                def solve_ad_f1(v):
                    x, _ = tv_deconvolve_adaptive(
                        v, psf=psf, lam=LAM, rho=RHO, max_iters=cap,
                        check_every=8, adapt_rho=True, fft_mode="fold1", **eps,
                    )
                    return x
                _, d_f1 = tv_deconvolve_adaptive(
                    y, psf=psf, lam=LAM, rho=RHO, max_iters=cap,
                    check_every=8, adapt_rho=True, fft_mode="fold1", **eps,
                )
                t_f1 = IterationTimer(
                    solve_ad_f1, lambda i: (y + 1e-4 * i,)
                ).measure(repeats=3)
                emit(results, {
                    "bench": tag, "solver": "adaptive(check8,fold1)",
                    "iterations": int(d_f1.iterations),
                    "s_to_tol": round(t_f1["seconds_per_call"], 4),
                })
            part_fold1()

        # (c) Anderson with early stop at the same tolerances ("fold", not
        # fold1 — the bf16x1 map noise floors AA's convergence).
        aa_fft = adaptive_fft

        def part_aa():
            def solve_aa(v):
                x, _ = tv_deconvolve_anderson(
                    v, psf=psf, lam=LAM, rho=RHO, iters=cap, early_stop=True,
                    fft_mode=aa_fft, **eps,
                )
                return x
            _, d_aa = tv_deconvolve_anderson(
                y, psf=psf, lam=LAM, rho=RHO, iters=cap, early_stop=True,
                fft_mode=aa_fft, **eps,
            )
            t_aa = IterationTimer(
                solve_aa, lambda i: (y + 1e-4 * i,)
            ).measure(repeats=3)
            emit(results, {
                "bench": tag, "solver": "anderson(m=5,early_stop)",
                "iterations": int(d_aa.iterations),
                "s_to_tol": round(t_aa["seconds_per_call"], 4),
            })
        part_aa()

        # (c2) every-k mixing — AA on G = T^8, ring/Gram/mixing
        # cost amortized over 8 fast q-carry iterations per block.
        def part_aa8():
            def solve_aa8(v):
                x, _ = tv_deconvolve_anderson(
                    v, psf=psf, lam=LAM, rho=RHO, iters=2 * cap + 1,
                    early_stop=True, aa_interval=8, fft_mode=aa_fft, **eps,
                )
                return x
            _, d_aa8 = tv_deconvolve_anderson(
                y, psf=psf, lam=LAM, rho=RHO, iters=2 * cap + 1,
                early_stop=True, aa_interval=8, fft_mode=aa_fft, **eps,
            )
            t_aa8 = IterationTimer(
                solve_aa8, lambda i: (y + 1e-4 * i,)
            ).measure(repeats=3)
            emit(results, {
                "bench": tag, "solver": "anderson(m=5,k=8,early_stop)",
                "iterations": int(d_aa8.iterations),
                "s_to_tol": round(t_aa8["seconds_per_call"], 4),
            })
        part_aa8()

        # (a) plain fixed fast path at the iteration count that reaches the
        # SAME stopping rule (found by a non-adaptive early-stop run).
        def part_fixed():
            _, d_fix = tv_deconvolve_adaptive(
                y, psf=psf, lam=LAM, rho=RHO, max_iters=cap, check_every=8,
                adapt_rho=False, fft_mode=adaptive_fft, **eps,
            )
            n_fix = int(d_fix.iterations)
            def solve_fix(v):
                return tv_deconvolve(
                    v, psf=psf, lam=LAM, rho=RHO, iters=n_fix,
                    fft_mode=fast_fft,
                )
            t_fix = IterationTimer(
                solve_fix, lambda i: (y + 1e-4 * i,)
            ).measure(repeats=3)
            emit(results, {
                "bench": tag, "solver": f"plain_fixed({n_fix})",
                "iterations": n_fix,
                "s_to_tol": round(t_fix["seconds_per_call"], 4),
            })
        part_fixed()

    if args.ttq:
        run_ttq("ttq_1080p", (4, 27, 48, 3), 40)  # (4, 1080, 1920, 3)

    if args.ttq_4k:
        run_ttq("ttq_4k", (1, 27, 48, 3), 80)  # (1, 2160, 3840, 3)

    if args.ttq_deep:
        # 512^2 batch-4 at 10x tighter tolerances: iteration counts blow up
        # for plain ADMM while AA's window keeps cutting them — the regime
        # where per-iteration overhead stops dominating.
        run_ttq("ttq_deep_512", (4, 32, 32, 3), 16,
                eps_abs=1e-5, eps_rel=1e-4, cap=400)

    if args.adaptive_fast:
        # The adaptive solver's between-check iterations on the q-carry
        # mid-loop (check_every=8, rho adaptation on, tolerances zeroed so
        # every run takes exactly max_iters iterations).
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.random((4, 1080, 1920, 3)), jnp.float32)
        psf = motion_psf()
        n_it = 96  # divisible by check_every
        for fm in sorted({adaptive_fft, fast_fft}):
            def solve(v, fm=fm):
                x, _ = tv_deconvolve_adaptive(
                    v, psf=psf, lam=LAM, rho=RHO, max_iters=n_it,
                    check_every=8, eps_abs=0.0, eps_rel=0.0, fft_mode=fm,
                )
                return x
            stats = IterationTimer(
                solve, lambda i: (img + 1e-3 * i,)
            ).measure(repeats=3)
            emit(results, {
                "bench": "adaptive_1080p_check8", "path": fm,
                "s_per_solve": round(stats["seconds_per_call"], 4),
                "iters_per_s": round(n_it / stats["seconds_per_call"], 2),
            })

    if args.train or args.train_scaling:
        import optax
        from admm_deconv.models import AdmmDenoiser
        from admm_deconv.metrics import gmsd_loss

        batches = (2,) if not args.train_scaling else (2, 4, 8)
        # The bf16-state carry is trainable, so the train bench measures
        # both storage configurations.
        for bsz, sdt in [(b, s) for b in batches for s in (None, "bfloat16")]:
          def part_train(bsz=bsz, sdt=sdt):
            rng = np.random.default_rng(2)
            x = jnp.asarray(rng.random((bsz, 112, 112, 3)), jnp.float32)
            t = jnp.asarray(rng.random((bsz, 112, 112, 3)), jnp.float32)
            model = AdmmDenoiser(state_dtype=sdt)
            params = jax.jit(model.init)(jax.random.PRNGKey(0), x)
            opt = optax.adabelief(1e-4)
            opt_state = jax.jit(opt.init)(params)

            @jax.jit
            def step(params, opt_state, x, t):
                loss, grads = jax.value_and_grad(
                    lambda p: gmsd_loss(model.apply(p, x), t)
                )(params)
                upd, opt_state = opt.update(grads, opt_state, params)
                return optax.apply_updates(params, upd), opt_state, loss

            timer = IterationTimer(
                lambda xi, ti: step(params, opt_state, xi, ti)[2],
                lambda i: (x + 1e-3 * i, t),
            )
            stats = timer.measure(repeats=8)
            ms = stats["seconds_per_call"] * 1e3
            emit(results, {"bench": "flagship_train_step", "batch": bsz,
                           "state_dtype": sdt or "float32",
                           "ms_per_step": round(ms, 1),
                           "images_per_s": round(bsz / (ms / 1e3), 1)})
          part_train()

    if args.train_layer:
        # Gradients through the unrolled solver at SOLVER scale (1080p),
        # where the solver's own device time dominates the step instead of
        # the flagship's 112^2 per-op overheads.  remat keeps the 20-iter
        # unroll's saved residuals bounded.
        import optax
        from admm_deconv.layers import ADMMDeconv

        for sdt in (None, "bfloat16"):
            def part_layer(sdt=sdt):
                rng = np.random.default_rng(3)
                x = jnp.asarray(rng.random((2, 1080, 1920, 3)), jnp.float32)
                t = jnp.asarray(rng.random((2, 1080, 1920, 3)), jnp.float32)
                layer = ADMMDeconv(
                    kernel_shape=(), iters=20, iso=False, remat=True,
                    lam_init=0.05, rho_init=0.5, trainable=("lam", "rho"),
                    state_dtype=sdt,
                )
                params = jax.jit(layer.init)(jax.random.PRNGKey(0), x)
                opt = optax.adam(1e-3)
                opt_state = jax.jit(opt.init)(params)

                @jax.jit
                def step(params, opt_state, x, t):
                    loss, grads = jax.value_and_grad(
                        lambda p: jnp.mean((layer.apply(p, x) - t) ** 2)
                    )(params)
                    upd, opt_state = opt.update(grads, opt_state, params)
                    return optax.apply_updates(params, upd), opt_state, loss

                timer = IterationTimer(
                    lambda xi, ti: step(params, opt_state, xi, ti)[2],
                    lambda i: (x + 1e-3 * i, t),
                )
                stats = timer.measure(repeats=4)
                ms = stats["seconds_per_call"] * 1e3
                emit(results, {
                    "bench": "tv_layer_train_step_1080p", "batch": 2,
                    "iters": 20, "state_dtype": sdt or "float32",
                    "ms_per_step": round(ms, 1),
                })
            part_layer()

    if args.train_io:
        # Prove the input pipeline keeps up
        # with the compute step.  Builds a real PNG corpus from the natural
        # fixtures (random 112x112 crops at load time), then times a full
        # epoch of the flagship Trainer with (a) the overlapped loop
        # (prefetch thread + on-device metric sums) and (b) the
        # synchronous comparator (prefetch off + per-batch float fetches).
        import shutil
        import tempfile
        import time as _time

        from PIL import Image

        from admm_deconv.models import AdmmDenoiser
        from admm_deconv.data.feeder import DataLoader, ImageDataFeeder
        from admm_deconv.train import TrainConfig, Trainer

        def part_train_io():
            root = tempfile.mkdtemp(prefix="train_io_")
            fix = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures")
            rng = np.random.default_rng(7)
            xd, yd = os.path.join(root, "x"), os.path.join(root, "y")
            os.makedirs(xd), os.makedirs(yd)
            photos = [
                np.asarray(Image.open(os.path.join(fix, f"{n}.png")), np.float32) / 255.0
                for n in ("china", "flower", "hopper")
            ]
            n_imgs = 48
            for i in range(n_imgs):
                clean = photos[i % 3]
                noisy = np.clip(
                    clean + rng.normal(0, rng.integers(5, 35) / 255.0, clean.shape), 0, 1
                )
                Image.fromarray((clean * 255).astype(np.uint8)).save(
                    os.path.join(yd, f"im{i:03d}.png"))
                Image.fromarray((noisy * 255).astype(np.uint8)).save(
                    os.path.join(xd, f"im{i:03d}.png"))
            bsz = 8
            try:
                for tag, prefetch, on_device in (
                    ("overlapped", 2, True), ("synchronous", 0, False),
                ):
                    cfg = TrainConfig(
                        batch_size=bsz, im_shape=(112, 112), epochs=1,
                        lr_rate=1e-4, loss="gmsd", optimizer="adabelief",
                        save_dir=root, checkpointing=False,
                        prefetch_batches=prefetch,
                    )
                    trainer = Trainer(AdmmDenoiser(), cfg)
                    feeder = ImageDataFeeder(
                        xd, yd, ".png", (112, 112), (112, 112),
                        rng=np.random.default_rng(3),
                    )
                    loader = DataLoader(
                        feeder, batch_size=bsz, shuffle=True, drop_last=True,
                        rng=np.random.default_rng(4),
                    )
                    state = trainer.init_state(
                        jax.random.PRNGKey(0), np.zeros((bsz, 112, 112, 3), np.float32)
                    )
                    # Warm the compile outside the timed epoch.  The step
                    # DONATES (state, acc): keep the returned state and
                    # never touch the donated originals again.
                    xb, yb = next(iter(loader))
                    state, acc = trainer._train_step(
                        state, jnp.asarray(xb), jnp.asarray(yb),
                        trainer._zero_acc(),
                    )
                    jax.block_until_ready(state.params)

                    def run_epoch():
                        nonlocal state
                        acc = trainer._zero_acc()
                        n = 0
                        if prefetch:
                            from admm_deconv.train.prefetch import Prefetcher

                            it = Prefetcher(
                                loader, transform=trainer._shard_batch, depth=prefetch
                            )
                        else:
                            it = ((trainer._shard_batch(x, y)) for x, y in loader)
                        for x, y in it:
                            state, acc = trainer._train_step(state, x, y, acc)
                            if not on_device:
                                _ = [float(v) for v in acc.values()]
                            n += 1
                        # Force completion: fetch the accumulated loss.
                        _ = float(acc["loss"])
                        return n

                    for rep in range(2):  # rep 0 flushes any residual
                        t0 = _time.time()  # compile; rep 1 is steady state
                        nb = run_epoch()
                        dt = _time.time() - t0
                        imgs = nb * bsz
                        emit(results, {
                            "bench": "train_epoch_io", "mode": tag,
                            "batch": bsz, "epoch_rep": rep, "batches": nb,
                            "seconds": round(dt, 3),
                            "images_per_s": round(imgs / dt, 1),
                        })
            finally:
                shutil.rmtree(root, ignore_errors=True)

        part_train_io()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
