#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU, at full width.

    python chip_smoke.py            # one card: every single-card phase
    python chip_smoke.py --multi    # four cards: the multi-card phases only

Phases (one line each; any failure ends the script with a non-zero code):

  device      the JAX device, the card's name and power limit
  reference   the fp32 comparator (fft_mode="xla", fp32 carry, HIGHEST
              matmul precision) against the float64 numpy twin
              (tests/reference_twin.py) on a 1080x1920 RGB frame
  kernels     the Triton stencil kernel as compiled for the card, against
              the plain jnp stencil (and that against the numpy twin)
  solve_1080p tv_deconvolve with fft_mode="auto" and the policy's carry at
  solve_4k    1080p batch-4 and on one 4K frame, against the comparator,
              with iterations/s
  to_tolerance solve_auto at 1080p batch-4 stops on its tolerance, through
              the q-carry mid-loop
  composite   composite_tv_deconvolve with a [0, 1] box
  gradient    jax.grad through the unrolled solver (remat) and through the
              implicit-differentiation solver
  train       Trainer steps of AdmmDenoiser (only where flax imports)

With ``--multi``: the tiled solver over a 4-card tile mesh against the
single-card solver, fixed-iteration and adaptive.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from admm_deconv.ops.composite import composite_tv_deconvolve  # noqa: E402
from admm_deconv.ops.diff import grad2d  # noqa: E402
from admm_deconv.ops.fft import psf_to_otf  # noqa: E402
from admm_deconv.ops.implicit import tv_deconvolve_implicit  # noqa: E402
from admm_deconv.ops.policy import policy  # noqa: E402
from admm_deconv.ops.solver import (  # noqa: E402
    resolve_fft_mode,
    solve_auto,
    tv_deconvolve,
)
from admm_deconv.ops.stencil import _jnp_stencil_step  # noqa: E402
from admm_deconv.ops.stencil_triton import stencil_step_triton  # noqa: E402
import reference_twin as twin  # noqa: E402

LAM, RHO = 0.0041, 0.021
SHAPE_1080P = (4, 1080, 1920, 3)
SHAPE_4K = (1, 2160, 3840, 3)
SHAPE_MULTI = (4, 2160, 3840, 3)
SHAPE_GRAD = (2, 1080, 1920, 3)
ITERS = 50
TILE_PX = 24
CARD = ""


def log(phase, **kv):
    print(json.dumps({"phase": phase, **kv, "card": CARD}), flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def motion_psf():
    psf = np.zeros((7, 7), np.float32)
    psf[3, :] = 1.0 / 7.0
    return psf


def blocks_scene(shape, seed):
    """Piecewise-constant tiles (the regime TV regularization is for)."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    tiles = rng.random((b, -(-h // TILE_PX), -(-w // TILE_PX), c)) > 0.5
    img = np.kron(tiles, np.ones((1, TILE_PX, TILE_PX, 1)))[:, :h, :w]
    return (0.2 + 0.4 * img).astype(np.float32)


@jax.jit
def blur(x, psf):
    """Centered circular convolution with the PSF (the forward model)."""
    otf = psf_to_otf(psf, x.shape[1:3])
    xf = jnp.transpose(x, (0, 3, 1, 2))
    yf = jnp.fft.irfft2(otf * jnp.fft.rfft2(xf), s=x.shape[1:3])
    return jnp.transpose(yf, (0, 2, 3, 1))


def psnr(x, ref):
    mse = float(jnp.mean((jnp.clip(x, 0, 1) - ref) ** 2))
    return 10 * math.log10(1.0 / mse)


def comparator(y, psf, iters, **kw):
    """The fp32 reference path: native FFT, fp32 carry, HIGHEST matmuls."""
    with jax.default_matmul_precision("highest"):
        return jax.block_until_ready(
            tv_deconvolve(y, psf, LAM, RHO, iters=iters, fft_mode="xla", **kw)
        )


def auto_is_fp32():
    p = policy()
    return resolve_fft_mode("auto") == "xla" and not p.bf16_state


def carry_dtype():
    return "bfloat16" if policy().bf16_state else None


def card_name():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def iters_per_s(fn, y, iters, repeats=3):
    jax.block_until_ready(fn(y))
    inputs = [jax.block_until_ready(y + 1e-3 * (i + 1)) for i in range(repeats)]
    t0 = time.perf_counter()
    for inp in inputs:
        jax.block_until_ready(fn(inp))
    return iters * repeats / (time.perf_counter() - t0)


def phase_reference(psf):
    shape = (1, 1080, 1920, 3)
    clean = blocks_scene(shape, SEED)
    y = blur(jnp.asarray(clean), jnp.asarray(psf))
    x = comparator(y, jnp.asarray(psf), 20)
    worst = 0.0
    y64 = np.asarray(y, np.float64)
    for ch in range(3):
        ref = twin.admm_tv_reference(
            y64[0, :, :, ch], psf.astype(np.float64), LAM, RHO, iters=20
        )
        worst = max(worst, float(np.max(np.abs(np.asarray(x[0, :, :, ch]) - ref))))
    log("reference", shape=list(shape), iters=20, max_abs_vs_numpy=worst)
    check(worst <= 1e-4, f"comparator vs numpy twin: {worst} > 1e-4")


def phase_kernels():
    """The Triton stencil kernel as compiled for the card against the plain
    jnp stencil compiled for the same card, at both full-width shapes; the
    jnp stencil against the numpy twin on one plane."""
    worst = {}
    bf16, f32 = jnp.bfloat16, jnp.float32
    for name, (b, h, w, c) in (("1080p", SHAPE_1080P), ("4k", SHAPE_4K)):
        rng = np.random.default_rng(SEED)
        n = b * c
        x = jnp.asarray(rng.random((n, h, w)), f32)
        ux = jnp.asarray(0.1 * rng.standard_normal((n, h, w)), f32)
        uy = jnp.asarray(0.1 * rng.standard_normal((n, h, w)), f32)
        tau = jnp.asarray(rng.uniform(0.01, 0.1, (n,)), f32)
        for mode in ("aniso", "iso"):
            kern = jax.jit(lambda *a, m=mode: stencil_step_triton(*a, m))
            plain = jax.jit(lambda *a, m=mode: _jnp_stencil_step(*a, m))
            d32 = max(float(jnp.max(jnp.abs(k - p)))
                      for k, p in zip(kern(x, ux, uy, tau), plain(x, ux, uy, tau)))
            check(d32 <= 1e-6, f"kernel {name} {mode} fp32: max abs {d32}")
            u16 = (ux.astype(bf16), uy.astype(bf16))
            d16 = max(
                float(jnp.max(jnp.abs(k.astype(f32) - p.astype(f32))
                              / jnp.maximum(jnp.abs(p.astype(f32)), 1e-30)))
                for k, p in zip(kern(x, *u16, tau), plain(x, *u16, tau))
            )
            check(d16 <= 2.0 ** -8, f"kernel {name} {mode} bf16: rel {d16}")
            plane = twin.admm_stencil(
                *(np.asarray(a[0], np.float64) for a in (x, ux, uy)),
                float(tau[0]), mode,
            )
            dt = max(float(np.max(np.abs(np.asarray(g[0]) - p)))
                     for g, p in zip(plain(x, ux, uy, tau), plane))
            check(dt <= 1e-5, f"jnp stencil {name} {mode} vs numpy twin: {dt}")
            worst[f"{name}_{mode}"] = {"fp32_max_abs": d32, "bf16_max_rel": d16,
                                       "jnp_vs_twin": dt}
    log("kernels", kernel="admm_stencil (Pallas, backend=triton)", checks=worst)


def phase_solve(tag, shape, psf):
    clean = jnp.asarray(blocks_scene(shape, SEED))
    y = jax.block_until_ready(blur(clean, psf))
    x_ref = comparator(y, psf, ITERS)
    sdt = carry_dtype()
    fn = jax.jit(
        lambda v: tv_deconvolve(v, psf, LAM, RHO, iters=ITERS, fft_mode="auto",
                                state_dtype=sdt)
    )
    x = jax.block_until_ready(fn(y))
    dev = float(jnp.max(jnp.abs(x - x_ref)))
    tol = 1e-4 if auto_is_fp32() else 5e-3
    p_blur, p_ref, p_auto = psnr(y, clean), psnr(x_ref, clean), psnr(x, clean)
    rate = iters_per_s(fn, y, ITERS)
    log(tag, shape=list(shape), fft_mode=resolve_fft_mode("auto"),
        state_dtype=sdt or "float32", max_abs_vs_comparator=dev, tol=tol,
        psnr_blurred=p_blur, psnr_comparator=p_ref, psnr_auto=p_auto,
        iters_per_s=rate)
    check(dev <= tol, f"{tag}: max abs {dev} > {tol}")
    check(abs(p_auto - p_ref) <= 0.05, f"{tag}: PSNR {p_auto} vs {p_ref}")
    check(p_auto >= p_blur + 5, f"{tag}: PSNR gain {p_auto - p_blur} < 5 dB")


def _has_scan_in_while(jaxpr, in_while=False):
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan" and in_while:
            return True
        inner_while = in_while or name == "while"
        for v in eqn.params.values():
            subs = v if isinstance(v, (list, tuple)) else [v]
            for sub in subs:
                j = getattr(sub, "jaxpr", sub)
                if hasattr(j, "eqns") and _has_scan_in_while(j, inner_while):
                    return True
    return False


def phase_to_tolerance(psf):
    shape = SHAPE_1080P
    clean = jnp.asarray(blocks_scene(shape, SEED + 1))
    y = jax.block_until_ready(blur(clean, psf))
    eps_abs, eps_rel, max_iters = 1e-4, 1e-3, 400
    run = lambda v: solve_auto(  # noqa: E731
        v, psf, LAM, RHO, eps_abs=eps_abs, eps_rel=eps_rel, max_iters=max_iters
    )
    mid_loop = _has_scan_in_while(jax.make_jaxpr(run)(y).jaxpr)
    check(mid_loop, "to_tolerance: solve_auto did not run the q-carry mid-loop")
    t0 = time.perf_counter()
    x, d = jax.block_until_ready(run(y))
    seconds = time.perf_counter() - t0
    it = int(d.iterations)
    # Stopping needs r <= eps_pri with eps_pri >= sqrt(2HW) eps_abs +
    # eps_rel ||D x|| and ||z|| <= ||D x|| + r, so
    # r <= (sqrt(2HW) eps_abs + eps_rel ||D x||) / (1 - eps_rel).
    xf = jnp.transpose(x, (0, 3, 1, 2)).reshape(-1, *x.shape[1:3])
    dxx, dxy = grad2d(xf)
    dx_norm = np.asarray(jnp.sqrt(jnp.sum(dxx**2 + dxy**2, axis=(-2, -1))))
    sqrt_n = math.sqrt(2.0 * shape[1] * shape[2])
    r_bound = (sqrt_n * eps_abs + eps_rel * dx_norm) / (1 - eps_rel)
    r = np.asarray(d.r_norm)
    s = np.asarray(d.s_norm)
    log("to_tolerance", shape=list(shape), iterations=it, max_iters=max_iters,
        r_norm_max=float(r.max()), r_bound_min=float(r_bound.min()),
        s_norm_max=float(s.max()), rho_range=[float(jnp.min(d.rho)),
                                              float(jnp.max(d.rho))],
        q_carry_mid_loop=mid_loop, seconds_incl_compile=seconds)
    check(it < max_iters, f"to_tolerance: ran all {max_iters} iterations")
    check(bool(np.all(r <= r_bound)), "to_tolerance: primal residual above tolerance")
    check(bool(np.all(np.isfinite(s))), "to_tolerance: dual residual not finite")
    check(bool(jnp.all(jnp.isfinite(x))), "to_tolerance: non-finite output")


def phase_composite(psf):
    shape = SHAPE_1080P
    clean = jnp.asarray(blocks_scene(shape, SEED + 2))
    y = jax.block_until_ready(blur(clean, psf))
    kw = dict(lam_tv=LAM, lam_l1=1e-4, rho1=RHO, rho2=RHO, iters=ITERS,
              x_bounds=(0.0, 1.0))
    with jax.default_matmul_precision("highest"):
        ref = jax.block_until_ready(
            composite_tv_deconvolve(y, psf, fft_mode="xla", **kw)
        )
    x = jax.block_until_ready(
        composite_tv_deconvolve(y, psf, state_dtype=carry_dtype(), **kw)
    )
    lo, hi = float(jnp.min(x)), float(jnp.max(x))
    dev = float(jnp.max(jnp.abs(x - ref)))
    tol = 1e-4 if auto_is_fp32() else 5e-3
    p_blur, p_ref, p_auto = psnr(y, clean), psnr(ref, clean), psnr(x, clean)
    log("composite", shape=list(shape), min=lo, max=hi,
        max_abs_vs_comparator=dev, tol=tol, psnr_blurred=p_blur,
        psnr_comparator=p_ref, psnr_auto=p_auto)
    check(lo >= 0.0 and hi <= 1.0, f"composite: outside the box [{lo}, {hi}]")
    check(dev <= tol, f"composite: max abs {dev} > {tol}")
    check(abs(p_auto - p_ref) <= 0.05, f"composite: PSNR {p_auto} vs {p_ref}")
    check(p_auto >= p_blur + 5, f"composite: PSNR gain {p_auto - p_blur} < 5 dB")


def phase_gradient(psf):
    shape = SHAPE_GRAD
    clean = jnp.asarray(blocks_scene(shape, SEED + 3))
    y = jax.block_until_ready(blur(clean, psf))
    sdt = carry_dtype()

    def loss(params, fft_mode, state_dtype):
        lam, rho = params
        x = tv_deconvolve(y, psf, lam, rho, iters=10, remat=True,
                          fft_mode=fft_mode, state_dtype=state_dtype)
        return jnp.mean((x - clean) ** 2)

    p0 = (jnp.float32(LAM), jnp.float32(RHO))
    g = jax.block_until_ready(jax.grad(loss)(p0, "auto", sdt))
    with jax.default_matmul_precision("highest"):
        g_ref = jax.block_until_ready(jax.grad(loss)(p0, "xla", None))
    rel = max(
        abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(g, g_ref)
    )
    tol = 1e-4 if sdt is None else 1e-2
    g_imp = jax.block_until_ready(
        jax.grad(
            lambda lam: jnp.mean(
                (tv_deconvolve_implicit(y, psf, lam, RHO, iters=10) - clean) ** 2
            )
        )(jnp.float32(LAM))
    )
    log("gradient", shape=list(shape), grad_lam_rho=[float(v) for v in g],
        grad_ref=[float(v) for v in g_ref], rel_err=rel, tol=tol,
        grad_implicit_lam=float(g_imp))
    check(rel <= tol, f"gradient: relative error {rel} > {tol}")
    check(bool(jnp.isfinite(g_imp)), "gradient: implicit gradient not finite")


def phase_train():
    try:
        import flax  # noqa: F401
        import optax  # noqa: F401
    except ImportError as e:
        log("train", skipped=f"{e.name} is not installed")
        return
    from admm_deconv.models import AdmmDenoiser
    from admm_deconv.train import TrainConfig, Trainer

    with open(os.path.join(ROOT, "configs", "train_cfg.json")) as f:
        cfg = TrainConfig.from_dict({**json.load(f), "checkpointing": False})
    (h, w), batch = cfg.im_shape, cfg.batch_size
    rng = np.random.default_rng(SEED)
    pair = lambda: tuple(  # noqa: E731
        jnp.asarray(rng.random((batch, h, w, 3), np.float32)) for _ in range(2)
    )
    trainer = Trainer(AdmmDenoiser(), cfg)
    state = trainer.init_state(jax.random.PRNGKey(SEED), pair()[0])
    acc = trainer._zero_acc()
    losses, total = [], 0.0
    for _ in range(3):
        state, acc = trainer._train_step(state, *pair(), acc)
        now = float(acc["loss"])
        losses.append(now - total)
        total = now
    cache = trainer._train_step._cache_size()
    log("train", im_shape=[h, w], batch=batch, loss=cfg.loss,
        optimizer=cfg.optimizer, losses=losses, jit_cache_size=cache)
    check(all(math.isfinite(v) for v in losses), "train: non-finite loss")
    check(cache == 1, f"train: {cache} compiled train steps, expected 1")


def multi_phases(psf):
    from admm_deconv.parallel import make_mesh, tiled_tv_deconvolve
    from admm_deconv.ops.solver import tv_deconvolve_adaptive

    mesh = make_mesh({"tile": 4})
    clean = jnp.asarray(blocks_scene(SHAPE_MULTI, SEED))
    y = jax.block_until_ready(blur(clean, psf))
    iters = 24
    ref = tv_deconvolve(y, psf, LAM, RHO, iters=iters, fft_mode="xla")
    got = tiled_tv_deconvolve(y, psf, LAM, RHO, iters=iters, mesh=mesh,
                              fft_mode="xla")
    dev = float(jnp.max(jnp.abs(jnp.asarray(got) - ref)))
    log("tiled_fixed", shape=list(SHAPE_MULTI), mesh={"tile": 4}, iters=iters,
        max_abs_vs_single=dev)
    check(dev <= 1e-4, f"tiled_fixed: max abs {dev} > 1e-4")

    kw = dict(adapt_rho=True, check_every=8)
    _, d_ref = tv_deconvolve_adaptive(y, psf, LAM, RHO, max_iters=400,
                                      fft_mode="xla", **kw)
    x_t, d_t = tiled_tv_deconvolve(y, psf, LAM, RHO, iters=400, mesh=mesh,
                                   early_stop=True, fft_mode="xla",
                                   return_diagnostics=True, **kw)
    it_ref, it_t = int(d_ref.iterations), int(d_t.iterations)
    log("tiled_adaptive", shape=list(SHAPE_MULTI), iterations_single=it_ref,
        iterations_tiled=it_t)
    check(it_ref == it_t, f"tiled_adaptive: {it_t} vs {it_ref} iterations")
    check(bool(jnp.all(jnp.isfinite(x_t))), "tiled_adaptive: non-finite output")

    try:
        import flax  # noqa: F401
    except ImportError as e:
        log("train_mesh", skipped=f"{e.name} is not installed")


def main():
    global CARD, SEED
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card phases")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    SEED = args.seed

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX found {devs[0].platform}")
    want = 4 if args.multi else 1
    if len(devs) < want:
        fail(f"needs {want} GPUs, found {len(devs)}")
    CARD = card_name()
    print(CARD, flush=True)
    log("device", jax=jax.__version__, kind=devs[0].device_kind,
        count=len(devs), policy=dataclasses.asdict(policy()))
    psf_np = motion_psf()
    psf = jnp.asarray(psf_np)
    if args.multi:
        multi_phases(psf)
    else:
        phase_reference(psf_np)
        phase_kernels()
        phase_solve("solve_1080p", SHAPE_1080P, psf)
        phase_solve("solve_4k", SHAPE_4K, psf)
        phase_to_tolerance(psf)
        phase_composite(psf)
        phase_gradient(psf)
        phase_train()
    stats = devs[0].memory_stats() or {}
    log("device", peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


SEED = 0

if __name__ == "__main__":
    main()
