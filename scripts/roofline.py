#!/usr/bin/env python
"""Measure the solver on the GPU: where the device time goes, how far the
stencil is from its memory floor, and the evidence behind the ``"gpu"``
entry of the auto policy (``admm_deconv/ops/policy.py``).

Run on a machine with an NVIDIA GPU::

    python scripts/roofline.py [--out chiprun_out/roofline.json]

For the two full-width workloads (1080p batch-4 RGB and one 4K RGB frame,
7x7 motion PSF, 50 iterations) it prints one JSON line per measurement
(``--only`` picks a subset):

* ``matmul``: which dot algorithm XLA chose for an f32 matmul at DEFAULT,
  HIGH and HIGHEST, and its error against float64.
* ``solve``: iterations/s of ``tv_deconvolve`` for each ``fft_mode``
  (``xla`` = cuFFT, ``fold1``, ``fold``; ``--modes``), carry dtype, and
  precompute transform (``precompute_fft_mxu``), with the maximum deviation
  from the fp32 ``xla`` solve.
* ``stencil``: the stencil section alone, as XLA's fusion of the jnp
  expression and as the Triton kernel, against its memory floor.
* ``kernel``: the solver end to end with each stencil (policy
  ``stencil_kernel`` off/on), in turns.
* ``trace`` / ``kernel_trace``: device time per solver phase from a
  ``jax.profiler`` trace of one solve, the stencil's memory floor and the
  device's idle share.  Run these with
  ``XLA_FLAGS=--xla_gpu_enable_command_buffer=``: otherwise the loop body
  runs as one command buffer and its kernels are not attributed.

Timing: fresh inputs per repeat, each call ended by ``block_until_ready``.
Every line names the card, its power limit and the JAX device.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

from admm_deconv.ops.policy import overrides
from admm_deconv.ops.solver import tv_deconvolve
from admm_deconv.utils.profiling import (
    IterationTimer,
    device_time_by_scope,
    hlo_op_names,
    latest_xplane,
)

# Published peaks keyed by jax's device_kind.  Source: NVIDIA H100 Tensor
# Core GPU data sheet (SXM part, dense rates), at its 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "fp32_flops": 67e12,
    },
}

LAM, RHO, ITERS = 0.0041, 0.021, 50
SHAPES = {"1080p_b4": (4, 1080, 1920, 3), "4k": (1, 2160, 3840, 3)}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(dev) -> dict:
    if dev.device_kind not in PEAKS:
        raise KeyError(f"no published peaks for {dev.device_kind!r}")
    return PEAKS[dev.device_kind]


def motion_psf():
    psf = np.zeros((7, 7), np.float32)
    psf[3, :] = 1.0 / 7.0
    return jnp.asarray(psf)


def stencil_floor_bytes(shape, carry_itemsize: int) -> int:
    """Bytes one stencil pass must move: read x (fp32) and (ux, uy), write
    (q, ux', uy') in the carry dtype."""
    b, h, w, c = shape
    return b * c * h * w * (4 + 5 * carry_itemsize)


def solver(fft_mode, state_dtype, psf):
    return jax.jit(
        lambda y: tv_deconvolve(
            y, psf=psf, lam=LAM, rho=RHO, iters=ITERS, fft_mode=fft_mode,
            state_dtype=state_dtype,
        )
    )


def top_ops(ops, op_names, k=12):
    """The k longest instructions: (name, ms, scope or '?')."""
    from admm_deconv.utils.profiling import scope_of

    best = sorted(ops.items(), key=lambda kv: -kv[1])[:k]
    return [
        (op, ns * 1e-6, scope_of(op_names[op]) if op in op_names else "?")
        for op, ns in best
    ]


def stencil_alone(name, shape, emit, pk, steps=20, repeats=5):
    """The stencil section alone: ``steps`` chained passes in one jitted
    scan (q feeds the next pass's x), timed end to end, as XLA's fusion of
    the jnp expression and as the Triton kernel, for both carry dtypes;
    with the kernel's largest deviation from the jnp stencil."""
    from admm_deconv.ops.stencil import _jnp_stencil_step
    from admm_deconv.ops.stencil_triton import stencil_step_triton

    b, h, w, c = shape
    n = b * c
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.standard_normal((n, h, w)), jnp.float32)
    tau = jnp.asarray(rng.uniform(0.1, 0.3, (n,)), jnp.float32)
    impls = {
        "xla": lambda x, ux, uy: _jnp_stencil_step(x, ux, uy, tau, "aniso"),
        "kernel": lambda x, ux, uy: stencil_step_triton(x, ux, uy, tau, "aniso"),
    }
    for sdt in (jnp.float32, jnp.bfloat16):
        u = (0.1 * x0).astype(sdt)
        outs = {k: jax.jit(f)(x0, u, u) for k, f in impls.items()}
        dev = max(
            float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))
            for a, b in zip(outs["kernel"], outs["xla"])
        )
        for impl, f in impls.items():
            @jax.jit
            def run(x, f=f, sdt=sdt):
                def body(carry, _):
                    q, ux, uy = f(carry[0].astype(jnp.float32), carry[1], carry[2])
                    return (q, ux, uy), None
                v = (0.1 * x).astype(sdt)
                out, _ = jax.lax.scan(body, (v, v, v), None, length=steps)
                return out

            stats = IterationTimer(
                run, lambda i: (x0 + 1e-3 * (i + 2),)
            ).measure(repeats=repeats)
            per = stats["seconds_per_call"] / steps
            floor = stencil_floor_bytes(shape, jnp.dtype(sdt).itemsize) / pk["hbm_bytes_per_s"]
            emit({"bench": "stencil_alone", "shape": name, "impl": impl,
                  "state_dtype": jnp.dtype(sdt).name,
                  "ms_per_pass": per * 1e3, "floor_ms": floor * 1e3,
                  "over_floor": per / floor,
                  "max_abs_kernel_vs_xla": dev})


def kernel_end_to_end(name, shape, emit, psf, repeats, trace):
    """The solver with the stencil as XLA's fusion of the jnp expression
    and as the Triton kernel (policy ``stencil_kernel``), in turns
    (xla, kernel, kernel, xla): iterations/s, or with ``trace`` the
    stencil's device time per iteration."""
    img = jnp.asarray(np.random.default_rng(0).random(shape, dtype=np.float32))
    results = {"xla": [], "kernel": []}
    for impl in ("xla", "kernel", "kernel", "xla"):
        with overrides(stencil_kernel=impl == "kernel"):
            jax.clear_caches()  # tv_deconvolve's own jit cache holds a trace
            fn = solver("xla", None, psf).lower(img).compile()
            if trace:
                op_names = hlo_op_names(fn.as_text())
                jax.block_until_ready(fn(img + 0.5))
                with tempfile.TemporaryDirectory() as d:
                    with jax.profiler.trace(d):
                        jax.block_until_ready(fn(img + 0.25))
                    red = device_time_by_scope(latest_xplane(d), op_names,
                                               "/device:GPU")
                results[impl].append({
                    "stencil_ms_per_iter":
                        red["scopes"].get("stencil", 0) * 1e-6 / (ITERS - 1),
                    "unmatched_ms_per_iter":
                        red["unmatched_ns"] * 1e-6 / (ITERS - 1),
                    "busy_ms": red["busy_ns"] * 1e-6,
                    "window_ms": red["window_ns"] * 1e-6,
                    "top_ops": top_ops(red["ops"], op_names, 6)})
            else:
                stats = IterationTimer(
                    fn, lambda i: (img + 1e-3 * (i + 2),)
                ).measure(repeats=repeats)
                results[impl].append(ITERS / stats["seconds_per_call"])
    jax.clear_caches()
    emit({"bench": "kernel_trace" if trace else "kernel_end_to_end",
          "shape": name, "results": results})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write a JSON array here")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--only", default="matmul,solve,stencil,kernel,trace",
                    help="comma-separated subset of the measurements")
    ap.add_argument("--modes", default="xla,fold1,fold",
                    help="fft modes the solve measurement compares")
    args = ap.parse_args()
    only = set(args.only.split(","))

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform}")
    pk = peaks(dev)
    where = {"card": card(), "platform": dev.platform,
             "kind": dev.device_kind, "count": len(jax.devices())}
    results = []

    def emit(rec):
        rec = {**rec, **where}
        print(json.dumps(rec), flush=True)
        results.append(rec)

    # Matmul precision: the algorithm XLA picks for an f32 dot, and the
    # error it makes against float64 (TF32 keeps 10 mantissa bits).
    psf = motion_psf()
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal((2048, 2048))
    exact = a64 @ a64
    a = jnp.asarray(a64, jnp.float32)
    for prec in ("DEFAULT", "HIGH", "HIGHEST") if "matmul" in only else ():
        p = getattr(jax.lax.Precision, prec)
        fn = jax.jit(lambda x, p=p: jnp.dot(x, x, precision=p))
        txt = fn.lower(a).compile().as_text()
        gemm = [ln.strip() for ln in txt.splitlines() if "custom_call_target" in ln]
        rel = float(np.max(np.abs(np.asarray(fn(a), np.float64) - exact))
                    / np.max(np.abs(exact)))
        emit({"bench": "matmul_precision", "precision": prec,
              "max_rel_err_vs_f64": rel,
              "gemm_config": re.findall(r'"precision_config":\{[^}]*\}|"algorithm":"?[A-Z_0-9]+"?', " ".join(gemm))})

    configs = [
        ("xla", None, False), ("xla", "bfloat16", False),
        ("xla", None, True), ("fold1", None, True), ("fold", None, True),
    ]
    for name, shape in SHAPES.items():
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.random(shape, dtype=np.float32))
        if "stencil" in only:
            stencil_alone(name, shape, emit, pk)
        if "kernel" in only or "kernel_trace" in only:
            kernel_end_to_end(name, shape, emit, psf, args.repeats,
                              trace="kernel_trace" in only)
        with overrides(precompute_fft_mxu=False):
            ref = solver("xla", None, psf)(img)
        modes = args.modes.split(",")
        for fm, sdt, mxu_pre in configs if "solve" in only else ():
            if fm not in modes:
                continue
            with overrides(precompute_fft_mxu=mxu_pre):
                fn = solver(fm, sdt, psf)
                dev_max = float(jnp.max(jnp.abs(fn(img) - ref)))
                stats = IterationTimer(
                    fn, lambda i: (img + 1e-3 * (i + 2),)
                ).measure(repeats=args.repeats)
            emit({"bench": "solve", "shape": name, "fft_mode": fm,
                  "state_dtype": sdt or "float32",
                  "precompute_fft_mxu": mxu_pre,
                  "iters_per_s": ITERS / stats["seconds_per_call"],
                  "s_per_solve": stats["seconds_per_call"],
                  "max_abs_vs_xla_fp32": dev_max})

        for sdt in (None, "bfloat16") if "trace" in only else ():
            with overrides(precompute_fft_mxu=False):
                fn = solver("xla", sdt, psf).lower(img).compile()
                op_names = hlo_op_names(fn.as_text())
                jax.block_until_ready(fn(img + 0.5))
                with tempfile.TemporaryDirectory() as d:
                    with jax.profiler.trace(d):
                        jax.block_until_ready(fn(img + 0.25))
                    red = device_time_by_scope(
                        latest_xplane(d), op_names, "/device:GPU"
                    )
            itemsize = 2 if sdt else 4
            floor_s = stencil_floor_bytes(shape, itemsize) / pk["hbm_bytes_per_s"]
            # The q-carry loop runs iters - 1 stencil passes.
            st = red["scopes"].get("stencil", 0.0) * 1e-9 / (ITERS - 1)
            emit({"bench": "trace", "shape": name,
                  "state_dtype": sdt or "float32",
                  "scope_ms": {k: v * 1e-6 for k, v in red["scopes"].items()},
                  "unmatched_ms": red["unmatched_ns"] * 1e-6,
                  "trace_lines": red["lines"],
                  "top_ops": top_ops(red["ops"], op_names),
                  "busy_ms": red["busy_ns"] * 1e-6,
                  "window_ms": red["window_ns"] * 1e-6,
                  "idle_share": 1 - red["busy_ns"] / max(red["window_ns"], 1),
                  "stencil_ms_per_iter": st * 1e3,
                  "stencil_floor_ms": floor_s * 1e3,
                  "stencil_over_floor": st / floor_s if st else None})

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
