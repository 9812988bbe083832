"""Throughput of the solver's main path on an NVIDIA GPU.

    python bench.py

Prints one JSON line per metric; the headline (1080p batch-4 iters/s) is
LAST.  Workload: batched 1080p RGB deconvolution (4 frames, 7x7 motion PSF,
anisotropic TV, 50 iterations) and one 4K RGB frame, through
``tv_deconvolve`` with ``fft_mode="auto"`` and the auto policy's carry
dtype; plus the flagship ``AdmmDenoiser`` train step where flax is
installed.  Timing: fresh inputs per repeat, every call ended by
``block_until_ready``, compilation excluded.  Every line names the card,
its power limit and the JAX device; without a GPU the script exits with an
error.
"""

import json
import subprocess
import sys
import time

import numpy as np
from admm_deconv.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp

from admm_deconv.ops.policy import policy
from admm_deconv.ops.solver import tv_deconvolve

BATCH, H, W, C = 4, 1080, 1920, 3
ITERS = 50
REPEATS = 4


def make_inputs(shape=(BATCH, H, W, C)):
    rng = np.random.default_rng(0)
    img = rng.random(shape, dtype=np.float64).astype(np.float32)
    psf = np.zeros((7, 7), np.float32)
    psf[3, :] = 1.0 / 7.0
    return jnp.asarray(img), jnp.asarray(psf)


def time_fresh(fn, base, repeats=REPEATS):
    """Steady-state seconds per call: fresh inputs per repeat, each call
    ended by block_until_ready."""
    jax.block_until_ready(fn(base))  # warmup/compile
    inputs = [jax.block_until_ready(base + 0.001 * i) for i in range(repeats)]
    t0 = time.perf_counter()
    for inp in inputs:
        jax.block_until_ready(fn(inp))
    return (time.perf_counter() - t0) / repeats


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    where = {"card": card, "platform": dev.platform, "kind": dev.device_kind,
             "count": len(jax.devices())}

    def emit(rec):
        print(json.dumps({**rec, **where}), flush=True)

    sdt = "bfloat16" if policy().bf16_state else None

    def solve(y, psf):
        return tv_deconvolve(
            y, psf=psf, lam=0.0041, rho=0.021, iters=ITERS, fft_mode="auto",
            state_dtype=sdt,
        )

    # ---- secondary metrics first (the headline is the LAST line) ---------
    y4k, psf = make_inputs((1, 2160, 3840, 3))
    s4k = time_fresh(jax.jit(lambda v: solve(v, psf)), y4k, repeats=6)
    emit({"metric": "admm_tv_deconv_iters_per_s_4k_frame",
          "value": ITERS / s4k, "unit": "iters/s"})

    try:
        import flax  # noqa: F401
    except ImportError:
        emit({"metric": "flagship_train_step_ms",
              "skipped": "flax is not installed"})
    else:
        import optax
        from admm_deconv.metrics import gmsd_loss
        from admm_deconv.models import AdmmDenoiser

        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.random((2, 112, 112, 3)), jnp.float32)
        t = jnp.asarray(rng.random((2, 112, 112, 3)), jnp.float32)
        model = AdmmDenoiser()
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

        s_step = time_fresh(lambda xi: step(params, opt_state, xi, t), x, 8)
        emit({"metric": "flagship_train_step_ms", "value": s_step * 1e3,
              "unit": "ms/step"})

    # ---- headline (LAST): 1080p batch-4 -----------------------------------
    y, psf = make_inputs()
    s = time_fresh(jax.jit(lambda v: solve(v, psf)), y)
    emit({"metric": "admm_tv_deconv_iters_per_s_1080p_batch4",
          "value": ITERS / s, "unit": "iters/s"})


if __name__ == "__main__":
    main()
