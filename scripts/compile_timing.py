#!/usr/bin/env python
"""First-compile cost: measurement + the persistent-cache mitigation.

Two phases, run as separate processes so the disk cache (not the
in-process jit cache) is what's measured:

  --phase cold   Compile the production 1080p solve (the policy's fft mode
                 and carry) at a FRESH shape with the persistent cache
                 ENABLED: wall time = true first-compile latency, and the
                 executable lands in the cache.
  --phase warm   Same compile in a new process: wall time = disk-cache
                 load (what every later deployment process pays).

`python scripts/compile_timing.py` (no phase) orchestrates both and
prints one JSON line per phase.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, ".")

SHAPE = (4, 1080, 1928, 3)  # W=1928: off-bench shape so the run is cold


def measure(fft_mode: str) -> float:
    from admm_deconv.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from admm_deconv.ops.solver import tv_deconvolve

    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.random(SHAPE), jnp.float32)
    psf = np.zeros((7, 7), np.float32)
    psf[3, :] = 1 / 7
    from admm_deconv.ops.policy import policy

    sdt = "bfloat16" if policy().bf16_state else None

    def solve(v):
        return tv_deconvolve(
            v, psf=jnp.asarray(psf), lam=0.0041, rho=0.021, iters=50,
            fft_mode=fft_mode, state_dtype=sdt,
        )

    t0 = time.time()
    jax.block_until_ready(solve(y))
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["cold", "warm"], default=None)
    args = ap.parse_args()
    if args.phase:
        dt = measure("auto")
        print(json.dumps({
            "bench": "first_compile", "phase": args.phase,
            "shape": list(SHAPE), "seconds": dt,
        }), flush=True)
        return
    for phase in ("cold", "warm"):
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--phase", phase],
            cwd=os.path.join(os.path.dirname(__file__), ".."),
            capture_output=True, text=True,
        )
        out = [l for l in r.stdout.splitlines() if l.startswith("{")]
        print(out[-1] if out else json.dumps({
            "phase": phase, "error": (r.stderr or r.stdout)[-300:],
        }), flush=True)


if __name__ == "__main__":
    main()
