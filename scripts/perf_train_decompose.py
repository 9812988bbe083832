"""Where the flagship train step's milliseconds go (run on a GPU).

Times jitted value_and_grad+update steps for the full AdmmDenoiser and for
each sub-assembly in isolation on the BASELINE train workload
(2x112x112x3, gmsd loss, AdaBelief), plus forward-only, and reports
compile seconds for the full step.  Used to decide where training-throughput
effort goes (conv stack vs ADMM bank vs heads vs loss).
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp
import optax
import flax.linen as nn

from admm_deconv.metrics import gmsd_loss
from admm_deconv.models import AdmmDenoiser
from admm_deconv.models.zoo import Autoencoder, DenoiserBank
from admm_deconv.models.blocks import UpDownBlock, relu1
from admm_deconv.utils.profiling import IterationTimer

B, H, W = 2, 112, 112


class Heads(nn.Module):
    """The two UpDownBlock heads + relu1 applied to a 175-ch feature map."""

    @nn.compact
    def __call__(self, v):
        v = UpDownBlock((5, 5), (5, 5), 32, 32)(v)
        v = UpDownBlock((5, 5), (5, 5), 32, 3)(v)
        return relu1(v)


def time_step(name, model, x_ch=3, loss="gmsd", fwd_only=False, repeats=8):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.random((B, H, W, x_ch)), jnp.float32)
    t = jnp.asarray(rng.random((B, H, W, 3)), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)

    def loss_fn(p, xi, ti):
        out = model.apply(p, xi)
        if out.shape[-1] != 3:
            out = out[..., :3]  # sub-assemblies with wide outputs
        return gmsd_loss(out, ti) if loss == "gmsd" else jnp.mean((out - ti) ** 2)

    if fwd_only:
        step = jax.jit(lambda p, xi, ti: loss_fn(p, xi, ti))
        args = lambda i: (params, x + 1e-3 * i, t)
    else:
        opt = optax.adabelief(1e-4)
        opt_state = jax.jit(opt.init)(params)

        @jax.jit
        def step(p, s, xi, ti):
            l, g = jax.value_and_grad(loss_fn)(p, xi, ti)
            upd, s = opt.update(g, s, p)
            return optax.apply_updates(p, upd), s, l

        args = lambda i: (params, opt_state, x + 1e-3 * i, t)

    t0 = time.perf_counter()
    out = step(*args(0))
    jax.tree_util.tree_map(lambda a: a.block_until_ready(), out)
    float(jnp.sum(jax.tree_util.tree_leaves(out)[0]))
    compile_s = time.perf_counter() - t0

    timer = IterationTimer(lambda *a: step(*a)[-1] if not fwd_only else step(*a), args)
    stats = timer.measure(repeats=repeats)
    ms = stats["seconds_per_call"] * 1e3
    print(f"{name:34s} {ms:8.1f} ms/step   (compile {compile_s:.0f} s)")
    return ms


def main():
    print(f"backend={jax.default_backend()}  workload={B}x{H}x{W}x3 gmsd+AdaBelief")
    time_step("full AdmmDenoiser", AdmmDenoiser())
    time_step("full AdmmDenoiser fwd-only", AdmmDenoiser(), fwd_only=True)
    time_step("autoencoder only", Autoencoder())
    time_step("denoiser bank only (xla)", DenoiserBank())
    time_step("denoiser bank only (fold1)", DenoiserBank(fft_mode="fold1"))
    time_step("heads only", Heads(), x_ch=175)
    time_step("full, mse loss", AdmmDenoiser(), loss="mse")


if __name__ == "__main__":
    main()
