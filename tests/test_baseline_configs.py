"""Runnable versions of the five BASELINE.json solver configurations
(spatial sizes scaled down where needed to keep CPU tests fast; the code
paths are identical at full size)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from admm_deconv.data.dataset import add_poisson_gaussian
from admm_deconv.layers import ADMMDeconv
from admm_deconv.metrics import peak_snr
from admm_deconv.ops.solver import tv_deconvolve, tv_deconvolve_adaptive
from admm_deconv.parallel import make_mesh, shard_batch, tiled_tv_deconvolve

from reference_twin import circ_conv_centered


def _scene(rng, h, w, c=1):
    img = np.full((h, w, c), 0.25, np.float32)
    for _ in range(8):
        r0, c0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        r1, c1 = rng.integers(h // 2, h), rng.integers(w // 2, w)
        img[r0:r1, c0:c1] += rng.random(c).astype(np.float32) * 0.25
    return np.clip(img, 0, 1)


def _gauss_psf(k=7, sigma=1.2):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    psf = np.outer(g, g)
    return (psf / psf.sum()).astype(np.float32)


def _motion_psf(k=7):
    psf = np.zeros((k, k), np.float32)
    psf[k // 2, :] = 1.0 / k
    return psf


class TestBaselineConfigs:
    def test_config1_grayscale_gaussian_aniso_fixed_rho(self, rng):
        """256x256 grayscale, Gaussian blur, aniso TV, fixed rho, 50 iters."""
        img = _scene(rng, 256, 256)[:, :, 0]
        psf = _gauss_psf()
        blurred = circ_conv_centered(img.astype(np.float64), psf.astype(np.float64))
        x = tv_deconvolve(
            jnp.asarray(blurred, jnp.float32), psf=psf, lam=0.002, rho=0.02,
            iters=50, prox="aniso",
        )
        x = jnp.clip(x, 0, 1)
        ref = jnp.asarray(img)
        assert float(peak_snr(x[None, :, :, None], ref[None, :, :, None])) > float(
            peak_snr(jnp.asarray(blurred, jnp.float32)[None, :, :, None], ref[None, :, :, None])
        )

    def test_config2_rgb_motion_iso_box_adaptive(self, rng):
        """512->128 RGB motion blur, iso TV + box constraints, adaptive rho."""
        img = _scene(rng, 128, 128, 3)
        psf = _motion_psf()
        blurred = np.stack(
            [circ_conv_centered(img[..., c].astype(np.float64), psf.astype(np.float64)) for c in range(3)],
            axis=-1,
        )
        x, diag = tv_deconvolve_adaptive(
            jnp.asarray(blurred, jnp.float32), psf=psf, lam=0.004, rho=0.02,
            prox="iso", x_bounds=(0.0, 1.0), max_iters=120,
        )
        assert float(jnp.min(x)) >= 0.0 and float(jnp.max(x)) <= 1.0
        assert np.all(np.isfinite(np.asarray(diag.rho)))

    def test_config3_batched_sharded_poisson_gaussian(self, rng):
        """Batched frames sharded across chips, Poisson-Gaussian noise,
        solved with the config's stated L1+TV composite prior (round-3 fix:
        this used to run plain TV)."""
        from admm_deconv.ops.composite import composite_tv_deconvolve

        mesh = make_mesh({"data": 8})
        clean = np.stack([_scene(rng, 64, 64, 3) for _ in range(8)])
        noisy = np.stack([add_poisson_gaussian(im, rng, peak=100.0, sigma=10.0) for im in clean])
        y = shard_batch(jnp.asarray(noisy), mesh)
        x = composite_tv_deconvolve(
            y, None, lam_tv=0.05, lam_l1=0.002, rho1=0.5, rho2=0.5,
            iters=30, x_bounds=(0.0, 1.0),
        )
        assert float(peak_snr(x, jnp.asarray(clean))) > float(
            peak_snr(jnp.asarray(noisy), jnp.asarray(clean))
        )
        # Output stays batch-sharded (GSPMD propagates the input sharding)
        # and feasible (box enforced through the z2 prox, no post-clip).
        assert x.sharding.spec[0] == "data"
        assert float(jnp.min(x)) >= 0.0 and float(jnp.max(x)) <= 1.0
        # The plain-TV data-parallel path stays covered too.
        x_tv = jnp.clip(tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=30), 0, 1)
        assert x_tv.sharding.spec[0] == "data"

    def test_config4_unrolled_learned_layer(self, rng):
        """10-iteration differentiable layer with learned rho/lam/kernel."""
        layer = ADMMDeconv(kernel_shape=(5, 5), iters=10, remat=True)
        x_in = jnp.asarray(np.stack([_scene(rng, 32, 32, 1) for _ in range(2)]))
        target = jnp.asarray(np.stack([_scene(rng, 32, 32, 1) for _ in range(2)]))
        params = layer.init(jax.random.PRNGKey(0), x_in)
        import optax

        opt = optax.adam(1e-2)
        ostate = opt.init(params)

        @jax.jit
        def step(p, o):
            l, g = jax.value_and_grad(
                lambda p: jnp.mean((layer.apply(p, x_in) - target) ** 2)
            )(p)
            up, o = opt.update(g, o, p)
            return optax.apply_updates(p, up), o, l

        losses = []
        for _ in range(5):
            params, ostate, loss = step(params, ostate)
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_config5_multiframe_tiled_consensus(self, rng):
        """Multi-frame tiled across the mesh with shared-rho consensus."""
        mesh = make_mesh({"tile": 8})
        frames = np.stack([_scene(rng, 64, 64, 3) for _ in range(2)])
        psf = _motion_psf(5)
        y = jnp.asarray(frames)
        x = tiled_tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.1, iters=20, adapt_rho=True, mesh=mesh
        )
        assert x.shape == y.shape
        assert np.all(np.isfinite(np.asarray(x)))
