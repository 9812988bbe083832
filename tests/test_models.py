"""Model-zoo tests: shapes, channel bookkeeping, differentiability."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from admm_deconv.models import (
    AdmmDenoiser,
    Autoencoder,
    DenoiserBank,
    DeconvBank,
    MultistageUpDownscale,
    UpDownBlock,
    DownBlock,
    UpBlock,
    build_model,
    normalise,
    relu1,
    relu6,
)


def _x(rng, b=1, h=112, w=112, c=3):
    return jnp.asarray(rng.random((b, h, w, c)), jnp.float32)


class TestBlocks:
    def test_relu1_relu6(self):
        v = jnp.asarray([-1.0, 0.5, 3.0, 7.0])
        np.testing.assert_allclose(np.asarray(relu1(v)), [0, 0.5, 1, 1])
        np.testing.assert_allclose(np.asarray(relu6(v)), [0, 0.5, 3, 6])

    def test_normalise_per_image(self, rng):
        x = jnp.asarray(rng.random((2, 8, 8, 3)), jnp.float32) * 5 + 2
        out = normalise(x)
        m = np.asarray(jnp.mean(out, axis=(1, 2, 3)))
        s = np.asarray(jnp.std(out, axis=(1, 2, 3)))
        np.testing.assert_allclose(m, 0, atol=1e-5)
        np.testing.assert_allclose(s, 1, atol=1e-2)

    def test_updownblock_preserves_size(self, rng):
        x = _x(rng, h=32, w=32)
        blk = UpDownBlock((5, 5), (5, 5), 8, 4)
        params = blk.init(jax.random.PRNGKey(0), x)
        out = blk.apply(params, x)
        assert out.shape == (1, 32, 32, 4)

    def test_down_up_blocks(self, rng):
        x = _x(rng, h=32, w=32)
        d = DownBlock((5, 5), 8, (3, 3))
        pd = d.init(jax.random.PRNGKey(0), x)
        out_d = d.apply(pd, x)
        assert out_d.shape == (1, 28, 28, 8)
        u = UpBlock((5, 5), 8, (3, 3))
        pu = u.init(jax.random.PRNGKey(0), out_d)
        out_u = u.apply(pu, out_d)
        assert out_u.shape == (1, 32, 32, 8)


class TestZoo:
    def test_denoiser_bank_channels(self, rng):
        x = _x(rng, h=16, w=16)
        m = DenoiserBank(iters=2)
        params = m.init(jax.random.PRNGKey(0), x)
        out = m.apply(params, x)
        assert out.shape == (1, 16, 16, 15)  # 5 branches x 3 channels
        assert float(jnp.min(out)) >= 0.0 and float(jnp.max(out)) <= 1.0

    def test_denoiser_bank_fused_matches_per_branch(self, rng):
        """The single batched solve (fused=True) must equal the 5-branch
        composition given the same lam values."""
        import flax

        x = _x(rng, h=16, w=16)
        fused = DenoiserBank(iters=4, fused=True)
        unfused = DenoiserBank(iters=4, fused=False)
        pf = fused.init(jax.random.PRNGKey(0), x)
        pu = flax.core.unfreeze(unfused.init(jax.random.PRNGKey(0), x))
        lam = np.asarray(pf["params"]["lam"])
        for i in range(5):
            pu["params"][f"ADMMDeconv_{i}"]["lam"] = jnp.asarray([lam[i]])
        np.testing.assert_allclose(
            np.asarray(fused.apply(pf, x)),
            np.asarray(unfused.apply(pu, x)),
            atol=1e-6,
        )

    def test_denoiser_bank_fold_mode_matches_xla(self, rng):
        """fft_mode plumbing: the folded-DFT model equals the xla-FFT model."""
        x = _x(rng, h=16, w=16)
        m_x = DenoiserBank(iters=4)
        m_f = DenoiserBank(iters=4, fft_mode="fold_precise")
        params = m_x.init(jax.random.PRNGKey(0), x)
        np.testing.assert_allclose(
            np.asarray(m_f.apply(params, x)),
            np.asarray(m_x.apply(params, x)),
            atol=1e-5,
        )

    def test_denoiser_bank_fused_gradient(self, rng):
        x = _x(rng, h=16, w=16)
        m = DenoiserBank(iters=4, fused=True)
        params = {"params": {"lam": jnp.asarray([0.001, 0.01, 0.05, 0.1, 0.2])}}
        g = jax.grad(lambda p: jnp.sum(m.apply(p, x) ** 2))(params)
        gl = np.asarray(g["params"]["lam"])
        assert np.all(np.isfinite(gl)) and np.any(gl != 0)

    def test_denoiser_bank_bf16_carry_matches_fp32(self, rng):
        """The fused bank with a bf16 loop carry: forward and lam-gradient
        land within the carry's rounding envelope of the fp32 carry."""
        x = _x(rng, h=16, w=16)
        m_x = DenoiserBank(iters=4, fused=True)
        m_p = DenoiserBank(iters=4, fused=True, state_dtype="bfloat16")
        params = {"params": {"lam": jnp.asarray([0.001, 0.01, 0.05, 0.1, 0.2])}}
        np.testing.assert_allclose(
            np.asarray(m_p.apply(params, x)),
            np.asarray(m_x.apply(params, x)),
            atol=2e-2,
        )
        gx = jax.grad(lambda p: jnp.sum(m_x.apply(p, x) ** 2))(params)
        gp = jax.grad(lambda p: jnp.sum(m_p.apply(p, x) ** 2))(params)
        np.testing.assert_allclose(
            np.asarray(gp["params"]["lam"]),
            np.asarray(gx["params"]["lam"]),
            rtol=5e-2, atol=1e-2,
        )

    def test_autoencoder_output(self, rng):
        x = _x(rng)
        m = Autoencoder()
        params = m.init(jax.random.PRNGKey(0), x)
        out = m.apply(params, x)
        # 128 final up features + 32 residual = 160 channels, size-preserving.
        assert out.shape == (1, 112, 112, 160)

    def test_admm_denoiser_flagship(self, rng):
        x = _x(rng)
        m = AdmmDenoiser(denoiser_iters=2)
        params = m.init(jax.random.PRNGKey(0), x)
        out = m.apply(params, x)
        assert out.shape == x.shape  # restores RGB at input size
        assert float(jnp.min(out)) >= 0.0 and float(jnp.max(out)) <= 1.0

    def test_admm_denoiser_differentiable(self, rng):
        x = _x(rng, h=96, w=96)
        target = _x(rng, h=96, w=96)
        m = AdmmDenoiser(denoiser_iters=2)
        params = m.init(jax.random.PRNGKey(0), x)

        def loss(p):
            return jnp.mean((m.apply(p, x) - target) ** 2)

        g = jax.grad(loss)(params)
        leaves = jax.tree_util.tree_leaves(g)
        assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
        assert any(float(jnp.abs(l).max()) > 0 for l in leaves)

    def test_multistage(self, rng):
        x = _x(rng, h=48, w=48)
        m = MultistageUpDownscale()
        params = m.init(jax.random.PRNGKey(0), x)
        out = m.apply(params, x)
        assert out.shape[0] == 1 and out.shape[-1] == 32

    def test_deconv_bank(self, rng):
        x = _x(rng, h=32, w=32)
        m = DeconvBank(iters=2)
        params = m.init(jax.random.PRNGKey(0), x)
        out = m.apply(params, x)
        assert out.shape == (1, 32, 32, 9)

    def test_build_model_factory(self):
        assert isinstance(build_model("admm_denoiser", {"use_iso": True}), AdmmDenoiser)
        with pytest.raises(ValueError):
            build_model("nope")
