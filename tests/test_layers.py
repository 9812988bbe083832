"""Tests for the differentiable ADMM layer and its trainable-mask variants."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from admm_deconv.layers import (
    ADMMDeconv,
    ADMMDeconvF1,
    ADMMDeconvF2,
    ADMMDeconvF3,
)
from admm_deconv.ops.solver import tv_deconvolve


def _x(rng, b=2, h=16, w=16, c=3):
    return jnp.asarray(rng.random((b, h, w, c)), jnp.float32)


class TestForward:
    def test_denoise_mode_matches_solver(self, rng):
        x = _x(rng)
        layer = ADMMDeconvF3((), 10, 0.05, 0.5)
        params = layer.init(jax.random.PRNGKey(0), x)
        out = layer.apply(params, x)
        expected = tv_deconvolve(x, None, lam=0.05, rho=0.5, iters=10)
        np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=1e-5)

    def test_state_dtype_inference_knob(self, rng):
        """Round-4 deployment knob: bf16 loop-carry storage through the
        layer (inference only; the solver validates the path)."""
        x = _x(rng)
        base = ADMMDeconv(
            kernel_shape=(), iters=10, lam_init=0.05, rho_init=0.5,
            fft_mode="fold1",
        )
        fast = ADMMDeconv(
            kernel_shape=(), iters=10, lam_init=0.05, rho_init=0.5,
            fft_mode="fold1", state_dtype="bfloat16",
        )
        params = base.init(jax.random.PRNGKey(0), x)
        out32 = base.apply(params, x)
        out16 = fast.apply(params, x)
        assert out16.dtype == jnp.float32
        np.testing.assert_allclose(
            np.asarray(out16), np.asarray(out32), atol=2e-2
        )

    def test_kernel_mode_shapes(self, rng):
        x = _x(rng)
        layer = ADMMDeconv(kernel_shape=(5, 5), iters=5)
        params = layer.init(jax.random.PRNGKey(0), x)
        out = layer.apply(params, x)
        assert out.shape == x.shape
        assert "weight" in params["params"]

    def test_weight_clamped_to_unit_interval(self, rng):
        x = _x(rng, b=1, c=1)
        layer = ADMMDeconvF3((3, 3), 5, 0.01, 0.1)
        params = layer.init(jax.random.PRNGKey(0), x)
        # Poison the stored weight outside [0,1]; forward must project it.
        w = params["params"]["weight"]
        params = {"params": {**params["params"], "weight": w.at[0, 0, 0, 0].set(5.0)}}
        neg = {"params": {**params["params"], "weight": jnp.clip(w, 0, 1).at[0, 0, 0, 0].set(1.0)}}
        out_poisoned = layer.apply(params, x)
        out_clamped = layer.apply(neg, x)
        np.testing.assert_allclose(
            np.asarray(out_poisoned), np.asarray(out_clamped), rtol=1e-5, atol=1e-6
        )

    def test_activation_and_bias(self, rng):
        x = _x(rng)
        layer = ADMMDeconv(
            kernel_shape=(), iters=5, activation=jnp.abs, use_bias=True,
            lam_init=0.05, rho_init=0.5,
        )
        params = layer.init(jax.random.PRNGKey(0), x)
        assert "bias" in params["params"]
        out = layer.apply(params, x)
        assert float(jnp.min(out)) >= 0.0

    def test_unbatched_input(self, rng):
        x = _x(rng)[0]
        layer = ADMMDeconvF3((), 5, 0.05, 0.5)
        params = layer.init(jax.random.PRNGKey(0), x)
        out = layer.apply(params, x)
        assert out.shape == x.shape

    def test_ctor_validation(self):
        with pytest.raises(ValueError):
            ADMMDeconvF1((3, 3), 5, lam=-1.0)
        with pytest.raises(ValueError):
            ADMMDeconvF2((3, 3), 5, rho=0.0)
        with pytest.raises(ValueError):
            ADMMDeconvF3((3, 3), 5, lam=0.1, rho=-0.5)


class TestTrainableMasks:
    """The four reference variants = one module + stop_gradient mask
    (deconv_admm.jl trainable= declarations)."""

    def _grads(self, layer, rng):
        x = _x(rng, b=1, c=1)
        target = _x(rng, b=1, c=1)
        params = layer.init(jax.random.PRNGKey(0), x)

        def loss(p):
            return jnp.mean((layer.apply(p, x) - target) ** 2)

        return jax.grad(loss)(params)["params"]

    def test_f1_freezes_lam(self, rng):
        g = self._grads(ADMMDeconvF1((3, 3), 5, 0.05), rng)
        assert float(jnp.abs(g["lam"]).max()) == 0.0
        assert float(jnp.abs(g["rho"]).max()) > 0.0
        assert float(jnp.abs(g["weight"]).max()) > 0.0

    def test_f2_freezes_rho(self, rng):
        g = self._grads(ADMMDeconvF2((3, 3), 5, 0.5), rng)
        assert float(jnp.abs(g["rho"]).max()) == 0.0
        assert float(jnp.abs(g["lam"]).max()) > 0.0

    def test_f3_freezes_both(self, rng):
        g = self._grads(ADMMDeconvF3((3, 3), 5, 0.05, 0.5), rng)
        assert float(jnp.abs(g["lam"]).max()) == 0.0
        assert float(jnp.abs(g["rho"]).max()) == 0.0
        assert float(jnp.abs(g["weight"]).max()) > 0.0

    def test_full_variant_trains_all(self, rng):
        g = self._grads(
            ADMMDeconv(kernel_shape=(3, 3), iters=5, lam_init=0.05, rho_init=0.5), rng
        )
        assert float(jnp.abs(g["lam"]).max()) > 0.0
        assert float(jnp.abs(g["rho"]).max()) > 0.0

    def test_remat_same_grads(self):
        g_plain = self._grads(ADMMDeconvF2((3, 3), 6, 0.5), np.random.default_rng(7))
        g_remat = self._grads(
            ADMMDeconvF2((3, 3), 6, 0.5, remat=True), np.random.default_rng(7)
        )
        np.testing.assert_allclose(
            np.asarray(g_plain["lam"]), np.asarray(g_remat["lam"]), rtol=1e-5
        )
