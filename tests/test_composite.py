"""Composite TV + L1 + box prior solver tests (BASELINE config 3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from admm_deconv.ops.composite import composite_tv_deconvolve
from admm_deconv.ops.solver import tv_deconvolve

from reference_twin import circ_conv_centered


def _sparse_scene(rng, h=32, w=32):
    """Mostly-zero image with a few bright rectangles (L1-friendly)."""
    img = np.zeros((h, w))
    for _ in range(3):
        r0, c0 = rng.integers(0, h - 8, 2)
        img[r0 : r0 + 6, c0 : c0 + 6] = rng.random() * 0.8 + 0.2
    return img


class TestComposite:
    def test_tv_only_matches_core_solver_at_convergence(self, rng):
        img = _sparse_scene(rng)
        y = jnp.asarray(img + 0.05 * rng.standard_normal(img.shape), jnp.float32)
        x_tv = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=300)
        x_comp = composite_tv_deconvolve(
            y, None, lam_tv=0.05, lam_l1=0.0, rho1=0.5, rho2=0.5, iters=300
        )
        np.testing.assert_allclose(
            np.asarray(x_comp), np.asarray(x_tv), atol=2e-3
        )

    def test_l1_promotes_sparsity(self, rng):
        img = _sparse_scene(rng)
        noisy = jnp.asarray(
            img + 0.1 * rng.standard_normal(img.shape), jnp.float32
        )
        x_no_l1 = composite_tv_deconvolve(
            noisy, None, lam_tv=0.02, lam_l1=0.0, rho1=0.5, rho2=0.5, iters=100
        )
        x_l1 = composite_tv_deconvolve(
            noisy, None, lam_tv=0.02, lam_l1=0.08, rho1=0.5, rho2=0.5, iters=100
        )
        frac_zero = lambda a: float(jnp.mean(jnp.abs(a) < 1e-4))
        assert frac_zero(x_l1) > frac_zero(x_no_l1) + 0.1

    def test_box_constraint_exact(self, rng):
        img = _sparse_scene(rng)
        psf = np.zeros((5, 5), np.float32)
        psf[2, :] = 0.2
        blurred = circ_conv_centered(img, psf.astype(np.float64))
        x = composite_tv_deconvolve(
            jnp.asarray(blurred, jnp.float32), psf,
            lam_tv=0.005, lam_l1=0.0, rho1=0.05, rho2=0.05,
            iters=60, x_bounds=(0.0, 1.0),
        )
        assert float(jnp.min(x)) >= 0.0
        assert float(jnp.max(x)) <= 1.0

    def test_deconv_restores(self, rng):
        img = _sparse_scene(rng)
        psf = np.zeros((5, 5), np.float64)
        psf[2, :] = 0.2
        blurred = circ_conv_centered(img, psf)
        x = composite_tv_deconvolve(
            jnp.asarray(blurred, jnp.float32), jnp.asarray(psf, jnp.float32),
            lam_tv=0.003, lam_l1=0.003, rho1=0.03, rho2=0.03,
            iters=150, x_bounds=(0.0, 1.0),
        )
        err_blur = float(jnp.mean((jnp.asarray(blurred, jnp.float32) - img) ** 2))
        err_rest = float(jnp.mean((x - img) ** 2))
        assert err_rest < err_blur * 0.5

    def test_differentiable(self, rng):
        y = jnp.asarray(_sparse_scene(rng, 16, 16), jnp.float32)

        def loss(lam_tv, lam_l1):
            x = composite_tv_deconvolve(
                y, None, lam_tv=lam_tv, lam_l1=lam_l1, rho1=0.5, rho2=0.5, iters=8
            )
            return jnp.mean(x**2)

        g1, g2 = jax.grad(loss, argnums=(0, 1))(0.05, 0.02)
        assert np.isfinite(float(g1)) and np.isfinite(float(g2))

    def test_mxu_mode_matches(self, rng):
        y = jnp.asarray(_sparse_scene(rng), jnp.float32)
        a = composite_tv_deconvolve(
            y, None, lam_tv=0.05, lam_l1=0.02, rho1=0.5, rho2=0.5, iters=20
        )
        b = composite_tv_deconvolve(
            y, None, lam_tv=0.05, lam_l1=0.02, rho1=0.5, rho2=0.5, iters=20,
            fft_mode="mxu_precise",
        )
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)

    def test_fold1_mode_matches(self, rng):
        """Delta-form bf16x1 mode (fp32 on CPU): validates the x_B hoist
        with the rho2-augmented denominator."""
        y = jnp.asarray(_sparse_scene(rng), jnp.float32)
        psf = np.full((3, 3), 1 / 9, np.float32)
        kw = dict(lam_tv=0.05, lam_l1=0.02, rho1=0.5, rho2=0.5, iters=20,
                  x_bounds=(0.0, 1.0))
        a = composite_tv_deconvolve(y, psf, **kw)
        b = composite_tv_deconvolve(y, psf, fft_mode="fold1", **kw)
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)

    @pytest.mark.parametrize("fft_mode", ["xla", "fold1", "fold_precise"])
    def test_q_carry_matches_six_plane_loop(self, rng, fft_mode):
        """The q-carry loop (composite_stencil_step) must reproduce the
        6-plane (z1, u1, z2, u2) loop of the adaptive composite solver run
        at fixed penalties with the stopping rule off — with per-image
        lam, box bounds, and every fft mode (fold1 against xla: that
        solver rejects the delta form)."""
        from admm_deconv.ops.composite import composite_tv_deconvolve_adaptive

        imgs = np.stack([_sparse_scene(rng, 64, 64), _sparse_scene(rng, 64, 64)])
        y = jnp.asarray(imgs[..., None], jnp.float32)
        lam_b = np.asarray([0.01, 0.03], np.float32)
        kw = dict(lam_tv=lam_b, lam_l1=0.002, rho1=0.1, rho2=0.1,
                  x_bounds=(0.0, 1.0))
        ref, d = composite_tv_deconvolve_adaptive(
            y, None, max_iters=20, adapt_rho=False, eps_abs=0.0, eps_rel=0.0,
            fft_mode="xla" if fft_mode == "fold1" else fft_mode, **kw
        )
        assert int(d.iterations) == 20
        fast = composite_tv_deconvolve(y, None, iters=20, fft_mode=fft_mode, **kw)
        atol = 1e-4 if fft_mode == "fold1" else 1e-6
        np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=atol)

    def test_bf16_state_close(self, rng):
        """Mixed-precision carry on the composite loop: all
        four carried planes (q, u1x, u1y, u2) are residual-scale, so bf16
        storage stays inside a small quantization envelope; the box
        constraint remains EXACT (z2 is projected after the final fp32
        solve)."""
        y = jnp.asarray(_sparse_scene(rng, 64, 64), jnp.float32)
        kw = dict(lam_tv=0.01, lam_l1=0.002, rho1=0.1, rho2=0.1, iters=20,
                  x_bounds=(0.0, 1.0))
        x32 = composite_tv_deconvolve(y, None, **kw)
        x16 = composite_tv_deconvolve(y, None, state_dtype="bfloat16", **kw)
        assert x16.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(x16), np.asarray(x32), atol=2e-2)
        assert float(jnp.min(x16)) >= 0.0 and float(jnp.max(x16)) <= 1.0
        with pytest.raises(ValueError, match="iters"):
            composite_tv_deconvolve(y, None, iters=0, state_dtype="bfloat16")

    def test_q_carry_iso_matches_six_plane_loop(self, rng):
        from admm_deconv.ops.composite import composite_tv_deconvolve_adaptive

        y = jnp.asarray(_sparse_scene(rng, 64, 64), jnp.float32)
        kw = dict(lam_tv=0.01, lam_l1=0.002, rho1=0.1, rho2=0.2, prox="iso")
        ref, _ = composite_tv_deconvolve_adaptive(
            y, None, max_iters=20, adapt_rho=False, eps_abs=0.0, eps_rel=0.0,
            **kw
        )
        fast = composite_tv_deconvolve(y, None, iters=20, **kw)
        np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=1e-6)


class TestCompositeAdaptive:
    """Round-3 (VERDICT missing #3): residual-balanced early-stopping
    composite solver."""

    def test_early_stop_and_rho_adaptation(self, rng):
        imgs = np.stack([_sparse_scene(rng, 64, 64), _sparse_scene(rng, 64, 64)])
        y = jnp.asarray(imgs[..., None], jnp.float32)
        from admm_deconv.ops.composite import composite_tv_deconvolve_adaptive

        x, d = composite_tv_deconvolve_adaptive(
            y, None, lam_tv=0.01, lam_l1=0.002, rho1=5.0, rho2=5.0,
            max_iters=300, x_bounds=(0.0, 1.0),
        )
        assert int(d.iterations) < 300  # stopped on tolerance
        assert not np.allclose(np.asarray(d.rho), 5.0)  # rebalanced
        assert float(jnp.min(x)) >= 0.0 and float(jnp.max(x)) <= 1.0
        assert np.all(np.isfinite(np.asarray(d.r_norm)))
        assert np.all(np.isfinite(np.asarray(d.s_norm)))

    def test_no_adapt_matches_fixed_solver(self, rng):
        """With adaptation off and tolerances zeroed, max_iters iterations
        must equal the fixed-iteration solver bit-for-bit."""
        from admm_deconv.ops.composite import composite_tv_deconvolve_adaptive

        y = jnp.asarray(_sparse_scene(rng, 32, 32), jnp.float32)
        kw = dict(lam_tv=0.01, lam_l1=0.002, rho1=0.1, rho2=0.1)
        x_a, d = composite_tv_deconvolve_adaptive(
            y, None, max_iters=40, eps_abs=0.0, eps_rel=0.0,
            adapt_rho=False, **kw,
        )
        x_f = composite_tv_deconvolve(y, None, iters=40, **kw)
        assert int(d.iterations) == 40
        np.testing.assert_array_equal(np.asarray(x_a), np.asarray(x_f))

    def test_fold_mode_matches(self, rng):
        from admm_deconv.ops.composite import composite_tv_deconvolve_adaptive

        y = jnp.asarray(_sparse_scene(rng, 32, 32), jnp.float32)
        kw = dict(lam_tv=0.01, lam_l1=0.002, rho1=2.0, rho2=2.0, max_iters=60)
        x_a, d_a = composite_tv_deconvolve_adaptive(y, None, **kw)
        x_b, d_b = composite_tv_deconvolve_adaptive(
            y, None, fft_mode="fold_precise", **kw
        )
        assert int(d_a.iterations) == int(d_b.iterations)
        np.testing.assert_allclose(np.asarray(x_b), np.asarray(x_a), atol=1e-5)

    def test_fold1_and_pack_rejected(self, rng):
        from admm_deconv.ops.composite import composite_tv_deconvolve_adaptive

        y = jnp.zeros((16, 16))
        with pytest.raises(ValueError, match="fold1"):
            composite_tv_deconvolve_adaptive(y, fft_mode="fold1")
        with pytest.raises(ValueError, match="pack"):
            composite_tv_deconvolve_adaptive(y, fft_mode="pack")
