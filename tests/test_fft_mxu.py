"""MXU-matmul DFT tests: parity with jnp.fft and solver-mode agreement."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from admm_deconv.ops.fft_mxu import (
    fold_even_odd,
    fold_hermitian,
    irfft2_mxu,
    irfft2_mxu_folded,
    rfft2_mxu,
    rfft2_mxu_folded,
    spectral_scale_folded,
)
from admm_deconv.ops.solver import tv_deconvolve, tv_deconvolve_adaptive


class TestRfft2Mxu:
    @pytest.mark.parametrize("shape", [(8, 16), (3, 12, 20), (2, 15, 17)])
    def test_forward_matches_jnp(self, rng, shape):
        x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
        re, im = rfft2_mxu(x)
        ref = jnp.fft.rfft2(x)
        np.testing.assert_allclose(np.asarray(re), np.asarray(ref.real), atol=1e-3, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(im), np.asarray(ref.imag), atol=1e-3, rtol=1e-4)

    @pytest.mark.parametrize("shape", [(8, 16), (4, 10, 14), (2, 9, 13)])
    def test_roundtrip(self, rng, shape):
        x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
        re, im = rfft2_mxu(x)
        back = irfft2_mxu(re, im, x.shape[-2:])
        np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-4)

    def test_inverse_matches_jnp_irfft2(self, rng):
        # Arbitrary hermitian-consistent spectrum: rfft2 of a real image.
        x = jnp.asarray(rng.standard_normal((5, 12, 16)), jnp.float32)
        spec = jnp.fft.rfft2(x)
        got = irfft2_mxu(jnp.real(spec), jnp.imag(spec), (12, 16))
        ref = jnp.fft.irfft2(spec, s=(12, 16))
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)


class TestFoldedRepresentation:
    """The folded half-H Hermitian DFT path (`fft_mode="fold"`)."""

    @pytest.mark.parametrize("shape", [(3, 16, 20), (2, 17, 20), (2, 16, 21), (1, 9, 13)])
    def test_forward_matches_folded_fft(self, rng, shape):
        x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
        a_re, a_im, b_re, b_im = rfft2_mxu_folded(x)
        fa_re, fa_im, fb_re, fb_im = fold_hermitian(jnp.fft.rfft2(x))
        for got, ref in [(a_re, fa_re), (a_im, fa_im), (b_re, fb_re), (b_im, fb_im)]:
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)

    @pytest.mark.parametrize("shape", [(3, 16, 20), (2, 17, 21), (2, 12, 12)])
    def test_scale_pipeline_matches_fft(self, rng, shape):
        """rfft2 -> real multiplier -> irfft2, entirely in folded form."""
        x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
        h, w = shape[-2:]
        c = jnp.asarray(rng.random((h, w // 2 + 1)) + 0.5, jnp.float32)
        ref = jnp.fft.irfft2(c * jnp.fft.rfft2(x), s=(h, w))
        folded = rfft2_mxu_folded(x)
        ce, co = fold_even_odd(c)
        got = irfft2_mxu_folded(*spectral_scale_folded(folded, ce, co), (h, w))
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)

    def test_per_image_multiplier(self, rng):
        """Per-image c (the per-image-rho solver case) folds batchwise."""
        x = jnp.asarray(rng.standard_normal((3, 14, 18)), jnp.float32)
        c = jnp.asarray(rng.random((3, 14, 10)) + 0.5, jnp.float32)
        ref = jnp.fft.irfft2(c * jnp.fft.rfft2(x), s=(14, 18))
        ce, co = fold_even_odd(c)
        got = irfft2_mxu_folded(
            *spectral_scale_folded(rfft2_mxu_folded(x), ce, co), (14, 18)
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)


class TestSolverFftModes:
    def test_mxu_matches_xla(self, rng):
        img = np.clip(rng.random((2, 32, 32, 3)), 0, 1).astype(np.float32)
        psf = np.zeros((5, 5), np.float32)
        psf[2, :] = 0.2
        y = jnp.asarray(img)
        x_xla = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.05, iters=15, fft_mode="xla")
        x_mxu = tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.05, iters=15, fft_mode="mxu_precise"
        )
        np.testing.assert_allclose(
            np.asarray(x_mxu), np.asarray(x_xla), atol=1e-4, rtol=1e-3
        )

    def test_mxu_fast_mode_close(self, rng):
        img = np.clip(rng.random((32, 32)), 0, 1).astype(np.float32)
        y = jnp.asarray(img)
        x_xla = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=10, fft_mode="xla")
        x_mxu = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=10, fft_mode="mxu")
        np.testing.assert_allclose(
            np.asarray(x_mxu), np.asarray(x_xla), atol=2e-3
        )

    def test_fold_matches_xla(self, rng):
        img = np.clip(rng.random((2, 32, 32, 3)), 0, 1).astype(np.float32)
        psf = np.zeros((5, 5), np.float32)
        psf[2, :] = 0.2
        y = jnp.asarray(img)
        x_xla = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.05, iters=15, fft_mode="xla")
        x_fold = tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.05, iters=15, fft_mode="fold_precise"
        )
        np.testing.assert_allclose(
            np.asarray(x_fold), np.asarray(x_xla), atol=1e-4, rtol=1e-3
        )

    def test_fold_per_image_rho_and_denoise(self, rng):
        y = jnp.asarray(rng.random((2, 31, 33, 1)), jnp.float32)
        rho = jnp.asarray([0.05, 0.08])
        x_xla = tv_deconvolve(y, None, lam=0.01, rho=rho, iters=12, fft_mode="xla")
        x_fold = tv_deconvolve(
            y, None, lam=0.01, rho=rho, iters=12, fft_mode="fold_precise"
        )
        np.testing.assert_allclose(np.asarray(x_fold), np.asarray(x_xla), atol=1e-4)

    def test_fold1_matches_xla(self, rng):
        """Delta-form bf16x1 mode: on CPU all precisions are fp32, so fold1
        must match xla to float noise — this validates the x_B hoisting /
        rho-folded-multiplier restructuring itself (on a GPU, DEFAULT
        precision runs the loop matmuls in TF32)."""
        img = np.clip(rng.random((2, 32, 32, 3)), 0, 1).astype(np.float32)
        psf = np.zeros((5, 5), np.float32)
        psf[2, :] = 0.2
        y = jnp.asarray(img)
        x_xla = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.05, iters=15, fft_mode="xla")
        x_f1 = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.05, iters=15, fft_mode="fold1")
        np.testing.assert_allclose(np.asarray(x_f1), np.asarray(x_xla), atol=1e-4)

    def test_fold1_per_image_rho_denoise_and_state_path(self, rng):
        y = jnp.asarray(rng.random((2, 31, 33, 1)), jnp.float32)
        rho = jnp.asarray([0.05, 0.08])
        x_xla, d_xla = tv_deconvolve(
            y, None, lam=0.01, rho=rho, iters=12, fft_mode="xla",
            return_diagnostics=True,
        )
        x_f1, d_f1 = tv_deconvolve(
            y, None, lam=0.01, rho=rho, iters=12, fft_mode="fold1",
            return_diagnostics=True,
        )
        np.testing.assert_allclose(np.asarray(x_f1), np.asarray(x_xla), atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(d_f1.r_norm), np.asarray(d_xla.r_norm), rtol=1e-3
        )

    def test_fold1_differentiable(self, rng):
        y = jnp.asarray(rng.random((16, 16)), jnp.float32)

        def loss(lam):
            return jnp.mean(
                tv_deconvolve(y, None, lam=lam, rho=0.5, iters=5, fft_mode="fold1") ** 2
            )

        g = jax.grad(loss)(0.05)
        ref = jax.grad(
            lambda lam: jnp.mean(
                tv_deconvolve(y, None, lam=lam, rho=0.5, iters=5, fft_mode="xla") ** 2
            )
        )(0.05)
        np.testing.assert_allclose(float(g), float(ref), rtol=1e-3)

    def test_fold1_adaptive_matches_xla(self, rng):
        """Round 3: the adaptive solver supports fold1 by re-deriving the
        delta-form x_B hoist once per check_every block (rho is fixed
        between checks) and finishing with the HIGH-precision re-solve.  On
        CPU every precision is fp32, so the paths must agree tightly and
        stop at the same iteration."""
        y = jnp.asarray(rng.random((2, 32, 32, 3)), jnp.float32)
        psf = np.full((3, 3), 1 / 9, np.float32)
        kw = dict(psf=psf, lam=0.01, rho=0.05, max_iters=24, check_every=4)
        x_xla, d_xla = tv_deconvolve_adaptive(y, fft_mode="xla", **kw)
        x_f1, d_f1 = tv_deconvolve_adaptive(y, fft_mode="fold1", **kw)
        assert int(d_xla.iterations) == int(d_f1.iterations)
        np.testing.assert_allclose(np.asarray(x_f1), np.asarray(x_xla), atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(d_f1.rho), np.asarray(d_xla.rho), rtol=1e-5
        )

    def test_fold_adaptive_matches_xla(self, rng):
        y = jnp.asarray(rng.random((1, 32, 32, 3)), jnp.float32)
        psf = np.full((3, 3), 1 / 9, np.float32)
        x_xla, d_xla = tv_deconvolve_adaptive(
            y, psf=psf, lam=0.01, rho=0.05, max_iters=20, fft_mode="xla"
        )
        x_fold, d_fold = tv_deconvolve_adaptive(
            y, psf=psf, lam=0.01, rho=0.05, max_iters=20, fft_mode="fold_precise"
        )
        assert int(d_xla.iterations) == int(d_fold.iterations)
        np.testing.assert_allclose(np.asarray(x_fold), np.asarray(x_xla), atol=1e-4)

    def test_fold_differentiable(self, rng):
        y = jnp.asarray(rng.random((16, 16)), jnp.float32)

        def loss(lam):
            return jnp.mean(
                tv_deconvolve(y, None, lam=lam, rho=0.5, iters=5, fft_mode="fold_precise") ** 2
            )

        g = jax.grad(loss)(0.05)
        assert np.isfinite(float(g))

    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError, match="fft_mode"):
            tv_deconvolve(jnp.zeros((8, 8)), None, fft_mode="nope")

    def test_mxu_differentiable(self, rng):
        y = jnp.asarray(rng.random((16, 16)), jnp.float32)

        def loss(lam):
            return jnp.mean(
                tv_deconvolve(y, None, lam=lam, rho=0.5, iters=5, fft_mode="mxu_precise") ** 2
            )

        g = jax.grad(loss)(0.05)
        assert np.isfinite(float(g))
