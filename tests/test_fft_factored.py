"""Four-step factored FFT tests: parity with numpy, packing, solver mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from admm_deconv.ops.fft_factored import (
    best_factorization,
    fft2_c2c,
    pack_planes,
    real_filter2d_packed,
    spectrum_to_layout,
    unpack_planes,
)
from admm_deconv.ops.solver import tv_deconvolve

P = jax.lax.Precision


class TestFactorization:
    def test_mxu_friendly_sizes(self):
        # Small factor first; large factor >= 128 for the batched GEMM stage.
        assert best_factorization(1920) == (15, 128)
        assert best_factorization(1080) == (8, 135)
        assert best_factorization(2160) == (16, 135)
        assert best_factorization(3840) == (30, 128)

    def test_prime_returns_none(self):
        assert best_factorization(17) is None
        assert best_factorization(1) is None

    def test_small_balanced(self):
        n1, n2 = best_factorization(32)
        assert n1 * n2 == 32


class TestFft2C2C:
    @pytest.mark.parametrize("shape", [(32, 48), (24, 40), (17, 32), (135, 128)])
    def test_forward_matches_numpy(self, rng, shape):
        h, w = shape
        z = rng.standard_normal((3, h, w)) + 1j * rng.standard_normal((3, h, w))
        zr = jnp.asarray(z.real, jnp.float32)
        zi = jnp.asarray(z.imag, jnp.float32)
        fr, fi = fft2_c2c(zr, zi, precision=P.HIGHEST)
        ref = np.asarray(spectrum_to_layout(jnp.asarray(np.fft.fft2(z))))
        scale = np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(fr), ref.real, atol=2e-3 * scale)
        np.testing.assert_allclose(np.asarray(fi), ref.imag, atol=2e-3 * scale)

    @pytest.mark.parametrize("shape", [(32, 48), (17, 23)])
    def test_roundtrip(self, rng, shape):
        h, w = shape
        z = rng.standard_normal((2, h, w))
        zr = jnp.asarray(z, jnp.float32)
        zi = jnp.zeros_like(zr)
        fr, fi = fft2_c2c(zr, zi, precision=P.HIGHEST)
        br, bi = fft2_c2c(fr, fi, inverse=True, precision=P.HIGHEST)
        np.testing.assert_allclose(np.asarray(br), z, atol=1e-4)
        np.testing.assert_allclose(np.asarray(bi), 0.0, atol=1e-4)


class TestPacking:
    def test_pack_unpack_roundtrip(self, rng):
        for n in (4, 5):
            x = jnp.asarray(rng.standard_normal((n, 8, 8)), jnp.float32)
            zr, zi = pack_planes(x)
            assert zr.shape[0] == (n + 1) // 2
            back = unpack_planes(zr, zi, n)
            np.testing.assert_array_equal(np.asarray(back), np.asarray(x))

    def test_real_filter_matches_direct(self, rng):
        h, w = 24, 32
        x = rng.standard_normal((5, h, w)).astype(np.float32)
        psf = rng.standard_normal((5, 5))
        c_full = 1.0 / (1.0 + np.abs(np.fft.fft2(psf, s=(h, w))) ** 2)
        direct = np.fft.ifft2(c_full * np.fft.fft2(x)).real
        got = real_filter2d_packed(
            jnp.asarray(x),
            spectrum_to_layout(jnp.asarray(c_full, jnp.float32)),
            precision=P.HIGHEST,
        )
        np.testing.assert_allclose(np.asarray(got), direct, atol=1e-4)


class TestSolverPackMode:
    def test_pack_matches_xla(self, rng):
        img = np.clip(rng.random((2, 32, 48, 3)), 0, 1).astype(np.float32)
        psf = np.zeros((5, 5), np.float32)
        psf[2, :] = 0.2
        y = jnp.asarray(img)
        a = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.05, iters=15, fft_mode="xla")
        b = tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.05, iters=15, fft_mode="pack_precise"
        )
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)

    def test_pack_denoise_and_odd_planes(self, rng):
        img = np.clip(rng.random((32, 48, 3)), 0, 1).astype(np.float32)
        y = jnp.asarray(img)  # 3 planes -> odd, exercises zero-pad pairing
        a = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=10, fft_mode="xla")
        b = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=10, fft_mode="pack_precise")
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)

    def test_per_image_rho_rejected(self):
        with pytest.raises(ValueError, match="scalar"):
            tv_deconvolve(
                jnp.zeros((2, 16, 16, 1)),
                None,
                rho=jnp.asarray([0.5, 0.6]),
                iters=3,
                fft_mode="pack",
            )

    def test_pack_differentiable(self, rng):
        y = jnp.asarray(rng.random((16, 16)), jnp.float32)

        def loss(lam):
            return jnp.mean(
                tv_deconvolve(
                    y, None, lam=lam, rho=0.5, iters=5, fft_mode="pack_precise"
                )
                ** 2
            )

        g = jax.grad(loss)(0.05)
        assert np.isfinite(float(g))
