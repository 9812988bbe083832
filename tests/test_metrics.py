"""Metric tests: formula parity with the reference + oracle cross-checks."""

import numpy as np
import jax
import jax.numpy as jnp

from admm_deconv.metrics import (
    peak_snr,
    ssim,
    ssim_loss,
    ssim_loss_fast,
    gmsd,
    gmsd_loss,
)
from admm_deconv.metrics.ssim import SSIM_KERNEL_1D


def _imgs(rng, b=2, h=32, w=32, c=3):
    x = rng.random((b, h, w, c)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal((b, h, w, c)).astype(np.float32), 0, 1)
    return jnp.asarray(x), jnp.asarray(y)


class TestPSNR:
    def test_known_value(self):
        x = jnp.zeros((1, 4, 4, 1))
        y = jnp.full((1, 4, 4, 1), 0.1)
        # mse = 0.01 -> psnr = 20*log10(1/0.1) = 20
        np.testing.assert_allclose(float(peak_snr(x, y)), 20.0, rtol=1e-5)

    def test_identical_is_large(self, rng):
        x, _ = _imgs(rng)
        assert float(peak_snr(x, x)) > 100.0

    def test_per_image_then_mean(self, rng):
        # Reference psnr.jl:5-11: MSE per image over (H,W,C), then batch mean
        # of the per-image PSNRs — NOT PSNR of pooled MSE.
        x, y = _imgs(rng, b=2)
        p0 = float(peak_snr(x[:1], y[:1]))
        p1 = float(peak_snr(x[1:], y[1:]))
        np.testing.assert_allclose(float(peak_snr(x, y)), (p0 + p1) / 2, rtol=1e-5)


class TestSSIM:
    def test_kernel_normalized(self):
        np.testing.assert_allclose(SSIM_KERNEL_1D.sum(), 1.0, atol=2e-4)

    def test_identical_images(self, rng):
        x, _ = _imgs(rng)
        np.testing.assert_allclose(float(ssim(x, x)), 1.0, atol=1e-5)

    def test_range_and_sensitivity(self, rng):
        x, y = _imgs(rng)
        s = float(ssim(x, y))
        assert 0.0 < s < 1.0
        noisier = jnp.clip(x + 0.3, 0, 1)
        assert float(ssim(x, noisier)) < s

    def test_loss_is_one_minus(self, rng):
        x, y = _imgs(rng)
        np.testing.assert_allclose(
            float(ssim_loss(x, y)), 1.0 - float(ssim(x, y)), rtol=1e-6
        )

    def test_matches_brute_force(self, rng):
        """Valid-window SSIM against a direct sliding-window implementation."""
        x = rng.random((20, 20)).astype(np.float64)
        y = np.clip(x + 0.1 * rng.standard_normal((20, 20)), 0, 1)
        k1d = SSIM_KERNEL_1D
        k2d = np.outer(k1d, k1d)
        c1, c2 = 0.01**2, 0.03**2

        def win_stats(a, b, i, j):
            wa = a[i : i + 11, j : j + 11]
            wb = b[i : i + 11, j : j + 11]
            ma, mb = (k2d * wa).sum(), (k2d * wb).sum()
            va = (k2d * wa * wa).sum() - ma * ma
            vb = (k2d * wb * wb).sum() - mb * mb
            cab = (k2d * wa * wb).sum() - ma * mb
            return ((2 * ma * mb + c1) * (2 * cab + c2)) / (
                (ma * ma + mb * mb + c1) * (va + vb + c2)
            )

        vals = [win_stats(x, y, i, j) for i in range(10) for j in range(10)]
        expected = np.mean(vals)
        got = float(
            ssim(
                jnp.asarray(x[None, :, :, None], jnp.float32),
                jnp.asarray(y[None, :, :, None], jnp.float32),
            )
        )
        np.testing.assert_allclose(got, expected, rtol=1e-4)

    def test_crop_false_pads(self, rng):
        x, y = _imgs(rng, b=1, h=16, w=16, c=1)
        s = float(ssim(x, y, crop=False))
        assert 0.0 < s <= 1.0

    def test_fast_variant(self, rng):
        x, y = _imgs(rng)
        l = float(ssim_loss_fast(x, y))
        assert 0.0 <= l < 1.0

    def test_differentiable(self, rng):
        x, y = _imgs(rng, b=1, h=16, w=16, c=1)
        g = jax.grad(lambda a: ssim_loss(a, y))(x)
        assert np.all(np.isfinite(np.asarray(g)))
        assert float(jnp.max(jnp.abs(g))) > 0


class TestGMSD:
    def test_identical_is_zero(self, rng):
        x, _ = _imgs(rng)
        np.testing.assert_allclose(float(gmsd(x, x)), 0.0, atol=1e-6)

    def test_positive_for_different(self, rng):
        x, y = _imgs(rng)
        assert float(gmsd(x, y)) > 0

    def test_more_distortion_higher_score(self, rng):
        x, _ = _imgs(rng, b=1)
        slight = jnp.clip(x + 0.02 * jax.random.normal(jax.random.PRNGKey(0), x.shape), 0, 1)
        heavy = jnp.clip(x + 0.3 * jax.random.normal(jax.random.PRNGKey(1), x.shape), 0, 1)
        assert float(gmsd(x, heavy)) > float(gmsd(x, slight))

    def test_loss_alias(self, rng):
        x, y = _imgs(rng)
        np.testing.assert_allclose(float(gmsd_loss(x, y)), float(gmsd(x, y)))

    def test_differentiable(self, rng):
        x, y = _imgs(rng, b=1, h=16, w=16, c=1)
        g = jax.grad(lambda a: gmsd_loss(a, y))(x)
        assert np.all(np.isfinite(np.asarray(g)))

    def test_matches_brute_force(self, rng):
        """Independent pixel-loop re-derivation of GMSD (Sobel/8 correlation
        with circular indexing, 1e-16-eps magnitude, t=0.0026 similarity map,
        per-image std, batch mean) — the oracle the reference's training loss
        (``src/train.jl:191``) is held to, mirroring the SSIM brute-force
        test above."""
        b, h, w, c = 2, 12, 14, 3
        x = rng.random((b, h, w, c)).astype(np.float64)
        y = np.clip(x + 0.15 * rng.standard_normal((b, h, w, c)), 0, 1)
        sx = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float64) / 8.0
        sy = sx.T

        def mag(img):  # (h, w) single channel
            out = np.zeros((h, w, 2))
            for i in range(h):
                for j in range(w):
                    gx = gy = 0.0
                    for di in (-1, 0, 1):
                        for dj in (-1, 0, 1):
                            v = img[(i + di) % h, (j + dj) % w]
                            gx += sx[di + 1, dj + 1] * v
                            gy += sy[di + 1, dj + 1] * v
                    out[i, j] = (gx, gy)
            return np.sqrt(out[..., 0] ** 2 + out[..., 1] ** 2 + 1e-16)

        t = 0.0026
        scores = []
        for n in range(b):
            gms_ch = []
            for ch in range(c):
                mx, my = mag(x[n, :, :, ch]), mag(y[n, :, :, ch])
                gms_ch.append((2 * mx * my + t) / (mx**2 + my**2 + t))
            gms = np.stack(gms_ch)
            scores.append(np.sqrt(np.mean((gms - gms.mean()) ** 2)))
        expected = np.mean(scores)

        got = float(gmsd(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)))
        np.testing.assert_allclose(got, expected, rtol=1e-4)

    def test_imgrads_public_surface(self, rng):
        """imgrads/gradientsmag + Prewitt constants (``iqa_utils.jl:5-17,
        24-55``) are exposed and consistent."""
        from admm_deconv.metrics import (
            PREWITT_X, PREWITT_Y, SOBEL_X, SOBEL_Y, gradientsmag, imgrads,
        )

        np.testing.assert_allclose(PREWITT_X.sum(), 0.0, atol=1e-12)
        np.testing.assert_allclose(PREWITT_X, PREWITT_Y.T)
        np.testing.assert_allclose(SOBEL_X, SOBEL_Y.T)
        x, _ = _imgs(rng, b=1, h=16, w=16, c=3)
        gx, gy = imgrads(x)
        assert gx.shape == x.shape and gy.shape == x.shape
        m = gradientsmag(gx, gy)
        assert np.all(np.asarray(m) >= 0)
        gxp, _ = imgrads(x, kernel="prewitt")
        assert not np.allclose(np.asarray(gxp), np.asarray(gx))
        # A constant image has (numerically) zero gradients.
        const = jnp.ones((1, 8, 8, 1), jnp.float32)
        gcx, gcy = imgrads(const)
        np.testing.assert_allclose(np.asarray(gcx), 0.0, atol=1e-6)
