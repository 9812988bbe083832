"""Unit tests for the solver building blocks: FFT precompute, stencils, prox."""

import numpy as np
import jax.numpy as jnp
import pytest

from admm_deconv.ops.fft import psf_to_otf, laplacian_spectrum
from admm_deconv.ops.diff import grad2d, grad2d_adjoint
from admm_deconv.ops import prox

from reference_twin import circ_conv_centered, circ_corr_centered


class TestPsfToOtf:
    @pytest.mark.parametrize("kshape", [(7, 7), (3, 5), (4, 4), (1, 7), (2, 3)])
    def test_matches_centered_circular_conv(self, rng, kshape):
        h, w = 16, 24
        x = rng.standard_normal((h, w))
        psf = rng.standard_normal(kshape)
        otf = psf_to_otf(jnp.asarray(psf, jnp.float32), (h, w))
        via_fft = jnp.fft.irfft2(otf * jnp.fft.rfft2(jnp.asarray(x, jnp.float32)), s=(h, w))
        direct = circ_conv_centered(x, psf)
        np.testing.assert_allclose(np.asarray(via_fft), direct, rtol=1e-4, atol=1e-4)

    def test_adjoint_via_conj(self, rng):
        h, w = 16, 16
        x = rng.standard_normal((h, w))
        psf = rng.standard_normal((5, 5))
        otf = psf_to_otf(jnp.asarray(psf, jnp.float32), (h, w))
        via_fft = jnp.fft.irfft2(
            jnp.conj(otf) * jnp.fft.rfft2(jnp.asarray(x, jnp.float32)), s=(h, w)
        )
        direct = circ_corr_centered(x, psf)
        np.testing.assert_allclose(np.asarray(via_fft), direct, rtol=1e-4, atol=1e-4)

    def test_too_large_psf_raises(self):
        with pytest.raises(ValueError):
            psf_to_otf(jnp.ones((9, 9)), (8, 8))


class TestLaplacianSpectrum:
    def test_matches_fft_of_difference_filters(self):
        h, w = 12, 20
        dxf = np.zeros((h, w))
        dxf[0, 0], dxf[0, 1] = 1.0, -1.0
        dyf = np.zeros((h, w))
        dyf[0, 0], dyf[1, 0] = 1.0, -1.0
        expected = (
            np.abs(np.fft.rfft2(dxf)) ** 2 + np.abs(np.fft.rfft2(dyf)) ** 2
        )
        got = np.asarray(laplacian_spectrum((h, w)))
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


class TestDiff:
    def test_adjointness(self, rng):
        x = jnp.asarray(rng.standard_normal((3, 8, 8)), jnp.float32)
        zx = jnp.asarray(rng.standard_normal((3, 8, 8)), jnp.float32)
        zy = jnp.asarray(rng.standard_normal((3, 8, 8)), jnp.float32)
        dx, dy = grad2d(x)
        lhs = jnp.sum(dx * zx) + jnp.sum(dy * zy)
        rhs = jnp.sum(x * grad2d_adjoint(zx, zy))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-4)

    def test_frequency_consistency(self, rng):
        # rfft2(grad_x(x)) == Lambda_x * rfft2(x) with Lambda from the filter.
        h, w = 8, 12
        x = jnp.asarray(rng.standard_normal((h, w)), jnp.float32)
        dx, dy = grad2d(x)
        dxf = np.zeros((h, w))
        dxf[0, 0], dxf[0, 1] = 1.0, -1.0
        lam_x = np.fft.rfft2(dxf)
        np.testing.assert_allclose(
            np.asarray(jnp.fft.rfft2(dx)),
            lam_x * np.asarray(jnp.fft.rfft2(x)),
            rtol=1e-3,
            atol=1e-4,
        )

    def test_constant_image_has_zero_gradient(self):
        x = jnp.full((2, 4, 4), 3.7)
        dx, dy = grad2d(x)
        assert float(jnp.max(jnp.abs(dx))) == 0.0
        assert float(jnp.max(jnp.abs(dy))) == 0.0


class TestProx:
    def test_soft_closed_form(self, rng):
        v = jnp.asarray(rng.standard_normal((16,)), jnp.float32)
        zx, _ = prox.soft(v, v, 0.3)
        expected = np.sign(np.asarray(v)) * np.maximum(np.abs(np.asarray(v)) - 0.3, 0)
        np.testing.assert_allclose(np.asarray(zx), expected, rtol=1e-6)

    def test_soft_is_prox_of_l1(self, rng):
        # z = prox_{tau |.|}(v) minimizes 0.5(z-v)^2 + tau|z| — check optimality
        # against a dense grid.
        v = 0.8
        tau = 0.3
        zx, _ = prox.soft(jnp.asarray([v]), jnp.asarray([v]), tau)
        grid = np.linspace(-2, 2, 40001)
        obj = 0.5 * (grid - v) ** 2 + tau * np.abs(grid)
        assert abs(float(zx[0]) - grid[np.argmin(obj)]) < 1e-3

    def test_block_shrinks_magnitude(self, rng):
        vx = jnp.asarray(rng.standard_normal((8, 8)), jnp.float32)
        vy = jnp.asarray(rng.standard_normal((8, 8)), jnp.float32)
        zx, zy = prox.block(vx, vy, 0.5)
        r_in = np.sqrt(np.asarray(vx) ** 2 + np.asarray(vy) ** 2)
        r_out = np.sqrt(np.asarray(zx) ** 2 + np.asarray(zy) ** 2)
        np.testing.assert_allclose(r_out, np.maximum(r_in - 0.5, 0), rtol=1e-4, atol=1e-5)

    def test_block_zero_input_safe(self):
        zx, zy = prox.block(jnp.zeros((4, 4)), jnp.zeros((4, 4)), 0.5)
        assert np.all(np.isfinite(np.asarray(zx)))
        assert np.all(np.asarray(zx) == 0)

    def test_hard(self):
        v = jnp.asarray([-2.0, -0.1, 0.0, 0.1, 2.0])
        zx, _ = prox.hard(v, v, 0.5)
        np.testing.assert_allclose(np.asarray(zx), [-2.0, 0.0, 0.0, 0.0, 2.0])

    def test_gauss_bounded(self, rng):
        vx = jnp.asarray(rng.standard_normal((8, 8)), jnp.float32)
        vy = jnp.asarray(rng.standard_normal((8, 8)), jnp.float32)
        zx, zy = prox.gauss(vx, vy, 0.5)
        # scale in [0, 0.5): shrinks towards zero, never flips sign.
        assert np.all(np.abs(np.asarray(zx)) <= 0.5 * np.abs(np.asarray(vx)) + 1e-7)
        assert np.all(np.asarray(zx) * np.asarray(vx) >= 0)

    def test_resolve_unknown_raises(self):
        with pytest.raises(ValueError):
            prox.resolve("nope")

    def test_prox_dual_step_consistency(self, rng):
        dxx = jnp.asarray(rng.standard_normal((4, 4)), jnp.float32)
        dxy = jnp.asarray(rng.standard_normal((4, 4)), jnp.float32)
        ux = jnp.asarray(rng.standard_normal((4, 4)), jnp.float32)
        uy = jnp.asarray(rng.standard_normal((4, 4)), jnp.float32)
        zx, zy, nux, nuy = prox.prox_dual_step(dxx, dxy, ux, uy, 0.2, prox.soft)
        # u_new = (Dx + u) - z
        np.testing.assert_allclose(
            np.asarray(nux), np.asarray(dxx + ux - zx), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(nuy), np.asarray(dxy + uy - zy), rtol=1e-6
        )


class TestExactPrecomputeFFT:
    """Round 5: the precompute FFT helpers (MXU on accelerators, native on
    CPU) and the folded delta-hoist must match the native FFT."""

    def test_exact_helpers_match_native_on_cpu(self, rng):
        from admm_deconv.ops.fft import irfft2_exact, rfft2_exact

        x = jnp.asarray(rng.random((2, 16, 24)), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(rfft2_exact(x)), np.asarray(jnp.fft.rfft2(x)),
            rtol=1e-6, atol=1e-6,
        )
        c = jnp.fft.rfft2(x)
        np.testing.assert_allclose(
            np.asarray(irfft2_exact(c, (16, 24))),
            np.asarray(jnp.fft.irfft2(c, s=(16, 24))),
            rtol=1e-6, atol=1e-6,
        )

    def test_delta_hoist_matches_native(self, rng):
        from admm_deconv.ops.solver import _delta_hoist_irfft2

        x = jnp.asarray(rng.random((3, 16, 24)), jnp.float32)
        spec = jnp.fft.rfft2(x) * (1.0 + 0.5j)
        got = _delta_hoist_irfft2(spec, 16, 24)
        want = jnp.fft.irfft2(spec, s=(16, 24))
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6
        )

    def test_folded_hoist_identity_math(self, rng):
        """irfft2_mxu_folded(fold_hermitian(S)) == irfft2(S) — the identity
        the accelerator branch of _delta_hoist_irfft2 relies on (validated
        here on CPU with the MXU kernels at HIGHEST)."""
        from admm_deconv.ops.fft_mxu import fold_hermitian, irfft2_mxu_folded

        x = jnp.asarray(rng.random((2, 16, 24)), jnp.float32)
        spec = jnp.fft.rfft2(x) * (0.3 - 1.2j)
        got = irfft2_mxu_folded(*fold_hermitian(spec), (16, 24))
        want = jnp.fft.irfft2(spec, s=(16, 24))
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5
        )
