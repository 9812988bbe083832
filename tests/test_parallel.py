"""Multi-device tests on the virtual 8-device CPU mesh: batch sharding and
exact spatially-tiled solving."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from admm_deconv.ops.solver import tv_deconvolve
from admm_deconv.parallel import (
    make_mesh,
    replicate,
    shard_batch,
    tiled_tv_deconvolve,
)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh({"tile": 8})


def _img(rng, h=64, w=64):
    img = np.zeros((h, w))
    for _ in range(5):
        r0, c0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        r1, c1 = rng.integers(h // 2, h), rng.integers(w // 2, w)
        img[r0:r1, c0:c1] += rng.random() * 0.3
    return np.clip(img + 0.2, 0, 1).astype(np.float32)


class TestMesh:
    def test_device_count(self):
        assert len(jax.devices()) == 8

    def test_make_mesh_shapes(self):
        mesh = make_mesh({"data": 2, "tile": 4})
        assert mesh.shape == {"data": 2, "tile": 4}
        with pytest.raises(ValueError):
            make_mesh({"data": 16})

    def test_shard_batch(self):
        mesh = make_mesh({"data": 8})
        x = jnp.zeros((16, 8, 8, 3))
        xs = shard_batch(x, mesh)
        assert xs.sharding.spec == jax.sharding.PartitionSpec("data", None, None, None)

    def test_replicate(self):
        mesh = make_mesh({"data": 8})
        tree = {"a": jnp.ones((4,)), "b": jnp.zeros((2, 2))}
        rep = replicate(tree, mesh)
        assert rep["a"].sharding.is_fully_replicated


class TestTiledSolver:
    """The tiled solve must be numerically identical to single-device."""

    @pytest.mark.parametrize("use_psf", [False, True])
    def test_matches_single_device(self, rng, mesh8, use_psf):
        img = _img(rng)
        psf = None
        if use_psf:
            psf = np.zeros((5, 5), np.float32)
            psf[2, :] = 0.2
        y = jnp.asarray(img)
        expected = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.05, iters=15)
        got = tiled_tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.05, iters=15, mesh=mesh8
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-5
        )

    def test_batched_multichannel(self, rng, mesh8):
        imgs = np.stack([_img(rng), _img(rng)])[..., None].repeat(3, axis=-1)
        y = jnp.asarray(imgs)
        expected = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=10)
        got = tiled_tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=10, mesh=mesh8)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-5
        )

    def test_iso_prox(self, rng, mesh8):
        img = _img(rng)
        y = jnp.asarray(img)
        expected = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=10, prox="iso")
        got = tiled_tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=10, prox="iso", mesh=mesh8)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-5
        )

    @pytest.mark.parametrize("use_psf", [False, True])
    def test_fold_mode_matches_single_device(self, rng, mesh8, use_psf):
        """The MXU folded-DFT distributed path (fold matmuls + real
        all_to_alls) must agree with the single-device solver."""
        img = _img(rng)
        psf = None
        if use_psf:
            psf = np.zeros((5, 5), np.float32)
            psf[2, :] = 0.2
        y = jnp.asarray(img)
        expected = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.05, iters=15)
        got = tiled_tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.05, iters=15, mesh=mesh8,
            fft_mode="fold_precise",
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-4
        )

    @pytest.mark.parametrize("use_psf", [False, True])
    def test_fold1_matches_single_device(self, rng, mesh8, use_psf):
        """Distributed delta-form bf16x1 mode: on CPU all precisions are
        fp32, so this validates the x_B hoisting / rho-folded multiplier /
        final-iteration-outside-the-scan restructuring exactly."""
        img = _img(rng)
        psf = None
        if use_psf:
            psf = np.zeros((5, 5), np.float32)
            psf[2, :] = 0.2
        y = jnp.asarray(img)
        expected = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.05, iters=15)
        got = tiled_tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.05, iters=15, mesh=mesh8,
            fft_mode="fold1",
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-4
        )

    def test_fold1_early_stop_and_per_image_rho(self, rng, mesh8):
        imgs = np.stack([_img(rng), _img(rng)])[..., None]
        y = jnp.asarray(imgs)
        rho = jnp.asarray([0.3, 0.6])
        expected, d_exp = tiled_tv_deconvolve(
            y, None, lam=0.02, rho=rho, iters=40, mesh=mesh8,
            early_stop=True, return_diagnostics=True,
        )
        got, d_got = tiled_tv_deconvolve(
            y, None, lam=0.02, rho=rho, iters=40, mesh=mesh8,
            early_stop=True, fft_mode="fold1", return_diagnostics=True,
        )
        assert int(d_got.iterations) == int(d_exp.iterations)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-4
        )

    def test_fold1_rejected_with_adapt_rho(self, rng, mesh8):
        y = jnp.asarray(_img(rng))
        with pytest.raises(ValueError, match="fold1"):
            tiled_tv_deconvolve(
                y, None, lam=0.02, rho=0.5, iters=5, mesh=mesh8,
                adapt_rho=True, fft_mode="fold1",
            )

    def test_fold_mode_adapt_rho(self, rng, mesh8):
        img = _img(rng)
        ref = tiled_tv_deconvolve(
            jnp.asarray(img), None, lam=0.05, rho=5.0, iters=20, adapt_rho=True,
            mesh=mesh8,
        )
        got = tiled_tv_deconvolve(
            jnp.asarray(img), None, lam=0.05, rho=5.0, iters=20, adapt_rho=True,
            mesh=mesh8, fft_mode="fold_precise",
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)

    def test_adapt_rho_runs(self, rng, mesh8):
        img = _img(rng)
        got = tiled_tv_deconvolve(
            jnp.asarray(img), None, lam=0.05, rho=5.0, iters=20, adapt_rho=True,
            mesh=mesh8,
        )
        assert np.all(np.isfinite(np.asarray(got)))

    def test_bad_shapes_rejected(self, rng, mesh8):
        with pytest.raises(ValueError, match="divide"):
            tiled_tv_deconvolve(jnp.zeros((60, 64)), mesh=mesh8)
        with pytest.raises(ValueError, match="even"):
            tiled_tv_deconvolve(jnp.zeros((64, 63)), mesh=mesh8)
        with pytest.raises(ValueError, match="mesh"):
            tiled_tv_deconvolve(jnp.zeros((64, 64)))


class TestTiledFeatureParity:
    """Round-2 features (VERDICT missing #3): every single-chip solver
    capability repeated on the tiled solver, checked against
    ``ops/solver.py`` as the contract."""

    def test_per_image_lam_rho(self, rng, mesh8):
        imgs = np.stack([_img(rng), _img(rng)])[..., None]
        y = jnp.asarray(imgs)
        lam = np.asarray([0.01, 0.08], np.float32)
        rho = np.asarray([0.05, 0.4], np.float32)
        expected = tv_deconvolve(y, None, lam=lam, rho=rho, iters=12)
        got = tiled_tv_deconvolve(y, None, lam=lam, rho=rho, iters=12, mesh=mesh8)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-5
        )

    def test_early_stop_matches_adaptive_single_chip(self, rng, mesh8):
        from admm_deconv.ops.solver import tv_deconvolve_adaptive

        img = _img(rng)
        y = jnp.asarray(img)
        x_ref, d_ref = tv_deconvolve_adaptive(
            y, None, lam=0.05, rho=0.5, max_iters=100, adapt_rho=True,
        )
        x_t, d_t = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=100, adapt_rho=True,
            early_stop=True, mesh=mesh8, return_diagnostics=True,
        )
        assert int(d_t.iterations) == int(d_ref.iterations)
        np.testing.assert_allclose(
            np.asarray(x_t), np.asarray(x_ref), rtol=1e-3, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(d_t.r_norm), np.asarray(d_ref.r_norm), rtol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(d_t.s_norm), np.asarray(d_ref.s_norm), rtol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(d_t.rho), np.asarray(d_ref.rho), rtol=1e-5
        )

    @pytest.mark.parametrize("prox", ["aniso", "iso"])
    def test_check_every_matches_single_chip(self, rng, mesh8, prox):
        """Round 4 (VERDICT missing #1): the tiled adaptive/early-stop path
        gets block checking — residual psums and rho adaptation only every
        k-th iteration — and the mid-block iterations run the q-carry
        halo-stencil loop.  Iterates,
        iteration counts, adapted rho, and residuals must match the
        single-chip adaptive solver at the same cadence."""
        from admm_deconv.ops.solver import tv_deconvolve_adaptive

        imgs = np.stack([_img(rng), _img(rng)])[..., None]
        y = jnp.asarray(imgs)
        lam = np.asarray([0.02, 0.08], np.float32)
        x_ref, d_ref = tv_deconvolve_adaptive(
            y, None, lam=lam, rho=5.0, max_iters=48, adapt_rho=True,
            check_every=4, prox=prox,
        )
        x_t, d_t = tiled_tv_deconvolve(
            y, None, lam=lam, rho=5.0, iters=48, adapt_rho=True,
            early_stop=True, check_every=4, mesh=mesh8,
            prox=prox, return_diagnostics=True,
        )
        assert int(d_t.iterations) == int(d_ref.iterations)
        np.testing.assert_allclose(
            np.asarray(x_t), np.asarray(x_ref), rtol=1e-3, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(d_t.rho), np.asarray(d_ref.rho), rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(d_t.r_norm), np.asarray(d_ref.r_norm), rtol=1e-3,
            atol=1e-6,
        )

    def test_check_every_data_x_tile_fast_mid(self, rng):
        """Block checking + fast mid-loop on the 2-D data x tile mesh."""
        from admm_deconv.ops.solver import tv_deconvolve_adaptive
        from admm_deconv.parallel import make_mesh

        mesh = make_mesh({"data": 2, "tile": 4})
        imgs = np.stack([_img(rng), _img(rng)])[..., None]
        y = jnp.asarray(imgs)
        x_ref, d_ref = tv_deconvolve_adaptive(
            y, None, lam=0.05, rho=5.0, max_iters=64, adapt_rho=True,
            check_every=8,
        )
        x_t, d_t = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=5.0, iters=64, adapt_rho=True,
            early_stop=True, check_every=8, mesh=mesh, axis_name="tile",
            data_axis_name="data",
            return_diagnostics=True,
        )
        assert int(d_t.iterations) == int(d_ref.iterations)
        np.testing.assert_allclose(
            np.asarray(x_t), np.asarray(x_ref), rtol=1e-3, atol=1e-5
        )

    def test_check_every_fold1_early_stop(self, rng, mesh8):
        """fold1 (delta-form) + early stop + block checking: the mid-block
        iterations run bf16x1 solves and the check iterations HIGH (all
        fp32 on CPU, so this validates the restructuring exactly)."""
        from admm_deconv.ops.solver import tv_deconvolve_adaptive

        y = jnp.asarray(_img(rng))
        x_ref, d_ref = tv_deconvolve_adaptive(
            y, None, lam=0.05, rho=0.5, max_iters=48, adapt_rho=False,
            check_every=4, fft_mode="fold1",
        )
        x_t, d_t = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=48, adapt_rho=False,
            early_stop=True, check_every=4, mesh=mesh8, fft_mode="fold1",
            return_diagnostics=True,
        )
        assert int(d_t.iterations) == int(d_ref.iterations)
        np.testing.assert_allclose(
            np.asarray(x_t), np.asarray(x_ref), rtol=1e-3, atol=1e-4
        )

    def test_bf16_state_fast_paths(self, rng, mesh8):
        """Round-4 mixed-precision carry on the tiled solver: bf16 storage
        for (q, ux, uy) in the fixed fast loop and the adaptive fast
        mid-loop; results land within the bf16 quantization envelope of
        the fp32 runs, and validation rejects non-fast configurations."""
        y = jnp.asarray(_img(rng))
        kw = dict(lam=0.05, rho=0.5, iters=24, mesh=mesh8,
                  fft_mode="fold1")
        x32 = tiled_tv_deconvolve(y, None, **kw)
        x16 = tiled_tv_deconvolve(y, None, state_dtype="bfloat16", **kw)
        np.testing.assert_allclose(np.asarray(x16), np.asarray(x32), atol=2e-2)
        # Adaptive fast mid-loop variant.
        kwa = dict(lam=0.05, rho=5.0, iters=24, mesh=mesh8, adapt_rho=True,
                   early_stop=True, check_every=8,
                   eps_abs=0.0, eps_rel=0.0, return_diagnostics=True)
        xa32, d32 = tiled_tv_deconvolve(y, None, **kwa)
        xa16, d16 = tiled_tv_deconvolve(
            y, None, state_dtype="bfloat16", **kwa
        )
        assert int(d16.iterations) == int(d32.iterations) == 24
        np.testing.assert_allclose(
            np.asarray(xa16), np.asarray(xa32), atol=2e-2
        )
        with pytest.raises(ValueError, match="state_dtype"):
            tiled_tv_deconvolve(
                y, None, iters=10, mesh=mesh8, state_dtype="bfloat16",
                return_diagnostics=True,
            )

    def test_fold_tile1_mesh(self, rng):
        """T=1 keeps the unpacked self-send all_to_alls (the packed re-shard
        only engages on real meshes) — both branches must agree with the
        single-chip solver."""
        mesh1 = make_mesh({"tile": 1})
        y = jnp.asarray(_img(rng))
        expected = tv_deconvolve(y, None, lam=0.02, rho=0.1, iters=12)
        got = tiled_tv_deconvolve(
            y, None, lam=0.02, rho=0.1, iters=12, mesh=mesh1,
            fft_mode="fold_precise",
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-4
        )

    def test_check_every_validation(self, rng, mesh8):
        y = jnp.asarray(_img(rng))
        with pytest.raises(ValueError, match="check_every"):
            tiled_tv_deconvolve(
                y, None, iters=10, check_every=3, early_stop=True, mesh=mesh8
            )
        with pytest.raises(ValueError, match="check_every"):
            tiled_tv_deconvolve(
                y, None, iters=4, check_every=8, adapt_rho=True,
                early_stop=True, mesh=mesh8,
            )

    def test_warm_start_resumes(self, rng, mesh8):
        img = _img(rng)
        y = jnp.asarray(img)
        x20 = tiled_tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=20, mesh=mesh8)
        _, state = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, mesh=mesh8, return_state=True
        )
        resumed = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, mesh=mesh8, init_state=state
        )
        np.testing.assert_allclose(
            np.asarray(resumed), np.asarray(x20), rtol=1e-4, atol=1e-5
        )

    def test_diagnostics_match_single_chip(self, rng, mesh8):
        img = _img(rng)
        y = jnp.asarray(img)
        _, d_ref = tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, return_diagnostics=True
        )
        _, d_t = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, mesh=mesh8,
            return_diagnostics=True,
        )
        assert int(d_t.iterations) == 10
        np.testing.assert_allclose(
            np.asarray(d_t.r_norm), np.asarray(d_ref.r_norm), rtol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(d_t.s_norm), np.asarray(d_ref.s_norm), rtol=1e-3
        )

    def test_data_x_tile_mesh(self, rng):
        """BASELINE config 5's multi-frame tiled case: batch*channels over a
        'data' axis AND H over a 'tile' axis simultaneously."""
        from admm_deconv.parallel import make_mesh

        mesh = make_mesh({"data": 2, "tile": 4})
        imgs = np.stack([_img(rng), _img(rng)])[..., None].repeat(3, axis=-1)
        y = jnp.asarray(imgs)  # (2, 64, 64, 3) -> 6 planes over data=2
        lam = np.asarray([0.01, 0.05], np.float32)
        expected = tv_deconvolve(y, None, lam=lam, rho=0.1, iters=12)
        got = tiled_tv_deconvolve(
            y, None, lam=lam, rho=0.1, iters=12, mesh=mesh,
            axis_name="tile", data_axis_name="data",
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-5
        )

    def test_data_x_tile_adaptive_early_stop(self, rng):
        from admm_deconv.parallel import make_mesh

        mesh = make_mesh({"data": 2, "tile": 4})
        imgs = np.stack([_img(rng), _img(rng)])[..., None]
        y = jnp.asarray(imgs)
        x, d = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=5.0, iters=60, adapt_rho=True,
            early_stop=True, mesh=mesh, axis_name="tile",
            data_axis_name="data", return_diagnostics=True,
        )
        assert np.all(np.isfinite(np.asarray(x)))
        assert d.r_norm.shape == (2,)
        assert not np.allclose(np.asarray(d.rho), 5.0)  # rebalanced

    def test_alpha_over_relaxation(self, rng, mesh8):
        """Tiled over-relaxation must match the single-chip solver."""
        img = _img(rng)
        y = jnp.asarray(img)
        expected = tv_deconvolve(y, None, lam=0.02, rho=0.5, iters=15, alpha=1.6)
        got = tiled_tv_deconvolve(
            y, None, lam=0.02, rho=0.5, iters=15, mesh=mesh8, alpha=1.6
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-4, atol=1e-6
        )

    def test_fold_mode_per_image_rho(self, rng, mesh8):
        imgs = np.stack([_img(rng), _img(rng)])[..., None]
        y = jnp.asarray(imgs)
        rho = np.asarray([0.05, 0.3], np.float32)
        expected = tv_deconvolve(y, None, lam=0.02, rho=rho, iters=12)
        got = tiled_tv_deconvolve(
            y, None, lam=0.02, rho=rho, iters=12, mesh=mesh8,
            fft_mode="fold_precise",
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-4
        )


class TestTiledFastPath:
    """The q-carry halo-stencil fast loop inside the tiled solver must
    match the single-device solver for every fft mode, prox, per-image
    params, warm start, and both mesh shapes, down to 1-row tiles."""

    @pytest.fixture(scope="class")
    def mesh8(self):
        from admm_deconv.parallel import make_mesh

        return make_mesh({"tile": 8})

    @pytest.mark.parametrize("fft_mode", ["xla", "fold_precise", "fold1"])
    @pytest.mark.parametrize("use_psf", [False, True])
    def test_matches_single_chip(self, rng, mesh8, fft_mode, use_psf):
        img = _img(rng)
        psf = None
        if use_psf:
            psf = np.zeros((5, 5), np.float32)
            psf[2, :] = 0.2
        y = jnp.asarray(img)
        expected = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.05, iters=15)
        got = tiled_tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.05, iters=15, mesh=mesh8,
            fft_mode=fft_mode,
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-5
        )

    @pytest.mark.parametrize("prox", ["iso", "hard", "gauss"])
    def test_prox_modes(self, rng, mesh8, prox):
        img = _img(rng)
        y = jnp.asarray(img)
        expected = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=10, prox=prox)
        got = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, prox=prox, mesh=mesh8,
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-5
        )

    def test_data_x_tile_per_image_params(self, rng):
        from admm_deconv.parallel import make_mesh

        mesh = make_mesh({"data": 2, "tile": 4})
        imgs = np.stack([_img(rng), _img(rng)])[..., None].repeat(3, axis=-1)
        y = jnp.asarray(imgs)
        lam = np.asarray([0.01, 0.05], np.float32)
        rho = np.asarray([0.05, 0.3], np.float32)
        expected = tv_deconvolve(y, None, lam=lam, rho=rho, iters=12)
        got = tiled_tv_deconvolve(
            y, None, lam=lam, rho=rho, iters=12, mesh=mesh,
            data_axis_name="data",
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-5
        )

    def test_warm_start(self, rng, mesh8):
        img = _img(rng)
        y = jnp.asarray(img)
        x20 = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=20)
        _, state = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, mesh=mesh8, return_state=True
        )
        resumed = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, mesh=mesh8,
            init_state=state,
        )
        np.testing.assert_allclose(
            np.asarray(resumed), np.asarray(x20), rtol=1e-4, atol=1e-5
        )

    def test_x_bounds(self, rng, mesh8):
        img = _img(rng)
        y = jnp.asarray(img)
        expected = tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, x_bounds=(0.0, 1.0)
        )
        got = tiled_tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, mesh=mesh8,
            x_bounds=(0.0, 1.0),
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-3, atol=1e-5
        )

    def test_tiny_tile_falls_back(self, rng, mesh8):
        """H=8 over 8 tiles -> 1-row tiles: every stencil row is a halo
        row."""
        y = jnp.asarray(np.clip(rng.random((8, 64)).astype(np.float32), 0, 1))
        expected = tv_deconvolve(y, None, lam=0.02, rho=0.5, iters=5)
        got = tiled_tv_deconvolve(
            y, None, lam=0.02, rho=0.5, iters=5, mesh=mesh8,
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expected), rtol=1e-4, atol=1e-6
        )


class TestHaloStencilKernel:
    """The halo variant of stencil_step must be bit-exact vs the circular
    one on a tile decomposition of the same image."""

    @pytest.mark.parametrize("mode", ["aniso", "iso", "hard", "gauss"])
    def test_tile_decomposition_exact(self, rng, mode):
        from admm_deconv.ops.stencil import stencil_step

        n, h, w = 2, 64, 64
        x = jnp.asarray(rng.standard_normal((n, h, w)), jnp.float32)
        ux = jnp.asarray(rng.standard_normal((n, h, w)), jnp.float32) * 0.1
        uy = jnp.asarray(rng.standard_normal((n, h, w)), jnp.float32) * 0.1
        tau = jnp.asarray(rng.random((n,)), jnp.float32) * 0.3
        q_ref, ux_ref, uy_ref = stencil_step(x, ux, uy, tau, mode)
        T, ht = 4, h // 4
        outs = []
        for t in range(T):
            sl = slice(t * ht, (t + 1) * ht)
            halo = (
                x[:, (t * ht - 1) % h][:, None, :],
                x[:, ((t + 1) * ht) % h][:, None, :],
                ux[:, ((t + 1) * ht) % h][:, None, :],
                uy[:, ((t + 1) * ht) % h][:, None, :],
            )
            outs.append(stencil_step(x[:, sl], ux[:, sl], uy[:, sl], tau, mode, halo))
        for k, ref in enumerate((q_ref, ux_ref, uy_ref)):
            tiled = jnp.concatenate([o[k] for o in outs], axis=1)
            np.testing.assert_array_equal(np.asarray(tiled), np.asarray(ref))


class TestTiledAnderson:
    """Round-3 (VERDICT missing #5): Anderson acceleration on the tiled
    solver — tile-sharded histories, psum'd Gram/safeguard consensus —
    checked against the single-chip tv_deconvolve_anderson contract."""

    @pytest.mark.parametrize("fft_mode", ["xla", "fold1"])
    def test_matches_single_chip(self, rng, mesh8, fft_mode):
        from admm_deconv.ops.solver import tv_deconvolve_anderson
        from admm_deconv.parallel import tiled_tv_deconvolve_anderson

        img = _img(rng)
        psf = np.zeros((5, 5), np.float32)
        psf[2, :] = 0.2
        y = jnp.asarray(img)
        x_ref, d_ref = tv_deconvolve_anderson(
            y, psf=psf, lam=0.01, rho=0.05, iters=30, m=5, fft_mode=fft_mode
        )
        x_t, d_t = tiled_tv_deconvolve_anderson(
            y, psf=psf, lam=0.01, rho=0.05, iters=30, m=5, mesh=mesh8,
            fft_mode=fft_mode,
        )
        np.testing.assert_allclose(
            np.asarray(x_t), np.asarray(x_ref), rtol=1e-3, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(d_t.s_norm), np.asarray(d_ref.s_norm), rtol=1e-3,
            atol=1e-6,
        )

    def test_interval_mixing_matches_single_chip(self, rng, mesh8):
        """Round 4: every-k mixing on the tiled solver (one sharded ring
        write / psum'd Gram refresh per k iterations, fused-halo-stencil
        fast inner loop) must reproduce the single-chip aa_interval path."""
        from admm_deconv.ops.solver import tv_deconvolve_anderson
        from admm_deconv.parallel import tiled_tv_deconvolve_anderson

        y = jnp.asarray(_img(rng))
        psf = np.zeros((5, 5), np.float32)
        psf[2, :] = 0.2
        kw = dict(psf=psf, lam=0.01, rho=0.05, iters=29, m=5, aa_interval=4)
        x_ref, d_ref = tv_deconvolve_anderson(y, **kw)
        x_t, d_t = tiled_tv_deconvolve_anderson(
            y, mesh=mesh8, **kw
        )
        np.testing.assert_allclose(
            np.asarray(x_t), np.asarray(x_ref), rtol=1e-3, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(d_t.s_norm), np.asarray(d_ref.s_norm), rtol=1e-3,
            atol=1e-6,
        )
        # Early stop + interval on the tiled path runs and stops early.
        x_e, d_e = tiled_tv_deconvolve_anderson(
            y, psf=psf, lam=0.01, rho=0.05, iters=201, m=5, aa_interval=4,
            early_stop=True, mesh=mesh8,
        )
        assert int(d_e.iterations) < 201
        assert bool(jnp.all(jnp.isfinite(x_e)))
        with pytest.raises(ValueError, match="aa_interval"):
            tiled_tv_deconvolve_anderson(
                y, psf=psf, iters=30, aa_interval=4, mesh=mesh8
            )

    def test_early_stop_matches(self, rng, mesh8):
        from admm_deconv.ops.solver import tv_deconvolve_anderson
        from admm_deconv.parallel import tiled_tv_deconvolve_anderson

        img = _img(rng)
        y = jnp.asarray(img)
        x_ref, d_ref = tv_deconvolve_anderson(
            y, None, lam=0.02, rho=0.5, iters=200, m=5, early_stop=True
        )
        x_t, d_t = tiled_tv_deconvolve_anderson(
            y, None, lam=0.02, rho=0.5, iters=200, m=5, early_stop=True,
            mesh=mesh8,
        )
        assert int(d_t.iterations) == int(d_ref.iterations)
        np.testing.assert_allclose(
            np.asarray(x_t), np.asarray(x_ref), rtol=1e-3, atol=1e-5
        )

    def test_data_x_tile(self, rng):
        from admm_deconv.ops.solver import tv_deconvolve_anderson
        from admm_deconv.parallel import (
            make_mesh,
            tiled_tv_deconvolve_anderson,
        )

        mesh = make_mesh({"data": 2, "tile": 4})
        imgs = np.stack([_img(rng), _img(rng)])[..., None]
        y = jnp.asarray(imgs)
        lam = np.asarray([0.01, 0.05], np.float32)
        x_ref, _ = tv_deconvolve_anderson(y, None, lam=lam, rho=0.1, iters=25, m=4)
        x_t, _ = tiled_tv_deconvolve_anderson(
            y, None, lam=lam, rho=0.1, iters=25, m=4, mesh=mesh,
            data_axis_name="data",
        )
        np.testing.assert_allclose(
            np.asarray(x_t), np.asarray(x_ref), rtol=1e-3, atol=1e-5
        )

    def test_validation(self, rng, mesh8):
        from admm_deconv.parallel import tiled_tv_deconvolve_anderson

        y = jnp.zeros((64, 64))
        with pytest.raises(ValueError, match="mesh"):
            tiled_tv_deconvolve_anderson(y)
        with pytest.raises(ValueError, match="m"):
            tiled_tv_deconvolve_anderson(y, m=0, mesh=mesh8)
        with pytest.raises(ValueError, match="iters"):
            tiled_tv_deconvolve_anderson(y, iters=1, mesh=mesh8)


class TestTiledComposite:
    """Round-3: the composite (TV+L1+box) solver on the tile mesh, q-carry
    form with the halo-stencil kernel, vs the single-chip composite."""

    @pytest.mark.parametrize("fft_mode", ["xla", "fold1"])
    @pytest.mark.parametrize("prox", ["aniso", "iso"])
    def test_matches_single_chip(self, rng, mesh8, fft_mode, prox):
        from admm_deconv.ops.composite import composite_tv_deconvolve
        from admm_deconv.parallel import tiled_composite_tv_deconvolve

        img = _img(rng)
        psf = np.zeros((5, 5), np.float32)
        psf[2, :] = 0.2
        y = jnp.asarray(img)
        kw = dict(lam_tv=0.01, lam_l1=0.002, rho1=0.1, rho2=0.2, iters=20,
                  x_bounds=(0.0, 1.0))
        ref = composite_tv_deconvolve(
            y, psf, fft_mode="xla", prox=prox, **kw
        )
        got = tiled_composite_tv_deconvolve(
            y, psf, mesh=mesh8, fft_mode=fft_mode, prox=prox, **kw
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=1e-3, atol=1e-5
        )

    def test_data_x_tile_per_image_lam(self, rng):
        from admm_deconv.ops.composite import composite_tv_deconvolve
        from admm_deconv.parallel import (
            make_mesh,
            tiled_composite_tv_deconvolve,
        )

        mesh = make_mesh({"data": 2, "tile": 4})
        imgs = np.stack([_img(rng), _img(rng)])[..., None]
        y = jnp.asarray(imgs)
        lam_b = np.asarray([0.01, 0.03], np.float32)
        kw = dict(lam_tv=lam_b, lam_l1=0.002, rho1=0.1, rho2=0.2, iters=15)
        ref = composite_tv_deconvolve(y, None, fft_mode="xla",
                                      **kw)
        got = tiled_composite_tv_deconvolve(
            y, None, mesh=mesh, data_axis_name="data", **kw
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=1e-3, atol=1e-5
        )

    def test_validation(self, rng, mesh8):
        from admm_deconv.parallel import tiled_composite_tv_deconvolve

        with pytest.raises(ValueError, match="mesh"):
            tiled_composite_tv_deconvolve(jnp.zeros((64, 64)))
        with pytest.raises(ValueError, match="divide"):
            tiled_composite_tv_deconvolve(jnp.zeros((60, 64)), mesh=mesh8)
