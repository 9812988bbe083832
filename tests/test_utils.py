"""Utils tests: array helpers, 3-D diff adjointness, profiling, debug."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from admm_deconv.utils import (
    expand_dims,
    fftn_matlike,
    forward_diff3d,
    divergence3d,
    IterationTimer,
    enable_nan_checks,
)


class TestArrays:
    def test_expand_dims(self, rng):
        x = jnp.asarray(rng.random((3, 4)))
        assert expand_dims(x, 1).shape == (3, 1, 4)

    def test_fftn_matlike_pads(self, rng):
        x = jnp.asarray(rng.random((3, 4)), jnp.float32)
        out = fftn_matlike(x, (8, 8))
        expected = np.fft.fftn(np.pad(np.asarray(x), ((0, 5), (0, 4))))
        np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-3, atol=1e-4)

    def test_fftn_matlike_validates(self):
        with pytest.raises(ValueError):
            fftn_matlike(jnp.zeros((3, 4)), (8,))
        with pytest.raises(ValueError):
            fftn_matlike(jnp.zeros((3, 4)), (2, 8))


class TestDiff3d:
    def test_adjointness(self, rng):
        """<forward_diff3d(u), p> == -<u, divergence3d(p)> — the identity the
        reference's buggy divergence3d (base_funcs.jl:102) violates."""
        u = jnp.asarray(rng.standard_normal((4, 5, 6, 2)), jnp.float32)
        px = jnp.asarray(rng.standard_normal((4, 5, 6, 2)), jnp.float32)
        py = jnp.asarray(rng.standard_normal((4, 5, 6, 2)), jnp.float32)
        pz = jnp.asarray(rng.standard_normal((4, 5, 6, 2)), jnp.float32)
        beta = (1.0, 1.0, 1.0)
        dx, dy, dz = forward_diff3d(u, beta)
        lhs = float(jnp.sum(dx * px) + jnp.sum(dy * py) + jnp.sum(dz * pz))
        rhs = -float(jnp.sum(u * divergence3d(px, py, pz, beta)))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-4)

    def test_beta_validation(self):
        with pytest.raises(ValueError):
            forward_diff3d(jnp.zeros((2, 2, 2)), (1.0, 2.0))


class TestProfiling:
    def test_iteration_timer(self):
        import jax

        fn = jax.jit(lambda x: x * 2 + 1)
        timer = IterationTimer(fn, lambda i: (jnp.full((8, 8), float(i)),))
        stats = timer.measure(repeats=2)
        assert stats["seconds_per_call"] > 0
        assert stats["repeats"] == 2


class TestDebug:
    def test_nan_checks_toggle(self):
        import jax

        enable_nan_checks(True)
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: x / 0.0 * 0.0)(jnp.asarray(1.0))
        enable_nan_checks(False)


class TestSolverStateIO:
    def test_save_load_roundtrip(self, tmp_path, rng):
        import jax.numpy as jnp
        from admm_deconv.ops.solver import tv_deconvolve
        from admm_deconv.utils import save_solver_state, load_solver_state

        y = jnp.asarray(rng.random((16, 16)), jnp.float32)
        x10, state = tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, return_state=True
        )
        p = str(tmp_path / "state.npz")
        save_solver_state(p, state)
        restored = load_solver_state(p)
        x_resumed = tv_deconvolve(
            y, None, lam=0.05, rho=0.5, iters=10, init_state=restored
        )
        x20 = tv_deconvolve(y, None, lam=0.05, rho=0.5, iters=20)
        np.testing.assert_allclose(
            np.asarray(x_resumed), np.asarray(x20), rtol=1e-5, atol=1e-6
        )


class TestCompileCache:
    """Persistent-compile-cache helper: JAX_COMPILATION_CACHE_DIR when set,
    otherwise a fixed directory inside the checkout."""

    def test_enable_sets_config_and_creates_dir(self, tmp_path, monkeypatch):
        import jax

        from admm_deconv.utils.compile_cache import enable_compile_cache

        monkeypatch.delenv("ADMM_NO_COMPILE_CACHE", raising=False)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = str(tmp_path / "xla_cache")
        prev = jax.config.jax_compilation_cache_dir
        try:
            got = enable_compile_cache(d)
            assert got == d and os.path.isdir(d)
            assert jax.config.jax_compilation_cache_dir == d
        finally:
            jax.config.update("jax_compilation_cache_dir", prev)

    def test_default_dir_is_in_the_checkout(self, monkeypatch):
        import jax

        from admm_deconv.utils import compile_cache

        monkeypatch.delenv("ADMM_NO_COMPILE_CACHE", raising=False)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert compile_cache.DEFAULT_DIR == os.path.join(root, ".jax_cache")
        prev = jax.config.jax_compilation_cache_dir
        try:
            assert compile_cache.enable_compile_cache() == compile_cache.DEFAULT_DIR
            assert jax.config.jax_compilation_cache_dir == compile_cache.DEFAULT_DIR
        finally:
            jax.config.update("jax_compilation_cache_dir", prev)

    def test_env_dir_wins_and_is_not_overridden(self, tmp_path, monkeypatch):
        import jax

        from admm_deconv.utils.compile_cache import enable_compile_cache

        monkeypatch.delenv("ADMM_NO_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        prev = jax.config.jax_compilation_cache_dir
        assert enable_compile_cache(str(tmp_path / "arg")) == str(tmp_path / "env")
        assert jax.config.jax_compilation_cache_dir == prev
        assert not os.path.isdir(str(tmp_path / "arg"))

    def test_opt_out_env(self, tmp_path, monkeypatch):
        from admm_deconv.utils.compile_cache import enable_compile_cache

        monkeypatch.setenv("ADMM_NO_COMPILE_CACHE", "1")
        assert enable_compile_cache(str(tmp_path / "x")) is None
        assert not os.path.isdir(str(tmp_path / "x"))


class TestTraceReduction:
    """The trace -> device-time-per-phase reduction, on a recorded CPU
    trace of a small solve."""

    def test_scopes_found_in_a_recorded_trace(self, tmp_path):
        import jax

        from admm_deconv.ops.solver import tv_deconvolve
        from admm_deconv.utils.profiling import (
            device_time_by_scope,
            hlo_op_names,
            latest_xplane,
        )

        y = jnp.asarray(np.random.default_rng(0).random((1, 32, 48, 3)), jnp.float32)
        fn = jax.jit(
            lambda v: tv_deconvolve(v, None, lam=0.01, rho=0.1, iters=4)
        ).lower(y).compile()
        names = hlo_op_names(fn.as_text())
        assert any("admm/stencil" in v for v in names.values())
        jax.block_until_ready(fn(y))
        with jax.profiler.trace(str(tmp_path)):
            jax.block_until_ready(fn(y + 1))
        red = device_time_by_scope(latest_xplane(str(tmp_path)), names, "/host:CPU")
        assert red["scopes"].get("stencil", 0) > 0
        assert red["scopes"].get("x_update", 0) > 0
        assert 0 < red["busy_ns"] <= red["window_ns"]

    @pytest.mark.parametrize(
        "op_name,scope",
        [
            ("jit(f)/admm/loop/while/body/closed_call/admm/stencil/add", "stencil"),
            ("jit(f)/admm/precompute/jit(fft)/fft", "precompute"),
            ("jit(f)/transpose", "other"),
        ],
    )
    def test_scope_of(self, op_name, scope):
        from admm_deconv.utils.profiling import scope_of

        assert scope_of(op_name) == scope

    def test_hlo_op_names_parses_instructions(self):
        from admm_deconv.utils.profiling import hlo_op_names

        text = (
            '  %fusion.3 = f32[4]{0} fusion(f32[4]{0} %p), kind=kLoop, '
            'calls=%c, metadata={op_name="jit(f)/admm/stencil/add"}\n'
            '  ROOT %fft.1 = c64[4]{0} fft(%x), fft_type=RFFT, '
            'metadata={op_name="jit(f)/admm/x_update/fft"}\n'
            '  %p = f32[4]{0} parameter(0)\n'
        )
        assert hlo_op_names(text) == {
            "fusion.3": "jit(f)/admm/stencil/add",
            "fft.1": "jit(f)/admm/x_update/fft",
        }
