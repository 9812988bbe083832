"""The auto-mode policy: one entry per backend, overridable without
editing source, and an error for a backend with no entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_deconv.ops import policy as policy_mod
from admm_deconv.ops.policy import overrides, policy, refresh, set_policy
from admm_deconv.ops.solver import (
    resolve_fft_mode,
    solve_auto,
    tv_deconvolve,
    tv_deconvolve_adaptive,
)


@pytest.fixture
def backend(monkeypatch):
    """Pretend JAX's default backend is the given one (for resolution only:
    no computation runs on it)."""

    def set_backend(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)

    return set_backend


class TestPolicyTable:
    @pytest.mark.parametrize("name", ["cpu", "gpu"])
    def test_entries_are_complete(self, name):
        p = policy(name)
        assert p.fft_mode in ("xla", "mxu", "fold", "fold1", "pack")
        assert p.fft_mode_adaptive in ("xla", "mxu", "fold", "fold_precise")
        assert p.deep_eps_abs > 0
        assert p.solve_auto_check_every >= 1
        assert p.adaptive_fold1_min_check_every >= 1

    @pytest.mark.parametrize("name", ["neuron", "rocm", "METAL"])
    def test_unknown_backend_raises(self, name):
        with pytest.raises(ValueError, match="no auto policy"):
            policy(name)

    @pytest.mark.parametrize("name", ["neuron", "rocm"])
    def test_resolution_on_unknown_backend_raises(self, backend, name):
        backend(name)
        with pytest.raises(ValueError, match="no auto policy"):
            resolve_fft_mode("auto")

    def test_cpu_entry(self):
        p = policy("cpu")
        assert p.fft_mode == p.fft_mode_adaptive == "xla"
        assert p.bf16_state is False
        assert p.precompute_fft_mxu is False

    def test_gpu_entry_follows_the_native_fft(self):
        # On the H100 the native FFT is cuFFT, measured faster than the
        # DFT-by-matmul modes (PERF.md); the precompute follows it.
        p = policy("gpu")
        assert p.fft_mode == "xla"
        assert p.precompute_fft_mxu is False

    def test_default_backend_is_cpu_here(self):
        assert policy() == policy("cpu")


class TestOverrides:
    def test_set_policy_and_overrides(self):
        base = policy().deep_eps_abs
        with overrides(deep_eps_abs=1e-6, fft_mode="mxu") as p:
            assert p.deep_eps_abs == 1e-6
            assert policy().fft_mode == "mxu"
            # Overrides apply on every backend's entry.
            assert policy("gpu").fft_mode == "mxu"
        assert policy().deep_eps_abs == base
        set_policy(solve_auto_check_every=4)
        try:
            assert policy().solve_auto_check_every == 4
        finally:
            refresh()

    def test_unknown_field_raises(self):
        with pytest.raises(ValueError, match="unknown policy fields"):
            set_policy(nope=1)
        refresh()

    def test_env_overrides(self, monkeypatch):
        monkeypatch.setenv("ADMM_DEEP_EPS_ABS", "1e-5")
        monkeypatch.setenv("ADMM_FFT_MODE", "fold")
        monkeypatch.setenv("ADMM_BF16_STATE", "true")
        monkeypatch.setenv("ADMM_SOLVE_AUTO_CHECK_EVERY", "16")
        refresh()
        try:
            p = policy()
            assert p.deep_eps_abs == 1e-5
            assert p.fft_mode == "fold"
            assert p.bf16_state is True
            assert p.solve_auto_check_every == 16
        finally:
            monkeypatch.undo()
            refresh()
        assert policy() == policy_mod._TABLE["cpu"]

    @pytest.mark.parametrize("name", ["cpu", "gpu"])
    def test_resolvers_read_policy(self, backend, name):
        backend(name)
        # Explicit modes always pass through, any backend.
        assert resolve_fft_mode("fold") == "fold"
        with overrides(fft_mode="mxu"):
            assert resolve_fft_mode("auto") == "mxu"
        with overrides(fft_mode_adaptive="fold"):
            assert resolve_fft_mode("auto", adaptive=True) == "fold"
        assert resolve_fft_mode("auto") == policy(name).fft_mode


class TestSolveAutoFixedBudget:
    """A fixed budget runs as ONE check_every=iters block of the adaptive
    solver: the q-carry mid-loop, with true final residuals from the single
    end-of-run check."""

    def test_fixed_budget_cpu_matches_scan_solver(self, rng):
        y = jnp.asarray(rng.random((1, 32, 32, 1)), jnp.float32)
        x, diag = solve_auto(y, None, lam=0.03, rho=0.3, iters=12)
        x_ref, d_ref = tv_deconvolve(
            y, None, lam=0.03, rho=0.3, iters=12, return_diagnostics=True
        )
        # Same iterate sequence; only fp32 association order differs.
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(diag.r_norm), np.asarray(d_ref.r_norm), rtol=1e-4
        )
        assert int(diag.iterations) == 12

    def test_fixed_budget_large_iters_traces_fast(self, rng):
        """iters=400 must not blow up trace/compile time: the mid-loop is
        a scan, O(1) in iters."""
        import time

        y = jnp.asarray(rng.random((1, 16, 16, 1)), jnp.float32)
        t0 = time.time()
        x, diag = solve_auto(y, None, lam=0.03, rho=0.3, iters=400)
        elapsed = time.time() - t0
        assert bool(jnp.all(jnp.isfinite(x)))
        assert elapsed < 60, f"solve_auto(iters=400) took {elapsed:.1f}s"

    def test_single_iteration_budget(self, rng):
        y = jnp.asarray(rng.random((1, 16, 16, 1)), jnp.float32)
        x, diag = solve_auto(y, None, lam=0.03, rho=0.3, iters=1)
        x_ref = tv_deconvolve(y, None, lam=0.03, rho=0.3, iters=1)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(x_ref))
        assert int(diag.iterations) == 1

    def test_bf16_policy_narrows_the_carry(self, rng):
        y = jnp.asarray(rng.random((1, 32, 32, 1)), jnp.float32)
        x32, _ = solve_auto(y, None, lam=0.03, rho=0.3, iters=16)
        with overrides(bf16_state=True):
            x16, _ = solve_auto(y, None, lam=0.03, rho=0.3, iters=16)
        diff = float(jnp.max(jnp.abs(x16 - x32)))
        assert 0.0 < diff < 2e-2


class TestAdaptiveDeepEps:
    """tv_deconvolve_adaptive applies the deep-tolerance switch itself,
    not only via solve_auto."""

    @pytest.mark.parametrize("name", ["cpu", "gpu"])
    def test_deep_eps_resolves_to_adaptive_mode(self, backend, name):
        backend(name)
        p = policy()
        assert 1e-5 < p.deep_eps_abs  # a deep tolerance under the policy
        with overrides(fft_mode="fold1", fft_mode_adaptive="fold"):
            deep = 1e-5 < policy().deep_eps_abs
            assert resolve_fft_mode("auto", adaptive=deep) == "fold"
            assert resolve_fft_mode("auto", adaptive=False) == "fold1"

    def test_adaptive_runs_with_deep_eps(self, rng):
        """End-to-end: a deep-tolerance adaptive call with fft_mode='auto'
        runs and stays finite."""
        y = jnp.asarray(rng.random((1, 32, 32, 1)), jnp.float32)
        x, diag = tv_deconvolve_adaptive(
            y, None, lam=0.03, rho=0.3, max_iters=64, check_every=8,
            eps_abs=1e-5, eps_rel=1e-4,
        )
        assert bool(jnp.all(jnp.isfinite(x)))
