"""The stencil section (ops/stencil.py) against the numpy twin, its halo and
bf16-carry variants, its gradient, and the solvers' q-carry loops against
the reference-shaped 5-plane loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_deconv.ops import prox as prox_lib
from admm_deconv.ops.diff import grad2d, grad2d_adjoint
from admm_deconv.ops.solver import tv_deconvolve
from admm_deconv.ops.stencil import composite_stencil_step, stencil_step
from admm_deconv.ops.stencil_triton import stencil_step_triton
import reference_twin as twin

MODES = ["aniso", "iso", "hard", "gauss"]
SHAPES = [(2, 24, 128), (3, 17, 33), (1, 40, 6)]
F32, BF16 = jnp.float32, jnp.bfloat16


def _mk(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, F32)


def _tau(rng, kind, n):
    if kind == "scalar":
        return 0.3
    t = rng.uniform(0.1, 0.5, (n,)).astype(np.float32)
    return t if kind == "vector" else t[:, None, None]


def _tau_planes(tau, n):
    return np.broadcast_to(np.asarray(tau, np.float64).reshape(-1), (n,))


def _composition(x, ux, uy, tau, mode):
    """The unfused jnp composition stencil_step replaces."""
    t = jnp.asarray(tau, F32)
    t = t.reshape(-1, 1, 1) if t.ndim == 1 else t
    dxx, dxy = grad2d(x)
    zx, zy, ux2, uy2 = prox_lib.prox_dual_step(
        dxx, dxy, ux, uy, t, prox_lib.resolve(mode)
    )
    return grad2d_adjoint(zx - ux2, zy - uy2), ux2, uy2


class TestAgainstTwin:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("tau_kind", ["scalar", "vector", "bcast"])
    @pytest.mark.parametrize("shape", SHAPES, ids=["wide", "odd", "narrow"])
    def test_matches_numpy_twin(self, rng, mode, tau_kind, shape):
        x, ux, uy = _mk(rng, shape), _mk(rng, shape, 0.1), _mk(rng, shape, 0.1)
        tau = _tau(rng, tau_kind, shape[0])
        got = stencil_step(x, ux, uy, tau, mode)
        taus = _tau_planes(tau, shape[0])
        for i in range(shape[0]):
            want = twin.admm_stencil(
                np.asarray(x[i], np.float64), np.asarray(ux[i], np.float64),
                np.asarray(uy[i], np.float64), taus[i], mode,
            )
            for g, w in zip(got, want):
                assert g.dtype == F32
                np.testing.assert_allclose(np.asarray(g[i]), w, atol=1e-5)

    @pytest.mark.parametrize("name", ["soft", "block"])
    def test_prox_aliases(self, rng, name):
        shape = (2, 16, 32)
        x, ux, uy = _mk(rng, shape), _mk(rng, shape, 0.1), _mk(rng, shape, 0.1)
        canon = {"soft": "aniso", "block": "iso"}[name]
        for a, b in zip(
            stencil_step(x, ux, uy, 0.2, name), stencil_step(x, ux, uy, 0.2, canon)
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_callable_prox(self, rng):
        shape = (2, 16, 32)
        x, ux, uy = _mk(rng, shape), _mk(rng, shape, 0.1), _mk(rng, shape, 0.1)
        got = stencil_step(x, ux, uy, 0.2, prox_lib.soft)
        want = stencil_step(x, ux, uy, 0.2, "aniso")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_rejects_non_plane_input(self, rng):
        x = _mk(rng, (16, 32))
        with pytest.raises(ValueError, match="expected"):
            stencil_step(x, x, x, 0.1)


class TestHalo:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("tiles", [2, 3, 6])
    @pytest.mark.parametrize("carry", ["float32", "bfloat16"])
    def test_split_image_matches_circular(self, rng, mode, tiles, carry):
        n, h, w = 2, 48, 40
        dt = jnp.dtype(carry)
        x = _mk(rng, (n, h, w))
        ux = _mk(rng, (n, h, w), 0.1).astype(dt)
        uy = _mk(rng, (n, h, w), 0.1).astype(dt)
        tau = _tau(rng, "vector", n)
        ref = stencil_step(x, ux, uy, tau, mode)
        ht = h // tiles
        outs = []
        for t in range(tiles):
            sl = slice(t * ht, (t + 1) * ht)
            halo = (
                x[:, (t * ht - 1) % h][:, None],
                x[:, ((t + 1) * ht) % h][:, None],
                ux[:, ((t + 1) * ht) % h][:, None],
                uy[:, ((t + 1) * ht) % h][:, None],
            )
            outs.append(stencil_step(x[:, sl], ux[:, sl], uy[:, sl], tau, mode, halo))
        for k, r in enumerate(ref):
            tiled = jnp.concatenate([o[k] for o in outs], axis=1)
            assert tiled.dtype == dt
            np.testing.assert_array_equal(np.asarray(tiled), np.asarray(r))


class TestBf16Carry:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("tau_kind", ["scalar", "vector"])
    def test_is_fp32_math_rounded_once(self, rng, mode, tau_kind):
        """A bf16 carry changes only storage: the outputs are the fp32
        stencil of the (bf16-valued) inputs, rounded to bf16 once."""
        shape = (2, 24, 64)
        x = _mk(rng, shape)
        ux = _mk(rng, shape, 0.1).astype(BF16)
        uy = _mk(rng, shape, 0.1).astype(BF16)
        tau = _tau(rng, tau_kind, shape[0])
        got = stencil_step(x, ux, uy, tau, mode)
        want = stencil_step(x, ux.astype(F32), uy.astype(F32), tau, mode)
        for g, w in zip(got, want):
            assert g.dtype == BF16
            np.testing.assert_array_equal(
                np.asarray(g.astype(F32)), np.asarray(w.astype(BF16).astype(F32))
            )


class TestGradient:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("tau_kind", ["scalar", "vector"])
    def test_matches_composition_grad(self, rng, mode, tau_kind):
        shape = (2, 24, 64)
        x, ux, uy = _mk(rng, shape), _mk(rng, shape, 0.1), _mk(rng, shape, 0.1)
        tau = jnp.asarray(_tau(rng, tau_kind, shape[0]), F32)
        cts = [_mk(rng, shape) for _ in range(3)]

        def loss(fn):
            return lambda *a: sum(
                jnp.sum(o.astype(F32) * c) for o, c in zip(fn(*a), cts)
            )

        argn = (0, 1, 2, 3)
        g_s = jax.grad(loss(lambda *a: stencil_step(*a, mode)), argn)(x, ux, uy, tau)
        g_c = jax.grad(loss(lambda *a: _composition(*a, mode)), argn)(x, ux, uy, tau)
        for a, b in zip(g_s, g_c):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=2e-4, rtol=1e-4
            )

    @pytest.mark.parametrize("mode", MODES)
    def test_bf16_carry_cotangents(self, rng, mode):
        """Cotangents follow the primals (fp32 image, bf16 duals) and land
        within bf16 rounding of the fp32-carry gradient at the same
        point."""
        shape = (2, 24, 64)
        x = _mk(rng, shape)
        ux, uy = _mk(rng, shape, 0.1), _mk(rng, shape, 0.1)
        cts = [_mk(rng, shape) for _ in range(3)]

        def loss(x, ux, uy):
            return sum(
                jnp.sum(o.astype(F32) * c)
                for o, c in zip(stencil_step(x, ux, uy, 0.25, mode), cts)
            )

        ux16, uy16 = ux.astype(BF16), uy.astype(BF16)
        g16 = jax.grad(loss, (0, 1, 2))(x, ux16, uy16)
        # fp32 carry at the same (bf16-valued) point: only rounding differs.
        g32 = jax.grad(loss, (0, 1, 2))(x, ux16.astype(F32), uy16.astype(F32))
        assert g16[0].dtype == F32
        assert g16[1].dtype == BF16 and g16[2].dtype == BF16
        for a, b in zip(g16, g32):
            scale = float(jnp.max(jnp.abs(b)))
            err = float(jnp.max(jnp.abs(a.astype(F32) - b)))
            assert err <= 2e-2 * scale, (err, scale)


class TestComposite:
    @pytest.mark.parametrize("mode", ["aniso", "iso"])
    @pytest.mark.parametrize("bounds", [None, (0.0, 1.0)], ids=["free", "box"])
    @pytest.mark.parametrize("tau_kind", ["scalar", "vector"])
    def test_matches_composition(self, rng, mode, bounds, tau_kind):
        shape = (2, 20, 24)
        x = jnp.asarray(rng.random(shape), F32)
        ux, uy, u2 = (_mk(rng, shape, 0.1) for _ in range(3))
        tau_tv = _tau(rng, tau_kind, shape[0])
        tau_l1, ratio = 0.01, 0.5
        q, ux2, uy2, u2n = composite_stencil_step(
            x, ux, uy, u2, tau_tv, tau_l1, ratio, mode, bounds
        )
        q_tv, ux_r, uy_r = _composition(x, ux, uy, tau_tv, mode)
        v2 = x + u2
        z2 = jnp.sign(v2) * jnp.maximum(jnp.abs(v2) - tau_l1, 0.0)
        if bounds is not None:
            z2 = jnp.clip(z2, *bounds)
        u2_r = v2 - z2
        for g, w in zip(
            (q, ux2, uy2, u2n), (q_tv + ratio * (z2 - u2_r), ux_r, uy_r, u2_r)
        ):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)


class TestFastPathEquivalence:
    """The fixed solver's q-carry loop must reproduce the reference-shaped
    loop (the diagnostics path still runs the 5-plane-state scan)."""

    @pytest.fixture
    def problem(self, rng):
        y = jnp.asarray(rng.random((2, 64, 48, 3)), F32)
        psf = np.zeros((5, 5), np.float32)
        psf[2, :] = 1 / 5
        return y, jnp.asarray(psf)

    @pytest.mark.parametrize(
        "kwargs",
        [
            {},
            {"prox": "iso"},
            {"prox": "gauss"},
            {"alpha": 1.6},
            {"x_bounds": (0.0, 1.0)},
            {"lam": np.asarray([0.01, 0.02], np.float32)},
        ],
        ids=["default", "iso", "gauss", "overrelax", "bounds", "per_image_lam"],
    )
    def test_matches_diagnostics_path(self, problem, kwargs):
        y, psf = problem
        lam = kwargs.pop("lam", 0.01)
        x_fast = tv_deconvolve(y, psf=psf, lam=lam, rho=0.1, iters=13, **kwargs)
        x_slow, _ = tv_deconvolve(
            y, psf=psf, lam=lam, rho=0.1, iters=13,
            return_diagnostics=True, **kwargs,
        )
        np.testing.assert_allclose(
            np.asarray(x_fast), np.asarray(x_slow), atol=2e-6
        )

    def test_warm_start(self, problem):
        y, psf = problem
        _, state = tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.1, iters=7, return_state=True
        )
        x_fast = tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.1, iters=6, init_state=state
        )
        x_slow, _ = tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.1, iters=6,
            init_state=state, return_diagnostics=True,
        )
        np.testing.assert_allclose(
            np.asarray(x_fast), np.asarray(x_slow), atol=2e-6
        )

    def test_single_iteration(self, problem):
        y, psf = problem
        a = tv_deconvolve(y, psf=psf, lam=0.01, rho=0.1, iters=1)
        b, _ = tv_deconvolve(
            y, psf=psf, lam=0.01, rho=0.1, iters=1, return_diagnostics=True
        )
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-6)

    @pytest.mark.parametrize("lam_shape", ["scalar", "vector"])
    def test_gradient_matches_diagnostics_path(self, problem, lam_shape):
        y, psf = problem
        lam = (
            jnp.asarray(0.01)
            if lam_shape == "scalar"
            else jnp.asarray([0.01, 0.02], F32)
        )

        def loss(diag, lam, y):
            out = tv_deconvolve(
                y, psf=psf, lam=lam, rho=0.1, iters=6, return_diagnostics=diag
            )
            return jnp.sum((out[0] if diag else out) ** 2)

        gq = jax.grad(loss, argnums=(1, 2))(False, lam, y)
        g5 = jax.grad(loss, argnums=(1, 2))(True, lam, y)
        for a, b in zip(gq, g5):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-4, rtol=2e-4
            )

    def test_differentiable_with_remat(self, problem):
        y, psf = problem
        g = jax.grad(
            lambda yy: jnp.sum(
                tv_deconvolve(yy, psf=psf, lam=0.01, rho=0.1, iters=5, remat=True)
            )
        )(y)
        assert bool(jnp.all(jnp.isfinite(g)))


class TestBf16CarryTrains:
    def test_solver_state_dtype_trains(self, rng):
        """A bf16-carry solve is differentiable and its gradient lands
        within the carry's rounding envelope of the fp32-carry gradient."""
        y = jnp.asarray(rng.random((1, 32, 128, 1)), F32)

        def loss(sdt):
            return lambda lam: jnp.sum(
                tv_deconvolve(
                    y, None, lam=lam, rho=0.3, iters=8, state_dtype=sdt,
                ) ** 2
            )

        g16 = jax.grad(loss("bfloat16"))(0.05)
        g32 = jax.grad(loss(None))(0.05)
        assert np.isfinite(float(g16))
        np.testing.assert_allclose(float(g16), float(g32), rtol=2e-2)

    def test_layer_state_dtype_trains(self, rng):
        """An ADMMDeconv with state_dtype set produces finite, non-zero
        parameter gradients."""
        pytest.importorskip("flax")
        from admm_deconv.layers.deconv import ADMMDeconv

        layer = ADMMDeconv(
            kernel_shape=(), iters=6, iso=True, state_dtype="bfloat16",
        )
        x = jnp.asarray(rng.random((1, 24, 128, 1)), F32)
        params = layer.init(jax.random.PRNGKey(0), x)
        g = jax.grad(lambda p: jnp.sum(layer.apply(p, x) ** 2))(params)
        leaves = jax.tree_util.tree_leaves(g)
        assert leaves and all(bool(jnp.all(jnp.isfinite(l))) for l in leaves)
        assert any(float(jnp.max(jnp.abs(l))) > 0 for l in leaves)


class TestTritonKernel:
    """The hand-written stencil kernel (ops/stencil_triton.py) in the
    Pallas interpreter, against the jnp stencil it replaces on the GPU."""

    @staticmethod
    def _kernel(*args, mode="aniso"):
        # Small power-of-two blocks: partial blocks on both axes.
        return stencil_step_triton(*args, mode, 8, 16, 4, True)

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("tau_kind", ["scalar", "vector"])
    @pytest.mark.parametrize("carry", ["float32", "bfloat16"])
    def test_matches_jnp_stencil(self, rng, mode, tau_kind, carry):
        from admm_deconv.ops.stencil import _jnp_stencil_step

        shape = (2, 19, 37)
        dt = jnp.dtype(carry)
        x = _mk(rng, shape)
        ux, uy = _mk(rng, shape, 0.1).astype(dt), _mk(rng, shape, 0.1).astype(dt)
        tau = jnp.asarray(_tau(rng, tau_kind, shape[0]), F32)
        got = self._kernel(x, ux, uy, tau, mode=mode)
        want = _jnp_stencil_step(x, ux, uy, tau, mode)
        for g, w in zip(got, want):
            assert g.dtype == dt and g.shape == shape
            np.testing.assert_allclose(
                np.asarray(g.astype(F32)), np.asarray(w.astype(F32)),
                atol=1e-5 if carry == "float32" else 0, rtol=2.0 ** -8,
            )

    @pytest.mark.parametrize("mode", ["aniso", "iso"])
    def test_gradient_is_the_jnp_vjp(self, rng, mode):
        from admm_deconv.ops.stencil import _jnp_stencil_step

        shape = (2, 19, 37)
        x, ux, uy = _mk(rng, shape), _mk(rng, shape, 0.1), _mk(rng, shape, 0.1)
        tau = jnp.asarray(_tau(rng, "vector", shape[0]), F32)
        cts = [_mk(rng, shape) for _ in range(3)]

        def loss(fn):
            return lambda *a: sum(jnp.sum(o * c) for o, c in zip(fn(*a), cts))

        argn = (0, 1, 2, 3)
        g_k = jax.grad(loss(lambda *a: self._kernel(*a, mode=mode)), argn)(
            x, ux, uy, tau)
        g_j = jax.grad(loss(lambda *a: _jnp_stencil_step(*a, mode)), argn)(
            x, ux, uy, tau)
        for a, b in zip(g_k, g_j):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)

    @pytest.fixture
    def kernel_calls(self, monkeypatch):
        """Route stencil_step's kernel branch to the interpreter and count
        the calls."""
        from admm_deconv.ops import stencil_triton

        calls = []

        def fake(x, ux, uy, tau, mode="aniso"):
            calls.append(mode)
            return self._kernel(x, ux, uy, tau, mode=mode)

        monkeypatch.setattr(stencil_triton, "stencil_step_triton", fake)
        return calls

    def test_policy_selects_kernel(self, rng, kernel_calls):
        from admm_deconv.ops.policy import overrides

        shape = (2, 16, 24)
        x, ux, uy = _mk(rng, shape), _mk(rng, shape, 0.1), _mk(rng, shape, 0.1)
        want = stencil_step(x, ux, uy, 0.2, "iso")
        assert kernel_calls == []
        with overrides(stencil_kernel=True):
            got = stencil_step(x, ux, uy, 0.2, "iso")
        assert kernel_calls == ["iso"]
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)

    @pytest.mark.parametrize("case", ["halo", "callable"])
    def test_kernel_only_for_circular_named_prox(self, rng, kernel_calls, case):
        from admm_deconv.ops.policy import overrides

        shape = (2, 16, 24)
        x, ux, uy = _mk(rng, shape), _mk(rng, shape, 0.1), _mk(rng, shape, 0.1)
        halo = tuple(a[:, :1] for a in (x, x, ux, uy)) if case == "halo" else None
        prox = prox_lib.soft if case == "callable" else "aniso"
        with overrides(stencil_kernel=True):
            stencil_step(x, ux, uy, 0.2, prox, halo)
        assert kernel_calls == []

    def test_solver_runs_the_kernel(self, rng, kernel_calls):
        from admm_deconv.ops.policy import overrides

        y = jnp.asarray(rng.random((1, 24, 40, 2)), F32)
        want = tv_deconvolve(y, None, lam=0.02, rho=0.3, iters=6)
        jax.clear_caches()
        with overrides(stencil_kernel=True):
            got = tv_deconvolve(y, None, lam=0.02, rho=0.3, iters=6)
        jax.clear_caches()
        assert kernel_calls
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


@pytest.mark.gpu
def test_compiled_stencil_on_gpu(gpu_device, rng):
    """The stencil as XLA compiles it for the card, against the numpy twin
    (run on a machine with a GPU; chip_smoke.py covers full widths)."""
    shape = (2, 64, 96)
    x, ux, uy = (jax.device_put(_mk(rng, shape), gpu_device) for _ in range(3))
    got = jax.jit(lambda *a: stencil_step(*a, 0.2, "iso"))(x, ux, uy)
    for i in range(shape[0]):
        want = twin.admm_stencil(
            *(np.asarray(a[i], np.float64) for a in (x, ux, uy)), 0.2, "iso"
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g[i]), w, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_compiled_kernel_on_gpu(gpu_device, rng, mode):
    """The Triton kernel as compiled for the card, against the jnp stencil
    compiled for the same card."""
    from admm_deconv.ops.stencil import _jnp_stencil_step

    shape = (3, 100, 300)
    x, ux, uy = (jax.device_put(_mk(rng, shape), gpu_device) for _ in range(3))
    tau = jax.device_put(jnp.asarray(_tau(rng, "vector", 3), F32), gpu_device)
    got = jax.jit(lambda *a: stencil_step_triton(*a, mode))(x, ux, uy, tau)
    want = jax.jit(lambda *a: _jnp_stencil_step(*a, mode))(x, ux, uy, tau)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-6)
