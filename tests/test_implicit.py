"""Implicit-function-theorem differentiation of the ADMM fixed point
(``ops/implicit.py``) — a capability beyond the reference's unrolled-only
Zygote path (``src/layers/deconv_admm.jl:221``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_deconv.layers import ADMMDeconv
from admm_deconv.ops.implicit import tv_deconvolve_implicit
from admm_deconv.ops.solver import tv_deconvolve


@pytest.fixture
def problem(rng):
    y = jnp.asarray(rng.random((1, 32, 32, 1)), jnp.float32)
    psf = np.zeros((5, 5), np.float32)
    psf[2, :] = 1 / 5
    return y, jnp.asarray(psf)


def test_forward_matches_unrolled(problem):
    y, psf = problem
    xa = tv_deconvolve_implicit(y, psf=psf, lam=0.005, rho=0.05, iters=60)
    xb = tv_deconvolve(y, psf=psf, lam=0.005, rho=0.05, iters=60)
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xb), atol=1e-6)


def test_gradients_match_unrolled_at_convergence(problem):
    """With a well-converged forward and deep Neumann adjoint, the implicit
    lam/y/psf gradients approach the unrolled ones (few-% relative)."""
    y, psf = problem
    kw = dict(psf=psf, rho=0.05, iters=400)

    def loss_impl(lam, yy):
        return jnp.sum(
            tv_deconvolve_implicit(yy, lam=lam, bwd_iters=200, **kw) ** 2
        )

    def loss_unrl(lam, yy):
        return jnp.sum(tv_deconvolve(yy, lam=lam, **kw) ** 2)

    gl_i, gy_i = jax.grad(loss_impl, argnums=(0, 1))(jnp.float32(0.005), y)
    gl_u, gy_u = jax.grad(loss_unrl, argnums=(0, 1))(jnp.float32(0.005), y)
    assert abs(float(gl_i - gl_u)) / (abs(float(gl_u)) + 1e-12) < 0.05
    rel = float(jnp.max(jnp.abs(gy_i - gy_u)) / (jnp.max(jnp.abs(gy_u)) + 1e-12))
    assert rel < 0.10

    gp_i = jax.grad(
        lambda p: jnp.sum(
            tv_deconvolve_implicit(
                y, psf=p, lam=0.005, rho=0.05, iters=400, bwd_iters=200
            )
            ** 2
        )
    )(psf)
    gp_u = jax.grad(
        lambda p: jnp.sum(
            tv_deconvolve(y, psf=p, lam=0.005, rho=0.05, iters=400) ** 2
        )
    )(psf)
    rel = float(jnp.max(jnp.abs(gp_i - gp_u)) / (jnp.max(jnp.abs(gp_u)) + 1e-12))
    assert rel < 0.10


def test_rho_gradient_vanishes_at_fixed_point(problem):
    """At the exact fixed point the solution is independent of rho (any
    rho > 0 converges to the same minimizer), so the implicit rho gradient
    must be much smaller than the unrolled finite-iteration sensitivity."""
    y, psf = problem

    def loss(solver, rho):
        return jnp.sum(
            solver(y, psf=psf, lam=0.005, rho=rho, iters=400) ** 2
        )

    gr_i = float(
        jax.grad(
            lambda r: jnp.sum(
                tv_deconvolve_implicit(
                    y, psf=psf, lam=0.005, rho=r, iters=400, bwd_iters=200
                )
                ** 2
            )
        )(jnp.float32(0.05))
    )
    gr_u = float(
        jax.grad(lambda r: loss(tv_deconvolve, r))(jnp.float32(0.05))
    )
    assert abs(gr_i) < 0.5 * abs(gr_u)


def test_denoise_mode_differentiable(problem):
    y, _ = problem
    g = jax.grad(
        lambda l: jnp.sum(
            tv_deconvolve_implicit(y, psf=None, lam=l, rho=0.05, iters=100) ** 2
        )
    )(jnp.float32(0.01))
    assert np.isfinite(float(g))
    assert float(g) != 0.0


def test_layer_implicit_mode(problem):
    y, _ = problem
    layer = ADMMDeconv(
        kernel_shape=(3, 3), iters=20, diff_mode="implicit", bwd_iters=10,
        lam_init=0.01, rho_init=0.1,
    )
    params = layer.init(jax.random.PRNGKey(0), y)

    def loss(p):
        return jnp.mean((layer.apply(p, y) - y) ** 2)

    val, grads = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(val))
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in leaves)
    # weight/lam receive gradient signal
    flat = {
        "/".join(map(str, k)): v
        for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]
    }
    assert any("weight" in k and float(jnp.max(jnp.abs(v))) > 0 for k, v in flat.items())


class TestImplicitFold1:
    def test_fold1_backward_matches_xla(self, rng):
        """Round-3 regression: the implicit backward's _step must build the
        fold1 DELTA-form precompute (x_B + folded rho*C) — the plain c_spec
        silently mis-solved before.  fp32 on CPU -> gradients must agree."""
        from admm_deconv.ops.implicit import tv_deconvolve_implicit

        img = np.clip(
            rng.random((16, 16)).astype(np.float32) * 0.5 + 0.2, 0, 1
        )
        y = jnp.asarray(img)

        def loss(lam, mode):
            x = tv_deconvolve_implicit(
                y, None, lam=lam, rho=0.5, iters=40, fft_mode=mode
            )
            return jnp.sum(x * x)

        g_xla = jax.grad(lambda l: loss(l, "xla"))(0.05)
        g_f1 = jax.grad(lambda l: loss(l, "fold1"))(0.05)
        np.testing.assert_allclose(float(g_f1), float(g_xla), rtol=1e-4)
