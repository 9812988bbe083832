"""Differentiable unrolled-ADMM deconvolution layer.

The reference defines four near-identical mutable structs
(``ADMMDeconv``/``F1``/``F2``/``F3``, ``src/layers/deconv_admm.jl:6-209``)
that differ only in which of {weight (PSF), bias, lam, rho} are trainable.
Here that collapses to **one** flax module with a ``trainable`` mask:
non-trainable parameters are still stored in the variable tree but get
``stop_gradient`` applied in the forward pass, so optimizer updates cancel.

Feasibility handling: the reference *mutates the layer struct at forward
time* (clamping lam/rho/weight in place, ``deconv_admm.jl:216-219`` — a
Zygote-unfriendly trick).  Here the clamps are pure projections applied
inside the forward pass; stored parameters are untouched and gradients flow
through the clamp's subgradient.

Forward contract (``deconv_admm.jl:215-225``): clamp lam/rho to
``[creg, inf)`` and the PSF weight to ``[0, 1]``, run the unrolled solver,
add bias, apply the activation.  Gradients flow through the ``lax.scan``
unrolled iterations (optionally rematerialized), replacing Zygote
reverse-mode through a Julia loop.
"""

from __future__ import annotations

from typing import Callable, Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

from admm_deconv.ops.solver import tv_deconvolve

# Guard against rho -> 0 (tau = lam/rho and C = 1/(...rho...) both blow up;
# the reference has the same hazard unguarded when creg == 0).
_RHO_FLOOR = 1e-8


def _glorot_scalar_init(key, shape, dtype=jnp.float32):
    """|glorot_uniform| on a length-1 vector, as the reference initializes
    lam/rho (``deconv_admm.jl:50,101,203-204``): fan_in = fan_out = 1 gives
    limit sqrt(6/2) = sqrt(3); abs folds to [0, sqrt(3))."""
    limit = jnp.sqrt(3.0)
    return jnp.abs(jax.random.uniform(key, shape, dtype, -limit, limit))


class ADMMDeconv(nn.Module):
    """Unrolled ADMM TV-deconvolution as a trainable layer.

    Attributes:
      kernel_shape: PSF shape ``(kh, kw)``, or ``()`` for kernel-less pure
        TV denoising (reference empty-weight mode, ``deconv_admm.jl:198-202``).
      iters: number of unrolled ADMM iterations.
      activation: output nonlinearity (reference ``sigma``).
      iso: isotropic TV (block prox) vs anisotropic (soft prox).
      use_bias: add a scalar bias (reference ``Flux.create_bias(w, bias, 1)``).
      creg: feasibility clamp floor for lam/rho.
      lam_init / rho_init: fixed initial values; ``None`` -> random
        |glorot| init as the reference does for its trainable variants.
      trainable: subset of {"weight", "bias", "lam", "rho"} receiving
        gradients; the rest are stop-gradient'ed (frozen).
      remat: rematerialize the unrolled loop under autodiff.
      fft_mode: x-update FFT backend ("auto" | "xla" | "mxu" |
        "mxu_precise" | "fold" | "fold1" | "fold_precise" | "pack" |
        "pack_precise"); "auto" (default) takes the backend's policy entry
        (``ops.solver.resolve_fft_mode``).
      state_dtype: optional bf16 STORAGE for the solver's loop carry
        (``tv_deconvolve``'s ``state_dtype``).  Trainable: the stencil's
        arithmetic stays fp32, and gradient rounding is the same order as
        the forward's.
      diff_mode: "unroll" backpropagates through the ``lax.scan`` iterations
        (exact gradient of the truncated solver; required for trainable rho);
        "implicit" differentiates the converged fixed point with the
        implicit function theorem at O(1) memory
        (:func:`admm_deconv.ops.implicit.tv_deconvolve_implicit`).
      bwd_iters: Neumann-adjoint depth for ``diff_mode="implicit"``.
    """

    kernel_shape: Sequence[int] = ()
    iters: int = 50
    activation: Callable = lambda x: x
    iso: bool = False
    use_bias: bool = False
    creg: float = 0.0
    lam_init: float | None = None
    rho_init: float | None = None
    trainable: Sequence[str] = ("weight", "bias", "lam", "rho")
    remat: bool = False
    fft_mode: str = "auto"
    state_dtype: str | None = None
    diff_mode: str = "unroll"
    bwd_iters: int = 30

    def _maybe_stop(self, name: str, value: jnp.ndarray) -> jnp.ndarray:
        if name in self.trainable:
            return value
        return jax.lax.stop_gradient(value)

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.lam_init is None:
            lam = self.param("lam", _glorot_scalar_init, (1,))
        else:
            lam = self.param(
                "lam", lambda k, s: jnp.full(s, self.lam_init, jnp.float32), (1,)
            )
        if self.rho_init is None:
            rho = self.param("rho", _glorot_scalar_init, (1,))
        else:
            rho = self.param(
                "rho", lambda k, s: jnp.full(s, self.rho_init, jnp.float32), (1,)
            )
        lam = self._maybe_stop("lam", lam)
        rho = self._maybe_stop("rho", rho)

        psf = None
        if len(self.kernel_shape) == 2:
            # Reference: Flux.convfilter(k, 1=>1) with glorot init
            # (deconv_admm.jl:201), clamped to [0,1] at forward time.
            psf = self.param(
                "weight",
                nn.initializers.glorot_uniform(in_axis=-2, out_axis=-1),
                (*self.kernel_shape, 1, 1),
            )
            psf = self._maybe_stop("weight", psf)
            psf = jnp.clip(psf[..., 0, 0], 0.0, 1.0)
        elif len(self.kernel_shape) != 0:
            raise ValueError(f"kernel_shape must be () or (kh, kw), got {self.kernel_shape}")

        # Feasibility projections (pure; reference mutates the struct).
        lam = jnp.clip(lam, self.creg, None)[0]
        rho = jnp.maximum(jnp.clip(rho, self.creg, None), _RHO_FLOOR)[0]

        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if self.diff_mode == "implicit":
            from admm_deconv.ops.implicit import tv_deconvolve_implicit

            out = tv_deconvolve_implicit(
                x,
                psf=psf,
                lam=lam,
                rho=rho,
                iters=self.iters,
                prox="iso" if self.iso else "aniso",
                bwd_iters=self.bwd_iters,
                fft_mode=self.fft_mode,
            )
        elif self.diff_mode == "unroll":
            out = tv_deconvolve(
                x,
                psf=psf,
                lam=lam,
                rho=rho,
                iters=self.iters,
                prox="iso" if self.iso else "aniso",
                remat=self.remat,
                fft_mode=self.fft_mode,
                state_dtype=self.state_dtype,
            )
        else:
            raise ValueError(
                f"diff_mode must be 'unroll' or 'implicit', got {self.diff_mode!r}"
            )

        if self.use_bias:
            bias = self._maybe_stop("bias", self.param("bias", nn.initializers.zeros, (1,)))
            out = out + bias[0]
        out = self.activation(out)
        return out[0] if squeeze else out


def ADMMDeconvF1(
    kernel_shape: Sequence[int],
    iters: int,
    lam: float,
    activation: Callable = lambda x: x,
    *,
    iso: bool = False,
    use_bias: bool = False,
    creg: float = 0.0,
    remat: bool = False,
    fft_mode: str = "auto",
    state_dtype: str | None = None,
) -> ADMMDeconv:
    """Fixed lam; trainable weight/bias/rho (reference ``deconv_admm.jl:31-55``)."""
    if lam <= 0:
        raise ValueError("Parameter lam must be greater than 0")
    return ADMMDeconv(
        kernel_shape=tuple(kernel_shape),
        iters=iters,
        activation=activation,
        iso=iso,
        use_bias=use_bias,
        creg=creg,
        lam_init=lam,
        rho_init=None,
        trainable=("weight", "bias", "rho"),
        remat=remat,
        fft_mode=fft_mode,
        state_dtype=state_dtype,
    )


def ADMMDeconvF2(
    kernel_shape: Sequence[int],
    iters: int,
    rho: float,
    activation: Callable = lambda x: x,
    *,
    iso: bool = False,
    use_bias: bool = False,
    creg: float = 0.0,
    remat: bool = False,
    fft_mode: str = "auto",
    state_dtype: str | None = None,
) -> ADMMDeconv:
    """Fixed rho; trainable weight/bias/lam (reference ``deconv_admm.jl:83-107``)."""
    if rho <= 0:
        raise ValueError("Parameter rho must be greater than 0")
    return ADMMDeconv(
        kernel_shape=tuple(kernel_shape),
        iters=iters,
        activation=activation,
        iso=iso,
        use_bias=use_bias,
        creg=creg,
        lam_init=None,
        rho_init=rho,
        trainable=("weight", "bias", "lam"),
        remat=remat,
        fft_mode=fft_mode,
        state_dtype=state_dtype,
    )


def ADMMDeconvF3(
    kernel_shape: Sequence[int],
    iters: int,
    lam: float,
    rho: float,
    activation: Callable = lambda x: x,
    *,
    iso: bool = False,
    use_bias: bool = False,
    creg: float = 0.0,
    remat: bool = False,
    fft_mode: str = "auto",
    state_dtype: str | None = None,
) -> ADMMDeconv:
    """Fixed lam and rho; trainable weight/bias only (``deconv_admm.jl:135-161``)."""
    if lam <= 0:
        raise ValueError("Parameter lam must be greater than 0")
    if rho <= 0:
        raise ValueError("Parameter rho must be greater than 0")
    return ADMMDeconv(
        kernel_shape=tuple(kernel_shape),
        iters=iters,
        activation=activation,
        iso=iso,
        use_bias=use_bias,
        creg=creg,
        lam_init=lam,
        rho_init=rho,
        trainable=("weight", "bias"),
        remat=remat,
        fft_mode=fft_mode,
        state_dtype=state_dtype,
    )
