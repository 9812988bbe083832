"""Model zoo: the reference's restoration-network assemblies, re-built in flax.

Capability parity with ``src/nets/net_build.jl``:

* :class:`Autoencoder` — 6 down blocks (23x23..9x9 kernels) + nested
  up/down residual recursion (``net_build.jl:57-99``).
* :class:`DenoiserBank` — 5 kernel-less ADMM TV denoisers at fixed rho in
  {0.002, 0.02, 0.2, 2, 4}, 50 iters, relu1, concatenated channel-wise
  (``net_build.jl:113-128``; the third ctor arg of ``ADMMDeconvF2`` is rho).
* :class:`AdmmDenoiser` — the flagship model both trainers instantiate
  (``net_build.jl:169-192``): Parallel(autoencoder, denoiser bank) ->
  up/down head -> skip -> up/down head -> relu1.
* :class:`MultistageUpDownscale` — alternative assembly
  (``net_build.jl:131-166``).
* :class:`DeconvBank` — the reference's ``get_deconvs`` (``net_build.jl:
  102-110``), with its bugs fixed: the reference closes over an undefined
  ``mcfg`` and returns only the last layer; here it is a working
  Parallel bank of three ADMMDeconvF3 deconvolvers.
"""

from __future__ import annotations

from typing import Any, Sequence

import flax.linen as nn
import jax.numpy as jnp

from admm_deconv.layers.deconv import ADMMDeconv, ADMMDeconvF2, ADMMDeconvF3
from admm_deconv.models.blocks import (
    Chain,
    DownBlock,
    Parallel,
    SkipConnection,
    UpBlock,
    UpDownBlock,
    UpDownResidualBlock,
    relu1,
    relu6,
)


class Autoencoder(nn.Module):
    """Nested up/down residual conv autoencoder (``net_build.jl:57-99``).

    Structure (kernels 23/21/17/15/11/9, features 3->16->16->32->32->64->64
    down, then up blocks whose inputs grow by the 32-feature residual
    branches): each level wraps the deeper levels in an
    UpDownResidualBlock, so the output concatenates the final up-branch
    (128 features) with a 32-feature residual — 160 channels total.
    """

    @nn.compact
    def __call__(self, x):
        kers = [(23, 23), (21, 21), (17, 17), (15, 15), (11, 11), (9, 9)]
        down_feats = [(3, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64)]
        up_feats = [16, 64, 64, 64, 64, 128]
        pool_down = [(3, 3), (3, 3), (3, 3), (5, 5), (5, 5), (7, 7)]
        pool_up = [(3, 3), (3, 3), (3, 3), (5, 5), (7, 7), (3, 3)]

        down = [
            DownBlock(kers[i], down_feats[i][1], pool_down[i]) for i in range(6)
        ]
        up = [UpBlock(kers[5 - i], up_feats[i], pool_up[i]) for i in range(6)]

        # Innermost residual wraps [down_6, up_1]; each outer level wraps
        # [down_k, inner, up_j] (net_build.jl:85-90).  Residual-branch
        # up-features: 32 throughout; up/down kernels per level:
        res_kers = [(3, 3), (5, 5), (9, 9), (7, 7), (5, 5), (3, 3)]
        inner: Sequence[Any] = [down[5], up[0]]
        block = UpDownResidualBlock(tuple(inner), res_kers[0], res_kers[0], 32, 32)
        for lvl in range(1, 6):
            inner = [down[5 - lvl], block, up[lvl]]
            block = UpDownResidualBlock(
                tuple(inner), res_kers[lvl], res_kers[lvl], 32, 32
            )
        return block(x)


class DenoiserBank(nn.Module):
    """Bank of 5 pure-TV ADMM denoisers at different fixed rho, channel-concat
    (``net_build.jl:113-128``).

    ``fused=True`` (default) runs all 5 branches as ONE batched solve: the
    input is tiled 5x along the batch axis with per-image (lam, rho)
    vectors, so one 50-iteration scan replaces five.  Mathematically
    identical to the per-branch composition (each plane is an independent
    deconvolution; tested), and ~4-5x fewer op launches, which dominate
    at small training shapes.  Matches the reference's
    ``ADMMDeconvF2`` semantics: trainable lam (|glorot| init), fixed rho.
    """

    iso: bool = True
    iters: int = 50
    fused: bool = True
    fft_mode: str = "auto"
    # bf16 loop-carry storage for the bank's solves (round 5: trainable —
    # the mixed-storage kernel carries a custom VJP).
    state_dtype: str | None = None

    RHOS = (0.002, 0.02, 0.2, 2.0, 4.0)

    @nn.compact
    def __call__(self, x):
        if not self.fused:
            outs = [
                ADMMDeconvF2(
                    (), self.iters, rho, relu1, iso=self.iso,
                    fft_mode=self.fft_mode,
                    state_dtype=self.state_dtype,
                )(x)
                for rho in self.RHOS
            ]
            return jnp.concatenate(outs, axis=-1)

        from admm_deconv.layers.deconv import _RHO_FLOOR, _glorot_scalar_init
        from admm_deconv.ops.solver import tv_deconvolve

        n_br = len(self.RHOS)
        lam = self.param("lam", _glorot_scalar_init, (n_br,))
        lam = jnp.clip(lam, 0.0, None)
        rho = jnp.maximum(jnp.asarray(self.RHOS, x.dtype), _RHO_FLOOR)

        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        b = x.shape[0]
        x5 = jnp.concatenate([x] * n_br, axis=0)  # branch-major (5B, H, W, C)
        lam5 = jnp.repeat(lam, b)
        rho5 = jnp.repeat(rho, b)
        out = tv_deconvolve(
            x5,
            psf=None,
            lam=lam5,
            rho=rho5,
            iters=self.iters,
            prox="iso" if self.iso else "aniso",
            fft_mode=self.fft_mode,
            state_dtype=self.state_dtype,
        )
        out = relu1(out)
        h, w, c = out.shape[1:]
        # (5B,H,W,C) -> (B,H,W,5*C), branch-major channel order — identical
        # to concatenating the per-branch outputs.
        out = out.reshape(n_br, b, h, w, c)
        out = jnp.moveaxis(out, 0, 3).reshape(b, h, w, n_br * c)
        return out[0] if squeeze else out


class AdmmDenoiser(nn.Module):
    """The flagship restoration model (``net_build.jl:169-192``).

    Parallel(chcat, autoencoder[160ch], denoiser bank[15ch]) -> 175ch ->
    UpDownBlock(5x5, 175=>32=>32) -> skip-concat input (35ch) ->
    UpDownBlock(5x5, 35=>32=>3) -> relu1.
    """

    iso: bool = True
    denoiser_iters: int = 50
    fft_mode: str = "auto"
    state_dtype: str | None = None

    @nn.compact
    def __call__(self, x):
        auto_denoise = Parallel(
            (
                Autoencoder(),
                DenoiserBank(
                    iso=self.iso, iters=self.denoiser_iters,
                    fft_mode=self.fft_mode,
                    state_dtype=self.state_dtype,
                ),
            )
        )
        core = Chain((auto_denoise, UpDownBlock((5, 5), (5, 5), 32, 32)))
        prefin = SkipConnection(core)
        out = prefin(x)
        out = UpDownBlock((5, 5), (5, 5), 32, 3)(out)
        return relu1(out)


class MultistageUpDownscale(nn.Module):
    """ADMM front-end + multi-stage up/down conv refinement
    (``net_build.jl:131-166``).

    Divergence from the reference (documented): the reference's version is
    dead code and *cannot run* — its up/down kernel pairs (25/9, 19/7, ...)
    grow each block's spatial size by ``uk - dk`` pixels, so the additive
    ``SkipConnection`` at ``net_build.jl:163`` joins mismatched shapes.
    Here each block uses matching kernels (size-preserving), keeping the
    reference's channel structure and skip topology functional.
    """

    iso: bool = True
    fft_mode: str = "auto"

    @nn.compact
    def __call__(self, x):
        admm = ADMMDeconv(
            kernel_shape=(10, 10),
            iters=50,
            activation=lambda v: jnp.maximum(v, 0.0),
            iso=self.iso,
            fft_mode=self.fft_mode,
        )
        ks = [(9, 9), (7, 7), (5, 5), (3, 3)]
        ud1 = UpDownBlock(ks[0], ks[0], 32, 32)
        ud2 = UpDownBlock(ks[1], ks[1], 32, 64)
        ud3 = UpDownBlock(ks[2], ks[2], 64, 64)
        ud4 = UpDownBlock(ks[3], ks[3], 64, 64)
        ud5 = UpDownBlock(ks[3], ks[3], 64, 32)
        ud6 = UpDownBlock(ks[3], ks[3], 32, 32)

        skip_34 = SkipConnection(Chain((ud3, ud4)), merge=lambda a, b: a + b)
        skip_2345 = SkipConnection(Chain((ud2, skip_34, ud5)))
        return Chain((admm, ud1, skip_2345, ud6))(x)


class DeconvBank(nn.Module):
    """Three-scale learned deconvolution bank — the reference's broken
    ``get_deconvs`` (``net_build.jl:102-110``) made functional: the three
    ADMMDeconvF3 layers run in parallel and concat channel-wise."""

    iso: bool = False
    iters: int = 50
    fft_mode: str = "auto"

    @nn.compact
    def __call__(self, x):
        cfgs = [
            ((7, 7), 0.004, 0.02, self.iso),
            ((10, 10), 0.04, 0.04, self.iso),
            ((15, 15), 0.4, 0.06, not self.iso),
        ]
        outs = [
            ADMMDeconvF3(
                k, self.iters, lam, rho, relu6, iso=iso,
                fft_mode=self.fft_mode,
            )(x)
            for (k, lam, rho, iso) in cfgs
        ]
        return jnp.concatenate(outs, axis=-1)


def build_model(name: str, cfg: dict | None = None) -> nn.Module:
    """Config-driven model factory (the reference picks models in its
    trainers; ``use_iso`` is the knob consumed from ``train_cfg.json``)."""
    cfg = cfg or {}
    iso = bool(cfg.get("use_iso", True))
    fft_mode = str(cfg.get("fft_mode", "auto"))
    sdt = cfg.get("state_dtype")
    models = {
        "admm_denoiser": lambda: AdmmDenoiser(iso=iso, fft_mode=fft_mode, state_dtype=sdt),
        "autoencoder": lambda: Autoencoder(),
        "denoiser_bank": lambda: DenoiserBank(iso=iso, fft_mode=fft_mode, state_dtype=sdt),
        "multistage": lambda: MultistageUpDownscale(iso=iso, fft_mode=fft_mode),
        "deconv_bank": lambda: DeconvBank(iso=not iso, fft_mode=fft_mode),
    }
    try:
        return models[name]()
    except KeyError:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(models)}") from None
