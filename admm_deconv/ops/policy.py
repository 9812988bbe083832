"""Auto-mode policy: every constant behind "auto", keyed by backend.

The solvers' ``"auto"`` resolution (``fft_mode``, the loop-carry dtype,
``solve_auto``'s configuration) reads one :class:`AutoPolicy` entry per JAX
backend (``jax.default_backend()``).  There is a ``"cpu"`` entry and a
``"gpu"`` entry; any other backend raises, because no constant here was
measured on it.  ``PERF.md`` records the measurement behind each ``"gpu"``
value, with the card's name and power limit, or says that it was not
measured yet.

Override surface, applied on top of the backend's entry:

* environment: ``ADMM_<FIELD>=value`` (read at import and on
  :func:`refresh`), e.g. ``ADMM_DEEP_EPS_ABS=1e-5`` or
  ``ADMM_FFT_MODE=fold``.
* runtime: :func:`set_policy` (``set_policy(deep_eps_abs=1e-5)``), or the
  :func:`overrides` context manager for scoped tuning and tests.

The solvers read the policy while they are traced, so an override reaches
a jitted solver already traced with the same arguments only after
``jax.clear_caches()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import jax


@dataclasses.dataclass(frozen=True)
class AutoPolicy:
    """Constants behind every ``"auto"`` decision on one backend."""

    # fft_mode of the fixed-iteration solvers.
    fft_mode: str

    # fft_mode for loops that cannot carry fold1's delta form safely
    # (Anderson, the tiled adaptive solver, short check blocks, deep
    # tolerances).
    fft_mode_adaptive: str

    # Minimum check_every at which the adaptive solver's "auto" keeps
    # ``fft_mode`` instead of ``fft_mode_adaptive`` (fold1's per-block x_B
    # re-hoist must amortize over the block).
    adaptive_fold1_min_check_every: int

    # eps_abs below which the adaptive solvers take ``fft_mode_adaptive``
    # and solve_auto keeps a float32 carry.
    deep_eps_abs: float

    # Whether solve_auto stores the loop carry in bfloat16.
    bf16_state: bool

    # Run the per-solve precompute transforms as DFT-by-matmul
    # (``ops/fft_mxu.py``) instead of the native FFT.
    precompute_fft_mxu: bool

    # solve_auto's residual-check block length.
    solve_auto_check_every: int

    # Run the circular stencil section as the hand-written Pallas-Triton
    # kernel (ops/stencil_triton.py) instead of XLA's fusion of the jnp
    # expression.
    stencil_kernel: bool


_TABLE = {
    # XLA's CPU FFT is exact and the DFT-by-matmul modes only add FLOPs.
    "cpu": AutoPolicy(
        fft_mode="xla",
        fft_mode_adaptive="xla",
        adaptive_fold1_min_check_every=4,
        deep_eps_abs=1e-4,
        bf16_state=False,
        precompute_fft_mxu=False,
        solve_auto_check_every=8,
        stencil_kernel=False,
    ),
    # NVIDIA H100: see PERF.md, "Auto policy on the H100".
    "gpu": AutoPolicy(
        # Measured: cuFFT ("xla") against "fold1" and "fold".
        fft_mode="xla",
        fft_mode_adaptive="xla",
        # Only read when fft_mode is overridden to fold1; not yet measured
        # on the H100.
        adaptive_fold1_min_check_every=4,
        # Not yet measured on the H100.
        deep_eps_abs=1e-4,
        # Measured: bfloat16 against float32 carry.
        bf16_state=False,
        # Measured: follows fft_mode (the native FFT is cuFFT).
        precompute_fft_mxu=False,
        # Not yet measured on the H100.
        solve_auto_check_every=8,
        # Measured: the Triton kernel against XLA's fusion, end to end.
        stencil_kernel=True,
    ),
}

_FIELDS = {f.name: f for f in dataclasses.fields(AutoPolicy)}


def _parse(name: str, raw: str):
    kind = _FIELDS[name].type
    if kind in ("int", int):
        return int(raw)
    if kind in ("float", float):
        return float(raw)
    if kind in ("bool", bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return raw


def _from_env() -> dict:
    return {
        name: _parse(name, os.environ[f"ADMM_{name.upper()}"])
        for name in _FIELDS
        if f"ADMM_{name.upper()}" in os.environ
    }


_overrides = _from_env()


def policy(backend: str | None = None) -> AutoPolicy:
    """The active policy for ``backend`` (default: JAX's default backend),
    with environment and runtime overrides applied.  Raises for a backend
    that has no entry."""
    backend = backend or jax.default_backend()
    if backend not in _TABLE:
        raise ValueError(
            f"no auto policy for backend {backend!r}; known: {sorted(_TABLE)}"
        )
    return dataclasses.replace(_TABLE[backend], **_overrides)


def refresh() -> None:
    """Re-read ``ADMM_*`` environment overrides (drops set_policy)."""
    global _overrides
    _overrides = _from_env()


def set_policy(**kwargs) -> None:
    """Override policy fields at runtime, on every backend.  Unknown
    fields raise."""
    global _overrides
    unknown = set(kwargs) - set(_FIELDS)
    if unknown:
        raise ValueError(f"unknown policy fields: {sorted(unknown)}")
    _overrides = {**_overrides, **kwargs}


@contextlib.contextmanager
def overrides(**kwargs):
    """Scoped policy override (tests, A/B tuning)."""
    global _overrides
    prev = _overrides
    try:
        set_policy(**kwargs)
        yield policy()
    finally:
        _overrides = prev
