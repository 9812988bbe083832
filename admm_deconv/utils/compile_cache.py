"""Persistent XLA compilation cache.

Compiling a full-width solve takes seconds to minutes; the compile is
deterministic in the HLO, so JAX's persistent compilation cache turns every
later process start into a disk read.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself; nothing else is set in code), otherwise ``.jax_cache/`` at
the root of this checkout — a fixed path, because the path is part of what
makes a later run find the entries.

Usage (before the first jit call)::

    from admm_deconv.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

``bench.py`` and ``scripts/demo_deconv.py`` call this by default; set
``ADMM_NO_COMPILE_CACHE=1`` to opt out (e.g. when measuring true
first-compile latency).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(cache_dir: str | None = None) -> str | None:
    """Turn on JAX's persistent compilation cache and return its directory,
    or None when disabled via ``ADMM_NO_COMPILE_CACHE``.  A set
    ``JAX_COMPILATION_CACHE_DIR`` wins over ``cache_dir``, which defaults
    to :data:`DEFAULT_DIR`."""
    if os.environ.get("ADMM_NO_COMPILE_CACHE", "").strip() in ("1", "true", "yes"):
        return None
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    path = cache_dir or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
