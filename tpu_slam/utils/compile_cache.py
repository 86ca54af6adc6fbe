"""Persistent XLA compilation cache location.

Entry points (``chip_smoke.py``, ``bench.py``, the CLI mains) call
``enable_compile_cache()`` before their first compile. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this helper
sets nothing. Otherwise the cache goes to ``<repo>/.jax_cache``, a fixed
path (the cache key includes it, so a moving directory never hits),
listed in ``.gitignore``.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
