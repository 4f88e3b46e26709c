"""Where the persistent JAX compile cache lives for this repo's scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and wins:
no code here sets another directory.  When it is not set, the scripts
(chip_smoke.py, bench.py, tools/*) share one fixed directory inside the
checkout, ``<repo>/.jax_cache`` — a fixed path, because the path is part
of the cache key.  The library itself never configures a cache.
"""

from __future__ import annotations

import os
import pathlib

__all__ = ["configure_compile_cache", "REPO_ROOT"]

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def configure_compile_cache() -> str:
    """Apply the cache rule; returns the directory in effect."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
