"""Persistent XLA compile cache setup.

The full-pipeline programs take minutes to compile, so every entry point
(CLI, ``chip_smoke.py``, ``bench.py``) calls :func:`enable_compile_cache`
once, before its first compile.  Where ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX already reads it and nothing else is set here; otherwise the
cache lives at the fixed ``.jax_cache/`` of the checkout (a fixed path,
because the directory is part of the cache key).
"""
from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
