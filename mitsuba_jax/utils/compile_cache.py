"""Persistent XLA compilation cache for the entry points (CLI, render
server, bench.py, chip_smoke.py): a warm cache turns a render's minutes of
compilation into a lookup."""
from __future__ import annotations

import os

import jax

# fixed, gitignored directory inside the checkout; JAX keys cache entries
# by program, and a directory that moves never hits
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    directory is set here; otherwise the cache lives in DEFAULT_DIR."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
