"""Where JAX keeps its persistent compilation cache.

Every entry point (the CLI, bench.py, chip_smoke.py, the tests) calls
`enable()` before its first compile. It honours JAX_COMPILATION_CACHE_DIR
when that is set and otherwise uses one fixed directory inside the
checkout, `.jax_cache/` (listed in .gitignore): the path is part of the
cache's key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`, caching
    every compile that takes a second or more; returns the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
