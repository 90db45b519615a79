"""Persistent compilation cache shared by the entry points (the CLI,
``bench.py`` and ``chip_smoke.py``).

The telemetry step and the FEC decoder fold large constant tables into
their programs, so compiling them takes many seconds; a persistent cache
lets every later process reuse the executables. The cache directory is
part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def init_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives at the fixed
    ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
