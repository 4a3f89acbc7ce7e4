"""Persistent compilation cache at a fixed path.

Compiling the render kernels and the replay graph is a large share of a
cold run, so every entry point (rt.cli, rt.viewer, bench.py,
tools/bench_configs.py, chip_smoke.py) keeps JAX's persistent cache:

- if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
  helper sets nothing;
- otherwise the cache lives at ``<checkout>/.jax_cache`` — one fixed path
  (no temporary name, pid or time), because the path is part of what makes
  a later run find the entries again.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    # cache every executable, not only those that took >= 1 s to compile
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return str(DEFAULT_DIR)
