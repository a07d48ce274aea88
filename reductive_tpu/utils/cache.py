"""Persistent compilation cache for the entry scripts.

Compiling the kernels and the jitted steps takes seconds to minutes on a
cold process; JAX's persistent cache keeps the compiled programs (and
XLA's autotuning choices) between processes.  The cache key includes the
directory, so the directory must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache"]

_REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing else is set here.  Otherwise the cache lives at the fixed
    path ``<repo>/.jax_cache`` (listed in ``.gitignore``).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(_REPO_CACHE))
    return str(_REPO_CACHE)
