"""Persistent XLA compilation cache, placed from outside.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself. When it is set, this module
sets no other directory; when it is not, the cache goes to
``<repo>/.jax_cache`` (listed in ``.gitignore``). The path is part of the
cache key, so it is fixed rather than per-run.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Call before the first compilation."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
