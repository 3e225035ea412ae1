"""Where the repository's scripts keep JAX's persistent compilation cache."""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable() -> str:
    """Turn the persistent compilation cache on and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here; otherwise the cache lives at ``<repo>/.jax_cache``
    (a fixed path: the path is part of the cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
