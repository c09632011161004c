"""JAX's persistent compilation cache, at one fixed place.

A cold process spends seconds compiling each solver program; the
persistent cache lets the next process load them instead.  JAX keys the
cache by directory, so the directory must not move between runs:

  * where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
    module sets nothing;
  * otherwise the cache goes to `.jax_cache/` at the root of the checkout
    (listed in `.gitignore`).
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`; returns
    that directory."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
