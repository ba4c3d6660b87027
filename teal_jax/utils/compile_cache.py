"""Persistent XLA compilation cache at a fixed place.

A compiled 7B decode program takes tens of seconds to build; the cache
lets the second process that needs it load it instead. Its directory is
part of the cache key, so it must not move between runs: either the one
`JAX_COMPILATION_CACHE_DIR` names (JAX reads that variable itself, and
nothing here overrides it) or `<checkout>/.jax_cache` (listed in
.gitignore).
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory
    and return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
