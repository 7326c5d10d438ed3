"""Where the persistent XLA compile cache lives.

`JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it itself and no
code here sets another directory.  Otherwise the cache goes to the fixed
`<repo>/.jax_cache` — a fixed path, since the path is part of what a later
process must find again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses in this environment."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def configure_compile_cache() -> str:
    """Turn on the persistent compile cache (before the first compile) for
    every program that takes over half a second to compile; returns its
    directory."""
    import jax
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir()
