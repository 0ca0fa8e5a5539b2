"""Host runtime helpers: where compiled programs are cached.

`configure_compile_cache()` gives every entry point (examples, benchmarks,
tests, chip_smoke.py) one persistent XLA compilation cache. If
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is
changed. Otherwise the cache is `<checkout>/.jax_cache`: a fixed path,
because the path is part of the cache key, so a directory that moves
never hits. Call it before the first compilation.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> str:
    """Enable the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
