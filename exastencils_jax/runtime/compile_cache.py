"""JAX persistent compilation cache at a fixed place.

A cold run on the card compiles every V-cycle level and every staged DSL
run from scratch; the persistent cache lets later processes skip that.
The cache path is part of what makes an entry findable again, so it is
fixed: `$JAX_COMPILATION_CACHE_DIR` when that is set (JAX reads it
itself), otherwise `<checkout>/.jax_cache`, which `.gitignore` lists.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str:
    """The directory the cache lives in for this environment."""
    return environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()
    and return that directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
