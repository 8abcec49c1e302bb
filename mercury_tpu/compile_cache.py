"""Persistent XLA compilation cache for the program's entry points.

Each mode's receive program takes tens of seconds to compile, and a gateway
that gearshifts compiles several of them. The cache keeps compiled programs
across processes. JAX keys cache entries by the cache path among other
things, so the default location is a fixed directory inside the checkout
(listed in .gitignore), never a temporary or per-process name.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads it at start-up and
    nothing is set here. Otherwise the cache goes to CHECKOUT_CACHE_DIR.
    Called by the command-line entry points, not at package import."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
