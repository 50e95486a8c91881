"""Persistent XLA compilation cache location, shared by every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache lives at ``<checkout>/.jax_cache`` (ignored
by git): a fixed path, because the path is part of what a later process
must find again — never a temp name, a pid or a time.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.  Call before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
