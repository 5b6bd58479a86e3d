"""Persistent compilation cache: the one place every entry point sets it.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
changes it. Otherwise the cache lives at one fixed path inside the checkout
(`<checkout>/.jax_cache`, listed in .gitignore): the path is part of what
makes a later run find the entries again.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
