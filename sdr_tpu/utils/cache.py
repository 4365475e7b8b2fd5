"""Persistent XLA compilation cache location."""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache"]

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory and
    return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    this function changes nothing.  Otherwise the cache is
    ``<repo>/.jax_cache`` (listed in ``.gitignore``) - a fixed path, since
    the directory is part of what a later process looks the cache up by.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
