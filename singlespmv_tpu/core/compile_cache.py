"""Persistent XLA compile cache: one fixed location per checkout.

``setup()`` is called by the entry points (``bench.py``, the CLI,
``chip_smoke.py``) before anything compiles.  If ``JAX_COMPILATION_CACHE_DIR``
is set, JAX already uses that directory and nothing else is configured;
otherwise the cache goes to ``<repo>/.jax_cache``.  A fixed path matters: the
cache directory is part of the key, so a path that moves never hits.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def setup() -> str:
    """Enable the persistent compile cache; returns its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
