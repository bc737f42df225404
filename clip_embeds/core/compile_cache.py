"""Persistent XLA compilation cache.

A cold compile of a 7B trunk or a ViT-L train step takes minutes; JAX's
persistent cache keeps compiled executables on disk across processes. Every
entry point (bench.py, chip_smoke.py, the CLIs through create_model) calls
:func:`enable_persistent_cache`, which picks the directory by one rule:

* ``JAX_COMPILATION_CACHE_DIR`` set: that directory, and nothing else.
* otherwise: the fixed ``<checkout>/.jax_cache``. The path is part of what a
  later process looks up, so it never moves.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`enable_persistent_cache` uses."""
    return os.environ.get(CACHE_ENV) or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
