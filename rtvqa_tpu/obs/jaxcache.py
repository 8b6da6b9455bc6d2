"""Persistent XLA compilation cache.

Compiling the chunk programs at full resolution takes tens of seconds; with
JAX's persistent cache every later process reuses the compiled executables —
the CLI runs one process per clip.

Placement: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself;
nothing is set in code), otherwise a fixed directory inside the checkout,
``<repo>/.jax_cache``. A fixed path matters: the path is part of what the
cache keys on, so a directory that moves never hits.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent compilation cache lives in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_persistent_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
