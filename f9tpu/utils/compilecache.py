"""Persistent XLA compilation cache, shared by every entry point (CLI,
bench.py, chip_smoke.py, tools/hw_soak.py).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at one fixed path inside the
checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part
of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

__all__ = ["default_cache_dir", "enable_compile_cache"]


def default_cache_dir() -> str:
    """The fixed in-checkout cache directory used when the environment names
    none."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)), ".jax_cache")


def enable_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", default_cache_dir())
