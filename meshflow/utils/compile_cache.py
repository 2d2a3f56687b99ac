"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (cli.py, chip_smoke.py, bench.py, the
tests): when JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
nothing here overrides it; otherwise the cache lives at one fixed path
inside the checkout, so every process of this checkout finds what the
others compiled.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
