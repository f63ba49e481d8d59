"""Persistent XLA compile cache, shared by every entry point.

Compiling a solver chunk takes seconds to minutes; the persistent cache lets
a later process (the next test worker, the next bench run) reuse it. Every
entry point calls `enable_compile_cache()` once before its first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache, derived from this package's own location: a fixed
# path, so every process of one checkout finds the same cache
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache(min_compile_secs=0.5):
    """Turn the persistent compile cache on and return its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX has already read it and
    the setting is left alone; otherwise the cache lives at
    `CHECKOUT_CACHE_DIR`. Programs that compile faster than
    `min_compile_secs` are not written."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return jax.config.jax_compilation_cache_dir
