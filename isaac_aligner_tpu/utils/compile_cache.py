"""Where JAX keeps its persistent compilation cache.

The cache is keyed by path, so it lives at one fixed place: the directory
`JAX_COMPILATION_CACHE_DIR` names when it is set (JAX reads that variable
itself), otherwise `.jax_cache` at the root of the checkout (listed in
.gitignore).  Every entry point calls `enable_compile_cache()` before its
first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX at the persistent cache directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
