"""Where JAX keeps its persistent compilation cache for this program.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when it is set, nothing is
configured here. Otherwise the cache goes to one fixed directory inside
the checkout (`.jax_cache`, not versioned), so that runs from the same
checkout find each other's compiled programs.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
