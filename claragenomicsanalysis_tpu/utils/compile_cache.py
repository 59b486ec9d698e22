"""The persistent XLA compile cache, placed in one place.

Every entry point (cli.main, chip_smoke.py, bench.py, the test suite and the
scripts) calls enable_compile_cache() before its first compile.  The path is
part of what a cached executable is found by, so it is fixed: the
directory JAX_COMPILATION_CACHE_DIR names when that is set (JAX reads it
itself, and nothing is set here), otherwise <checkout>/.jax_cache, found
from this package's location and listed in .gitignore.
"""

import os

_ENV = "JAX_COMPILATION_CACHE_DIR"


def checkout_cache_dir() -> str:
    """<checkout>/.jax_cache for the checkout this package lives in."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its fixed directory and
    return that directory."""
    if os.environ.get(_ENV):
        return os.environ[_ENV]
    import jax
    path = checkout_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
