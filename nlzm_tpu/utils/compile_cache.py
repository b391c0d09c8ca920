"""One location for JAX's persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it itself and this
module sets nothing. Otherwise the cache lives at the fixed in-checkout
path `<repo>/.build/jaxcache`, so that every entry point (CLI, bench,
chip smoke run) shares it and a repeat run finds its compiled programs
(the directory is part of the cache key; one that moves never hits).
"""

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".build" / "jaxcache"


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir().

    Call before the first compilation; JAX settles the cache location
    at its first compile. Returns the directory in use."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
