"""Persistent XLA compilation cache: the one rule every entry point uses.

`python -m lbmdem.cli`, `bench.py` and `chip_smoke.py` call
`enable_compile_cache()` before their first compile, so a second process
on the same checkout reuses compiled programs (compilation is set-up
time, reported apart from step time).
"""

from __future__ import annotations

import os
import pathlib

# Fixed, in-checkout and listed in .gitignore: the directory is part of
# what makes a cache hit possible, so it is never derived from a
# temporary name, a process id or the time.
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and nothing
    is set here. Otherwise the cache goes to DEFAULT_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
