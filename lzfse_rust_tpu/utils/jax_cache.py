"""Persistent JAX compilation cache location, set in one place.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing is changed
here. Otherwise the cache lives in the checkout's .jax_cache/ (gitignored),
a fixed path so that later processes on the same checkout hit it.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def enable() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir",
                      str(CHECKOUT / ".jax_cache"))
