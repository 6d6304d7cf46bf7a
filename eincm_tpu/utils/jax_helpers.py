"""JAX runtime configuration helpers.

Reference: src/experiments/e00/jax_helpers.py:5-23 (`update_jax_config`,
`print_jax_info`, `delete_on_device_buffers`) plus the numerical-debug mode
from configs/jax_config/debug.yaml (jax_debug_nans / jax_debug_infs /
unfiltered tracebacks — SURVEY.md §5 "race detection" analogue).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import jax

# <checkout>/.jax_cache: a fixed path, because the path is part of the
# cache key (a cache that moves never hits); git-ignored
DEFAULT_COMPILATION_CACHE_DIR = str(
    Path(__file__).resolve().parents[2] / ".jax_cache"
)


def enable_compilation_cache(path: Optional[str] = None) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins: no
    other path is set in code then. Otherwise the cache goes to `path`, or
    to <checkout>/.jax_cache when `path` is None.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = path or DEFAULT_COMPILATION_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def update_jax_config(options: Dict) -> None:
    """Apply {flag: value} pairs to jax.config (e.g. {'jax_debug_nans': True})."""
    for key, value in options.items():
        jax.config.update(key, value)


def enable_debug_mode() -> None:
    """NaN/Inf checking + full tracebacks (configs/jax_config/debug.yaml)."""
    update_jax_config(
        {
            "jax_debug_nans": True,
            "jax_debug_infs": True,
            "jax_traceback_filtering": "off",
        }
    )


def disable_debug_mode() -> None:
    update_jax_config(
        {
            "jax_debug_nans": False,
            "jax_debug_infs": False,
            "jax_traceback_filtering": "auto",
        }
    )


def print_jax_info() -> str:
    info = (
        f"backend={jax.default_backend()} devices={jax.devices()} "
        f"x64={jax.config.jax_enable_x64}"
    )
    print(info)
    return info


def delete_on_device_buffers() -> int:
    """Free all live device arrays; returns the count deleted."""
    n = 0
    for arr in jax.live_arrays():
        arr.delete()
        n += 1
    return n
