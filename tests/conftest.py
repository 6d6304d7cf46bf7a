"""Test configuration.

The suite runs on JAX's CPU backend with exactly 8 virtual devices, so the
multi-device sharding paths run without a GPU (SURVEY.md §4 test strategy).
Both settings must be in place before JAX initializes its backends.

Tests marked `gpu` need an NVIDIA GPU and skip elsewhere. Run them on a GPU
machine with `JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu` (the
CPU backend stays enabled for the float64 references).
"""

import os

# the sharding tests assert 8 devices, so a different pre-existing count
# is replaced, not kept
_flags = [
    f
    for f in os.environ.get("XLA_FLAGS", "").split()
    if "xla_force_host_platform_device_count" not in f
]
_flags.append("--xla_force_host_platform_device_count=8")
os.environ["XLA_FLAGS"] = " ".join(_flags).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

# tests compile many tiny programs in parallel workers: keep them out of
# the persistent compilation cache that the CLI turns on
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's default device is a GPU. Decided
    per test, never at import, so every xdist worker collects the same
    tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX has {jax.devices()[0].platform}")
