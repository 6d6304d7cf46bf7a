"""Kernel-vs-reference parity on the GPU at the deployments' real widths.

Each case runs one check of chip_smoke.py's parity phase: the GPU result in
float32 against the plain reference on the CPU device in float64. They skip
without a GPU (see conftest.py)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    return jax.devices()[0]


WIDTHS = sorted(chip_smoke.PARITY_CASES)


@pytest.mark.parametrize("width", WIDTHS)
def test_splat_matches_f64_oracle(gpu, width):
    sensor, n, _ = chip_smoke.PARITY_CASES[width]
    chip_smoke.splat_parity(width, sensor, n, gpu)


@pytest.mark.parametrize("width", WIDTHS)
def test_interp_matches_f64_gather(gpu, width):
    sensor, n, _ = chip_smoke.PARITY_CASES[width]
    chip_smoke.interp_parity(width, sensor, n, gpu)


@pytest.mark.parametrize("width", WIDTHS)
def test_solver_loss_matches_f64_cpu(gpu, width):
    sensor, n, weights = chip_smoke.PARITY_CASES[width]
    chip_smoke.loss_parity(width, sensor, n, gpu, weights)
