"""Direct numeric parity vs the reference implementation (/root/reference).

Runs tests/reference_parity_check.py in a subprocess (it enables x64 and
stubs cv2; neither may leak into this process) and asserts the reported
relative errors. Reference formulas: src/eincm/losses.py:49-276,
src/utils/event_utils.py:13-61. Measured round-2 values are recorded in
PARITY.md.
"""

import json
import os
import subprocess
import sys

import pytest

REF = "/root/reference/src"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference checkout not available"
)


@pytest.fixture(scope="module")
def parity():
    script = os.path.join(os.path.dirname(__file__), "reference_parity_check.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, script],
        capture_output=True,
        text=True,
        env=env,
        timeout=900,
    )
    assert res.returncode == 0, f"parity check failed:\n{res.stderr[-4000:]}"
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_objectives_f64(parity):
    # every key of compute_loss_objectives matches the reference in f64
    assert parity["objectives_f64"] <= 1e-9, parity["objectives_f64_per_key"]


def test_loss_and_grad_f64(parity):
    assert parity["loss_f64"] <= 1e-9
    assert parity["grad_f64"] <= 1e-9


def test_solver_path_f64(parity):
    # the lean optimizer-path loss is numerically the reference loss
    assert parity["solver_loss_f64"] <= 1e-9
    assert parity["solver_grad_f64"] <= 1e-9


def test_handover_f64(parity):
    assert parity["handover_f64"] <= 1e-9


def test_f32_delta_bounded(parity):
    # informational bound: f32 is the production dtype; the delta vs the
    # reference's f64 must stay in the single-precision regime
    assert parity["loss_f32"] <= 1e-5
    assert parity["grad_f32"] <= 1e-4


def test_splat_wrap_compat_mode(parity):
    # opt-in wrap-compat splat reproduces the reference kernel's
    # negative-index wrapping bit behavior (src/utils/event_utils.py:59)
    assert parity["splat_wrap_compat"] <= 1e-12


def test_wrap_vs_drop_reported(parity):
    # drop-vs-wrap is a deliberate, documented deviation that only engages
    # when warped splat windows leave the sensor (ops/splat.py); sanity-bound
    # it so a regression in the drop path would be caught
    assert parity["wrap_vs_drop"] <= 0.2


@pytest.fixture(scope="module")
def loader_parity():
    """Data-layer code-vs-code parity: the reference's own dataloaders
    (cv2/imageio stubbed with our independently tested geometry) vs ours
    over identical generated fixture trees (VERDICT r3 item 1)."""
    script = os.path.join(
        os.path.dirname(__file__), "reference_loader_parity_check.py"
    )
    res = subprocess.run(
        [sys.executable, script],
        capture_output=True,
        text=True,
        env=dict(os.environ),
        timeout=1800,
    )
    assert res.returncode == 0, f"loader parity failed:\n{res.stderr[-4000:]}"
    return json.loads(res.stdout.strip().splitlines()[-1])


class TestLoaderParity:
    """Every loader attribute and datasample dict must be BIT-exact vs the
    reference loaders on the same trees: DSEC train (identity + warped
    geometry, pad/truncate corners), DSEC test official + extended, MVSEC
    (delta_idx 1/4/8, load_more_images, new pruning limits, outdoor_day1
    hood filter, GT propagation incl. the zero-flow mask path), ECD."""

    def test_all_logic_bit_exact(self, loader_parity):
        assert loader_parity["max_exact"] == 0.0, loader_parity["nonzero"]

    def test_geometry_products_eps(self, loader_parity):
        # mapping / event_rect_map: f64 op-order may differ (reference
        # per-pixel squeeze vs our batched matmul) before the f32 cast
        assert loader_parity["geometry_max"] <= 1e-3, loader_parity["nonzero"]

    def test_coverage_breadth(self, loader_parity):
        # the harness compares ~250 distinct (loader, attribute/sample-key)
        # pairs; a collapse in coverage should fail loudly
        assert loader_parity["n_comparisons"] >= 240


@pytest.fixture(scope="module")
def solver_parity():
    """End-to-end optimizer-trajectory parity: the reference pyramid driven
    by scipy's f64 BFGS/L-BFGS-B vs our on-device solve_window, 10-window
    handover chain (VERDICT r2 item 1). ~15-20 min of CPU work."""
    script = os.path.join(
        os.path.dirname(__file__), "reference_solver_parity_check.py"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # run single-device: the conftest's forced 8-device virtual mesh leaks
    # through XLA_FLAGS and changes XLA's compilation enough to nudge
    # trajectories into different basins on individual windows — the
    # recorded tolerances are calibrated on the standalone (1-device) run
    env["XLA_FLAGS"] = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    res = subprocess.run(
        [sys.executable, script],
        capture_output=True,
        text=True,
        env=env,
        timeout=3600,
    )
    assert res.returncode == 0, f"solver parity failed:\n{res.stderr[-4000:]}"
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def production_parity():
    """Trajectory parity at the MVSEC PRODUCTION shape (256x336, 30k
    events, growing maxiters 40..10) — hours of scipy f64 CPU work, so
    opt-in via EINCM_PRODUCTION_PARITY=1 (VERDICT r3 item 2; measured
    values recorded in PARITY.md; scripts/production_parity.py runs both
    tunings — this fixture runs the TV-engaging one, which showed the
    larger toy-scale deltas)."""
    script = os.path.join(
        os.path.dirname(__file__), "reference_solver_parity_check.py"
    )
    env = dict(os.environ)
    env.update(
        {
            "JAX_PLATFORMS": "cpu",
            "EINCM_PARITY_H": "256",
            "EINCM_PARITY_W": "336",
            "EINCM_PARITY_EVENTS": "30000",
            "EINCM_PARITY_MAXITERS": "40,33,25,18,10",
            "EINCM_PARITY_FEATURES": "180",
            "EINCM_PARITY_VX": "4.0",
            "EINCM_PARITY_VY": "-3.0",
            "EINCM_PARITY_WINDOWS": "10",
            "EINCM_PARITY_ALPHA": "20",
            "EINCM_PARITY_BETA": "35",
            "EINCM_PARITY_GAMMA": "0.0025",
        }
    )
    env["XLA_FLAGS"] = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    res = subprocess.run(
        [sys.executable, script],
        capture_output=True,
        text=True,
        env=env,
        timeout=6 * 3600,
    )
    assert res.returncode == 0, (
        f"production parity failed:\n{res.stderr[-4000:]}"
    )
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.skipif(
    os.environ.get("EINCM_PRODUCTION_PARITY") != "1",
    reason="hours of scipy f64 CPU work; opt in with EINCM_PRODUCTION_PARITY=1",
)
@pytest.mark.slow
class TestProductionTrajectoryParity:
    """ΔAEE bounds mirror TestSolverTrajectoryParity's toy-scale bounds —
    the VERDICT r3 item-2 'Done' criterion is that production-shape deltas
    stay within them (measured round-4 values in PARITY.md)."""

    def test_mean_aee_delta_small(self, production_parity):
        for mode in ("wolfe", "armijo"):
            assert production_parity[f"aee_delta_mean_{mode}"] <= 0.1, (
                production_parity
            )

    def test_worst_window_bounded(self, production_parity):
        for mode in ("wolfe", "armijo"):
            worst = max(production_parity[f"aee_delta_per_window_{mode}"])
            assert worst <= 0.75, production_parity

    def test_recovers_flow_like_reference(self, production_parity):
        assert production_parity["aee_ref"] < 2.0
        for mode in ("wolfe", "armijo"):
            assert abs(
                production_parity[f"aee_{mode}"] - production_parity["aee_ref"]
            ) <= 0.15, production_parity


@pytest.mark.slow
class TestSolverTrajectoryParity:
    """Tolerances sit above the round-3 measured values (PARITY.md records
    them): two correct BFGS implementations diverge on individual windows
    (line-search step choices compound over a 5-level pyramid x 10-window
    prior chain), so equivalence is asserted on end metrics, not iterates."""

    def test_recovers_flow_like_reference(self, solver_parity):
        # both implementations recover the synthetic flow to the same level
        assert solver_parity["aee_ref"] < 2.0
        for mode in ("wolfe", "armijo"):
            assert abs(
                solver_parity[f"aee_{mode}"] - solver_parity["aee_ref"]
            ) <= 0.15, solver_parity

    def test_mean_aee_delta_small(self, solver_parity):
        # sequence-mean DEGRADATION bounded (one-sided: measured means are
        # -0.065/-0.105 px, i.e. ours is slightly BETTER on this sequence)
        for mode in ("wolfe", "armijo"):
            assert solver_parity[f"aee_delta_mean_{mode}"] <= 0.1, (
                solver_parity
            )

    def test_worst_window_bounded(self, solver_parity):
        # individual windows may land in different basins; bound the
        # worst-window DEGRADATION (measured +0.10 wolfe / +0.32 armijo;
        # the largest |delta|s are windows where ours is better). Margin
        # above measurement is deliberate: basin outcomes shift with any
        # XLA compilation detail (device count, fusion choices)
        for mode in ("wolfe", "armijo"):
            worst = max(solver_parity[f"aee_delta_per_window_{mode}"])
            assert worst <= 0.75, solver_parity

    def test_level_losses_track_reference(self, solver_parity):
        # per-level final losses within 20% relative (measured <= 5.3%)
        for mode in ("wolfe", "armijo"):
            assert solver_parity[f"level_loss_delta_{mode}"] <= 0.2, (
                solver_parity
            )

    def test_handover_weights_track(self, solver_parity):
        # solved blend weights broadly agree (measured max |dw| ~0.1 both
        # modes; different-but-equally-good optima legitimately shift the
        # blend optimum, so this is a sanity band, not an eps bound)
        for mode in ("wolfe", "armijo"):
            assert solver_parity[f"handover_w_delta_{mode}"] <= 0.25, (
                solver_parity
            )
