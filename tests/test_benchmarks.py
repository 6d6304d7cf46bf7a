"""Smoke tests for the shared benchmark harness (eincm_tpu/utils/benchmarks.py).

bench.py is the driver's only window into this framework's performance: if
the harness import chain, staging, or solver wiring regresses, the driver's
end-of-round benchmark dies with no test having caught it. These tests run
the harness on CPU with tiny solver settings — they verify plumbing, not
performance numbers.
"""

import numpy as np
import pytest

from eincm_tpu.utils.benchmarks import (
    MVSEC_H,
    MVSEC_N_EVENTS,
    MVSEC_W,
    build_mvsec_solve_bench,
    solve_diag_str,
    stage_mvsec_windows,
)


def test_stage_mvsec_windows_contract():
    staged, vels = stage_mvsec_windows(n_windows=2, rotate_deg=15.0)
    assert len(staged) == 2 and len(vels) == 2
    for w, vel in zip(staged, vels):
        assert w.xs.shape == (MVSEC_N_EVENTS,)
        assert w.ys.shape == (MVSEC_N_EVENTS,)
        assert w.ts.shape == (MVSEC_N_EVENTS,)
        # 2 reference edge maps at sensor size, finite everywhere
        assert w.edges.shape[1:] == (MVSEC_H, MVSEC_W)
        assert w.edges.shape[0] == w.edge_ts.shape[0] == 2
        assert np.all(np.isfinite(np.asarray(w.edges)))
        assert np.isclose(np.hypot(*vel), 5.0)
    # rotation: the two windows must have distinct GT velocities
    assert not np.allclose(vels[0], vels[1])


@pytest.mark.slow
def test_build_mvsec_solve_bench_runs_on_cpu():
    # tiny solver settings: this verifies the harness wiring (staging ->
    # SolverConfig -> make_window_solver -> chained rounds -> sync), not perf
    one_round, res = build_mvsec_solve_bench(
        n_windows=2,
        solver_overrides={
            "theta_opt_maxiters": (1, 1, 1, 1, 1),
            "handover_opt_maxiters": (2, 2, 2, 2, 2),
            "n_extra_attempts": {},
        },
    )
    dt = one_round()
    assert dt > 0.0
    diag = solve_diag_str(res)
    assert "total_iters/level=" in diag and "f0=" in diag
    assert "ls_probes=" in diag
    # the warmup result must be a real solve: finite loss and theta
    assert np.isfinite(float(res.theta_opt_states[0].fun_val))
    assert np.all(np.isfinite(np.asarray(res.final_theta_pyr[0])))
