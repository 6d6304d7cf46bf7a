"""Scan-over-levels solver equivalence vs the per-level build.

Equivalence structure:

- On CPU, XLA's dense-algebra reduction trees differ between the D_l-sized
  and D_max-padded computations by ULPs (e.g. an 8-wide dot vs the same 8
  non-zeros inside a 128-wide dot), and the BFGS/handover chain amplifies
  ULP differences chaotically (line-search accept flips) — the same effect
  the production-parity harness documents for our-vs-reference CPU runs.
  CI on CPU therefore asserts OUTCOME QUALITY (flow recovered equally
  well, same convergence structure), not trajectory closeness; plus a
  single-device first-window trajectory-band check (before chaos has
  anything to amplify: measured 2.6e-4, asserted < 5e-3).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eincm_tpu.models.loss import LossParams
from eincm_tpu.models.pyramid import (
    HandoverSettings,
    SolverConfig,
    WindowSample,
    solve_window,
)
from eincm_tpu.models.pyramid_scan import solve_window_scan
from eincm_tpu.ops.filters import gaussian_blur_3x3
from eincm_tpu.ops.normalize import normalize_to_unit_range
from eincm_tpu.ops.resize import scale_theta_to_sensor_size
from eincm_tpu.ops.splat import events_to_pdf_frame


def _cfg(**kw):
    base = dict(
        n_pyr_lvls=3,
        sensor_size=(32, 32),
        params=LossParams(alpha=60.0, beta=0.0),
        theta_opt_maxiters=(8, 6, 4),
        handover_opt_maxiters=(5, 5, 5),
        n_extra_attempts={0: 1},
        max_ls_evals=6,
    )
    base.update(kw)
    return SolverConfig(**base)


def _window(seed=0, velocity=(2.0, -1.0), sensor=(32, 32), n_events=1024):
    """Moving-dots window (same scheme as tests/test_pyramid.py)."""
    rng = np.random.default_rng(seed)
    h, w = sensor
    feat = rng.uniform(4, min(h, w) - 8, size=(24, 2))
    ts = rng.uniform(0, 1, n_events).astype(np.float32)
    which = rng.integers(0, len(feat), n_events)
    xs = np.round(feat[which, 0] + velocity[0] * ts).astype(np.float32)
    ys = np.round(feat[which, 1] + velocity[1] * ts).astype(np.float32)

    def edge_map(t):
        ex = jnp.asarray(feat[:, 0] + velocity[0] * t)
        ey = jnp.asarray(feat[:, 1] + velocity[1] * t)
        m = events_to_pdf_frame(ex, ey, sensor)
        return normalize_to_unit_range(gaussian_blur_3x3(m))

    return WindowSample(
        xs=jnp.asarray(xs),
        ys=jnp.asarray(ys),
        ts=jnp.asarray(ts),
        edges=jnp.stack([edge_map(0.0), edge_map(1.0)]),
        edge_ts=jnp.array([0.0, 1.0], jnp.float32),
    )


def _aee(res, cfg, velocity):
    full = np.asarray(
        scale_theta_to_sensor_size(res.final_theta_pyr[0], cfg.sensor_size)
    )
    v = np.asarray(velocity)
    return float(np.linalg.norm(full - v[None, None, :], axis=-1).mean())


def _assert_quality_equivalent(a, b, cfg, velocity):
    """Both builds recover the flow equally well; structure matches."""
    for lvl in range(cfg.n_pyr_lvls):
        assert (
            a.final_theta_pyr[lvl].shape == b.final_theta_pyr[lvl].shape
        ), lvl
        sa, sb = a.theta_opt_states[lvl], b.theta_opt_states[lvl]
        assert int(sa.status) in (0, 1, 2, 4) and int(sb.status) in (0, 1, 2, 4)
        assert np.isfinite(float(sa.fun_val)) and np.isfinite(float(sb.fun_val))
        # both land at comparable objective floors
        np.testing.assert_allclose(
            float(sa.fun_val), float(sb.fun_val), rtol=5e-2,
            err_msg=f"fun_val lvl {lvl}",
        )
    aee_a, aee_b = _aee(a, cfg, velocity), _aee(b, cfg, velocity)
    speed = float(np.linalg.norm(velocity))
    assert aee_a < 0.5 * speed, f"per-level build failed recovery: {aee_a}"
    assert aee_b < 0.5 * speed, f"scan build failed recovery: {aee_b}"
    assert abs(aee_a - aee_b) < 0.1, (aee_a, aee_b)


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


class TestScanEquivalence:
    # The first-window and chained comparisons run in float64: in float32
    # the ULP differences between the D_l-sized and padded computations
    # grow chaotically, and which seed lands within 0.1 px is luck (over 8
    # seeds the per-window |dAEE| reaches ~0.2-0.28 px in float32, 0 in
    # float64). In float64 both builds must agree; the other tests keep
    # float32.
    def test_first_window(self):
        with jax.enable_x64(True):
            cfg = _cfg()
            w = _f64(_window())
            zero = cfg.zero_pyramid(jnp.float64)
            a = solve_window(cfg, w, zero, is_first_sample=True)
            b = solve_window_scan(cfg, w, zero, is_first_sample=True)
            _assert_quality_equivalent(a, b, cfg, (2.0, -1.0))
            np.testing.assert_allclose(
                np.asarray(a.final_theta_pyr[0]),
                np.asarray(b.final_theta_pyr[0]), rtol=1e-6, atol=1e-6,
            )

    def test_chained_windows_with_handover_solve(self):
        cfg = _cfg(
            handover=HandoverSettings(
                solve_handover_for_levels=(0, 1),
                handover_grid_probes=5,
            ),
            compute_prior_loss=True,
        )
        with jax.enable_x64(True):
            self._chain(cfg)

    @staticmethod
    def _chain(cfg):
        prior_a = prior_b = cfg.zero_pyramid(jnp.float64)
        for i in range(3):
            v = (2.0 + 0.3 * i, -1.0)
            w = _f64(_window(seed=i, velocity=v))
            a = solve_window(cfg, w, prior_a, is_first_sample=(i == 0))
            b = solve_window_scan(cfg, w, prior_b, is_first_sample=(i == 0))
            _assert_quality_equivalent(a, b, cfg, v)
            if i > 0:
                # each build's prior loss is evaluated under ITS own chain
                assert np.isfinite(float(a.prior_loss_lvl0))
                assert np.isfinite(float(b.prior_loss_lvl0))
                for wa, wb in zip(
                    a.final_handover_weights, b.final_handover_weights
                ):
                    lo, hi = cfg.handover.handover_limits
                    assert lo <= float(wa) <= hi and lo <= float(wb) <= hi
            prior_a = a.final_theta_pyr
            prior_b = b.final_theta_pyr

    def test_tv_term_gamma_and_ftol(self):
        # gamma engages the TV switch branches + the dynamic level gate;
        # ftol exercises the noise-floor termination under traced maxiters.
        # beta=0: naive synthetic edge maps fight alignment (verify skill
        # note), and the recovery-quality bar needs the solve to work.
        cfg = _cfg(
            params=LossParams(alpha=60.0, beta=0.0, gamma=0.0025),
            theta_ftol=1e-5,
        )
        v = (1.5, 2.0)
        w = _window(velocity=v)
        zero = cfg.zero_pyramid()
        a = solve_window(cfg, w, zero, is_first_sample=True)
        b = solve_window_scan(cfg, w, zero, is_first_sample=True)
        _assert_quality_equivalent(a, b, cfg, v)

    def test_wolfe_line_search(self):
        cfg = _cfg(line_search="wolfe", max_ls_evals=10)
        w = _window()
        zero = cfg.zero_pyramid()
        a = solve_window(cfg, w, zero, is_first_sample=True)
        b = solve_window_scan(cfg, w, zero, is_first_sample=True)
        _assert_quality_equivalent(a, b, cfg, (2.0, -1.0))

    def test_collect_intermediate_rejected(self):
        cfg = _cfg(collect_intermediate=True)
        w = _window()
        with pytest.raises(ValueError, match="collect_intermediate"):
            solve_window_scan(cfg, w, cfg.zero_pyramid(), True)


_FIRSTWIN_CHILD = r"""
import os, sys, json
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "tests"))
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from test_pyramid_scan import _cfg, _window
from eincm_tpu.models.pyramid import solve_window
from eincm_tpu.models.pyramid_scan import solve_window_scan

cfg = _cfg()
w = _window()
a = solve_window(cfg, w, cfg.zero_pyramid(), is_first_sample=True)
b = solve_window_scan(cfg, w, cfg.zero_pyramid(), is_first_sample=True)
max_theta = max(
    float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
    for x, y in zip(a.final_theta_pyr, b.final_theta_pyr)
)
iters_equal = all(
    int(sa.total_iters) == int(sb.total_iters)
    and int(sa.status) == int(sb.status)
    for sa, sb in zip(a.theta_opt_states, b.theta_opt_states)
)
print(json.dumps({{"max_theta_delta": max_theta, "iters_equal": iters_equal}}))
"""


@pytest.mark.slow
def test_single_device_first_window_band():
    """Single CPU device (no forced virtual mesh), first window: before the
    handover chain gives chaos anything to amplify, the two builds' final
    thetas agree to a few 1e-4 (ULP-seeded drift only; measured 2.6e-4) and
    their per-level iteration counts/statuses are identical."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    res = subprocess.run(
        [sys.executable, "-c", _FIRSTWIN_CHILD.format(repo=repo)],
        capture_output=True,
        text=True,
        env=env,
        timeout=1500,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["max_theta_delta"] < 5e-3
    assert out["iters_equal"]
