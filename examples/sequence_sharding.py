"""Scale-out demo: one event-window SEQUENCE sharded over an 8-device mesh.

The reference pipeline is strictly sequential over windows — its handover
prior chain makes window i depend on window i-1
(reference: src/eincm/solver.py:254-255, src/experiments/e00/exp_mgr.py:620).
This demo runs the same sequence three ways and compares accuracy:

  1. sequential   — exact prior chain, one window at a time (the reference
                    schedule);
  2. two-pass     — all windows solve in parallel without priors, then all
                    re-solve in parallel with the neighbor's pass-1 result
                    as prior (`parallel/batch.py:two_pass_sequence_solve`);
  3. seq-sharded  — each device takes a contiguous chunk and runs the TRUE
                    in-chunk handover chain; chunk-boundary priors travel
                    between devices via `lax.ppermute`
                    (`parallel/batch.py:sequence_shard_solve`).

Runs anywhere: forces a virtual 8-device CPU mesh (the same recipe the test
suite and the multi-device dry run use). On several GPUs the identical
code shards over the physical mesh — the schedules only touch
`jax.sharding` / `shard_map` / `ppermute`.

Usage:  python examples/sequence_sharding.py
"""

import os
import sys
import time

# runnable straight from a checkout: python examples/sequence_sharding.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from eincm_tpu.models.loss import LossParams
from eincm_tpu.models.pyramid import (
    HandoverSettings,
    SolverConfig,
    WindowSample,
    solve_window,
)
from eincm_tpu.ops.splat import events_to_pdf_frame
from eincm_tpu.ops.filters import gaussian_blur_3x3
from eincm_tpu.ops.normalize import normalize_to_unit_range
from eincm_tpu.parallel.batch import (
    make_window_mesh,
    sequence_shard_solve,
    two_pass_sequence_solve,
)

H = W = 48
N_WINDOWS = 16
N_EVENTS = 3072
rng = np.random.default_rng(11)


def make_window(v):
    """Synthetic window: dots moving with velocity v (px / unit time)."""
    n_feat = 40
    feat = rng.uniform(6, H - 6, size=(n_feat, 2))
    ts = rng.uniform(0, 1, N_EVENTS).astype(np.float32)
    which = rng.integers(0, n_feat, N_EVENTS)
    xs = np.round(feat[which, 0] + v[0] * ts).astype(np.float32)
    ys = np.round(feat[which, 1] + v[1] * ts).astype(np.float32)

    def edge_map(t):
        ex = jnp.asarray(feat[:, 0] + v[0] * t)
        ey = jnp.asarray(feat[:, 1] + v[1] * t)
        m = events_to_pdf_frame(ex, ey, (H, W))
        return normalize_to_unit_range(gaussian_blur_3x3(m))

    edges = jnp.stack([edge_map(0.0), edge_map(1.0)])
    return WindowSample(
        xs=jnp.asarray(xs),
        ys=jnp.asarray(ys),
        ts=jnp.asarray(ts),
        edges=edges,
        edge_ts=jnp.asarray([0.0, 1.0], jnp.float32),
    )


def main():
    mesh = make_window_mesh()
    print(f"mesh: {mesh.devices.size} devices, axis 'windows'")

    # velocities drift smoothly across the sequence — the regime where the
    # handover prior chain helps
    angles = np.linspace(0.0, 1.2, N_WINDOWS)
    vels = np.stack([3.0 * np.cos(angles), -2.0 * np.sin(angles) - 1.0], 1)
    windows = [make_window(v) for v in vels]
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *windows)

    cfg = SolverConfig(
        n_pyr_lvls=3,
        sensor_size=(H, W),
        params=LossParams(alpha=40.0, beta=0.0, gamma=0.0),
        theta_opt_maxiters=(12, 8, 6),
        handover=HandoverSettings(use_handover=True, alpha_handover=0.5),
        max_ls_evals=6,
    )

    def aee(final_pyrs_lvl0):
        # level-0 theta mean vs the known per-window velocity
        th = np.asarray(final_pyrs_lvl0).reshape(N_WINDOWS, -1, 2).mean(1)
        return float(np.linalg.norm(th - vels, axis=1).mean())

    # 1. sequential chain (reference schedule)
    t0 = time.perf_counter()
    prior = tuple(cfg.zero_pyramid(jnp.float32))
    finals = []
    for i in range(N_WINDOWS):
        res = solve_window(
            cfg,
            jax.tree_util.tree_map(lambda x: x[i], batch),
            prior,
            is_first_sample=(i == 0),
        )
        prior = res.final_theta_pyr
        finals.append(prior[0])
    seq_aee = aee(jnp.stack(finals))
    t_seq = time.perf_counter() - t0
    print(f"sequential : AEE {seq_aee:.3f} px   {t_seq:6.1f} s")

    # 2. two-pass parallel schedule
    t0 = time.perf_counter()
    _, final = two_pass_sequence_solve(cfg, batch, mesh=mesh)
    tp_aee = aee(final[0])
    t_tp = time.perf_counter() - t0
    print(f"two-pass   : AEE {tp_aee:.3f} px   {t_tp:6.1f} s")

    # 3. sequence-sharded chunks with ppermute boundary exchange
    t0 = time.perf_counter()
    _, final = sequence_shard_solve(cfg, batch, mesh)
    ss_aee = aee(final[0])
    t_ss = time.perf_counter() - t0
    print(f"seq-sharded: AEE {ss_aee:.3f} px   {t_ss:6.1f} s")

    vmag = float(np.linalg.norm(vels, axis=1).mean())
    print(f"(mean |V| = {vmag:.2f} px; all schedules should sit well below)")
    assert tp_aee < 0.5 * vmag and ss_aee < 0.5 * vmag


if __name__ == "__main__":
    main()
