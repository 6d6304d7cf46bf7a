"""Verification drive: full pyramid solve on synthetic events, on the default
JAX device (the GPU where there is one)."""
import os
import sys
import time

# runnable straight from a checkout: python examples/synthetic_recovery.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

print("backend:", jax.default_backend(), jax.devices())

from eincm_tpu.models.loss import LossParams
from eincm_tpu.models.pyramid import (
    HandoverSettings,
    SolverConfig,
    WindowSample,
    make_window_solver,
)
from eincm_tpu.ops.splat import events_to_pdf_frame
from eincm_tpu.ops.filters import gaussian_blur_3x3
from eincm_tpu.ops.normalize import normalize_to_unit_range

# ---- synthetic scene: dots moving with constant velocity v ----
H = W = 64
V = np.array([3.0, -2.0])  # px per unit time (x, y)
rng = np.random.default_rng(7)
n_feat = 60
feat = rng.uniform(8, 48, size=(n_feat, 2))  # (x0, y0)

n_ev = 8192
ts = rng.uniform(0, 1, n_ev).astype(np.float32)
which = rng.integers(0, n_feat, n_ev)
xs = (feat[which, 0] + V[0] * ts).astype(np.float32)
ys = (feat[which, 1] + V[1] * ts).astype(np.float32)
xs = np.round(xs)  # events land on integer pixels
ys = np.round(ys)

# edges at t=0 and t=1: splat the feature positions, blur, normalize
def edge_map(t):
    ex = jnp.asarray(feat[:, 0] + V[0] * t)
    ey = jnp.asarray(feat[:, 1] + V[1] * t)
    m = events_to_pdf_frame(ex, ey, (H, W))
    return normalize_to_unit_range(gaussian_blur_3x3(m))

edges = jnp.stack([edge_map(0.0), edge_map(1.0)])
edge_ts = jnp.array([0.0, 1.0], jnp.float32)

sample = WindowSample(
    xs=jnp.asarray(xs), ys=jnp.asarray(ys), ts=jnp.asarray(ts),
    edges=edges, edge_ts=edge_ts,
)

cfg = SolverConfig(
    n_pyr_lvls=5,
    sensor_size=(H, W),
    params=LossParams(alpha=60.0, beta=0.0, gamma=0.0, delta=0.0),
    theta_opt_maxiters=(25, 20, 15, 10, 10),
    theta_gtol=1e-4,
    n_extra_attempts={0: 1},
    handover=HandoverSettings(use_handover=True, solve_handover_for_levels=(0,)),
)

solver = make_window_solver(cfg)
prior = cfg.zero_pyramid()

t0 = time.time()
res = jax.block_until_ready(solver(sample, prior, is_first=True))
t1 = time.time()
print(f"first-window solve (incl. compile): {t1-t0:.1f}s")

t0 = time.time()
res2 = jax.block_until_ready(
    solver(sample, res.final_theta_pyr, is_first=False)
)
t1 = time.time()
print(f"second-window solve (compiled, with handover): {t1-t0:.2f}s")

theta0 = np.asarray(res.final_theta_pyr[0])  # (16,16,2) coarse field
print("level-0 theta mean:", theta0.reshape(-1, 2).mean(0), " GT:", V)
for lvl, st in enumerate(res.theta_opt_states):
    print(f"  lvl{lvl}: iters={int(st.iter_num)} f={float(st.fun_val):.4f} "
          f"success={bool(st.success)} status={int(st.status)} nev={int(st.n_fun_evals)}")

# per-pixel error at event pixels of the FULL upscaled field
from eincm_tpu.ops.resize import scale_theta_to_sensor_size
full = np.asarray(scale_theta_to_sensor_size(res.final_theta_pyr[0], (H, W)))
iy = ys.astype(int); ix = xs.astype(int)
err = np.linalg.norm(full[iy, ix] - V[None, :], axis=-1)
print(f"AEE at event pixels: {err.mean():.3f} px  (|V| = {np.linalg.norm(V):.2f})")
print("handover weights:", [float(w) for w in res2.final_handover_weights])
