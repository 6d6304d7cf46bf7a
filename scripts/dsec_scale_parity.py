"""DSEC-scale f32/precision accuracy stress (VERDICT r2 item 3).

Round-2 f32 parity was measured at toy scale (40x56, 4k events); this
harness measures it in the production regime the reference warns about
(configs/main.yaml:34 BFGS-needs-f64 warning; SURVEY.md §7 "float64" hard
part): 480x640 sensor, 1.5M events, alpha=2000/beta=4000.

Two phases:
  1. a CPU subprocess evaluates the REFERENCE loss+grad in f64 on a seeded
     DSEC-scale window and saves them;
  2. this process evaluates OUR f32 loss+grad on its default JAX device and
     reports relative errors, then runs a full synthetic DSEC-scale
     3-window solve and reports final AEE.

Run on a GPU:  python scripts/dsec_scale_parity.py
Prints one JSON line.
"""

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache")
)

H, W = 480, 640
N_EVENTS = 1_500_000
COARSE = (16, 16)
SEED = 11
ALPHA, BETA = 2000.0, 4000.0

_REF_PHASE = r"""
import os, sys, types
import numpy as np
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
sys.modules.setdefault("cv2", types.ModuleType("cv2"))
sys.path.insert(0, "/root/reference/src")
from eincm import losses as ref_losses

H, W, N, SEED = %(H)d, %(W)d, %(N)d, %(SEED)d
rng = np.random.default_rng(SEED)
xs = np.round(rng.uniform(8, W - 9, N))
ys = np.round(rng.uniform(8, H - 9, N))
ts = np.sort(rng.uniform(0, 1, N))
edges = rng.uniform(0, 1, (2, H, W))
edge_ts = np.array([0.0, 1.0])
theta = rng.uniform(-6.0, 6.0, (%(ch)d, %(cw)d, 2))

def loss(th):
    out, _ = ref_losses.loss_func(
        th, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ts),
        jnp.asarray(edges), jnp.asarray(edge_ts),
        %(alpha)f, %(beta)f, %(gamma)f, %(delta)f, 0, 5, (H, W), "bilinear",
    )
    return out

f, g = jax.value_and_grad(loss)(jnp.asarray(theta))
np.savez("%(out)s", f=np.asarray(f), g=np.asarray(g))
print("ref f64:", float(f))
"""


def run_reference_phase(out_path, alpha=ALPHA, beta=BETA, gamma=0.0, delta=0.0):
    code = _REF_PHASE % dict(
        H=H, W=W, N=N_EVENTS, SEED=SEED, ch=COARSE[0], cw=COARSE[1],
        alpha=alpha, beta=beta, gamma=gamma, delta=delta, out=out_path,
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    res = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=3600,
    )
    if res.returncode != 0:
        raise RuntimeError(f"reference phase failed:\n{res.stderr[-3000:]}")
    print(res.stdout.strip(), file=sys.stderr)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


if __name__ == "__main__":
    import numpy as np

    # cache keyed on every parameter that determines the reference result —
    # a bare filename silently reused stale baselines after edits
    def ref_loss_grad(alpha, beta, gamma, delta):
        key = (
            f"{H}x{W}_n{N_EVENTS}_s{SEED}_a{alpha:g}_b{beta:g}"
            f"_g{gamma:g}_d{delta:g}_c{COARSE[0]}x{COARSE[1]}"
        )
        npz = os.path.join(tempfile.gettempdir(), f"eincm_dsec_ref_{key}.npz")
        if not os.path.exists(npz):
            run_reference_phase(npz, alpha, beta, gamma, delta)
        ref = np.load(npz)
        return ref["f"], ref["g"]

    f_ref, g_ref = ref_loss_grad(ALPHA, BETA, 0.0, 0.0)

    import jax
    import jax.numpy as jnp

    from eincm_tpu.models.loss import (
        LossParams,
        LossStatics,
        compute_window_statics,
        solver_loss,
    )

    print(f"backend: {jax.default_backend()}", file=sys.stderr)

    rng = np.random.default_rng(SEED)
    xs = np.round(rng.uniform(8, W - 9, N_EVENTS)).astype(np.float32)
    ys = np.round(rng.uniform(8, H - 9, N_EVENTS)).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1, N_EVENTS)).astype(np.float32)
    edges64 = rng.uniform(0, 1, (2, H, W))
    edge_ts = np.array([0.0, 1.0], np.float32)
    theta = rng.uniform(-6.0, 6.0, (*COARSE, 2)).astype(np.float32)

    statics = LossStatics(sensor_size=(H, W), n_pyr_lvls=5)
    params = LossParams(ALPHA, BETA, 0.0, 0.0)

    results = {"f_ref": float(f_ref)}

    def loss_grad(p):
        @jax.jit
        def fg(th, exs=jnp.asarray(xs), eys=jnp.asarray(ys),
               ets=jnp.asarray(ts)):
            wstat = compute_window_statics(
                exs, eys, jnp.asarray(edges64, jnp.float32), (H, W)
            )
            return jax.value_and_grad(solver_loss)(
                th, exs, eys, ets,
                jnp.asarray(edges64, jnp.float32), jnp.asarray(edge_ts),
                p, 0, statics, wstat,
            )

        f, g = fg(jnp.asarray(theta))
        return float(f), np.asarray(g)

    f, g = loss_grad(params)
    results["loss_relerr"] = rel_err(f, f_ref)
    results["grad_relerr"] = rel_err(g, g_ref)

    # ---- per-objective f32 stress (SURVEY §7: "parity must be validated
    # per-objective"): gamma (TV regularizer, finest-level gated — active in
    # the MVSEC-outdoor production tuning, run.sh:73-97) and delta (event-
    # collapse divergence) each activated at DSEC scale, against their own
    # f64 reference evaluations ---------------------------------------------
    for case, (a_, b_, g_, d_) in {
        "gamma_tv": (20.0, 35.0, 0.0025, 0.0),
        "delta_collapse": (20.0, 35.0, 0.0, 1.0),
    }.items():
        fr, gr = ref_loss_grad(a_, b_, g_, d_)
        f, g = loss_grad(LossParams(a_, b_, g_, d_))
        results[f"loss_relerr_{case}"] = rel_err(f, fr)
        results[f"grad_relerr_{case}"] = rel_err(g, gr)

    # ---- full DSEC-scale solve: final AEE per kernel ---------------------
    from eincm_tpu.data.staging import stage_datasample
    from eincm_tpu.data.synthetic import SyntheticDataLoader
    from eincm_tpu.experiments.config import EdgeConfig
    from eincm_tpu.models.pyramid import (
        HandoverSettings,
        SolverConfig,
        make_window_solver,
    )
    from eincm_tpu.ops.resize import scale_theta_to_sensor_size

    dl = SyntheticDataLoader(
        sensor_size=(H, W), n_windows=3, des_n_events=N_EVENTS,
        velocity=(6.0, -4.0), n_features=400, seed=2,
    )
    dl.get_ready()
    edge_fn = EdgeConfig(
        enable_image_preprocessing=False, smoothen_method="eincm_iedt"
    ).make_edge_fn()

    cfg = SolverConfig(
        n_pyr_lvls=5,
        sensor_size=(H, W),
        params=params,
        theta_opt_maxiters=(40, 33, 25, 18, 10),
        theta_gtol=1e-4,
        n_extra_attempts={0: 2},
        handover=HandoverSettings(
            use_handover=True, solve_handover_for_levels=(0,)
        ),
    )
    v = np.array([6.0, -4.0])
    solver = make_window_solver(cfg)
    prior = cfg.zero_pyramid()
    aees = []
    for i in range(3):
        staged = stage_datasample(
            dl[i], edge_fn=edge_fn, preprocess=False, pad_to=N_EVENTS,
        )
        res = solver(staged.window, prior, is_first=(i == 0))
        prior = res.final_theta_pyr
        full = np.asarray(
            scale_theta_to_sensor_size(
                res.final_theta_pyr[0], (H, W), "bilinear"
            )
        )
        ev = staged.eval_events
        ix = np.clip(np.asarray(ev["x"]).astype(int), 0, W - 1)
        iy = np.clip(np.asarray(ev["y"]).astype(int), 0, H - 1)
        err = np.linalg.norm(full[iy, ix] - v[None, :], axis=-1)
        aees.append(float(err.mean()))
    results["solve_aee"] = round(float(np.mean(aees)), 4)

    print(json.dumps(results))
