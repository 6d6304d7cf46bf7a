"""Direct numeric parity check against the reference implementation.

Runs the reference's pure-JAX loss (/root/reference/src/eincm/losses.py) on
CPU in float64 side by side with eincm_tpu's loss on identical synthetic
windows, and prints one JSON line of relative errors. Executed in a
subprocess by tests/test_reference_parity.py so that enabling x64 and
stubbing cv2 cannot leak into the main test process.

Comparisons (all on CPU):
  objectives_f64   max rel err over every key of compute_loss_objectives
  loss_f64         rel err of loss_func's scalar, several (a,b,g,d, lvl) cfgs
  grad_f64         rel err of d loss / d theta (coarse theta), same cfgs
  solver_loss_f64  rel err of the lean optimizer-path loss vs reference
  solver_grad_f64  rel err of its gradient
  handover_f64     rel err of handover_loss_func at several blend weights
  loss_f32         our f32 loss vs reference f64 (informational)
  grad_f32         our f32 grad vs reference f64 (informational)
  wrap_vs_drop     loss delta when warps leave the sensor (reference wraps
                   negative splat indices, we drop; informational)

The windows keep all warped coordinates >= 1 pixel inside the sensor so the
reference's negative-index wrap (src/utils/event_utils.py:59) cannot fire,
except in the dedicated wrap_vs_drop probe.
"""

import json
import os
import sys
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

# cv2 is imported at module scope by the reference's img_utils but only used
# inside host-side preprocessing functions that this check never calls.
sys.modules.setdefault("cv2", types.ModuleType("cv2"))
REF = "/root/reference/src"
if REF not in sys.path:
    sys.path.insert(0, REF)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from eincm import losses as ref_losses  # noqa: E402
from utils import event_utils as ref_event_utils  # noqa: E402

from eincm_tpu.models import loss as our_loss_mod  # noqa: E402
from eincm_tpu.models.loss import LossParams, LossStatics  # noqa: E402


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    denom = max(float(np.max(np.abs(b))), 1e-30)
    return float(np.max(np.abs(a - b))) / denom


def make_window(seed, H, W, n_events, n_refs, coarse_hw, vmax, margin):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(margin, W - 1 - margin, n_events)
    ys = rng.uniform(margin, H - 1 - margin, n_events)
    # event coords are integral in the real pipeline (sensor pixels)
    xs = np.round(xs)
    ys = np.round(ys)
    ts = np.sort(rng.uniform(0.0, 1.0, n_events))
    edges = rng.uniform(0.0, 1.0, (n_refs, H, W))
    edge_ts = np.linspace(0.0, 1.0, n_refs)
    ch, cw = coarse_hw
    theta = rng.uniform(-vmax, vmax, (ch, cw, 2))
    return dict(
        xs=jnp.asarray(xs),
        ys=jnp.asarray(ys),
        ts=jnp.asarray(ts),
        edges=jnp.asarray(edges),
        edge_ts=jnp.asarray(edge_ts),
        theta=jnp.asarray(theta),
        sensor_size=(H, W),
    )


def ref_loss(w, params, lvl, n_pyr_lvls=5, method="bilinear"):
    loss, _ = ref_losses.loss_func(
        w["theta"], w["xs"], w["ys"], w["ts"], w["edges"], w["edge_ts"],
        params.alpha, params.beta, params.gamma, params.delta,
        lvl, n_pyr_lvls, w["sensor_size"], method,
    )
    return loss


def our_loss(w, params, lvl, n_pyr_lvls=5, method="bilinear"):
    statics = LossStatics(
        sensor_size=w["sensor_size"], n_pyr_lvls=n_pyr_lvls,
        scale_to_sensor_size_method=method,
    )
    loss, _ = our_loss_mod.loss_func(
        w["theta"], w["xs"], w["ys"], w["ts"], w["edges"], w["edge_ts"],
        params, lvl, statics,
    )
    return loss


def our_solver_loss(w, params, lvl, n_pyr_lvls=5, method="bilinear"):
    statics = LossStatics(
        sensor_size=w["sensor_size"], n_pyr_lvls=n_pyr_lvls,
        scale_to_sensor_size_method=method,
    )
    wstat = our_loss_mod.compute_window_statics(
        w["xs"], w["ys"], w["edges"], w["sensor_size"]
    )
    return our_loss_mod.solver_loss(
        w["theta"], w["xs"], w["ys"], w["ts"], w["edges"], w["edge_ts"],
        params, lvl, statics, wstat,
    )


def as_f32(w):
    out = dict(w)
    for k in ("xs", "ys", "ts", "edges", "edge_ts", "theta"):
        out[k] = w[k].astype(jnp.float32)
    return out


def main():
    results = {}

    w = make_window(
        seed=0, H=40, W=56, n_events=4096, n_refs=3,
        coarse_hw=(5, 7), vmax=2.0, margin=4,
    )

    # --- full objective bundle ------------------------------------------
    scaled = ref_losses.scale_theta_to_sensor_size(
        w["theta"], w["sensor_size"], "bilinear"
    )
    ref_objs = ref_losses.compute_loss_objectives(
        scaled, w["xs"], w["ys"], w["ts"], w["edges"], w["edge_ts"],
        w["sensor_size"],
    )
    ref_objs["theta_divergence"] = __import__(
        "eincm.regularizers", fromlist=["per_pix_theta_divergence"]
    ).per_pix_theta_divergence(scaled)
    our_objs = our_loss_mod.compute_loss_objectives(
        scaled, w["xs"], w["ys"], w["ts"], w["edges"], w["edge_ts"],
        w["sensor_size"],
    )
    per_key = {}
    for k, v in ref_objs.items():
        assert k in our_objs, f"missing objective key: {k}"
        per_key[k] = rel_err(our_objs[k], v)
    results["objectives_f64"] = max(per_key.values())
    results["objectives_f64_per_key"] = per_key

    # --- loss + grad over several configs -------------------------------
    cfgs = [
        (LossParams(60.0, 60.0, 0.0, 0.0), 1),      # ECD tuning, mid level
        (LossParams(20.0, 35.0, 0.0025, 0.0), 0),   # MVSEC outdoor, finest
        (LossParams(2000.0, 4000.0, 0.0, 0.0), 0),  # DSEC tuning
        (LossParams(1.0, 1.0, 0.01, 0.5), 0),       # all terms active
        (LossParams(1.0, 1.0, 0.01, 0.5), 2),       # TV gated off
    ]
    loss_errs, grad_errs, sl_errs, sg_errs = [], [], [], []
    for params, lvl in cfgs:
        rl, rg = jax.value_and_grad(lambda th: ref_loss({**w, "theta": th}, params, lvl))(w["theta"])
        ol, og = jax.value_and_grad(lambda th: our_loss({**w, "theta": th}, params, lvl))(w["theta"])
        sl, sg = jax.value_and_grad(lambda th: our_solver_loss({**w, "theta": th}, params, lvl))(w["theta"])
        loss_errs.append(rel_err(ol, rl))
        grad_errs.append(rel_err(og, rg))
        sl_errs.append(rel_err(sl, rl))
        sg_errs.append(rel_err(sg, rg))
    results["loss_f64"] = max(loss_errs)
    results["grad_f64"] = max(grad_errs)
    results["solver_loss_f64"] = max(sl_errs)
    results["solver_grad_f64"] = max(sg_errs)

    # --- handover loss ---------------------------------------------------
    params, lvl = LossParams(20.0, 35.0, 0.0, 0.0), 1
    prev = w["theta"][::-1, ::-1, :] * 0.7
    ho_errs = []
    for aw in (0.0, 0.3, 0.8, 1.0):
        rh = ref_losses.handover_loss_func(
            aw, prev, w["theta"], w["xs"], w["ys"], w["ts"], w["edges"],
            w["edge_ts"], params.alpha, params.beta, params.gamma,
            params.delta, lvl, 5, w["sensor_size"], "bilinear",
        )
        oh = our_loss_mod.handover_loss_func(
            jnp.asarray(aw, jnp.float64), prev, w["theta"], w["xs"], w["ys"],
            w["ts"], w["edges"], w["edge_ts"], params, lvl,
            LossStatics(sensor_size=w["sensor_size"], n_pyr_lvls=5),
        )
        ho_errs.append(rel_err(oh, rh))
    results["handover_f64"] = max(ho_errs)

    # --- f32 delta (informational) ---------------------------------------
    params, lvl = LossParams(20.0, 35.0, 0.0025, 0.0), 0
    w32 = as_f32(w)
    rl, rg = jax.value_and_grad(lambda th: ref_loss({**w, "theta": th}, params, lvl))(w["theta"])
    ol32, og32 = jax.value_and_grad(lambda th: our_loss({**w32, "theta": th}, params, lvl))(w32["theta"])
    results["loss_f32"] = rel_err(ol32, rl)
    results["grad_f32"] = rel_err(og32, rg)

    # --- wrap-vs-drop delta (informational) ------------------------------
    wbig = make_window(
        seed=1, H=40, W=56, n_events=4096, n_refs=3,
        coarse_hw=(5, 7), vmax=30.0, margin=0,
    )
    rl = ref_loss(wbig, params, 0)
    ol = our_loss(wbig, params, 0)
    results["wrap_vs_drop"] = rel_err(ol, rl)

    # --- wrap-compat splat vs the reference kernel, bit behavior ---------
    from eincm_tpu.ops import splat as our_splat

    rng = np.random.default_rng(3)
    H, W = 40, 56
    # coordinates spilling below 0 on both axes so wrapping fires; none
    # below -1 so the single-wrap semantics match exactly
    cx = jnp.asarray(rng.uniform(-0.9, W - 1 + 0.49, 4096))
    cy = jnp.asarray(rng.uniform(-0.9, H - 1 + 0.49, 4096))
    ref_frame = ref_event_utils.events_to_pdf_frame(cx, cy, (H, W))
    our_splat.set_splat_wrap_compat(True)
    try:
        our_frame = our_splat.events_to_pdf_frame(cx, cy, (H, W))
    finally:
        our_splat.set_splat_wrap_compat(False)
    results["splat_wrap_compat"] = rel_err(our_frame, ref_frame)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
