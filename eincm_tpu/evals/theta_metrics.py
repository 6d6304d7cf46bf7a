"""Full per-window metric bundle for a solved theta field.

Port of src/evaluations/theta_eval.py:14-95 (`evaluate_theta_array`): loss
recomputation, FWL, IWE variance, and — when ground truth is available — the
sparse flow errors. Returns the same `evals` dict keys as the reference plus
the formatted strings for log parity.

Restructuring: the reference evaluates the bundle eagerly, op by op
(dozens of dispatches per window, each a host round-trip). Here every
device computation — objectives, loss, IWE variance and
the flow-error reductions — runs as ONE jitted dispatch (`_eval_bundle`),
and only the small scalar/per-ref bundle is transferred to the host. The big
per-event arrays (warped coordinates) never leave the device.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from eincm_tpu.models.loss import (
    LossParams,
    compute_loss_objectives,
    compute_window_statics,
)
from eincm_tpu.ops.splat import events_to_pdf_frame

from eincm_tpu.evals.flow_metrics import sparse_flow_error


# re-exported here for the evaluation API; single implementation lives in
# models/objectives.py (reference: src/utils/theta_utils.py:40-73)
from eincm_tpu.models.objectives import per_pix_theta_to_flow  # noqa: F401


def _eval_bundle_impl(
    theta_array: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    gt_flow: jax.Array,
    err_mask: jax.Array,
    pvec: jax.Array,
    wstat,
    sensor_size: Tuple[int, int],
    has_gt: bool,
    has_mask: bool,
):
    """One-dispatch evaluation: returns (small host bundle, device loss_obj).

    `pvec` carries (alpha, beta, gamma, delta) as traced values so one
    compilation serves every objective weighting. `wstat` is the window's
    precomputed zero-warp statistics (WindowStatics) — theta-independent, so
    one computation serves every iterate evaluated against this window.
    """
    objs = compute_loss_objectives(
        theta_array, xs, ys, ts, edges, edge_ts, sensor_size,
        window_statics=wstat,
    )
    mean_rel_contrast = objs["rel_contrasts"].mean()
    mean_rel_corr = objs["rel_correlations"].mean()
    mean_rel_iwe_div = objs["rel_iwe_divergences"].mean()
    tot_var = objs["theta_total_variation"]
    # NOTE: UNWEIGHTED means, exactly like the reference eval
    # (src/evaluations/theta_eval.py:27-42) — the reference's solver loss
    # applies multi_ref_weights (losses.py:176-193) but its eval loss does
    # not, so for n_refs > 1 this reported loss deliberately differs from
    # the optimized objective by the same factor the reference's does.
    loss = (
        pvec[0] * (-mean_rel_contrast)
        + pvec[1] * (-mean_rel_corr)
        + pvec[2] * tot_var
        + pvec[3] * mean_rel_iwe_div
    )
    # the reference re-splats the ref-0 warped events for iwe_var
    # (src/evaluations/theta_eval.py:25-43); fused into the same dispatch here
    iwe = events_to_pdf_frame(
        objs["warped_xs"][0], objs["warped_ys"][0], sensor_size
    )
    small: Dict = {
        "loss": loss,
        "iwe_var": jnp.var(iwe),
        "mean_rel_contrast": mean_rel_contrast,
        "mean_rel_corr": mean_rel_corr,
        "theta_tot_var": tot_var,
        "theta_div": objs["theta_divergence"],
        "fwl": objs["flow_warp_losses"][0],
        "mean_rel_iwe_div": mean_rel_iwe_div,
        "rel_iwe_divergences": objs["rel_iwe_divergences"],
        "rel_contrasts": objs["rel_contrasts"],
        "rel_correlations": objs["rel_correlations"],
        "flow_warp_losses": objs["flow_warp_losses"],
        "multi_ref_weights": objs["multi_ref_weights"],
    }
    if has_gt:
        pred_flow = per_pix_theta_to_flow(theta_array, xs, ys, ts)
        small["flow_errors"] = sparse_flow_error(
            pred_flow, gt_flow, err_mask if has_mask else None
        )
    return small, objs


_eval_bundle = partial(
    jax.jit, static_argnames=("sensor_size", "has_gt", "has_mask")
)(_eval_bundle_impl)


def eval_window_small(
    theta_coarse: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    gt_flow: jax.Array,
    err_mask: jax.Array,
    pvec: jax.Array,
    sensor_size: Tuple[int, int],
    has_gt: bool,
    has_mask: bool,
    upscale_method: str,
):
    """Single-window evaluation returning ONLY the small host bundle.

    Building block of the sharded batch eval (parallel.batch.
    eval_batch_sharded): takes the solver's COARSE level-0 theta and
    upscales on device (smaller host->device transfers than shipping
    full-sensor thetas), computes the window statics inline (each window is
    evaluated once in batch mode, so there is nothing to hoist), and drops
    the large per-event objective arrays before they can stack across the
    window axis.
    """
    from eincm_tpu.ops.resize import scale_theta_to_sensor_size

    theta_full = scale_theta_to_sensor_size(
        theta_coarse, sensor_size, upscale_method
    )
    wstat = compute_window_statics(xs, ys, edges, sensor_size)
    small, _ = _eval_bundle_impl(
        theta_full, xs, ys, ts, edges, edge_ts, gt_flow, err_mask,
        pvec, wstat, sensor_size, has_gt, has_mask,
    )
    return small


def format_eval_result(
    small: Dict, sensor_size: Tuple[int, int], has_gt: bool
) -> Tuple[str, str, Dict]:
    """Build the reference-parity strings + `evals` dict from one window's
    host-resident small bundle (theta_eval.py:44-93). Mutates `small` (pops
    flow_errors) — pass a per-window copy."""
    evals: Dict = {}
    acc_eval_str = ""
    if has_gt:
        fe = small.pop("flow_errors")
        evals.update({k: v for k, v in fe["errors"].items()})
        evals.update({k: v for k, v in fe["counts"].items()})
        evals["n_pixels"] = sensor_size[0] * sensor_size[1]
        e, c = fe["errors"], fe["counts"]
        acc_eval_str = (
            f', AEE(↓): {float(e["AEE"]):8.6f}, AREE(↓): {float(e["AREE"]):8.6f}, '
            + ", ".join(
                f'A{n}PE(↓): {float(e[f"A{n}PE"]):8.6f}' for n in (1, 2, 3, 5, 10, 20)
            )
            + f', | n_pixels:{evals["n_pixels"]:,}, n_gt_mask:{int(c["n_gt"]):,}, '
            + f'n_event_mask:{int(c["n_pred"]):,}, n_ee: {int(c["n_ee"]):,}\n'
        )

    time_str = f'[{time.strftime("%Y-%m-%d %H:%M:%S")}]'
    eval_str = (
        f'total_loss(↓): {float(small["loss"]):8.6f}, '
        f'iwe_var(↑): {float(small["iwe_var"]):8.6f}, '
        f'mean_rel_contrast(↑): {float(small["mean_rel_contrast"]):8.6f}, '
        f'mean_rel_corr(↑): {float(small["mean_rel_corr"]):8.6f}, '
        f'theta_tot_var(↓): {float(small["theta_tot_var"]):8.6f}, '
        f'theta_div(↓): {float(small["theta_div"]):8.6f}, '
        f'mean_rel_iwe_div(↓): {float(small["mean_rel_iwe_div"]):8.6f}, '
        f'FWL(↑): {float(small["fwl"]):8.6f}'
        f"{acc_eval_str}"
    )
    evals.update(small)
    return time_str, eval_str, evals


def _bucket_pad_events(eval_xs, eval_ys, eval_ts, dtype):
    """NaN-pad eval events to a multiple of 8192 (idempotent).

    The raw eval slices vary in length per window and would recompile the
    jitted bundle every time; padded events are sanitized away by every
    consumer. Already-padded arrays (length a multiple of 8192, right dtype)
    pass through unchanged, so callers may pre-pad once per window.
    """
    e = eval_xs.shape[0]
    bucket = max(8192, -(-e // 8192) * 8192)
    # cast BEFORE the padding branch: an exact-multiple window must not
    # slip through at a different dtype (extra recompile + mixed precision)
    eval_xs = eval_xs.astype(dtype)
    eval_ys = eval_ys.astype(dtype)
    eval_ts = eval_ts.astype(dtype)
    if e < bucket:
        fill = jnp.full((bucket - e,), jnp.nan, dtype)
        eval_xs = jnp.concatenate([eval_xs, fill])
        eval_ys = jnp.concatenate([eval_ys, fill])
        eval_ts = jnp.concatenate([eval_ts, fill])
    return eval_xs, eval_ys, eval_ts


def prepare_eval_inputs(
    eval_xs: jax.Array,
    eval_ys: jax.Array,
    eval_ts: jax.Array,
    edges: jax.Array,
    sensor_size: Tuple[int, int],
    dtype=jnp.float32,
):
    """Pad one window's eval events and compute its zero-warp statistics once.

    Returns (padded_xs, padded_ys, padded_ts, window_statics) to thread into
    repeated `evaluate_theta_array` calls over the same window (the
    per-iterate trajectory evaluation would otherwise re-splat the full
    event window's theta-independent statistics for every recorded iterate).
    """
    xs, ys, ts = _bucket_pad_events(eval_xs, eval_ys, eval_ts, dtype)
    wstat = compute_window_statics(xs, ys, edges, sensor_size)
    return xs, ys, ts, wstat


def evaluate_theta_array(
    theta_array: jax.Array,
    eval_xs: jax.Array,
    eval_ys: jax.Array,
    eval_ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    gt_flow: Optional[jax.Array],
    params: LossParams,
    sensor_size: Tuple[int, int],
    err_eval_event_mask: Optional[jax.Array] = None,
    window_statics=None,
) -> Tuple[str, str, Dict, Dict]:
    """Evaluate a full-sensor theta over one window.

    Returns:
        (time_str, eval_str, evals, loss_objectives) like the reference.
        `loss_objectives` values remain on device (the warped coordinate
        arrays are large); everything in `evals` is host-resident.

    `window_statics` (from `prepare_eval_inputs`, together with the padded
    events) reuses the theta-independent zero-warp statistics across
    repeated evaluations of one window.
    """
    has_gt = gt_flow is not None
    has_mask = err_eval_event_mask is not None
    dtype = theta_array.dtype
    eval_xs, eval_ys, eval_ts = _bucket_pad_events(
        eval_xs, eval_ys, eval_ts, dtype
    )
    if window_statics is None:
        window_statics = compute_window_statics(
            eval_xs, eval_ys, edges, sensor_size
        )
    if gt_flow is None:
        gt_flow = jnp.zeros((1, 1, 2), dtype)
    if err_eval_event_mask is None:
        err_eval_event_mask = jnp.zeros((1, 1), bool)
    pvec = jnp.asarray(
        [params.alpha, params.beta, params.gamma, params.delta], dtype
    )
    small, loss_obj = _eval_bundle(
        theta_array, eval_xs, eval_ys, eval_ts, edges, edge_ts,
        gt_flow, err_eval_event_mask, pvec, window_statics,
        sensor_size, has_gt, has_mask,
    )
    # ONE host transfer for the whole (small) bundle
    small = jax.device_get(small)
    time_str, eval_str, evals = format_eval_result(small, sensor_size, has_gt)
    return time_str, eval_str, evals, loss_obj
