"""The EINCM bi-modal objective ("C^2Max"): contrast + edge correlation.

Functional port of src/eincm/losses.py:39-276, restructured for one
on-device solve:

- `compute_window_statics` hoists every theta-independent quantity (zero-warp
  IWE, its contrast/correlation/divergence, the event mask) out of the
  optimizer loop. The reference recomputes all of these on every BFGS
  function evaluation (src/eincm/losses.py:49-105); here they are computed
  once per event window.
- The multi-reference warp shares a single theta gather
  (`warp_events_multi_ref`) instead of re-gathering per reference time.
- All shapes are static; the per-window loss jits once per pyramid level.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from functools import partial
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from eincm_tpu.models.objectives import (
    compute_fwl,
    compute_mean_gradient_magnitude,
    compute_mean_squared_error,
    iwe_divergence,
    per_pix_theta_divergence,
)
from eincm_tpu.ops.filters import scharr_grads
from eincm_tpu.ops.normalize import normalize_to_unit_range
from eincm_tpu.ops.resize import scale_theta_to_sensor_size
from eincm_tpu.ops.splat import (
    events_to_pdf_frame,
    make_event_mask,
    splat_multi_ref,
)
from eincm_tpu.ops.warp import (
    warp_events_multi_ref,
    warp_events_multi_ref_coarse,
)

EPSN = sys.float_info.epsilon


def _sanitize_events(xs, ys, ts):
    """Replace NaN padding events by a FAR off-sensor sentinel.

    NaN coordinates are dropped correctly by every forward op, but they
    poison the BACKWARD pass: the warp VJP multiplies zero cotangents by
    NaN interp weights / NaN dts (NaN*0 = NaN) and the contamination reaches
    dtheta. A finite off-sensor event (x = y = -1e4, t = 0) contributes zero
    to every splat/mask/objective while keeping all gradient paths finite.

    The sentinel must sit far beyond any physical flow magnitude: the WARPED
    coordinate is sentinel - theta*dt, and the theta gathered at the
    sentinel is arbitrary (negative indices wrap, far-out-of-range clamps),
    so a near-sensor sentinel (an earlier -10) re-entered the sensor and
    splatted phantom mass whenever |theta|*dt exceeded ~8.5 px — routine at
    DSEC flow scales. At -1e4 re-entry would need |theta|*dt ~ 1e4 px.
    (The opt-in wrap-compat splat only wraps indices in [-n, -1]; -1e4 is
    beyond it and stays dropped. exp(-0.5*q^2) underflows to 0, not NaN.)
    """
    finite = jnp.isfinite(xs) & jnp.isfinite(ys) & jnp.isfinite(ts)
    sent = jnp.asarray(-1e4, xs.dtype)
    zero = jnp.asarray(0.0, ts.dtype)
    return (
        jnp.where(finite, xs, sent),
        jnp.where(finite, ys, sent),
        jnp.where(finite, ts, zero),
    )


@dataclass(frozen=True)
class LossParams:
    """Objective weights (reference: loss_func args, src/eincm/losses.py:115-118).

    alpha: contrast weight, beta: edge-correlation weight,
    gamma: total-variation weight, delta: IWE-divergence weight.
    """

    alpha: float
    beta: float
    gamma: float = 0.0
    delta: float = 0.0


@dataclass(frozen=True)
class LossStatics:
    """Trace-time constants of the loss."""

    sensor_size: Tuple[int, int]
    n_pyr_lvls: int
    scale_to_sensor_size_method: str = "bilinear"


class WindowStatics(NamedTuple):
    """Theta-independent per-window quantities (see module docstring)."""

    zero_iwe: jax.Array  # (H, W)
    normalized_zero_iwe: jax.Array  # (H, W)
    zero_contrast: jax.Array  # ()
    zero_corrs: jax.Array  # (n_refs,)
    zero_iwe_divergence: jax.Array  # ()
    event_mask: jax.Array  # (H, W) bool


def compute_weights_for_multi_reference(n_refs: int, n_sigma: float = 1.5) -> np.ndarray:
    """Gaussian weights over reference times, normalized to sum 1.

    Reference: src/eincm/losses.py:39-46 (host-side scipy.stats, static at
    trace time). Implemented with plain numpy.
    """
    q = np.linspace(-n_sigma, n_sigma, n_refs)
    w = np.exp(-0.5 * q * q) / math.sqrt(2.0 * math.pi)
    return w / w.sum()


@partial(jax.jit, static_argnames=("sensor_size",))
def compute_window_statics(
    xs: jax.Array,
    ys: jax.Array,
    edges: jax.Array,
    sensor_size: Tuple[int, int],
) -> WindowStatics:
    """Precompute all theta-independent loss inputs for one event window."""
    zero_iwe = events_to_pdf_frame(xs, ys, sensor_size)
    nzi = normalize_to_unit_range(zero_iwe)
    zero_contrast = compute_mean_gradient_magnitude(zero_iwe)
    zero_corrs = -jax.vmap(compute_mean_squared_error, (0, None))(edges, nzi)
    zero_div = iwe_divergence(nzi)
    mask = make_event_mask(xs, ys, sensor_size)
    return WindowStatics(zero_iwe, nzi, zero_contrast, zero_corrs, zero_div, mask)


def _theta_objectives(
    scaled_theta: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    statics: WindowStatics,
    sensor_size: Tuple[int, int],
) -> Dict[str, jax.Array]:
    """Theta-dependent objective bundle, given precomputed window statics."""
    dtype = scaled_theta.dtype
    epsn = jnp.asarray(EPSN, dtype)
    xs, ys, ts = _sanitize_events(xs, ys, ts)

    warped_xs, warped_ys = warp_events_multi_ref(
        scaled_theta, xs, ys, ts, edge_ts, 1.0
    )  # (n_refs, E)

    iwes = splat_multi_ref(warped_xs, warped_ys, sensor_size)  # (n_refs, H, W)
    normalized_iwes = jax.vmap(normalize_to_unit_range)(iwes)

    corrs = -jax.vmap(compute_mean_squared_error)(edges, normalized_iwes)
    contrasts = jax.vmap(compute_mean_gradient_magnitude)(iwes)
    iwe_divs = jax.vmap(iwe_divergence)(normalized_iwes)
    fwls = jax.vmap(compute_fwl, (0, None))(iwes, statics.zero_iwe)

    rel_corrs = corrs / (statics.zero_corrs + epsn)
    rel_contrasts = contrasts / (statics.zero_contrast + epsn)
    rel_iwe_divs = iwe_divs / (statics.zero_iwe_divergence + epsn)

    # Total variation over the event-masked flow field; the mask is a window
    # static, so reuse it instead of re-deriving it from events.
    flow = scaled_theta * statics.event_mask[..., None].astype(dtype)
    gx = scharr_grads(flow[..., 0])
    gy = scharr_grads(flow[..., 1])
    nz = (
        (jnp.abs(gx[..., 0]) > 0)
        | (jnp.abs(gx[..., 1]) > 0)
        | (jnp.abs(gy[..., 0]) > 0)
        | (jnp.abs(gy[..., 1]) > 0)
    )
    l1 = 0.25 * (
        jnp.abs(gx[..., 0]) + jnp.abs(gx[..., 1])
        + jnp.abs(gy[..., 0]) + jnp.abs(gy[..., 1])
    )
    tv = l1.sum() / (nz.sum() + epsn)

    multi_ref_weights = jnp.asarray(
        compute_weights_for_multi_reference(n_refs=edges.shape[0]), dtype
    )

    return {
        "warped_xs": warped_xs,
        "warped_ys": warped_ys,
        "correlations": corrs,
        "zero_correlations": statics.zero_corrs,
        "rel_correlations": rel_corrs,
        "contrasts": contrasts,
        "zero_contrast": statics.zero_contrast,
        "rel_contrasts": rel_contrasts,
        "theta_total_variation": tv,
        "iwe_divergences": iwe_divs,
        "zero_iwe_divergence": statics.zero_iwe_divergence,
        "rel_iwe_divergences": rel_iwe_divs,
        "flow_warp_losses": fwls,
        "multi_ref_weights": multi_ref_weights,
    }


def compute_loss_objectives(
    theta: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    sensor_size: Tuple[int, int],
    window_statics: WindowStatics | None = None,
) -> Dict[str, jax.Array]:
    """Full objective bundle for a full-sensor theta — evaluation entry point.

    Mirrors reference `compute_loss_objectives` (src/eincm/losses.py:49-105),
    including the theta-independent zero-warp statistics and the
    theta-divergence diagnostic. `window_statics` may be supplied to reuse
    the zero-warp statistics across repeated evaluations of one window
    (e.g. per-iterate evaluation of a recorded solve trajectory).
    """
    statics = (
        window_statics
        if window_statics is not None
        else compute_window_statics(xs, ys, edges, sensor_size)
    )
    objs = _theta_objectives(theta, xs, ys, ts, edges, edge_ts, statics, sensor_size)
    objs["theta_divergence"] = per_pix_theta_divergence(theta)
    return objs


def loss_from_objectives(
    objs: Dict[str, jax.Array],
    params: LossParams,
    cur_pyr_lvl: int,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Combine the objective bundle into the final scalar loss.

    Reference: src/eincm/losses.py:167-205. TV is applied only at the finest
    pyramid level (cur_pyr_lvl <= 0, src/eincm/losses.py:171).
    """
    dtype = objs["contrasts"].dtype
    epsn = jnp.asarray(EPSN, dtype)
    w = objs["multi_ref_weights"]

    tv = objs["theta_total_variation"] if cur_pyr_lvl <= 0 else jnp.zeros((), dtype)

    rel_corrs = (w * objs["correlations"]) / (objs["zero_correlations"] + epsn)
    rel_contrasts = (w * objs["contrasts"]) / (objs["zero_contrast"] + epsn)
    rel_divs = (w * objs["iwe_divergences"]) / (objs["zero_iwe_divergence"] + epsn)

    mean_rel_corr = rel_corrs.mean()
    mean_rel_contrast = rel_contrasts.mean()
    mean_rel_iwe_divergence = rel_divs.mean()

    contrast_correlation_loss = (
        params.alpha * (-mean_rel_contrast) + params.beta * (-mean_rel_corr)
    )
    regularization_loss = params.gamma * tv + params.delta * mean_rel_iwe_divergence
    final_loss = contrast_correlation_loss + regularization_loss

    aux = {
        "final_loss": final_loss,
        "mean_rel_corr": mean_rel_corr,
        "mean_rel_contrast": mean_rel_contrast,
        "mean_rel_iwe_divergence": mean_rel_iwe_divergence,
        "theta_total_variation": tv,
        "multi_ref_weights": w,
    }
    return final_loss, aux


def loss_func(
    theta: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    params: LossParams,
    cur_pyr_lvl: int,
    statics: LossStatics,
    window_statics: WindowStatics | None = None,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """The C^2Max loss of a (coarse) theta over one event window.

    Reference: src/eincm/losses.py:108-205. `window_statics` may be supplied
    to skip recomputation of theta-independent terms inside optimizer loops.
    """
    scaled_theta = scale_theta_to_sensor_size(
        theta, statics.sensor_size, statics.scale_to_sensor_size_method
    )
    if window_statics is None:
        window_statics = compute_window_statics(xs, ys, edges, statics.sensor_size)
    objs = _theta_objectives(
        scaled_theta, xs, ys, ts, edges, edge_ts, window_statics, statics.sensor_size
    )
    loss, aux = loss_from_objectives(objs, params, cur_pyr_lvl)
    aux["scaled_theta"] = scaled_theta
    return loss, aux


def _solver_loss_tail(
    warped_xs: jax.Array,
    warped_ys: jax.Array,
    edges: jax.Array,
    params: LossParams,
    window_statics: WindowStatics,
    sensor_size: Tuple[int, int],
) -> jax.Array:
    """Shared level-shape-independent part of the lean loss: splat the
    (n_refs, E) warped events and combine contrast/correlation(/divergence).

    Factored out so `solver_loss` (static level) and `solver_loss_dyn`
    (traced level) are the same math by construction — this is also the
    expensive subgraph, which the scan-over-levels solver traces ONCE
    instead of once per pyramid level.
    """
    dtype = warped_xs.dtype
    epsn = jnp.asarray(EPSN, dtype)
    w = jnp.asarray(
        compute_weights_for_multi_reference(n_refs=edges.shape[0]), dtype
    )

    iwes = splat_multi_ref(warped_xs, warped_ys, sensor_size)
    normalized_iwes = jax.vmap(normalize_to_unit_range)(iwes)

    corrs = -jax.vmap(compute_mean_squared_error)(edges, normalized_iwes)
    contrasts = jax.vmap(compute_mean_gradient_magnitude)(iwes)

    rel_corrs = (w * corrs) / (window_statics.zero_corrs + epsn)
    rel_contrasts = (w * contrasts) / (window_statics.zero_contrast + epsn)
    loss = params.alpha * (-rel_contrasts.mean()) + params.beta * (
        -rel_corrs.mean()
    )

    if params.delta != 0.0:
        divs = jax.vmap(iwe_divergence)(normalized_iwes)
        rel_divs = (w * divs) / (window_statics.zero_iwe_divergence + epsn)
        loss = loss + params.delta * rel_divs.mean()
    return loss


def _masked_tv(
    scaled_theta: jax.Array, event_mask: jax.Array
) -> jax.Array:
    """Event-masked L1 total variation (reference regularizers.py:14-38)."""
    dtype = scaled_theta.dtype
    epsn = jnp.asarray(EPSN, dtype)
    flow = scaled_theta * event_mask[..., None].astype(dtype)
    gx = scharr_grads(flow[..., 0])
    gy = scharr_grads(flow[..., 1])
    nz = (
        (jnp.abs(gx[..., 0]) > 0)
        | (jnp.abs(gx[..., 1]) > 0)
        | (jnp.abs(gy[..., 0]) > 0)
        | (jnp.abs(gy[..., 1]) > 0)
    )
    l1 = 0.25 * (
        jnp.abs(gx[..., 0]) + jnp.abs(gx[..., 1])
        + jnp.abs(gy[..., 0]) + jnp.abs(gy[..., 1])
    )
    return l1.sum() / (nz.sum() + epsn)


def solver_loss(
    theta: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    params: LossParams,
    cur_pyr_lvl: int,
    statics: LossStatics,
    window_statics: WindowStatics,
) -> jax.Array:
    """Lean optimization-path loss — numerically equal to `loss_func`'s
    scalar, with everything the optimizer doesn't need stripped out:

    - per-event theta comes straight from the coarse grid (fused bilinear
      interp; no full-sensor gather and no scatter in the VJP);
    - FWL is never computed (it is a metric, not a loss term);
    - IWE divergence is skipped when delta == 0, TV when gamma == 0 or the
      pyramid level gates it off (src/eincm/losses.py:171).

    The reference evaluates the full bundle on every BFGS iteration
    (src/eincm/losses.py:49-105); the objective value is identical.
    """
    sensor_size = statics.sensor_size
    xs, ys, ts = _sanitize_events(xs, ys, ts)

    if statics.scale_to_sensor_size_method == "bilinear":
        warped_xs, warped_ys = warp_events_multi_ref_coarse(
            theta, xs, ys, ts, edge_ts, sensor_size
        )
    else:
        scaled = scale_theta_to_sensor_size(
            theta, sensor_size, statics.scale_to_sensor_size_method
        )
        warped_xs, warped_ys = warp_events_multi_ref(
            scaled, xs, ys, ts, edge_ts, 1.0
        )

    loss = _solver_loss_tail(
        warped_xs, warped_ys, edges, params, window_statics, sensor_size
    )

    if params.gamma != 0.0 and cur_pyr_lvl <= 0:
        scaled = scale_theta_to_sensor_size(
            theta, sensor_size, statics.scale_to_sensor_size_method
        )
        tv = _masked_tv(scaled, window_statics.event_mask)
        loss = loss + params.gamma * tv

    return loss


def solver_loss_dyn(
    flat_theta_pad: jax.Array,
    lvl: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    params: LossParams,
    statics: LossStatics,
    window_statics: WindowStatics,
    level_shapes: Tuple[Tuple[int, int], ...],
) -> jax.Array:
    """`solver_loss` with a TRACED pyramid level over a padded flat theta.

    The scan-over-levels solver's loss: `flat_theta_pad` is the finest
    level's flat size with coarser levels' thetas in its prefix; `lvl`
    selects, via `lax.switch`, a tiny per-level branch (slice + reshape +
    coarse warp — the only level-shape-dependent ops), and everything
    expensive (`_solver_loss_tail`) is traced once, shared by all levels.

    Per-level numerics are identical to `solver_loss(theta_l, ...,
    cur_pyr_lvl=l)`: the selected warp branch is the same computation, the
    tail is the same function, and the TV term's level gate becomes an
    exact multiply-by-zero at levels > 0 (reference gates TV to the finest
    level, src/eincm/losses.py:171).
    """
    dtype = flat_theta_pad.dtype
    sensor_size = statics.sensor_size
    xs, ys, ts = _sanitize_events(xs, ys, ts)

    def warp_branch(shape):
        h, wd = shape
        d = h * wd * 2

        def br(flat, bxs, bys, bts):
            theta = flat[:d].reshape(h, wd, 2)
            if statics.scale_to_sensor_size_method == "bilinear":
                return warp_events_multi_ref_coarse(
                    theta, bxs, bys, bts, edge_ts, sensor_size
                )
            scaled = scale_theta_to_sensor_size(
                theta, sensor_size, statics.scale_to_sensor_size_method
            )
            return warp_events_multi_ref(scaled, bxs, bys, bts, edge_ts, 1.0)

        return br

    warped_xs, warped_ys = jax.lax.switch(
        lvl, [warp_branch(s) for s in level_shapes], flat_theta_pad, xs, ys, ts
    )

    loss = _solver_loss_tail(
        warped_xs, warped_ys, edges, params, window_statics, sensor_size
    )

    if params.gamma != 0.0:

        def scale_branch(shape):
            h, wd = shape
            d = h * wd * 2

            def br(flat):
                return scale_theta_to_sensor_size(
                    flat[:d].reshape(h, wd, 2),
                    sensor_size,
                    statics.scale_to_sensor_size_method,
                )

            return br

        scaled = jax.lax.switch(
            lvl, [scale_branch(s) for s in level_shapes], flat_theta_pad
        )
        tv = _masked_tv(scaled, window_statics.event_mask)
        gate = jnp.where(
            lvl <= 0,
            jnp.asarray(params.gamma, dtype),
            jnp.asarray(0.0, dtype),
        )
        loss = loss + gate * tv

    return loss


def handover_loss_func(
    alpha_handover: jax.Array,
    prev_theta: jax.Array,
    theta: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    params: LossParams,
    cur_pyr_lvl: int,
    statics: LossStatics,
    window_statics: WindowStatics | None = None,
) -> jax.Array:
    """Loss of the blended theta w*prev + (1-w)*cur as a function of w.

    Reference: src/eincm/losses.py:208-276.
    """
    theta_ho = alpha_handover * prev_theta + (1.0 - alpha_handover) * theta
    loss, _ = loss_func(
        theta_ho, xs, ys, ts, edges, edge_ts, params, cur_pyr_lvl, statics,
        window_statics,
    )
    return loss
