"""Per-event warping under a per-pixel velocity field ("theta").

Reference semantics (src/eincm/event_warpers.py:6-37, `per_pix_warp`):
coordinates are rounded to integers, the velocity at that pixel is gathered,
and the event is displaced back in time to `t_ref`:

    x' = round(x) - theta[round(y), round(x), 0] * (t - t_ref) * delta_time
    y' = round(y) - theta[round(y), round(x), 1] * (t - t_ref) * delta_time

The gather indices are the *unwarped* integer event coordinates, which are
fixed for a whole solve — we gather the per-event velocity once and reuse it
for every reference time (the reference instead re-gathers inside a vmap over
reference times, src/eincm/losses.py:26,58).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def gather_theta_at_events(
    theta: jax.Array, xs: jax.Array, ys: jax.Array
) -> jax.Array:
    """Gather per-event velocities theta[round(y), round(x), :] -> (E, 2).

    A plain XLA gather; its VJP w.r.t. theta is a scatter-add."""
    xi = jnp.round(xs).astype(jnp.int32)
    yi = jnp.round(ys).astype(jnp.int32)
    return theta[yi, xi, :]


@jax.jit
def per_pix_warp(
    theta: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    t_ref: jax.Array,
    delta_time: float = 1.0,
) -> Tuple[jax.Array, jax.Array]:
    """Warp events to `t_ref` under per-pixel velocity `theta` (H, W, 2).

    Reference: src/eincm/event_warpers.py:6-37.
    """
    xi = jnp.round(xs)
    yi = jnp.round(ys)
    th = gather_theta_at_events(theta, xs, ys)
    dts = (ts - t_ref) * delta_time
    warped_xs = xi - th[:, 0] * dts
    warped_ys = yi - th[:, 1] * dts
    return warped_xs, warped_ys


def _bilinear_axis_weights(
    pix: jax.Array, coarse_n: int, full_n: int
) -> jax.Array:
    """Normalized triangle weights of full-res pixel centers against the
    coarse grid, matching `jax.image.scale_and_translate(method='bilinear',
    translation=0)` exactly: output center i samples input coordinate
    u = (i + 0.5) / scale - 0.5 with edge-renormalized triangle kernel.

    Args:
        pix: (E,) integer-valued full-res pixel coordinates (float).
        coarse_n: coarse grid size along this axis (h or w).
        full_n: full sensor size along this axis (H or W).

    Returns:
        (E, coarse_n) weights, rows summing to 1.
    """
    dtype = pix.dtype
    u = (pix + 0.5) * (coarse_n / full_n) - 0.5
    k = jax.lax.broadcasted_iota(dtype, (pix.shape[0], coarse_n), 1)
    w = jnp.maximum(0.0, 1.0 - jnp.abs(k - u[:, None]))
    # off-grid (sentinel/padding) events have an all-zero row; guard the
    # normalization so they interpolate to zero with finite gradients
    return w / jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1e-20)


def interp_theta_at_events(
    theta: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    sensor_size: Tuple[int, int],
    chunk: int = 2_097_152,
) -> jax.Array:
    """Per-event velocity sampled from the COARSE theta grid -> (E, 2).

    Numerically equal to
        gather_theta_at_events(scale_theta_to_sensor_size(theta, S,
                               'bilinear'), xs, ys)
    but far cheaper at DSEC scale: instead of materializing the full
    (H, W, 2) field and gathering per event, each event contracts small
    bilinear weights against the (h, w, 2) grid — one (E, h) x (h, w*c)
    matmul per chunk plus a weighted sum over w. The default chunk covers a
    DSEC-scale window (1.5M events) in one chunk.
    """
    h, w, c = theta.shape
    H, W = sensor_size
    dtype = theta.dtype
    xi = jnp.round(xs.astype(dtype))
    yi = jnp.round(ys.astype(dtype))

    e = xi.shape[0]
    # clamp to the (128-rounded) event count: small windows must not pad up
    # to a full default chunk (at 8k events that would waste ~94% of the
    # weight-construction and matmul work on padding, every solver probe)
    chunk = min(chunk, max(128, -(-e // 128) * 128))
    n_chunks = max(1, -(-e // chunk))
    pad = n_chunks * chunk - e
    if pad:
        fill = jnp.full((pad,), 0.0, dtype)
        xi = jnp.concatenate([xi, fill])
        yi = jnp.concatenate([yi, fill])

    theta_flat = theta.reshape(h, w * c)

    def one(cxi, cyi):
        oy = _bilinear_axis_weights(cyi, h, H)  # (E, h)
        ox = _bilinear_axis_weights(cxi, w, W)  # (E, w)
        m = jax.lax.dot_general(
            oy, theta_flat, (((1,), (0,)), ((), ())),
            preferred_element_type=dtype,
            precision=jax.lax.Precision.HIGHEST,
        )  # (E, w*c)
        m = m.reshape(-1, w, c)
        return jnp.sum(m * ox[:, :, None], axis=1)  # (E, c)

    if n_chunks == 1:
        out = one(xi, yi)
    else:
        out = jax.lax.map(
            lambda args: one(*args),
            (xi.reshape(n_chunks, chunk), yi.reshape(n_chunks, chunk)),
        ).reshape(-1, c)
    return out[:e]


def warp_events_multi_ref_coarse(
    theta: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    t_refs: jax.Array,
    sensor_size: Tuple[int, int],
    delta_time: float = 1.0,
) -> Tuple[jax.Array, jax.Array]:
    """Multi-reference warp directly under a coarse theta (fused interp).

    Equal to `warp_events_multi_ref(scale_theta_to_sensor_size(theta), ...)`
    for the 'bilinear' scaling method.
    """
    xi = jnp.round(xs)
    yi = jnp.round(ys)
    th = interp_theta_at_events(theta, xs, ys, sensor_size)  # (E, 2)
    dts = (ts[None, :] - t_refs[:, None]) * delta_time
    warped_xs = xi[None, :] - th[None, :, 0] * dts
    warped_ys = yi[None, :] - th[None, :, 1] * dts
    return warped_xs, warped_ys


def warp_events_multi_ref(
    theta: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    t_refs: jax.Array,
    delta_time: float = 1.0,
) -> Tuple[jax.Array, jax.Array]:
    """Warp the same events to several reference times at once.

    The theta gather happens once; each reference time is then a pure
    elementwise displacement (broadcast over the leading refs axis).

    Returns:
        (n_refs, E) warped xs and ys.
    """
    xi = jnp.round(xs)
    yi = jnp.round(ys)
    th = gather_theta_at_events(theta, xs, ys)  # (E, 2)
    dts = (ts[None, :] - t_refs[:, None]) * delta_time  # (n_refs, E)
    warped_xs = xi[None, :] - th[None, :, 0] * dts
    warped_ys = yi[None, :] - th[None, :, 1] * dts
    return warped_xs, warped_ys
