"""Image-of-Warped-Events (IWE) accumulation by scatter-add.

The reference builds the IWE by scatter-adding a 3x3 window of 2-D standard
normal pdf values around each (rounded) warped event coordinate
(reference: src/utils/event_utils.py:13-61, `events_to_pdf_frame`). That is
the design here too: each event touches window_size**2 texels, and XLA emits
one scatter kernel whose colliding updates resolve with atomic adds.

Gradients flow through the pdf values only; the window placement (round)
has zero gradient — identical to the reference, where the integer cast is
non-differentiable. The VJP of the scatter-add is a gather of the cotangent
at the same texels.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

# Opt-in reproduction of the reference's negative-index wrap (a JAX
# negative-indexing artifact where splat mass at coordinate -k teleports to
# the opposite sensor edge; src/utils/event_utils.py:59). For bit-level
# parity studies only — physically the drop behavior is correct.
_SPLAT_WRAP_COMPAT = False


def set_splat_wrap_compat(enable: bool) -> None:
    """Toggle the wrap-compat splat. Consulted at TRACE time: set it before
    the first jitted call of a given shape (already-compiled programs are
    not retraced)."""
    global _SPLAT_WRAP_COMPAT
    _SPLAT_WRAP_COMPAT = bool(enable)


def _gauss1d(q: jax.Array) -> jax.Array:
    """Standard normal pdf, one axis of the separable 2-D splat kernel."""
    return jnp.exp(-0.5 * q * q) * jnp.asarray(_INV_SQRT_2PI, q.dtype)


def _texel_index(
    t: jax.Array, n: int, wrap: bool
) -> Tuple[jax.Array, jax.Array]:
    """Integer texel indices along one axis and their in-sensor mask.

    `t` holds float texel coordinates (exact integers, or NaN for dropped
    events). With `wrap`, coordinates in [-n, -1] land at n + t, as the
    reference's negative indexing does before its out-of-range drop."""
    if wrap:
        t = jnp.where((t < 0) & (t >= -n), t + n, t)
    valid = (t >= 0) & (t <= n - 1)  # False for NaN
    return jnp.where(valid, t, 0).astype(jnp.int32), valid


def events_to_pdf_frame(
    xs: jax.Array,
    ys: jax.Array,
    sensor_size: Tuple[int, int] = (260, 346),
    window_size: int = 3,
) -> jax.Array:
    """IWE of warped events: one scatter-add of every event's window.

    Matches reference `events_to_pdf_frame` (src/utils/event_utils.py:13-61):
    each event deposits a window_size x window_size patch of 2-D standard
    normal pdf values centred at its rounded coordinate. Out-of-sensor texels
    and NaN events are dropped (the reference wraps negative indices; see
    `set_splat_wrap_compat`).

    Args:
        xs, ys: (E,) float warped event coordinates (x = column, y = row).
        sensor_size: (H, W).
        window_size: odd window size; radius = window_size // 2.

    Returns:
        (H, W) accumulation frame in at least float32 (float64 for x64
        inputs).
    """
    H, W = sensor_size
    hw = window_size // 2
    dtype = jnp.result_type(xs.dtype, jnp.float32)
    xs = xs.astype(dtype)
    ys = ys.astype(dtype)
    d = jnp.arange(-hw, hw + 1, dtype=dtype)
    cols = jnp.round(xs)[:, None] + d  # (E, k)
    rows = jnp.round(ys)[:, None] + d
    gx = _gauss1d(cols - xs[:, None])
    gy = _gauss1d(rows - ys[:, None])
    ci, cvalid = _texel_index(cols, W, _SPLAT_WRAP_COMPAT)
    ri, rvalid = _texel_index(rows, H, _SPLAT_WRAP_COMPAT)
    valid = rvalid[:, :, None] & cvalid[:, None, :]  # (E, k, k)
    pdf = jnp.where(valid, gy[:, :, None] * gx[:, None, :], 0.0)
    # dropped texels get the one-past-the-end index, which mode="drop" skips
    flat = jnp.where(valid, ri[:, :, None] * W + ci[:, None, :], H * W)
    frame = jnp.zeros((H * W,), dtype).at[flat.ravel()].add(
        pdf.ravel(), mode="drop"
    )
    return frame.reshape(H, W)


def splat_multi_ref(
    warped_xs: jax.Array,
    warped_ys: jax.Array,
    sensor_size: Tuple[int, int],
    window_size: int = 3,
) -> jax.Array:
    """(n_refs, E) warped coords -> (n_refs, H, W) IWEs."""
    splat = partial(
        events_to_pdf_frame, sensor_size=sensor_size, window_size=window_size
    )
    return jax.vmap(splat)(warped_xs, warped_ys)


def events_to_pdf_frame_scatter(
    xs: jax.Array,
    ys: jax.Array,
    sensor_size: Tuple[int, int] = (260, 346),
    window_size: int = 3,
) -> jax.Array:
    """IWE via one 2-D scatter-add per window tap — the plain reference
    that `events_to_pdf_frame` is tested against.

    Same math as the reference kernel (src/utils/event_utils.py:31-61) with
    one deliberate deviation: the reference's `.at[rs, cs].add(mode='drop')`
    applies Python negative-index *wrapping* before dropping, so splat texels
    at coordinate -1..-n wrap to the opposite sensor edge. That is a physical
    artifact (mass teleports across the sensor); this oracle drops
    out-of-sensor texels on every side, like the default splat.
    """
    H, W = sensor_size
    dtype = jnp.result_type(xs.dtype, jnp.float32)
    xs = xs.astype(dtype)
    ys = ys.astype(dtype)
    rx = jnp.round(xs)
    ry = jnp.round(ys)
    rxi = rx.astype(jnp.int32)
    ryi = ry.astype(jnp.int32)

    frame = jnp.zeros((H, W), dtype)
    hw = window_size // 2
    for dx in range(-hw, hw + 1):
        for dy in range(-hw, hw + 1):
            qx = (rx + dx) - xs
            qy = (ry + dy) - ys
            pdf = _gauss1d(qx) * _gauss1d(qy)
            # NaN coords must drop, not poison pixel (0,0) via int-cast UB;
            # negative indices are forced out-of-range so 'drop' really drops
            # them instead of wrapping.
            valid = jnp.isfinite(qx) & jnp.isfinite(qy)
            pdf = jnp.where(valid, pdf, 0.0)
            rows = jnp.where(valid & (ryi + dy >= 0), ryi + dy, H)
            cols = jnp.where(valid & (rxi + dx >= 0), rxi + dx, W)
            frame = frame.at[rows, cols].add(pdf, mode="drop")
    return frame


def event_counts(
    xs: jax.Array,
    ys: jax.Array,
    sensor_size: Tuple[int, int],
) -> jax.Array:
    """Per-pixel event counts by scatter-add.

    Coordinates are truncated toward zero like the reference's
    `.astype(jnp.int16)` (src/utils/event_utils.py:76); event coordinates are
    integral in practice so trunc == round there. NaN and out-of-sensor
    events are dropped.
    """
    H, W = sensor_size
    xi, xvalid = _texel_index(jnp.trunc(xs.astype(jnp.float32)), W, False)
    yi, yvalid = _texel_index(jnp.trunc(ys.astype(jnp.float32)), H, False)
    flat = jnp.where(xvalid & yvalid, yi * W + xi, H * W)
    counts = jnp.zeros((H * W,), jnp.float32).at[flat].add(1.0, mode="drop")
    return counts.reshape(H, W)


def make_event_mask(
    xs: jax.Array, ys: jax.Array, sensor_size: Tuple[int, int]
) -> jax.Array:
    """Boolean mask of pixels containing at least one event.

    Reference: src/utils/event_utils.py:64-77 (`make_event_mask`).
    """
    return event_counts(xs, ys, sensor_size) > 0
