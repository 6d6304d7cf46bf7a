"""Native event-ingest kernels (events.cpp) vs the numpy reference path."""

import numpy as np
import pytest

from eincm_tpu.native import events as ne

pytestmark = pytest.mark.skipif(
    not ne.available(), reason="native library did not build"
)


def _numpy_rectify(x, y, t, p, rectify_map, sensor_size):
    """The loader's numpy path (reference: dsec_loader.py:145-171)."""
    h, w = sensor_size
    rect = rectify_map[y, x]
    rx = np.round(rect[:, 0]).astype(np.int16)
    ry = np.round(rect[:, 1]).astype(np.int16)
    keep = (rx >= 0) & (rx < w) & (ry >= 0) & (ry < h)
    return rx[keep], ry[keep], t[keep], p[keep]


def test_rectify_filter_matches_numpy():
    rng = np.random.default_rng(0)
    h, w, n = 60, 80, 200_000
    x = rng.integers(0, w, n).astype(np.uint16)
    y = rng.integers(0, h, n).astype(np.uint16)
    t = np.sort(rng.integers(0, 10**9, n)).astype(np.int64)
    p = rng.integers(0, 2, n).astype(np.uint8)
    # rectify map with distortion pushing ~20% of events out of the sensor
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    m = np.stack(
        [gx + rng.normal(0, 6, (h, w)).astype(np.float32) + 0.123,
         gy + rng.normal(0, 6, (h, w)).astype(np.float32) + 0.123],
        axis=-1,
    )

    ox, oy, ot, op = ne.rectify_filter_events(x, y, t, p, m, (h, w))
    ex, ey, et, ep = _numpy_rectify(x, y, t, p, m, (h, w))
    assert len(ox) == len(ex) and len(ox) < n  # some events dropped
    np.testing.assert_array_equal(ox, ex)
    np.testing.assert_array_equal(oy, ey)
    np.testing.assert_array_equal(ot, et)
    np.testing.assert_array_equal(op, ep)


def test_rectify_half_tie_rounding_matches_numpy():
    """Exact .5 coordinates must round half-to-EVEN like np.round
    (dsec_loader.py:153-154): 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0.
    Real rectify maps do land on exact halves (caught by the warped-geometry
    loader parity harness; C++ rint under FE_TONEAREST matches, lround did
    not)."""
    h, w = 6, 8
    n = w  # one event per column of row 0
    x = np.arange(w, dtype=np.uint16)
    y = np.zeros(n, np.uint16)
    t = np.arange(n, dtype=np.int64)
    p = np.ones(n, np.uint8)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    m = np.stack([gx - 0.5, gy + 0.5], axis=-1)  # every coord an exact tie

    ox, oy, ot, op = ne.rectify_filter_events(x, y, t, p, m, (h, w))
    ex, ey, et, ep = _numpy_rectify(x, y, t, p, m, (h, w))
    np.testing.assert_array_equal(ox, ex)
    np.testing.assert_array_equal(oy, ey)
    np.testing.assert_array_equal(ot, et)
    np.testing.assert_array_equal(op, ep)


def test_rectify_all_kept_identity_map():
    h, w, n = 8, 8, 1000
    rng = np.random.default_rng(1)
    x = rng.integers(0, w, n).astype(np.uint16)
    y = rng.integers(0, h, n).astype(np.uint16)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    m = np.stack([gx, gy], axis=-1)
    ox, oy, ot, op = ne.rectify_filter_events(
        x, y, np.arange(n, dtype=np.int64), np.zeros(n, np.uint8), m, (h, w)
    )
    assert len(ox) == n
    np.testing.assert_array_equal(ox, x.astype(np.int16))
    np.testing.assert_array_equal(oy, y.astype(np.int16))
    np.testing.assert_array_equal(ot, np.arange(n))

def test_rectify_filter_multiworker_heavy_early_drops():
    """Regression: with n large enough for multiple workers and most drops
    concentrated in the FIRST workers' ranges, the in-place pass-2
    compaction used to race — worker k's destination slots (global prefix
    counts[k]) lie inside earlier workers' still-being-read ranges. The
    fixed kernel compacts from a scratch buffer and must match numpy
    exactly at any worker count."""
    rng = np.random.default_rng(5)
    h, w = 48, 64
    n = (4 << 20) + 12345  # > 4 worker grains of 2^20
    # x correlated with index: early events land at low columns, which the
    # map pushes off-sensor -> worker 0 drops nearly everything
    x = ((np.arange(n) * w) // n).astype(np.uint16)
    y = rng.integers(0, h, n).astype(np.uint16)
    t = np.arange(n, dtype=np.int64)
    p = rng.integers(0, 2, n).astype(np.uint8)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    m = np.stack([gx, gy], axis=-1)
    m[:, : w // 3, 0] = -5.0  # first third of the columns rectify off-sensor

    ox, oy, ot, op = ne.rectify_filter_events(x, y, t, p, m, (h, w))
    ex, ey, et, ep = _numpy_rectify(x, y, t, p, m, (h, w))
    assert len(ex) < n * 3 // 4  # the drop pattern actually engaged
    np.testing.assert_array_equal(ox, ex)
    np.testing.assert_array_equal(oy, ey)
    np.testing.assert_array_equal(ot, et)
    np.testing.assert_array_equal(op, ep)
