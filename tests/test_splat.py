"""The scatter-add splat must agree with the per-tap scatter oracle."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eincm_tpu.ops.splat import (
    event_counts,
    events_to_pdf_frame,
    events_to_pdf_frame_scatter,
    make_event_mask,
    splat_multi_ref,
)

SENSOR = (24, 32)

# sensor widths of the reference deployments (ECD, MVSEC, DSEC) at reduced
# event counts
WIDTHS = {"ecd": (180, 240), "mvsec": (256, 336), "dsec": (480, 640)}
CASES = ("spill", "nan_pad", "sentinel_pad", "out_of_sensor")


def _rand_events(rng, n, sensor=SENSOR, spread=3.0):
    h, w = sensor
    xs = rng.uniform(-spread, w - 1 + spread, n).astype(np.float32)
    ys = rng.uniform(-spread, h - 1 + spread, n).astype(np.float32)
    return xs, ys


def _case_events(rng, sensor, case, n=3000):
    """Warped coordinates for one edge case:
    - spill: windows crossing every sensor edge;
    - nan_pad: NaN padding at the end (staging's pad value);
    - sentinel_pad: the loss layer's finite far off-sensor sentinel;
    - out_of_sensor: a third of the events wholly outside the sensor."""
    xs, ys = _rand_events(rng, n, sensor, spread=2.0)
    if case == "nan_pad":
        xs[-n // 10:] = np.nan
        ys[-n // 10:] = np.nan
    elif case == "sentinel_pad":
        xs[-n // 10:] = -1e4
        ys[-n // 10:] = -1e4
    elif case == "out_of_sensor":
        h, w = sensor
        k = n // 3
        xs[:k] = rng.uniform(w + 2, w + 50, k)
        ys[k:2 * k] = rng.uniform(-50, -2.6, k)
    return jnp.asarray(xs), jnp.asarray(ys)


def test_single_event_center_mass():
    # One event at an exact integer coord: 3x3 patch of N(0,I) pdf values.
    xs = jnp.array([5.0])
    ys = jnp.array([7.0])
    frame = events_to_pdf_frame(xs, ys, SENSOR)
    peak = 1.0 / (2.0 * math.pi)
    assert np.isclose(float(frame[7, 5]), peak, rtol=1e-6)
    assert np.isclose(float(frame[7, 6]), peak * math.exp(-0.5), rtol=1e-6)
    assert np.isclose(float(frame[8, 6]), peak * math.exp(-1.0), rtol=1e-6)
    assert float(frame[7, 8]) == 0.0  # outside window
    # total mass = sum of the 3x3 patch
    g = [math.exp(0), 2 * math.exp(-0.5)]
    mass = (g[0] + g[1]) ** 2 / (2 * math.pi)
    assert np.isclose(float(frame.sum()), mass, rtol=1e-5)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_splat_matches_oracle(rng, width, case):
    sensor = WIDTHS[width]
    xs, ys = _case_events(rng, sensor, case)
    a = events_to_pdf_frame(xs, ys, sensor)
    b = events_to_pdf_frame_scatter(xs, ys, sensor)
    assert a.shape == sensor and a.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_splat_grad_matches_oracle(rng, width, case):
    sensor = WIDTHS[width]
    xs, ys = _case_events(rng, sensor, case)
    cot = jnp.asarray(rng.normal(0, 1, sensor).astype(np.float32))

    def grads(splat):
        return jax.grad(lambda x, y: (splat(x, y, sensor) * cot).sum(),
                        argnums=(0, 1))(xs, ys)

    ga = grads(events_to_pdf_frame)
    gb = grads(events_to_pdf_frame_scatter)
    # NaN events carry no gradient path (the loss layer sanitizes them
    # first); compare the finite events
    fin = np.isfinite(np.asarray(xs)) & np.isfinite(np.asarray(ys))
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(np.asarray(a)[fin], np.asarray(b)[fin],
                                   rtol=1e-5, atol=1e-7)
    if case == "sentinel_pad":
        assert np.all(np.asarray(ga[0])[-300:] == 0.0)


@pytest.mark.parametrize("n_refs", [1, 2, 3])
def test_splat_multi_ref_matches_oracle(rng, n_refs):
    sensor = WIDTHS["mvsec"]
    xs, ys = _rand_events(rng, n_refs * 2000, sensor)
    wx = jnp.asarray(xs.reshape(n_refs, -1))
    wy = jnp.asarray(ys.reshape(n_refs, -1))
    cot = jnp.asarray(rng.normal(0, 1, (n_refs, *sensor)).astype(np.float32))

    def oracle(x, y):
        return jax.vmap(
            lambda p, q: events_to_pdf_frame_scatter(p, q, sensor))(x, y)

    def ours(x, y):
        return splat_multi_ref(x, y, sensor)

    np.testing.assert_allclose(np.asarray(ours(wx, wy)),
                               np.asarray(oracle(wx, wy)), rtol=1e-5,
                               atol=1e-7)
    for f in (ours, oracle):
        assert f(wx, wy).shape == (n_refs, *sensor)
    ga = jax.grad(lambda x, y: (ours(x, y) * cot).sum(), (0, 1))(wx, wy)
    gb = jax.grad(lambda x, y: (oracle(x, y) * cot).sum(), (0, 1))(wx, wy)
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_splat_keeps_float64(rng):
    xs, ys = _rand_events(rng, 500)
    with jax.enable_x64(True):
        a = events_to_pdf_frame(jnp.asarray(xs, jnp.float64),
                                jnp.asarray(ys, jnp.float64), SENSOR)
        b = events_to_pdf_frame_scatter(jnp.asarray(xs, jnp.float64),
                                        jnp.asarray(ys, jnp.float64), SENSOR)
        assert a.dtype == jnp.float64
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-15)


def test_out_of_bounds_dropped(rng):
    xs = jnp.array([-10.0, 100.0, 5.0])
    ys = jnp.array([5.0, 5.0, -50.0])
    frame = events_to_pdf_frame(xs, ys, SENSOR)
    assert float(frame.sum()) == 0.0


def test_boundary_partial_drop():
    # Event at the corner: only the in-sensor part of the window lands.
    xs = jnp.array([0.0])
    ys = jnp.array([0.0])
    a = events_to_pdf_frame(xs, ys, SENSOR)
    b = events_to_pdf_frame_scatter(xs, ys, SENSOR)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
    assert float(a[0, 0]) > 0


def test_nan_events_dropped(rng):
    xs, ys = _rand_events(rng, 64)
    xs_nan = np.concatenate([xs, [np.nan, 3.0]]).astype(np.float32)
    ys_nan = np.concatenate([ys, [3.0, np.nan]]).astype(np.float32)
    a = events_to_pdf_frame(jnp.asarray(xs_nan), jnp.asarray(ys_nan), SENSOR)
    b = events_to_pdf_frame(jnp.asarray(xs), jnp.asarray(ys), SENSOR)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_window5(rng):
    xs, ys = _rand_events(rng, 200)
    a = events_to_pdf_frame(xs, ys, SENSOR, window_size=5)
    b = events_to_pdf_frame_scatter(xs, ys, SENSOR, window_size=5)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_event_counts_and_mask(rng):
    xs = jnp.array([1.0, 1.0, 2.0, 31.0])
    ys = jnp.array([1.0, 1.0, 3.0, 23.0])
    counts = event_counts(xs, ys, SENSOR)
    assert float(counts[1, 1]) == 2.0
    assert float(counts[3, 2]) == 1.0
    assert float(counts[23, 31]) == 1.0
    assert float(counts.sum()) == 4.0
    mask = make_event_mask(xs, ys, SENSOR)
    assert bool(mask[1, 1]) and bool(mask[3, 2])
    assert not bool(mask[0, 0])


@pytest.mark.parametrize("spread", [0.0, 0.9, 6.0])
def test_event_counts_match_numpy(rng, spread):
    """Counts truncate toward zero (reference .astype(int16)); NaN and
    out-of-sensor events are dropped, negative ones are not wrapped."""
    h, w = SENSOR
    xs, ys = _rand_events(rng, 4000, SENSOR, spread=spread)
    xs[:50] = np.nan
    counts = np.asarray(event_counts(jnp.asarray(xs), jnp.asarray(ys), SENSOR))
    ref = np.zeros(SENSOR)
    fin = np.isfinite(xs) & np.isfinite(ys)
    xi = np.trunc(xs[fin]).astype(int)
    yi = np.trunc(ys[fin]).astype(int)
    keep = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    np.add.at(ref, (yi[keep], xi[keep]), 1.0)
    np.testing.assert_array_equal(counts, ref)


def test_splat_gradient_finite_difference(rng):
    xs, ys = _rand_events(rng, 50)
    xs = jnp.asarray(xs)
    ys = jnp.asarray(ys)

    def f(shift):
        frame = events_to_pdf_frame(xs + shift, ys, SENSOR)
        return (frame**2).sum()

    g = jax.grad(f)(0.0)
    eps = 1e-3
    fd = (f(eps) - f(-eps)) / (2 * eps)
    assert np.isclose(float(g), float(fd), rtol=1e-2)


def test_wrap_compat_mode(rng):
    """Opt-in wrap mode: texels at coordinate -k land at n-k (reference
    negative-index semantics); default mode drops them."""
    from eincm_tpu.ops.splat import set_splat_wrap_compat

    h, w = SENSOR
    # one event whose rounded coord is 0: the dx=-1/dy=-1 texels go negative
    xs = jnp.array([0.2], jnp.float32)
    ys = jnp.array([0.1], jnp.float32)
    g = lambda q: math.exp(-0.5 * q * q) / math.sqrt(2 * math.pi)

    plain = np.asarray(events_to_pdf_frame(xs, ys, SENSOR))
    assert plain[0, w - 1] == 0 and plain[h - 1, 0] == 0

    set_splat_wrap_compat(True)
    try:
        wrapped = np.asarray(events_to_pdf_frame(xs, ys, SENSOR))
    finally:
        set_splat_wrap_compat(False)
    # column -1 wraps to w-1, row -1 wraps to h-1
    np.testing.assert_allclose(
        wrapped[0, w - 1], g(-1 - 0.2) * g(0 - 0.1), rtol=1e-6)
    np.testing.assert_allclose(
        wrapped[h - 1, 0], g(0 - 0.2) * g(-1 - 0.1), rtol=1e-6)
    np.testing.assert_allclose(
        wrapped[h - 1, w - 1], g(-1 - 0.2) * g(-1 - 0.1), rtol=1e-6)
    # in-sensor mass identical to the plain mode
    np.testing.assert_allclose(wrapped[:3, :3], plain[:3, :3], rtol=1e-6)
