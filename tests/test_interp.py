"""Coarse-theta interpolation vs the gather of the upscaled field."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eincm_tpu.ops.resize import scale_theta_to_sensor_size
from eincm_tpu.ops.warp import gather_theta_at_events, interp_theta_at_events

SENSOR = (48, 64)

GRID_CASES = [
    (16, 16, 3000, 0.0),
    (1, 1, 257, 0.0),  # level-0 grid, non-128-multiple event count
    (8, 11, 1024, 0.0),  # non-square, non-8-multiple width
    (3, 5, 31, 0.0),
    # off-sensor events (real warped data): the u<0 / u>n-1 edge
    # renormalization branch of the axis weights
    (16, 16, 2048, 25.0),
    (4, 6, 513, 3.0),
]


def _case(rng, n, gh, gw, spread=0.0):
    H, W = SENSOR
    xs = jnp.asarray(
        np.round(rng.uniform(-spread, W - 1 + spread, n)).astype(np.float32)
    )
    ys = jnp.asarray(
        np.round(rng.uniform(-spread, H - 1 + spread, n)).astype(np.float32)
    )
    theta = jnp.asarray(rng.normal(0, 3, (gh, gw, 2)).astype(np.float32))
    return theta, xs, ys


def _upscaled_gather(theta, xs, ys):
    full = scale_theta_to_sensor_size(theta, SENSOR, "bilinear")
    return gather_theta_at_events(full, xs, ys)


def _triangle_ref(theta, xs, ys):
    """float64 numpy bilinear sampling with edge-renormalized triangle
    weights, the rule `scale_and_translate` applies inside the sensor,
    extended to off-sensor events (all-zero weights give 0)."""
    theta = np.asarray(theta, np.float64)
    gh, gw, _ = theta.shape
    H, W = SENSOR

    def weights(pix, coarse, full):
        u = (np.asarray(pix, np.float64) + 0.5) * (coarse / full) - 0.5
        w = np.maximum(0.0, 1.0 - np.abs(np.arange(coarse)[None] - u[:, None]))
        return w / np.maximum(w.sum(1, keepdims=True), 1e-20)

    wy = weights(ys, gh, H)
    wx = weights(xs, gw, W)
    return np.einsum("eh,ew,hwc->ec", wy, wx, theta)


@pytest.mark.parametrize("gh,gw,n,spread", GRID_CASES)
def test_forward_matches_upscaled_gather(rng, gh, gw, n, spread):
    theta, xs, ys = _case(rng, n, gh, gw, spread)
    a = interp_theta_at_events(theta, xs, ys, SENSOR)
    assert a.shape == (n, 2)
    np.testing.assert_allclose(np.asarray(a), _triangle_ref(theta, xs, ys),
                               rtol=3e-5, atol=1e-5)
    # inside the sensor the upscaled field's gather is the reference; off
    # it, that gather wraps or clamps its indices, so only the f64 rule holds
    H, W = SENSOR
    inside = np.asarray((xs >= 0) & (xs <= W - 1) & (ys >= 0) & (ys <= H - 1))
    b = _upscaled_gather(theta, xs, ys)
    np.testing.assert_allclose(np.asarray(a)[inside], np.asarray(b)[inside],
                               rtol=3e-5, atol=1e-5)


@pytest.mark.parametrize("gh,gw,n,spread", GRID_CASES[:3])
def test_grad_matches_upscaled_gather(rng, gh, gw, n, spread):
    theta, xs, ys = _case(rng, n, gh, gw)
    cot = jnp.asarray(rng.normal(0, 1, (n, 2)).astype(np.float32))
    ga = jax.grad(lambda t: jnp.vdot(
        interp_theta_at_events(t, xs, ys, SENSOR), cot))(theta)
    gb = jax.grad(lambda t: jnp.vdot(_upscaled_gather(t, xs, ys), cot))(theta)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gb), rtol=1e-4,
                               atol=1e-4)
    # event coordinates enter through round(): zero cotangent
    gx = jax.grad(lambda x: jnp.vdot(
        interp_theta_at_events(theta, x, ys, SENSOR), cot))(xs)
    np.testing.assert_array_equal(np.asarray(gx), 0.0)


def test_off_sensor_sentinel_rows_are_zero(rng):
    """Far off-sensor events (the NaN-padding sentinel) interpolate to 0."""
    theta, xs, ys = _case(rng, 64, 8, 8)
    xs = xs.at[:5].set(-1e4)
    ys = ys.at[:5].set(-1e4)
    out = interp_theta_at_events(theta, xs, ys, SENSOR)
    np.testing.assert_array_equal(np.asarray(out[:5]), 0.0)


def test_grad_ignores_padded_events(rng):
    """dtheta from a padded call equals dtheta from the unpadded events."""
    theta, xs, ys = _case(rng, 300, 8, 8)
    xs2 = jnp.concatenate([xs, jnp.full((45,), -1e4, jnp.float32)])
    ys2 = jnp.concatenate([ys, jnp.full((45,), -1e4, jnp.float32)])
    cot = jnp.asarray(rng.normal(0, 1, (300, 2)).astype(np.float32))
    cot2 = jnp.concatenate([cot, jnp.zeros((45, 2), jnp.float32)])
    g1 = jax.grad(lambda t: jnp.vdot(
        interp_theta_at_events(t, xs, ys, SENSOR), cot))(theta)
    g2 = jax.grad(lambda t: jnp.vdot(
        interp_theta_at_events(t, xs2, ys2, SENSOR), cot2))(theta)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-6)


@pytest.mark.parametrize("chunk", [128, 1024])
def test_chunked_matches_single_chunk(rng, chunk):
    """Windows larger than `chunk` run as a lax.map over chunks; the
    result must not depend on the chunking."""
    theta, xs, ys = _case(rng, 5000, 16, 16, 2.0)
    a = interp_theta_at_events(theta, xs, ys, SENSOR, chunk=chunk)
    b = interp_theta_at_events(theta, xs, ys, SENSOR)
    # f32: the matmul's summation blocking depends on the chunk shape
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-5)
