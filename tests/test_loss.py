"""Loss composition, window statics, and gradient-path tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eincm_tpu.models.loss import (
    LossParams,
    LossStatics,
    compute_loss_objectives,
    compute_weights_for_multi_reference,
    compute_window_statics,
    handover_loss_func,
    loss_func,
)

SENSOR = (24, 32)


@pytest.fixture
def window(rng):
    n = 400
    xs = jnp.asarray(rng.integers(0, SENSOR[1], n).astype(np.float32))
    ys = jnp.asarray(rng.integers(0, SENSOR[0], n).astype(np.float32))
    ts = jnp.asarray(np.sort(rng.uniform(0, 1, n)).astype(np.float32))
    edges = jnp.asarray(rng.uniform(0, 1, (2, *SENSOR)).astype(np.float32))
    edge_ts = jnp.array([0.0, 1.0], jnp.float32)
    return xs, ys, ts, edges, edge_ts


class TestMultiRefWeights:
    def test_matches_scipy_norm_pdf(self):
        import scipy.stats as stats

        for n in [1, 2, 3, 5]:
            w = compute_weights_for_multi_reference(n)
            q = np.linspace(-1.5, 1.5, n)
            ref = stats.norm.pdf(q, 0, 1)
            ref = ref / ref.sum()
            np.testing.assert_allclose(w, ref, rtol=1e-12)
            assert np.isclose(w.sum(), 1.0)


class TestLoss:
    def test_zero_theta_baseline(self, window):
        """At theta=0 warped == unwarped, so every relative objective is 1
        and the loss is -(alpha+beta)/n_refs * sum(w) = -(alpha+beta)*mean(w)."""
        xs, ys, ts, edges, edge_ts = window
        params = LossParams(alpha=60.0, beta=60.0)
        statics = LossStatics(SENSOR, 3)
        theta = jnp.zeros((4, 4, 2))
        loss, aux = loss_func(
            theta, xs, ys, ts, edges, edge_ts, params, 2, statics
        )
        n_refs = edges.shape[0]
        w = compute_weights_for_multi_reference(n_refs)
        expected = -(60.0 + 60.0) * w.mean()
        assert np.isclose(float(loss), expected, rtol=1e-4)
        assert np.isclose(float(aux["mean_rel_contrast"]), w.mean(), rtol=1e-4)

    def test_window_statics_match_inline(self, window):
        xs, ys, ts, edges, edge_ts = window
        params = LossParams(alpha=20.0, beta=35.0, gamma=0.01, delta=0.5)
        statics = LossStatics(SENSOR, 3)
        theta = jnp.asarray(
            np.random.default_rng(1).normal(0, 1, (4, 4, 2)).astype(np.float32)
        )
        ws = compute_window_statics(xs, ys, edges, SENSOR)
        l1, _ = loss_func(theta, xs, ys, ts, edges, edge_ts, params, 0, statics)
        l2, _ = loss_func(
            theta, xs, ys, ts, edges, edge_ts, params, 0, statics, ws
        )
        assert np.isclose(float(l1), float(l2), rtol=1e-6)

    def test_tv_only_at_finest_level(self, window):
        xs, ys, ts, edges, edge_ts = window
        params = LossParams(alpha=0.0, beta=0.0, gamma=5.0, delta=0.0)
        statics = LossStatics(SENSOR, 3)
        theta = jnp.asarray(
            np.random.default_rng(2).normal(0, 2, (4, 4, 2)).astype(np.float32)
        )
        l0, _ = loss_func(theta, xs, ys, ts, edges, edge_ts, params, 0, statics)
        l1, _ = loss_func(theta, xs, ys, ts, edges, edge_ts, params, 1, statics)
        assert float(l0) > 0.0  # TV active
        assert np.isclose(float(l1), 0.0, atol=1e-7)  # TV gated off

    def test_loss_is_differentiable(self, window):
        xs, ys, ts, edges, edge_ts = window
        params = LossParams(alpha=60.0, beta=60.0)
        statics = LossStatics(SENSOR, 3)

        def f(theta):
            l, _ = loss_func(theta, xs, ys, ts, edges, edge_ts, params, 0, statics)
            return l

        g = jax.grad(f)(jnp.zeros((4, 4, 2)))
        assert g.shape == (4, 4, 2)
        assert np.all(np.isfinite(np.asarray(g)))
        assert float(jnp.abs(g).sum()) > 0

    def test_gradient_matches_finite_difference(self, window):
        xs, ys, ts, edges, edge_ts = window
        params = LossParams(alpha=60.0, beta=60.0)
        statics = LossStatics(SENSOR, 3)

        def f(s):
            theta = jnp.full((2, 2, 2), 0.0).at[..., 0].set(s)
            l, _ = loss_func(theta, xs, ys, ts, edges, edge_ts, params, 1, statics)
            return l

        g = float(jax.grad(f)(0.3))
        eps = 1e-2
        fd = (f(0.3 + eps) - f(0.3 - eps)) / (2 * eps)
        assert np.isclose(g, float(fd), rtol=5e-2, atol=1e-3)

    def test_objectives_bundle_keys(self, window):
        xs, ys, ts, edges, edge_ts = window
        theta = jnp.zeros((*SENSOR, 2))
        objs = compute_loss_objectives(theta, xs, ys, ts, edges, edge_ts, SENSOR)
        for k in [
            "warped_xs", "correlations", "zero_correlations", "rel_correlations",
            "contrasts", "zero_contrast", "rel_contrasts",
            "theta_total_variation", "theta_divergence", "iwe_divergences",
            "zero_iwe_divergence", "rel_iwe_divergences", "flow_warp_losses",
            "multi_ref_weights",
        ]:
            assert k in objs, k
        assert objs["warped_xs"].shape == (2, xs.shape[0])
        # zero theta: FWL == 1 for every ref
        np.testing.assert_allclose(
            np.asarray(objs["flow_warp_losses"]), 1.0, rtol=1e-5
        )

    def test_handover_loss_endpoints(self, window):
        xs, ys, ts, edges, edge_ts = window
        params = LossParams(alpha=60.0, beta=60.0)
        statics = LossStatics(SENSOR, 3)
        rng2 = np.random.default_rng(3)
        prev = jnp.asarray(rng2.normal(0, 1, (4, 4, 2)).astype(np.float32))
        cur = jnp.asarray(rng2.normal(0, 1, (4, 4, 2)).astype(np.float32))

        def lf(th):
            l, _ = loss_func(th, xs, ys, ts, edges, edge_ts, params, 0, statics)
            return float(l)

        ho0 = handover_loss_func(
            jnp.asarray(0.0), prev, cur, xs, ys, ts, edges, edge_ts,
            params, 0, statics,
        )
        ho1 = handover_loss_func(
            jnp.asarray(1.0), prev, cur, xs, ys, ts, edges, edge_ts,
            params, 0, statics,
        )
        assert np.isclose(float(ho0), lf(cur), rtol=1e-5)
        assert np.isclose(float(ho1), lf(prev), rtol=1e-5)


class TestSolverLoss:
    def test_interp_matches_scale_then_gather(self, rng):
        from eincm_tpu.ops.resize import scale_theta_to_sensor_size
        from eincm_tpu.ops.warp import (
            gather_theta_at_events,
            interp_theta_at_events,
        )

        H, W = 48, 56
        theta = jnp.asarray(rng.normal(0, 2, (6, 7, 2)).astype(np.float32))
        xs = jnp.asarray(rng.integers(0, W, 500).astype(np.float32))
        ys = jnp.asarray(rng.integers(0, H, 500).astype(np.float32))
        full = scale_theta_to_sensor_size(theta, (H, W), "bilinear")
        ref = gather_theta_at_events(full, xs, ys)
        out = interp_theta_at_events(theta, xs, ys, (H, W))
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-5
        )

    def test_solver_loss_equals_full_loss(self, window, rng):
        from eincm_tpu.models.loss import solver_loss

        xs, ys, ts, edges, edge_ts = window
        statics = LossStatics(SENSOR, 3)
        ws = compute_window_statics(xs, ys, edges, SENSOR)
        theta = jnp.asarray(rng.normal(0, 1, (4, 4, 2)).astype(np.float32))
        for params, lvl in [
            (LossParams(60.0, 60.0), 1),
            (LossParams(20.0, 35.0, 0.01, 0.0), 0),
            (LossParams(20.0, 35.0, 0.0, 0.5), 2),
            (LossParams(2000.0, 4000.0, 0.1, 0.3), 0),
        ]:
            lean = solver_loss(
                theta, xs, ys, ts, edges, edge_ts, params, lvl, statics, ws
            )
            full, _ = loss_func(
                theta, xs, ys, ts, edges, edge_ts, params, lvl, statics, ws
            )
            assert np.isclose(float(lean), float(full), rtol=1e-4), (params, lvl)

    def test_solver_loss_grad_matches_full(self, window):
        from eincm_tpu.models.loss import solver_loss

        xs, ys, ts, edges, edge_ts = window
        statics = LossStatics(SENSOR, 3)
        ws = compute_window_statics(xs, ys, edges, SENSOR)
        params = LossParams(60.0, 60.0)
        theta0 = jnp.full((4, 4, 2), 0.5)

        g_lean = jax.grad(solver_loss)(
            theta0, xs, ys, ts, edges, edge_ts, params, 1, statics, ws
        )
        g_full = jax.grad(
            lambda t: loss_func(
                t, xs, ys, ts, edges, edge_ts, params, 1, statics, ws
            )[0]
        )(theta0)
        np.testing.assert_allclose(
            np.asarray(g_lean), np.asarray(g_full), rtol=1e-3, atol=1e-5
        )


def test_nan_padded_events_grads_finite(rng):
    """Regression: NaN padding events (fixed-shape staging / tile sort) must
    not poison dtheta through the warp VJP (NaN*0 in the interp weights)."""
    from eincm_tpu.models.loss import (
        LossParams, LossStatics, compute_window_statics, solver_loss,
    )

    H = W = 32
    n, n_pad = 512, 128
    xs = np.concatenate([
        rng.integers(0, W, n).astype(np.float32), np.full(n_pad, np.nan, np.float32)
    ])
    ys = np.concatenate([
        rng.integers(0, H, n).astype(np.float32), np.full(n_pad, np.nan, np.float32)
    ])
    ts = np.concatenate([
        rng.uniform(0, 1, n).astype(np.float32), np.full(n_pad, np.nan, np.float32)
    ])
    edges = jnp.asarray(rng.uniform(0, 1, (2, H, W)).astype(np.float32))
    ets = jnp.asarray([0.0, 1.0], jnp.float32)
    theta = jnp.asarray(rng.normal(0, 1, (4, 4, 2)).astype(np.float32))
    statics = LossStatics(sensor_size=(H, W), n_pyr_lvls=3)
    wstat = compute_window_statics(jnp.asarray(xs), jnp.asarray(ys), edges, (H, W))

    val, grad = jax.value_and_grad(solver_loss)(
        theta, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ts), edges, ets,
        LossParams(20.0, 35.0, 0.001), 0, statics, wstat,
    )
    assert np.isfinite(float(val))
    assert np.all(np.isfinite(np.asarray(grad)))

    # the padded window must produce the SAME loss/grad as the unpadded one
    wstat0 = compute_window_statics(
        jnp.asarray(xs[:n]), jnp.asarray(ys[:n]), edges, (H, W)
    )
    val0, grad0 = jax.value_and_grad(solver_loss)(
        theta, jnp.asarray(xs[:n]), jnp.asarray(ys[:n]), jnp.asarray(ts[:n]),
        edges, ets, LossParams(20.0, 35.0, 0.001), 0, statics, wstat0,
    )
    np.testing.assert_allclose(float(val), float(val0), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(grad), np.asarray(grad0), rtol=1e-4, atol=1e-6
    )


def test_permuted_padded_events_same_loss(rng):
    """Event order and NaN padding leave the loss unchanged: every
    reduction is permutation-invariant, and the scatter-add splat sums
    colliding texels in whatever order it likes."""
    from eincm_tpu.models.loss import (
        LossParams, LossStatics, compute_window_statics, solver_loss,
    )

    H = W = 32
    n = 700
    xs = rng.integers(0, W, n).astype(np.float32)
    ys = rng.integers(0, H, n).astype(np.float32)
    ts = rng.uniform(0, 1, n).astype(np.float32)
    edges = jnp.asarray(rng.uniform(0, 1, (2, H, W)).astype(np.float32))
    ets = jnp.asarray([0.0, 1.0], jnp.float32)
    theta = jnp.asarray(rng.normal(0, 1, (4, 4, 2)).astype(np.float32))
    statics = LossStatics(sensor_size=(H, W), n_pyr_lvls=3)
    params = LossParams(20.0, 35.0)

    def loss(x_, y_, t_):
        w = compute_window_statics(jnp.asarray(x_), jnp.asarray(y_), edges, (H, W))
        return solver_loss(
            theta, jnp.asarray(x_), jnp.asarray(y_), jnp.asarray(t_),
            edges, ets, params, 0, statics, w,
        )

    a = float(loss(xs, ys, ts))
    order = rng.permutation(n)
    pad = np.full(100, np.nan, np.float32)
    b = float(loss(np.concatenate([xs[order], pad]),
                   np.concatenate([ys[order], pad]),
                   np.concatenate([ts[order], pad])))
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_nan_padding_no_phantom_mass_under_large_flow():
    """Regression: the NaN-padding sentinel must stay off-sensor AFTER the
    warp. The old near-sensor sentinel (-10) gathered a real (wrapped /
    clamped) theta and re-entered the sensor whenever |theta|*dt exceeded
    ~8.5 px, splatting tens of thousands of phantom events at DSEC flow
    scales. Padded and unpadded windows must produce identical IWEs, with
    finite gradients."""
    import jax

    from eincm_tpu.models.loss import _sanitize_events
    from eincm_tpu.ops.splat import splat_multi_ref
    from eincm_tpu.ops.warp import warp_events_multi_ref

    H = W = 64
    rng = np.random.default_rng(3)
    n = 500
    xs = rng.integers(4, W - 4, n).astype(np.float32)
    ys = rng.integers(4, H - 4, n).astype(np.float32)
    ts = rng.uniform(0, 1, n).astype(np.float32)
    pad = np.full(512, np.nan, np.float32)
    t_refs = jnp.asarray([0.0, 1.0], jnp.float32)
    # large uniform flow: -25 px/unit-time in both axes
    theta = jnp.full((H, W, 2), -25.0, jnp.float32)

    def iwes(xs, ys, ts):
        xs, ys, ts = _sanitize_events(
            jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ts)
        )
        wx, wy = warp_events_multi_ref(theta, xs, ys, ts, t_refs, 1.0)
        return splat_multi_ref(wx, wy, (H, W))

    ref = iwes(xs, ys, ts)
    padded = iwes(
        np.concatenate([xs, pad]),
        np.concatenate([ys, pad]),
        np.concatenate([ts, pad]),
    )
    np.testing.assert_allclose(np.asarray(padded), np.asarray(ref), atol=1e-5)

    g = jax.grad(
        lambda th: jnp.sum(
            splat_multi_ref(
                *warp_events_multi_ref(
                    th,
                    *_sanitize_events(
                        jnp.asarray(np.concatenate([xs, pad])),
                        jnp.asarray(np.concatenate([ys, pad])),
                        jnp.asarray(np.concatenate([ts, pad])),
                    ),
                    t_refs,
                    1.0,
                ),
                (H, W),
            )
        )
    )(theta)
    assert bool(jnp.all(jnp.isfinite(g)))
