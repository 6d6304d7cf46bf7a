"""Flow metric tests against a direct boolean-masked numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from eincm_tpu.evals.flow_metrics import sparse_flow_error
from eincm_tpu.evals.theta_metrics import evaluate_theta_array, per_pix_theta_to_flow
from eincm_tpu.models.loss import LossParams


def numpy_sparse_flow_error(pred, gt, event_mask=None):
    """Oracle: the reference algorithm with dynamic boolean indexing."""
    eps = np.finfo(np.float64).eps
    mp = (~np.isinf(pred[..., 0])) & (~np.isinf(pred[..., 1])) & (
        np.linalg.norm(pred, axis=-1) > 0
    )
    if event_mask is not None:
        mp &= event_mask
    mg = (~np.isinf(gt[..., 0])) & (~np.isinf(gt[..., 1])) & (
        np.linalg.norm(gt, axis=-1) > 0
    )
    m = mp & mg
    p, g = pred[m], gt[m]
    epe = np.linalg.norm(p - g, axis=-1)
    out = {
        "AEE": epe.mean() if epe.size else 0.0,
        "AREE": (epe / (np.linalg.norm(g, axis=-1) + eps)).mean() if epe.size else 0.0,
    }
    for n in [1, 2, 3, 5, 10, 20]:
        out[f"A{n}PE"] = (epe > n).sum() * 100 / (epe.size + eps)
    return out, m.sum(), mp.sum(), mg.sum()


@pytest.fixture
def flows(rng):
    H, W = 20, 24
    pred = rng.normal(0, 3, (H, W, 2)).astype(np.float32)
    gt = rng.normal(0, 3, (H, W, 2)).astype(np.float32)
    # sprinkle invalids
    gt[2, 3] = np.inf
    gt[5, 5] = 0.0
    pred[7, 7] = 0.0
    pred[1, 1] = np.inf
    return pred, gt


def test_matches_numpy_oracle(flows):
    pred, gt = flows
    res = sparse_flow_error(jnp.asarray(pred), jnp.asarray(gt))
    exp, n_ee, n_pred, n_gt = numpy_sparse_flow_error(pred, gt)
    for k, v in exp.items():
        assert np.isclose(float(res["errors"][k]), v, rtol=1e-4), k
    assert int(res["counts"]["n_ee"]) == n_ee
    assert int(res["counts"]["n_pred"]) == n_pred
    assert int(res["counts"]["n_gt"]) == n_gt


def test_event_mask_applied(flows, rng):
    pred, gt = flows
    mask = rng.uniform(0, 1, pred.shape[:2]) > 0.5
    res = sparse_flow_error(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    exp, n_ee, *_ = numpy_sparse_flow_error(pred, gt, mask)
    assert np.isclose(float(res["errors"]["AEE"]), exp["AEE"], rtol=1e-4)
    assert int(res["counts"]["n_ee"]) == n_ee


def test_perfect_prediction(flows):
    _, gt = flows
    res = sparse_flow_error(jnp.asarray(gt), jnp.asarray(gt))
    assert np.isclose(float(res["errors"]["AEE"]), 0.0, atol=1e-6)
    for n in [1, 2, 3, 5, 10, 20]:
        assert float(res["errors"][f"A{n}PE"]) == 0.0


def test_theta_to_flow_masks_to_events():
    theta = jnp.ones((8, 10, 2)) * 2.5
    xs = jnp.array([1.0, 5.0])
    ys = jnp.array([2.0, 6.0])
    ts = jnp.array([0.1, 0.9])
    flow = per_pix_theta_to_flow(theta, xs, ys, ts)
    assert np.allclose(np.asarray(flow[2, 1]), [2.5, 2.5])
    assert np.allclose(np.asarray(flow[6, 5]), [2.5, 2.5])
    assert np.allclose(np.asarray(flow).sum(), 2 * 5.0)


def test_evaluate_theta_array_bundle(rng):
    H, W = 24, 32
    n = 300
    xs = jnp.asarray(rng.integers(0, W, n).astype(np.float32))
    ys = jnp.asarray(rng.integers(0, H, n).astype(np.float32))
    ts = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    edges = jnp.asarray(rng.uniform(0, 1, (2, H, W)).astype(np.float32))
    edge_ts = jnp.array([0.0, 1.0], jnp.float32)
    gt = rng.normal(0, 2, (H, W, 2)).astype(np.float32)
    theta = jnp.zeros((H, W, 2))

    t_str, e_str, evals, loss_obj = evaluate_theta_array(
        theta, xs, ys, ts, edges, edge_ts, jnp.asarray(gt),
        LossParams(alpha=60.0, beta=60.0), (H, W),
    )
    for k in ["loss", "iwe_var", "fwl", "AEE", "AREE", "A3PE", "n_ee"]:
        assert k in evals, k
    assert "total_loss" in e_str and "FWL" in e_str and "AEE" in e_str
    # zero theta -> zero flow -> no valid pred pixels -> AEE 0 with n_ee 0
    assert int(evals["n_ee"]) == 0


def test_evaluate_theta_array_with_prepared_inputs_identical(rng):
    """prepare_eval_inputs (pad once + hoisted window statics) must give
    bit-identical metrics to the self-contained path — the per-iterate
    trajectory evaluation reuses one WindowStatics across all iterates."""
    from eincm_tpu.evals.theta_metrics import prepare_eval_inputs

    H, W = 24, 32
    n = 300
    xs = jnp.asarray(rng.integers(0, W, n).astype(np.float32))
    ys = jnp.asarray(rng.integers(0, H, n).astype(np.float32))
    ts = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    edges = jnp.asarray(rng.uniform(0, 1, (2, H, W)).astype(np.float32))
    edge_ts = jnp.array([0.0, 1.0], jnp.float32)
    gt = jnp.asarray(rng.normal(0, 2, (H, W, 2)).astype(np.float32))
    theta = jnp.asarray(rng.normal(0, 1, (H, W, 2)).astype(np.float32))
    params = LossParams(alpha=60.0, beta=60.0, gamma=0.01, delta=0.1)

    _, _, evals_ref, _ = evaluate_theta_array(
        theta, xs, ys, ts, edges, edge_ts, gt, params, (H, W)
    )
    pxs, pys, pts, wstat = prepare_eval_inputs(
        xs, ys, ts, edges, (H, W), dtype=theta.dtype
    )
    # reuse across two calls, like the intermediate-trajectory path does
    for _ in range(2):
        _, _, evals_new, _ = evaluate_theta_array(
            theta, pxs, pys, pts, edges, edge_ts, gt, params, (H, W),
            window_statics=wstat,
        )
        for k, v in evals_ref.items():
            assert np.array_equal(np.asarray(v), np.asarray(evals_new[k])), k


class TestProfilingUtils:
    """utils/profiling.py (SURVEY.md §5 tracing/profiling subsystem)."""

    def test_timer_sections_and_report(self):
        from eincm_tpu.utils.profiling import Timer

        t = Timer()
        x = jnp.arange(8.0)
        with t.section("a", sync_on=x):
            _ = x * 2
        with t.section("a"):
            pass
        with t.section("b", sync_on=np.arange(3)):  # non-jax leaf syncs too
            pass
        assert t.counts["a"] == 2 and t.counts["b"] == 1
        rep = t.report()
        assert "a: total" in rep and "ms/call" in rep

    def test_timed_jitted_callable(self):
        import jax

        from eincm_tpu.utils.profiling import timed

        f = jax.jit(lambda x: (x * x).sum())
        sec, out = timed(f, jnp.arange(16.0), iters=3)
        assert sec > 0 and float(out) == float((jnp.arange(16.0) ** 2).sum())

    def test_timer_section_waits_on_any_tree(self):
        from eincm_tpu.utils.profiling import Timer

        t = Timer()
        with t.section("empty", sync_on=()):  # no leaves: a no-op wait
            pass
        with t.section("tree", sync_on={"x": jnp.zeros((2, 2))}):
            pass
        assert t.counts == {"empty": 1, "tree": 1}
