"""Data layer tests: windowing policy, synthetic loader, staging, edge pipeline."""

import numpy as np
import pytest

from eincm_tpu.data.staging import stage_datasample
from eincm_tpu.data.synthetic import SyntheticDataLoader
from eincm_tpu.data.windowing import adjust_event_window


class TestWindowing:
    def test_exact_fit(self):
        s, e, d, o = adjust_event_window(100, 200, 100, 1000)
        assert (s, e, d, o) == (100, 200, 0, 100)

    def test_deficit_symmetric_extension(self):
        s, e, d, o = adjust_event_window(100, 200, 110, 1000)
        assert d == 10 and o == 100
        assert s == 95 and e == 205

    def test_deficit_odd(self):
        s, e, d, o = adjust_event_window(100, 200, 105, 1000)
        assert s == 100 - 3 and e == 200 + 2  # ceil-left, floor-right

    def test_deficit_clipped_at_stream_start(self):
        s, e, d, o = adjust_event_window(2, 10, 100, 1000)
        assert s == 0
        assert e == 10 + 46

    def test_surplus_prefer_latest(self):
        s, e, d, o = adjust_event_window(100, 300, 50, 1000, True)
        assert (s, e) == (250, 300)

    def test_surplus_prefer_earliest(self):
        s, e, d, o = adjust_event_window(100, 300, 50, 1000, False)
        assert (s, e) == (100, 150)

    def test_none_des_n_events(self):
        s, e, d, o = adjust_event_window(100, 300, None, 1000)
        assert (s, e, d, o) == (100, 300, 0, 200)


class TestSyntheticLoader:
    def test_contract_keys(self):
        dl = SyntheticDataLoader(n_windows=3, des_n_events=512)
        dl.get_ready()
        assert len(dl) == 3
        sample = dl[1]
        for k in ["events", "images", "image_ts", "flow_gt", "eval_ts",
                  "n_event_deficiency", "orig_n_events"]:
            assert k in sample, k
        ev = sample["events"]
        assert len(ev["x"]) == 512
        assert ev["x"].dtype == np.int16
        assert sample["images"].shape[0] == 2
        assert sample["flow_gt"].shape == (*dl.sensor_size, 2)

    def test_events_in_sensor(self):
        dl = SyntheticDataLoader(n_windows=2, des_n_events=256)
        dl.get_ready()
        s = dl[0]
        h, w = dl.sensor_size
        assert s["events"]["x"].min() >= 0 and s["events"]["x"].max() < w
        assert s["events"]["y"].min() >= 0 and s["events"]["y"].max() < h

    def test_event_positions_follow_flow(self):
        dl = SyntheticDataLoader(n_windows=2, des_n_events=16384,
                                 velocity=(4.0, 0.0))
        dl.get_ready()
        s = dl[0]
        t = s["events"]["t"]
        x = s["events"]["x"].astype(float)
        # least-squares slope of x against t estimates the x-velocity;
        # feature-position variance adds noise, hence the loose bound.
        slope = np.cov(x, t)[0, 1] / np.var(t)
        assert 2.0 < slope < 6.0, slope


class TestStaging:
    def _sample(self):
        dl = SyntheticDataLoader(n_windows=2, des_n_events=1024)
        dl.get_ready()
        return dl[0], dl

    def test_time_normalization(self):
        sample, dl = self._sample()
        staged = stage_datasample(sample, preprocess=False)
        t = np.asarray(staged.window.ts)
        assert t.min() >= -0.01 and t.max() <= 1.01
        et = np.asarray(staged.window.edge_ts)
        assert np.isclose(et[0], 0.0, atol=1e-6)
        assert np.isclose(et[-1], 1.0, atol=1e-6)

    def test_edges_shape_and_range(self):
        sample, dl = self._sample()
        staged = stage_datasample(sample, preprocess=False)
        assert staged.window.edges.shape == (2, *dl.sensor_size)
        e = np.asarray(staged.window.edges)
        assert e.min() >= 0.0 and e.max() <= 1.0 + 1e-6
        assert e.max() > 0.1  # dots produce edges

    def test_pad_to_fixed_shape(self):
        sample, dl = self._sample()
        staged = stage_datasample(sample, preprocess=False, pad_to=2048)
        assert staged.window.xs.shape == (2048,)
        assert np.isnan(np.asarray(staged.window.xs)[-1])

    def test_eval_subslice_when_padded(self):
        sample, dl = self._sample()
        sample["n_event_deficiency"] = 5  # pretend window was extended
        staged = stage_datasample(sample, preprocess=False)
        assert len(staged.eval_events["x"]) <= len(sample["events"]["x"])


class TestEdgePipeline:
    def test_canny_finds_box_edges(self):
        from eincm_tpu.edge.canny import canny

        img = np.zeros((40, 40), np.uint8)
        img[10:30, 10:30] = 200
        edges = canny(img, 30, 80)
        assert edges.dtype == np.uint8
        assert edges[10, 20] > 0 or edges[9, 20] > 0 or edges[11, 20] > 0
        assert edges[20, 20] == 0  # interior not edge
        assert edges[:5].sum() == 0  # background clean

    def test_canny_matches_opencv_roughly(self, rng):
        cv2 = pytest.importorskip("cv2")
        from eincm_tpu.edge.canny import canny

        img = (rng.uniform(0, 1, (64, 64)) * 40).astype(np.uint8)
        img[16:48, 16:48] += 120
        ours = canny(img, 30, 80, 3, True) > 0
        theirs = cv2.Canny(img, 30, 80, None, 3, True) > 0
        # agreement on the vast majority of pixels
        agree = (ours == theirs).mean()
        assert agree > 0.95, agree

    def test_iedt_range_and_peak_on_edges(self):
        from eincm_tpu.edge.iedt import eincm_inv_exp_dist_transform, rtef_iedt

        edges = np.zeros((32, 32), bool)
        edges[16, :] = True
        for fn in [
            lambda e: eincm_inv_exp_dist_transform(e, alpha=6),
            lambda e: rtef_iedt(e),
        ]:
            surf = fn(edges)
            assert np.isclose(surf[16, 10], 1.0, atol=1e-6)
            assert surf[0, 10] < 0.1
            assert surf.min() >= 0 and surf.max() <= 1

    def test_clahe_improves_contrast(self, rng):
        from eincm_tpu.edge.filters_np import clahe

        img = (rng.uniform(100, 130, (50, 60))).astype(np.uint8)
        out = clahe(img, 5, (5, 5))
        assert out.std() > img.std()

    def test_bilateral_preserves_edges(self):
        from eincm_tpu.edge.filters_np import bilateral_filter

        img = np.zeros((20, 20), np.uint8)
        img[:, 10:] = 200
        out = bilateral_filter(img, 5, 15, 15)
        # step edge preserved (not blurred to midtones)
        assert out[5, 8] < 30 and out[5, 12] > 170

    def test_nl_means_reduces_noise(self, rng):
        from eincm_tpu.edge.filters_np import nl_means_denoise

        clean = np.full((40, 40), 128.0)
        noisy = np.clip(
            clean + rng.normal(0, 10, clean.shape), 0, 255
        ).astype(np.uint8)
        out = nl_means_denoise(noisy, h=10)
        assert out.std() < noisy.std() * 0.7


class TestPrefetcher:
    def test_order_and_completeness(self):
        from eincm_tpu.data.prefetch import StagingPrefetcher

        calls = []

        class FakeLoader:
            def __getitem__(self, i):
                return {"idx": i}

        def stage(sample):
            calls.append(sample["idx"])
            return sample["idx"] * 10

        pf = StagingPrefetcher(FakeLoader(), [0, 2, 5], stage, depth=2)
        out = list(pf)
        assert out == [(0, 0), (2, 20), (5, 50)]
        assert sorted(calls) == [0, 2, 5]

    def test_empty(self):
        from eincm_tpu.data.prefetch import StagingPrefetcher

        pf = StagingPrefetcher(None, [], lambda s: s)
        assert list(pf) == []

    def test_duplicate_indices(self):
        """Regression (round-3 review): futures were keyed by index VALUE,
        so a repeated index overwrote the pending future and the second
        occurrence crashed on pop. n_repeat-style callers may pass dups."""
        from eincm_tpu.data.prefetch import StagingPrefetcher

        class FakeLoader:
            def __getitem__(self, i):
                return i

        for idxs in ([3, 3], [1, 2, 1], [0, 0, 0, 0]):
            pf = StagingPrefetcher(FakeLoader(), idxs, lambda i: i * 10, depth=2)
            assert list(pf) == [(i, i * 10) for i in idxs]

    def test_exception_propagates(self):
        from eincm_tpu.data.prefetch import StagingPrefetcher

        class FakeLoader:
            def __getitem__(self, i):
                return i

        def stage(i):
            if i == 1:
                raise ValueError("boom")
            return i

        pf = StagingPrefetcher(FakeLoader(), [0, 1], stage, depth=2)
        import pytest as _pytest

        with _pytest.raises(ValueError):
            list(pf)

