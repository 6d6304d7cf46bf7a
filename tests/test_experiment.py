"""Full experiment-shell integration tests on the synthetic dataset (CPU)."""

import numpy as np
import pytest

from eincm_tpu.experiments.config import (
    ExperimentConfig,
    apply_overrides,
    load_config,
)
from eincm_tpu.experiments.manager import EINCMExperiment
from eincm_tpu.experiments.outputs import (
    EINCMOutputLoader,
    validate_eval_results,
    validate_opt_results,
)


def tiny_cfg(tmp_path, **kw):
    cfg = ExperimentConfig()
    cfg.dataset.kind = "synthetic"
    cfg.dataset.sensor_size = (32, 32)
    cfg.dataset.des_n_events = 1024
    cfg.dataset.n_windows = 3
    cfg.dataset.velocity = (2.0, -1.0)
    cfg.solver.n_pyr_lvls = 3
    cfg.solver.theta_maxiter = 6
    cfg.solver.theta_miniter = 3
    cfg.solver.handover_maxiter = 5
    cfg.solver.max_ls_evals = 6
    cfg.alpha, cfg.beta = 60.0, 0.0
    cfg.edge.enable_image_preprocessing = False
    cfg.output_dir = str(tmp_path)
    cfg.phases.plot = False
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


class TestConfig:
    def test_roundtrip_dict(self):
        cfg = ExperimentConfig()
        d = cfg.to_dict()
        cfg2 = ExperimentConfig.from_dict(d)
        assert cfg2.to_dict() == d

    def test_overrides(self):
        cfg = ExperimentConfig()
        cfg2 = apply_overrides(
            cfg, ["alpha=20", "dataset.des_n_events=999", "phases.plot=true"]
        )
        assert cfg2.alpha == 20
        assert cfg2.dataset.des_n_events == 999
        assert cfg2.phases.plot is True

    def test_unknown_override_rejected(self):
        with pytest.raises(KeyError):
            apply_overrides(ExperimentConfig(), ["nonexistent.key=1"])

    def test_yaml_load(self, tmp_path):
        p = tmp_path / "c.yaml"
        p.write_text("alpha: 33\ndataset:\n  kind: synthetic\n  des_n_events: 77\n")
        cfg = load_config(str(p), ["beta=44"])
        assert cfg.alpha == 33 and cfg.beta == 44
        assert cfg.dataset.des_n_events == 77

    def test_max_ls_evals_resolves_per_line_search(self):
        # None resolves at SolverConfig.__post_init__ (6 armijo / 10 wolfe)
        # so BOTH the YAML path and direct SolverConfig construction agree;
        # explicit values always win.
        from eincm_tpu.models.pyramid import SolverConfig

        def mk(**kw):
            return SolverConfig(
                n_pyr_lvls=2,
                sensor_size=(8, 8),
                params=ExperimentConfig().loss_params,
                theta_opt_maxiters=(2, 2),
                **kw,
            )

        assert mk(line_search="armijo").max_ls_evals == 6
        assert mk(line_search="wolfe").max_ls_evals == 10
        assert mk(line_search="wolfe", max_ls_evals=4).max_ls_evals == 4

        cfg = ExperimentConfig()
        assert cfg.solver.max_ls_evals is None
        assert cfg.solver_config().max_ls_evals == 6
        cfg.solver.line_search = "wolfe"
        assert cfg.solver_config().max_ls_evals == 10
        cfg.solver.max_ls_evals = 25
        assert cfg.solver_config().max_ls_evals == 25

    def test_growing_maxiters(self):
        cfg = ExperimentConfig()
        cfg.solver.n_pyr_lvls = 5
        cfg.solver.use_growing_maxiters = True
        m = cfg.solver.growing_maxiters(10, 25)
        assert len(m) == 5
        assert m[0] == 25  # finest gets maxiter
        assert m[-1] == 10  # coarsest gets miniter
        assert all(m[i] >= m[i + 1] for i in range(4))


class TestExperimentRun:
    def test_solve_eval_produces_artifacts(self, tmp_path):
        cfg = tiny_cfg(tmp_path)
        exp = EINCMExperiment(cfg)
        exp.run()

        out = exp.out_dir
        assert (out / "opt_results.npz").exists()
        assert (out / "eval_results.npz").exists()
        assert (out / "scores.txt").exists()

        loader = EINCMOutputLoader()
        opt = loader.load_opt_results(out / "opt_results.npz")
        validate_opt_results(opt, cfg.solver.n_pyr_lvls)
        assert len(opt) == 3
        ev = loader.load_eval_results(out / "eval_results.npz")
        validate_eval_results(ev)

        scores = (out / "scores.txt").read_text()
        assert "AEE" in scores and "fwl" in scores

    def test_solve_recovers_flow(self, tmp_path):
        cfg = tiny_cfg(tmp_path)
        exp = EINCMExperiment(cfg)
        exp.run_solver()
        exp.run_eval()
        aees = [
            float(np.asarray(rec["evals"]["AEE"]))
            for rec in exp.eval_results.values()
        ]
        # zero-theta AEE would be |v| = 2.24; solved must be clearly better
        assert np.mean(aees) < 1.5, aees

    def test_checkpoint_resume(self, tmp_path):
        cfg = tiny_cfg(tmp_path)
        cfg.phases.checkpoint_every_percent = 34.0  # after every ~1 window
        cfg.phases.delete_checkpoints_at_end = False
        exp = EINCMExperiment(cfg)
        exp.run_solver()
        ckpts = sorted(exp.ckpt_dir.glob("checkpoint_*.npz"))
        assert ckpts, "no checkpoints written"

        # resume from the first checkpoint; must re-solve only later windows
        cfg2 = tiny_cfg(tmp_path / "resumed")
        cfg2.phases.run_from_checkpoint = str(ckpts[0])
        exp2 = EINCMExperiment(cfg2)
        solver, calls = exp2.window_solver, []
        exp2.window_solver = lambda *a, **k: (calls.append(1), solver(*a, **k))[1]
        exp2.run_solver()
        assert len(exp2.opt_results) == 3
        # only the windows AFTER the checkpoint were actually re-solved
        assert len(calls) == 3 - len(
            np.load(ckpts[0], allow_pickle=True)["opt_results"].item()
        )
        # the restored window records equal the checkpointed ones exactly
        ck = np.load(ckpts[0], allow_pickle=True)["opt_results"].item()
        for key, rec in ck.items():
            np.testing.assert_array_equal(
                exp2.opt_results[key]["solver_final_results"][
                    "final_theta_pyr"]["pyr_lvl_0"],
                rec["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"],
            )

    def test_checkpoint_zero_percent_disables(self, tmp_path):
        """Regression (round-3 review): 0 meant 'checkpoint after every
        window' in the serial path (ceil(n*0/100) -> max(1, 0) == 1) while
        the parallel path treats 0 as off; both must disable."""
        cfg = tiny_cfg(tmp_path)
        cfg.phases.checkpoint_every_percent = 0
        cfg.phases.delete_checkpoints_at_end = False
        exp = EINCMExperiment(cfg)
        exp.run_solver()
        assert not list(exp.ckpt_dir.glob("checkpoint_*.npz"))

    def test_plot_phase(self, tmp_path):
        cfg = tiny_cfg(tmp_path)
        cfg.phases.plot = True
        cfg.solver.collect_intermediate = True  # enables per-step figures
        cfg.mpl_rcparams = {"figure.dpi": 72}  # reference mpl_rcparams group
        import matplotlib

        dpi0 = matplotlib.rcParams["figure.dpi"]
        exp = EINCMExperiment(cfg)
        try:
            exp.run()
            assert matplotlib.rcParams["figure.dpi"] == 72
        finally:
            # rcParams are process-global; don't leak into later tests
            matplotlib.rcParams["figure.dpi"] = dpi0
        pngs = list((exp.out_dir / "plots").glob("end_result_*.png"))
        assert len(pngs) == 3
        assert (exp.out_dir / "plots" / "seq_aee.png").exists()
        assert (exp.out_dir / "plots" / "end_results.gif").exists()
        # per-step figures from the recorded level-0 iterates
        steps = list((exp.out_dir / "plots").glob("step_result_*.png"))
        assert len(steps) >= 3
        # handover diagnostic (reference plotters.py:448-473): emitted for
        # every window whose finest level actually blended with a prior
        ho = list((exp.out_dir / "plots").glob("handover_*_pyr0.png"))
        assert len(ho) >= 1
        assert not (exp.out_dir / "plots" / "handover_000000_pyr0.png").exists()
        # MJPEG AVI assembled (reference's video format): check RIFF header
        avi = exp.out_dir / "plots" / "end_results.avi"
        assert avi.exists()
        head = avi.read_bytes()[:200]
        assert head[:4] == b"RIFF" and head[8:12] == b"AVI "
        assert b"MJPG" in head and b"vids" in head

    def test_avi_writer_roundtrip(self, tmp_path):
        import struct

        from eincm_tpu.utils.avi import write_mjpeg_avi

        frames = [
            (np.random.default_rng(i).uniform(0, 255, (48, 64, 3))).astype(
                np.uint8
            )
            for i in range(5)
        ]
        path = write_mjpeg_avi(frames, tmp_path / "t.avi", fps=3)
        data = path.read_bytes()
        assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
        # declared RIFF size matches the file
        assert struct.unpack("<I", data[4:8])[0] + 8 == len(data)
        # main header: 5 frames, 48x64
        i = data.find(b"avih")
        vals = struct.unpack("<14I", data[i + 8 : i + 8 + 56])
        assert vals[4] == 5 and vals[8] == 64 and vals[9] == 48
        # exactly 5 frame chunks: each appears once as a movi chunk header
        # and once as its idx1 entry
        assert data.count(b"00dc") == 2 * 5
        i = data.find(b"movi")
        first = data[i + 4 : i + 16]
        assert first[:4] == b"00dc" and first[8:10] == b"\xff\xd8"
        # index present
        assert b"idx1" in data


class TestDSECSubmission:
    def test_export_pngs(self, tmp_path):
        cfg = tiny_cfg(tmp_path)
        exp = EINCMExperiment(cfg)
        exp.run_solver()

        # fake an eval-ts csv with file indices
        csv = tmp_path / "seq.csv"
        csv.write_text(
            "# from_timestamp_us, to_timestamp_us, file_index\n"
            "0,1,10\n2,3,20\n4,5,30\n"
        )
        from eincm_tpu.tools.dsec_submission import export_submission

        written = export_submission(
            exp.out_dir / "opt_results.npz", csv, tmp_path / "sub"
        )
        assert len(written) == 3
        from eincm_tpu.utils.png16 import read_png16

        img = read_png16(written[0])
        assert img.shape == (480, 640, 3)
        assert img.dtype == np.uint16
        assert np.all(img[..., 2] == 1)
        # decode back: flow = (enc - 2^15) / 128 must be finite and small
        flow = (img[..., :2].astype(np.float64) - 2**15) / 128
        assert np.all(np.abs(flow) < 100)


class TestShippedConfigs:
    """The shipped per-dataset YAMLs must parse through the real loader and
    reproduce the reference run.sh tunings (BASELINE.md table) — a typo in
    configs/ would otherwise only surface on a user's machine."""

    REPO = __import__("pathlib").Path(__file__).resolve().parent.parent

    def _load(self, name):
        cfg = load_config(str(self.REPO / "configs" / f"{name}.yaml"))
        # the SolverConfig bridge validates maxiter/bases shape invariants
        cfg.solver_config()
        return cfg

    def test_all_shipped_configs_load(self):
        for p in (self.REPO / "configs").glob("*.yaml"):
            self._load(p.stem)

    def test_ecd_slider_tuning(self):
        cfg = self._load("ecd_slider")
        assert (cfg.alpha, cfg.beta) == (60.0, 60.0)
        assert cfg.dataset.kind == "ecd"
        assert cfg.dataset.des_n_events == 30_000
        assert tuple(cfg.dataset.sensor_size) == (176, 240)
        assert (cfg.edge.canny_th1, cfg.edge.canny_th2) == (100.0, 200.0)
        assert cfg.solver.theta_maxiter == 25

    def test_mvsec_indoor_tuning(self):
        cfg = self._load("mvsec_indoor")
        assert (cfg.alpha, cfg.beta) == (20.0, 35.0)
        assert cfg.dataset.delta_idx == 4
        assert cfg.solver.theta_maxiter == 40
        assert cfg.solver.n_extra_attempts == {0: 1, 1: 1}
        assert tuple(cfg.dataset.sensor_size) == (256, 336)

    def test_mvsec_outdoor_tuning(self):
        cfg = self._load("mvsec_outdoor")
        assert cfg.gamma == 0.0025
        assert cfg.dataset.des_n_events == 40_000
        assert cfg.solver.theta_maxiter == 25
        assert (cfg.edge.canny_th1, cfg.edge.canny_th2) == (30.0, 80.0)

    def test_dsec_tuning(self):
        cfg = self._load("dsec_test")
        assert (cfg.alpha, cfg.beta) == (2000.0, 4000.0)
        assert cfg.dataset.des_n_events == 1_500_000
        assert tuple(cfg.dataset.sensor_size) == (480, 640)
        assert cfg.solver.n_extra_attempts == {i: 2 for i in range(5)}
        # the splat is chosen by the code, not by the config
        assert not hasattr(cfg.solver, "splat_impl")
        # growing maxiters reproduce the reference per-level budgets
        sc = cfg.solver_config()
        assert sc.theta_opt_maxiters[0] == 40
        assert sc.theta_opt_maxiters[-1] == cfg.solver.theta_miniter


class TestPlotterExtras:
    def test_nan_visualizer_and_step_plots(self, tmp_path, rng):
        from eincm_tpu.experiments.plotters import EINCMExperimentPlotter

        cfg = tiny_cfg(tmp_path)
        p = EINCMExperimentPlotter(cfg, tmp_path / "plots")

        theta = rng.normal(0, 1, (16, 16, 2))
        assert p.plot_nan_theta(0, theta) is None  # clean field -> no plot
        theta[3, 4, 0] = np.nan
        path = p.plot_nan_theta(0, theta)
        assert path is not None and path.exists()

        thetas = rng.normal(0, 1, (12, 2 * 8 * 8))
        losses = np.sort(rng.normal(0, 1, 12))[::-1]
        sp = p.plot_step_results(1, None, thetas, losses)
        assert sp.exists()

        # non-square sensors (DSEC 480x640) must reshape by aspect, not sqrt
        cfg_ns = tiny_cfg(tmp_path)
        cfg_ns.dataset.sensor_size = (480, 640)
        p_ns = EINCMExperimentPlotter(cfg_ns, tmp_path / "plots_ns")
        assert p_ns._level_shape(30 * 40) == (30, 40)
        assert p_ns._level_shape(480 * 640) == (480, 640)
        thetas_ns = rng.normal(0, 1, (5, 2 * 30 * 40))
        sp_ns = p_ns.plot_step_results(1, None, thetas_ns, losses[:5])
        assert sp_ns.exists()

        q = p.plot_grad_quiver(
            2, rng.normal(0, 1, (32, 32, 2)), rng.normal(0, 1, (32, 32, 2))
        )
        assert q.exists()

        hp = p.plot_handover(
            3,
            rng.normal(0, 1, (16, 16, 2)),
            rng.normal(0, 1, (16, 16, 2)),
            rng.normal(0, 1, (16, 16, 2)),
            alpha_ho=0.37,
            pyr=0,
        )
        assert hp.exists() and hp.name == "handover_000003_pyr0.png"

    def test_blend_image_events_and_gt_flow(self, rng):
        from eincm_tpu.experiments.plotters import (
            blend_image_events_and_gt_flow,
        )

        img = rng.uniform(0, 255, (24, 32))
        xs = rng.uniform(0, 31, 200)
        ys = rng.uniform(0, 23, 200)
        gt = rng.normal(0, 2, (24, 32, 2))
        pair = blend_image_events_and_gt_flow(img, xs, ys, gt)
        trip = blend_image_events_and_gt_flow(img, xs, ys, gt, triple_blend=True)
        assert pair.shape == (24, 32, 3) and pair.dtype == np.uint8
        # the triple blend pulls the composite toward the GT-flow image, so
        # the two paths must differ
        assert not np.array_equal(pair, trip)
        # NaN-padded events are dropped, not crashed on
        xs[::3] = np.nan
        blend_image_events_and_gt_flow(img, xs, ys, gt)

    def test_split_run_ranges(self, tmp_path):
        cfg = tiny_cfg(tmp_path)
        cfg.phases.run_idx_ranges = ((0, 1), (2, 3))
        exp = EINCMExperiment(cfg)
        exp.run_solver()
        keys = sorted(exp.opt_results)
        assert keys == ["datasample_idx_0", "datasample_idx_2"]


def test_cli_smoke(tmp_path):
    """End-user CLI flow: python -m eincm_tpu.experiments with overrides."""
    from eincm_tpu.experiments.__main__ import main

    exp = main([
        "dataset.kind=synthetic",
        "dataset.sensor_size=[24, 24]",
        "dataset.des_n_events=256",
        "dataset.n_windows=2",
        "solver.n_pyr_lvls=2",
        "solver.theta_maxiter=3",
        "solver.theta_miniter=2",
        "solver.max_ls_evals=4",
        "alpha=30", "beta=0",
        "edge.enable_image_preprocessing=false",
        f"output_dir={tmp_path}",
        "phases.plot=false",
    ])
    assert (exp.out_dir / "opt_results.npz").exists()
    assert (exp.out_dir / "scores.txt").exists()


def test_parallel_windows_mode(tmp_path):
    """Two-pass sharded solve through the manager produces valid artifacts."""
    cfg = tiny_cfg(tmp_path)
    cfg.dataset.n_windows = 4
    cfg.phases.parallel_windows = True
    cfg.phases.eval = True
    exp = EINCMExperiment(cfg)
    exp.run_solver()
    assert len(exp.opt_results) == 4
    from eincm_tpu.experiments.outputs import validate_opt_results

    validate_opt_results(exp.opt_results, cfg.solver.n_pyr_lvls)
    exp.run_eval()
    aees = [
        float(np.asarray(r["evals"]["AEE"])) for r in exp.eval_results.values()
    ]
    assert np.mean(aees) < 1.6, aees


def test_eval_only_invocation_loads_saved_artifacts(tmp_path):
    """phases.solve=false + eval/plot must auto-load the experiment's saved
    opt_results.npz (reference exp_mgr.py:556-559 disk path) — the
    production CLI rehearsal caught this as a crash."""
    cfg = tiny_cfg(tmp_path)
    EINCMExperiment(cfg).run_solver()

    cfg2 = tiny_cfg(tmp_path)
    cfg2.phases.solve = False
    cfg2.phases.eval = True
    cfg2.phases.plot = True
    exp = EINCMExperiment(cfg2)
    exp.run()
    assert len(exp.eval_results) == 3
    assert (exp.out_dir / "scores.txt").exists()
    assert list((exp.out_dir / "plots").glob("**/*end_result*"))


def test_eager_eval_plot_in_solve_loop(tmp_path):
    """Eager per-window EVAL/PLOT inside the solve loop (reference
    exp_mgr.py:646-656) with the every-N gates."""
    cfg = tiny_cfg(tmp_path)
    cfg.dataset.n_windows = 4
    cfg.phases.eager_eval = True
    cfg.phases.eager_eval_every = 2  # windows 0 and 2
    cfg.phases.eager_plot = True
    cfg.phases.eager_plot_every = 4  # window 0 only
    cfg.phases.eval = False
    exp = EINCMExperiment(cfg)
    exp.run_solver()
    assert set(exp.eval_results) == {"datasample_idx_0", "datasample_idx_2"}
    for rec in exp.eval_results.values():
        assert np.isfinite(float(np.asarray(rec["evals"]["AEE"])))
    plots = list((exp.out_dir / "plots").glob("**/*end_result*"))
    assert len(plots) == 1, plots

    # the standalone EVAL phase still re-evaluates everything (reference
    # behavior: eager collection does not replace the phase)
    exp.run_eval()
    assert len(exp.eval_results) == 4


def test_parallel_eval_matches_serial(tmp_path):
    """phases.parallel_eval shards the EVAL phase over the 8-device mesh
    (VERDICT r3 item 5); per-window metrics must match the serial path (same
    per-window shapes inside lax.map -> same math). 5 windows over 8 devices
    exercises the repeat-last batch padding."""
    cfg = tiny_cfg(tmp_path)
    cfg.dataset.n_windows = 5
    exp = EINCMExperiment(cfg)
    exp.run_solver()
    exp.run_eval()
    serial = {
        k: {m: np.asarray(v) for m, v in r["evals"].items()}
        for k, r in exp.eval_results.items()
    }

    exp.eval_results = {}
    exp.cfg.phases.parallel_eval = True
    exp.run_eval()
    par = exp.eval_results
    assert set(par) == set(serial)
    for k in serial:
        assert set(par[k]["evals"]) == set(serial[k])
        for m, v in serial[k].items():
            np.testing.assert_allclose(
                np.asarray(par[k]["evals"][m]), v, rtol=2e-5, atol=1e-6,
                err_msg=f"{k}/{m}",
            )
    # artifacts written by the parallel path too
    assert (exp.out_dir / "eval_results.npz").exists()
    assert (exp.out_dir / "scores.txt").exists()


def test_parallel_eval_pad_grows_beyond_des(tmp_path):
    """eval_events are boundary-sliced from the raw stream, NOT capped by
    des_n_events — a busy window can exceed the des-derived pad capacity
    (advisor r4). The parallel path must grow its padding to the chunk max
    instead of raising."""
    cfg = tiny_cfg(tmp_path)
    cfg.dataset.n_windows = 2
    exp = EINCMExperiment(cfg)
    exp.run_solver()

    orig_stage = exp.stage
    big_n = 8192 + 100  # past the minimum 8192 bucket for des=1024

    def stage(sample):
        s = orig_stage(sample)
        ev = s.eval_events
        reps = -(-big_n // len(ev["x"]))
        big = {k: np.tile(np.asarray(v), reps)[:big_n] for k, v in ev.items()}
        return s._replace(eval_events=big)

    exp.stage = stage
    exp.cfg.phases.parallel_eval = True
    exp.run_eval()
    assert len(exp.eval_results) == 2
    for rec in exp.eval_results.values():
        assert np.isfinite(float(np.asarray(rec["evals"]["AEE"])))


def test_eval_intermediate_hook(tmp_path):
    """phases.eval_intermediate: every recorded level-0 iterate is evaluated
    against GT (reference callbacks.py:140-149 capability, post-hoc), and the
    handover solve's probe trajectory is recorded."""
    import dataclasses

    cfg = tiny_cfg(tmp_path)
    cfg.phases.eval_intermediate = True
    cfg.handover = dataclasses.replace(
        cfg.handover, solve_handover_for_levels=(0,)
    )
    exp = EINCMExperiment(cfg)
    exp.run_solver()

    # handover probe history recorded for solved levels of non-first windows
    rec = exp.opt_results["datasample_idx_1"]["solver_intermediate_results"]
    ho = rec["handover_opt"]
    assert int(ho["n_iters"]["pyr_lvl_0"]) > 0
    assert len(ho["weights"]["pyr_lvl_0"]) == int(ho["n_iters"]["pyr_lvl_0"])
    assert np.all(np.isfinite(ho["losses"]["pyr_lvl_0"]))

    exp.run_eval()
    inter = exp.eval_results["datasample_idx_0"].get("intermediate")
    assert inter is not None
    n_rec = len(rec["theta_opt"]["losses"]["pyr_lvl_0"])
    assert n_rec >= 1
    assert len(exp.eval_results["datasample_idx_0"]["intermediate"]["loss"]) >= 1
    assert "AEE" in inter and np.all(np.isfinite(inter["AEE"]))
    # the trajectory should not get worse from first to best iterate
    assert inter["loss"].min() <= inter["loss"][0] + 1e-6


def test_parallel_windows_sequence_shard(tmp_path):
    """sequence_shard mode through the manager: streamed staging assembles a
    properly sharded batch (windows not divisible by the 8-device mesh) and
    the solve recovers the synthetic flow."""
    cfg = tiny_cfg(tmp_path)
    cfg.dataset.n_windows = 6  # pads to 8 over the virtual mesh
    cfg.phases.parallel_windows = True
    cfg.phases.parallel_mode = "sequence_shard"
    cfg.phases.eval = True
    exp = EINCMExperiment(cfg)
    exp.run_solver()
    assert len(exp.opt_results) == 6
    from eincm_tpu.experiments.outputs import validate_opt_results

    validate_opt_results(exp.opt_results, cfg.solver.n_pyr_lvls)
    exp.run_eval()
    aees = [
        float(np.asarray(r["evals"]["AEE"])) for r in exp.eval_results.values()
    ]
    assert np.mean(aees) < 1.6, aees


class TestArmijoRescue:
    """Armijo tail safeguard: anomalous windows re-solved with strong Wolfe."""

    def test_anomaly_predicate(self):
        import types

        import jax.numpy as jnp

        def fake(f_opt, status, f_prior):
            st = types.SimpleNamespace(
                fun_val=jnp.asarray(f_opt), status=jnp.asarray(status)
            )
            return types.SimpleNamespace(
                theta_opt_states=(st,), prior_loss_lvl0=jnp.asarray(f_prior)
            )

        anom = EINCMExperiment._anomalous
        assert not anom(fake(-5.0, 1, -4.0))  # improved on the prior: fine
        assert not anom(fake(-5.0, 2, jnp.inf))  # first-ish window: fine
        assert anom(fake(-3.0, 1, -4.0))  # worse than keeping the prior
        assert anom(fake(jnp.nan, 3, -4.0))  # NaN solve

    def test_prior_loss_recorded(self, tmp_path):
        cfg = tiny_cfg(tmp_path)
        exp = EINCMExperiment(cfg)
        dl = cfg.dataset.make_loader()
        dl.get_ready()
        staged = exp.stage(dl[0])
        prior = exp.solver_cfg.zero_pyramid()
        res1 = exp.window_solver(staged.window, prior, is_first=True)
        assert np.isposinf(float(res1.prior_loss_lvl0))
        res2 = exp.window_solver(
            staged.window, res1.final_theta_pyr, is_first=False
        )
        f_prior = float(res2.prior_loss_lvl0)
        assert np.isfinite(f_prior)
        # the prior IS this window's solution, so re-optimizing from it
        # cannot end worse: the anomaly predicate must pass
        assert not exp._anomalous(res2)

    def test_repeat_solve_keeps_first_prior_loss(self, tmp_path):
        """Regression (round-3 review): with phases.n_repeat_solve > 1 the
        returned prior_loss_lvl0 must be the FIRST repeat's — measured
        against the previous WINDOW's theta — not the last repeat's, which
        measures against the window's own near-optimal first solve and makes
        the anomaly predicate vacuously false."""
        cfg = tiny_cfg(tmp_path)
        cfg.phases.n_repeat_solve = 2
        exp = EINCMExperiment(cfg)
        dl = cfg.dataset.make_loader()
        dl.get_ready()
        staged0, staged1 = exp.stage(dl[0]), exp.stage(dl[1])
        res0 = exp._solve_one(
            exp.window_solver, staged0, exp.solver_cfg.zero_pyramid(), True
        )
        res1 = exp._solve_one(
            exp.window_solver, staged1, res0.final_theta_pyr, False
        )
        # ground truth for the signal: a single un-repeated solve from the
        # same prior (prior_loss_lvl0 depends only on the prior, not on the
        # optimization that follows)
        ref = exp.window_solver(
            staged1.window, res0.final_theta_pyr, is_first=False
        )
        f_repeat = float(res1.prior_loss_lvl0)
        f_ref = float(ref.prior_loss_lvl0)
        assert np.isfinite(f_repeat)
        np.testing.assert_allclose(f_repeat, f_ref, rtol=1e-6)
        # and it must NOT be the last repeat's self-referential value (ref
        # IS the first repeat, so feeding its final theta back reproduces
        # exactly what the buggy second repeat reported): the loss at the
        # window's own first-solve optimum is strictly better than at the
        # previous window's theta on this workload
        f_buggy = float(
            exp.window_solver(
                staged1.window, ref.final_theta_pyr, is_first=False
            ).prior_loss_lvl0
        )
        assert f_buggy < f_repeat

    def test_rescue_engages_and_results_valid(self, tmp_path, monkeypatch):
        cfg = tiny_cfg(tmp_path)
        cfg.phases.eval = False
        exp = EINCMExperiment(cfg)
        # force the anomaly on every non-first window; the rescue must run,
        # count, and still produce a schema-valid opt_results tree
        monkeypatch.setattr(
            EINCMExperiment, "_anomalous", staticmethod(lambda res: True)
        )
        exp.run_solver()
        assert exp.n_rescue_attempts == cfg.dataset.n_windows - 1
        assert 0 <= exp.n_rescued <= exp.n_rescue_attempts
        validate_opt_results(exp.opt_results, cfg.solver.n_pyr_lvls)

    def test_rescue_off_when_wolfe(self, tmp_path, monkeypatch):
        cfg = tiny_cfg(tmp_path)
        cfg.phases.eval = False
        cfg.solver.line_search = "wolfe"
        exp = EINCMExperiment(cfg)
        monkeypatch.setattr(
            EINCMExperiment, "_anomalous", staticmethod(lambda res: True)
        )
        exp.run_solver()
        assert exp.n_rescue_attempts == 0 and exp.n_rescued == 0


def test_parallel_checkpoint_step_sized_from_solved_windows(tmp_path):
    """Regression (round-3 review): the super-step size must come from the
    windows actually solved this run, not len(dataloader) — with a
    run_idx_range restricting 24 windows to 16, sizing from 24 would round
    the step past 16 and silently write zero mid-run checkpoints."""
    cfg = tiny_cfg(tmp_path)
    cfg.dataset.n_windows = 24
    cfg.dataset.velocity = (0.5, -0.25)
    cfg.phases.parallel_windows = True
    cfg.phases.eval = False
    cfg.phases.run_idx_range = (0, 16)
    cfg.phases.parallel_checkpoint_every_percent = 50.0
    cfg.phases.delete_checkpoints_at_end = False
    exp = EINCMExperiment(cfg)
    exp.run_solver()
    assert len(exp.opt_results) == 16
    ckpts = sorted(exp.ckpt_dir.glob("checkpoint_*.npz"))
    assert len(ckpts) == 1, [c.name for c in ckpts]
    ck = np.load(ckpts[0], allow_pickle=True)["opt_results"].item()
    assert len(ck) == 8  # first super-step: 50% of the 16 solved windows


def test_parallel_windows_checkpoint_resume(tmp_path):
    """Parallel-mode mid-sequence checkpointing: the sequence solves in
    super-steps with the prior chain carried across them, a checkpoint after
    each; killing after the first super-step and resuming reproduces the
    straight-through results bitwise."""
    cfg = tiny_cfg(tmp_path)
    cfg.dataset.n_windows = 16
    cfg.dataset.velocity = (0.5, -0.25)  # 16 windows must fit the sensor
    cfg.phases.parallel_windows = True
    cfg.phases.eval = False
    cfg.phases.parallel_checkpoint_every_percent = 50.0  # 2 super-steps of 8
    cfg.phases.delete_checkpoints_at_end = False
    exp = EINCMExperiment(cfg)
    exp.run_solver()
    assert len(exp.opt_results) == 16
    ckpts = sorted(exp.ckpt_dir.glob("checkpoint_*.npz"))
    assert len(ckpts) == 1, [c.name for c in ckpts]
    ck = np.load(ckpts[0], allow_pickle=True)["opt_results"].item()
    assert len(ck) == 8  # first super-step only

    # "kill" after the first super-step: resume from its checkpoint
    cfg2 = tiny_cfg(tmp_path / "resumed")
    cfg2.dataset.n_windows = 16
    cfg2.dataset.velocity = (0.5, -0.25)
    cfg2.phases.parallel_windows = True
    cfg2.phases.eval = False
    cfg2.phases.parallel_checkpoint_every_percent = 50.0
    cfg2.phases.run_from_checkpoint = str(ckpts[0])
    exp2 = EINCMExperiment(cfg2)
    exp2.run_solver()
    assert len(exp2.opt_results) == 16
    # resumed records match the straight-through run exactly (the resumed
    # super-step was seeded with the same carried boundary prior)
    for key in exp.opt_results:
        np.testing.assert_array_equal(
            exp2.opt_results[key]["solver_final_results"]["final_theta_pyr"][
                "pyr_lvl_0"
            ],
            exp.opt_results[key]["solver_final_results"]["final_theta_pyr"][
                "pyr_lvl_0"
            ],
            err_msg=key,
        )
