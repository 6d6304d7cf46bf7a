"""Experiment orchestration: SOLVE / EVAL / PLOT phases over a sequence.

Functional equivalent of `EINCMExperiment` (src/experiments/e00/exp_mgr.py:
32-862): per-window staging, the sequential prior-chain solve, periodic
checkpointing with resume, evaluation against ground truth, score
aggregation into scores.txt, and plotting. The solver itself is the jitted
on-device pyramid (one dispatch per window) instead of a host BFGS loop.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from eincm_tpu.data.staging import StagedSample, stage_datasample
from eincm_tpu.evals.theta_metrics import evaluate_theta_array
from eincm_tpu.experiments.config import ExperimentConfig
from eincm_tpu.experiments.outputs import (
    EINCMOutputLoader,
    save_eval_results,
    save_opt_results,
    solve_result_to_record,
    validate_opt_results,
)
from eincm_tpu.models.pyramid import WindowSample, make_window_solver
from eincm_tpu.ops.resize import scale_theta_to_sensor_size
from eincm_tpu.utils.console import log, ok, warn

EPSN = sys.float_info.epsilon

# DSEC-extended scoring also reports the original-timestamp subset
# (exp_mgr.py:706-714): every 5th window, skipping the first.
_EXTENDED_SUBSET = slice(None, None, 5)


class EINCMExperiment:
    def __init__(self, cfg: ExperimentConfig):
        self.cfg = cfg
        self.solver_cfg = cfg.solver_config()
        self.edge_fn = cfg.edge.make_edge_fn()

        # armijo tail safeguard (serial path): the anomaly signal costs one
        # extra finest-level loss evaluation per window inside the jitted
        # solve, so it is compiled in only when the rescue is active
        self._rescue_on = (
            cfg.solver.line_search == "armijo" and cfg.solver.armijo_rescue
        )
        serial_cfg = self.solver_cfg
        if self._rescue_on:
            import dataclasses

            serial_cfg = dataclasses.replace(
                serial_cfg, compute_prior_loss=True
            )
        if cfg.solver.scan_levels and not (
            serial_cfg.collect_intermediate or serial_cfg.progress_heartbeat
        ):
            from eincm_tpu.models.pyramid_scan import make_window_solver_scan

            self.window_solver = make_window_solver_scan(serial_cfg)
        else:
            if cfg.solver.scan_levels:
                log(
                    "solver.scan_levels ignored: collect_intermediate / "
                    "progress_heartbeat need the per-level build"
                )
            self.window_solver = make_window_solver(serial_cfg)

        self.out_dir = Path(cfg.output_dir) / cfg.experiment_name
        self.ckpt_dir = self.out_dir / "checkpoints"
        os.makedirs(self.ckpt_dir, exist_ok=True)

        self.opt_results: Dict = {}
        self.eval_results: Dict = {}
        self.dataloader = None
        self._prior_pyr = None
        self._is_first = True
        self._ckpt_idx = -1
        self._rescue_solver = None  # lazily-compiled wolfe variant
        self.n_rescue_attempts = 0  # anomalies that triggered a wolfe re-solve
        self.n_rescued = 0  # re-solves that actually replaced the result

    # ------------------------------------------------------------------ prep

    def _prepare_dataloader(self):
        if self.dataloader is None:
            self.dataloader = self.cfg.dataset.make_loader()
            self.dataloader.get_ready()
        return self.dataloader

    def _maybe_resume(self):
        path = self.cfg.phases.run_from_checkpoint
        if not path:
            return
        log(f"resuming from checkpoint {path}")
        data = np.load(path, allow_pickle=True)
        self.opt_results = data["opt_results"].item()
        idxs = sorted(
            int(k.replace("datasample_idx_", "")) for k in self.opt_results
        )
        self._ckpt_idx = idxs[-1]
        last = self.opt_results[f"datasample_idx_{self._ckpt_idx}"]
        pyr = last["solver_final_results"]["final_theta_pyr"]
        self._prior_pyr = tuple(
            jnp.asarray(pyr[f"pyr_lvl_{l}"])
            for l in range(self.solver_cfg.n_pyr_lvls)
        )
        self._is_first = False

    def _skip_idx(self, idx: int) -> bool:
        if idx <= self._ckpt_idx:
            return True
        rng = self.cfg.phases.run_idx_range
        if rng is not None and not (rng[0] <= idx < rng[1]):
            return True
        ranges = self.cfg.phases.run_idx_ranges
        if ranges is not None and not any(a <= idx < b for a, b in ranges):
            return True
        return False

    def stage(self, datasample) -> StagedSample:
        # NaN-pad every window to the configured event count: loaders can
        # come up short at sequence boundaries (the reference's unhandled
        # "corner case", dsec_loader.py:297-306), and one odd shape would
        # force a full solve/eval recompile (minutes at DSEC scale). Padded events
        # contribute exactly nothing, so this is value-preserving.
        return stage_datasample(
            datasample,
            edge_fn=self.edge_fn,
            preprocess=self.cfg.edge.enable_image_preprocessing,
            pad_to=self.cfg.dataset.des_n_events,
        )

    # ----------------------------------------------------------------- solve

    def run_solver(self):
        if self.cfg.phases.parallel_windows:
            return self.run_solver_parallel()
        dl = self._prepare_dataloader()
        self._maybe_resume()
        if self._prior_pyr is None:
            self._prior_pyr = self.solver_cfg.zero_pyramid()

        n = len(dl)
        # 0 (or >=100) disables mid-sequence checkpoints, matching the
        # parallel path's gate — previously 0 meant "after every window"
        ckpt_pct = self.cfg.phases.checkpoint_every_percent
        ckpt_every = (
            max(1, int(np.ceil(n * ckpt_pct / 100.0)))
            if ckpt_pct and 0 < ckpt_pct < 100
            else None
        )
        t_begin = time.perf_counter()
        n_done = 0
        indices = [i for i in range(n) if not self._skip_idx(i)]
        from eincm_tpu.data.prefetch import StagingPrefetcher

        def finalize(idx, res):
            """Materialize one window's results on the host (blocks until the
            device finishes it; the NEXT window is already enqueued by then,
            so the readback rides behind its execution)."""
            nonlocal n_done
            rec = solve_result_to_record(res)
            self.opt_results[f"datasample_idx_{idx}"] = rec
            n_done += 1
            dt = time.perf_counter() - t_begin
            states = rec["solver_final_results"]["theta_opt_state_pyr"]
            f0 = float(states["pyr_lvl_0"]["fun_val"])
            iters = [
                int(states[f"pyr_lvl_{i}"]["iter_num"])
                for i in range(len(states))
            ]
            log(
                f"[{idx + 1}/{n}] solved (f={f0:.4f}, iters={iters}, "
                f"avg {dt / n_done:.1f}s/window)"
            )
            if ckpt_every and n_done % ckpt_every == 0:
                self.save_checkpoint(idx, n)

        def stage_for_solve(ds):
            # transfer the solver inputs host->device inside the prefetch
            # worker thread, so the copies overlap the previous window's
            # device compute instead of blocking the dispatch
            import jax

            staged = self.stage(ds)
            return staged._replace(window=jax.device_put(staged.window))

        # One-window readback lag: dispatch window i+1 (async, queues on
        # device behind i via the prior-pyramid dependency) BEFORE window
        # i's anomaly check / result fetch, so host transfers overlap device
        # compute. The armijo rescue is OPTIMISTIC about this pipelining:
        # window i+1 launches with i's unrescued prior; when the (rare,
        # <~10%) rescue fires, window i is re-solved with strong Wolfe and
        # window i+1 is re-dispatched from the corrected prior.
        prefetcher = StagingPrefetcher(dl, indices, stage_for_solve, depth=2)
        pending = None  # (idx, staged, prior_before, first_before, res)

        def check_and_finalize(pending, cur=None):
            """Anomaly-check + finalize the pending window; `cur` is the
            in-flight successor (idx, staged, res, prior) to re-dispatch if
            the pending window gets rescued. Returns cur's (possibly
            re-solved) (res, prior-it-was-solved-from)."""
            p_idx, p_staged, p_prior, p_first, p_res = pending
            cur_res, cur_prior = (cur[2], cur[3]) if cur is not None else (None, None)
            if self._rescue_on and not p_first and self._anomalous(p_res):
                fixed = self._rescue_window(p_idx, p_staged, p_prior, p_res)
                if fixed is not p_res:
                    p_res = fixed
                    if cur is not None:
                        cur_prior = fixed.final_theta_pyr
                        cur_res = self._solve_one(
                            self.window_solver, cur[1], cur_prior, False
                        )
                        self._prior_pyr = cur_res.final_theta_pyr
                    else:
                        self._prior_pyr = fixed.final_theta_pyr
            finalize(p_idx, p_res)
            self._eager_hooks(p_idx, p_staged)
            return cur_res, cur_prior

        for idx, staged in prefetcher:
            prior_before, first_before = self._prior_pyr, self._is_first
            res = self._solve_one(
                self.window_solver, staged, prior_before, first_before
            )
            self._prior_pyr = res.final_theta_pyr  # optimistic
            self._is_first = False
            if pending is not None:
                res, prior_before = check_and_finalize(
                    pending, (idx, staged, res, prior_before)
                )
            pending = (idx, staged, prior_before, first_before, res)
        if pending is not None:
            check_and_finalize(pending)
        if self.n_rescue_attempts:
            warn(
                f"armijo rescue: {self.n_rescue_attempts}/{len(indices)} "
                f"windows re-solved with strong Wolfe, {self.n_rescued} "
                "replaced by the Wolfe result"
            )

        validate_opt_results(self.opt_results, self.solver_cfg.n_pyr_lvls)
        save_opt_results(
            self.out_dir / "opt_results.npz", self.opt_results, self.cfg.to_dict()
        )
        ok(f"opt_results.npz saved ({len(self.opt_results)} windows)")
        self._delete_checkpoints_if_configured()
        return self.opt_results

    def _stream_sharded_batch(self, dl, indices, mesh):
        """Stage the given windows through the prefetcher and assemble the
        sharded batch *incrementally on the devices*: each window is
        device_put onto its target shard as soon as staging finishes, so
        peak host memory is O(prefetch depth), not O(sequence) (the round-1
        version materialized the whole staged sequence in RAM first).

        Returns:
            (batch with global NamedSharding, batch_n).
        """
        n = len(indices)
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from eincm_tpu.data.prefetch import StagingPrefetcher

        n_dev = mesh.devices.size
        devices = mesh.devices.reshape(-1)
        # pad the window count to a multiple of the device count by
        # repeating the last window (results discarded after the solve)
        batch_n = -(-n // n_dev) * n_dev
        per_dev = batch_n // n_dev

        # NaN-pad every window to ONE fixed event count (padded events
        # contribute nothing to any splat/mask) so windows stack and shard.
        # A per-window pad target would produce ragged windows that cannot
        # stack — the streamed path never sees the whole sequence, so it
        # cannot discover a global maximum and requires des_n_events.
        pad_to = self.cfg.dataset.des_n_events
        if not pad_to:
            raise ValueError(
                "parallel windows mode requires dataset.des_n_events: the "
                "streamed sharded batch pads every window to that fixed "
                "event count (ragged windows cannot stack/shard)"
            )

        def stage_padded(ds):
            actual = len(ds["events"]["x"])
            if actual > pad_to:
                raise ValueError(
                    f"window has {actual} events > des_n_events={pad_to}; "
                    "the loader must truncate to des_n_events in parallel "
                    "windows mode"
                )
            return stage_datasample(
                ds,
                edge_fn=self.edge_fn,
                preprocess=self.cfg.edge.enable_image_preprocessing,
                pad_to=pad_to,
            )

        dev_windows = [[] for _ in range(n_dev)]
        prefetcher = StagingPrefetcher(dl, indices, stage_padded, depth=2)
        last = None
        for pos, (_, staged) in enumerate(prefetcher):
            j = pos // per_dev
            last = jax.device_put(staged.window, devices[j])
            dev_windows[j].append(last)
        for i in range(n, batch_n):
            j = i // per_dev
            dev_windows[j].append(jax.device_put(last, devices[j]))

        # stack each device's windows in place, then assemble global arrays
        stacked = [
            jax.tree_util.tree_map(lambda *a: jnp.stack(a), *bufs)
            for bufs in dev_windows
        ]
        shard = NamedSharding(mesh, P("windows"))

        def make_global(*leaves):
            global_shape = (batch_n, *leaves[0].shape[1:])
            return jax.make_array_from_single_device_arrays(
                global_shape, shard, list(leaves)
            )

        batch = jax.tree_util.tree_map(make_global, *stacked)
        return batch, batch_n

    def run_solver_parallel(self):
        """Whole-sequence solve sharded over all available devices.

        Two schedules for the sequential handover prior chain
        (src/eincm/solver.py:254-255; SURVEY.md §7 "hard parts"):

        - 'two_pass' (default): pass 1 solves every window prior-free in
          parallel; pass 2 re-solves with each window's prior taken from its
          predecessor's pass-1 result.
        - 'sequence_shard': contiguous window chunks per device with the
          exact in-chunk handover chain; chunk-boundary priors travel over
          the mesh via ppermute (parallel.batch.sequence_shard_solve).
        """
        import jax

        from eincm_tpu.parallel.batch import (
            make_window_mesh,
            sequence_shard_solve,
            two_pass_sequence_solve,
        )

        dl = self._prepare_dataloader()
        # checkpoint resume: restores solved records, skips their indices,
        # and carries the last solved window's final pyramid as the boundary
        # prior of the first remaining super-step
        self._maybe_resume()
        boundary = None if self._is_first else self._prior_pyr
        indices = [i for i in range(len(dl)) if not self._skip_idx(i)]
        mesh = make_window_mesh()
        n_dev = mesh.devices.size
        n = len(indices)

        mode = self.cfg.phases.parallel_mode
        if mode not in ("sequence_shard", "two_pass"):
            raise ValueError(f"unknown parallel_mode {mode!r}")

        # Mid-sequence checkpointing (exp_mgr.py:511-519 parity for the
        # parallel path): the sequence solves in super-steps of ~N% of the
        # windows (rounded up to a device-count multiple), the prior chain
        # carried across super-steps through `boundary`, a checkpoint saved
        # after each. Off by default (None) — a dedicated knob, because
        # chunking also moves each super-step's first-window prior to the
        # exact carried value (see PhaseSettings).
        pct = self.cfg.phases.parallel_checkpoint_every_percent
        serial_pct = self.cfg.phases.checkpoint_every_percent
        if pct is None and serial_pct != 25.0:  # 25.0 = dataclass default
            log(
                "NOTE: phases.checkpoint_every_percent is customized but "
                "only applies to the serial path; parallel runs checkpoint "
                "via phases.parallel_checkpoint_every_percent (unset — no "
                "mid-sequence checkpoints this run)"
            )
        total = len(dl)
        if pct and 0 < pct < 100 and n > n_dev:
            log(
                f"parallel super-step checkpointing every ~{pct}% of "
                "windows (prior chain carried exactly across super-steps)"
            )
            # sized from the n windows actually solved this run (resume /
            # run_idx_range can leave n << len(dl); sizing from the full
            # sequence would silently produce zero mid-run checkpoints)
            step = max(n_dev, -(-int(np.ceil(n * pct / 100.0)) // n_dev) * n_dev)
        else:
            step = max(n, 1)

        cfg_solver = self.cfg.solver_config()
        for start in range(0, n, step):
            chunk_idx = indices[start : start + step]
            batch, _ = self._stream_sharded_batch(dl, chunk_idx, mesh)
            if mode == "sequence_shard":
                res, final = sequence_shard_solve(
                    cfg_solver, batch, mesh, boundary_prior=boundary
                )
            else:
                res, final = two_pass_sequence_solve(
                    cfg_solver, batch, mesh, boundary_prior=boundary
                )

            # ONE host transfer for the whole result tree, then numpy
            # slicing — per-window sliced fetches would be ~50 tiny
            # device round-trips per window (outputs.solve_result_to_record)
            res = jax.device_get(res._replace(final_theta_pyr=tuple(final)))
            for i, ds_idx in enumerate(chunk_idx):
                rec = jax.tree_util.tree_map(lambda x: x[i], res)
                self.opt_results[f"datasample_idx_{ds_idx}"] = (
                    solve_result_to_record(rec)
                )
            # prior-chain carry = final pyramid of the last REAL window
            # (padded repeats beyond len(chunk_idx) are discarded)
            last = self.opt_results[f"datasample_idx_{chunk_idx[-1]}"]
            pyr = last["solver_final_results"]["final_theta_pyr"]
            boundary = tuple(
                jnp.asarray(pyr[f"pyr_lvl_{l}"])
                for l in range(self.solver_cfg.n_pyr_lvls)
            )
            if start + step < n:
                self.save_checkpoint(chunk_idx[-1], total)

        validate_opt_results(self.opt_results, self.solver_cfg.n_pyr_lvls)
        save_opt_results(
            self.out_dir / "opt_results.npz", self.opt_results, self.cfg.to_dict()
        )
        ok(
            f"opt_results.npz saved ({n} windows, {mode} over "
            f"{n_dev} device(s))"
        )
        self._delete_checkpoints_if_configured()
        return self.opt_results

    def _solve_one(self, solver, staged, prior, is_first):
        """Run one window (incl. n_repeat_solve repeats).

        Repeats deliberately feed the window's own result back as the prior
        and drop first-sample semantics after the first solve — exactly the
        reference's behavior (solver.py:254-256 updates prior_theta_pyr and
        _IS_FIRST_SAMPLE at the END of solve()).

        The returned result carries the FIRST repeat's prior_loss_lvl0: the
        armijo-rescue anomaly signal compares the window's optimum against
        the PREVIOUS window's theta, and later repeats would measure it
        against the window's own near-optimal first solve instead (making
        `_anomalous` vacuously false for n_repeat_solve > 1).
        """
        first_prior_loss = None
        for _ in range(max(1, self.cfg.phases.n_repeat_solve)):
            res = solver(staged.window, prior, is_first=is_first)
            if first_prior_loss is None:
                first_prior_loss = res.prior_loss_lvl0
            prior = res.final_theta_pyr
            is_first = False
        return res._replace(prior_loss_lvl0=first_prior_loss)

    @staticmethod
    def _anomalous(res) -> bool:
        """An armijo window whose level-0 optimum is worse than keeping the
        prior window's theta (or that hit NaN) is anomalous. One batched
        scalar fetch: each device round-trip costs more than the scalars."""
        import jax

        f_opt, f_prior, status = jax.device_get(
            (
                res.theta_opt_states[0].fun_val,
                res.prior_loss_lvl0,
                res.theta_opt_states[0].status,
            )
        )
        return int(status) == 3 or not (float(f_opt) <= float(f_prior))

    def _rescue_window(self, idx, staged, prior, armijo_res):
        """Re-solve an anomalous armijo window with strong Wolfe; keep the
        better of the two (by level-0 pre-handover loss). The Wolfe solver
        variant compiles lazily on the first rescue."""
        if self._rescue_solver is None:
            import dataclasses

            # the wolfe second opinion keeps its validated bracket+zoom
            # budget even under the leaner armijo probe cap (PARITY.md)
            rescue_cfg = dataclasses.replace(
                self.solver_cfg,
                line_search="wolfe",
                max_ls_evals=max(10, self.solver_cfg.max_ls_evals),
            )
            if self.cfg.solver.scan_levels and not (
                rescue_cfg.collect_intermediate
                or rescue_cfg.progress_heartbeat
            ):
                from eincm_tpu.models.pyramid_scan import (
                    make_window_solver_scan,
                )

                self._rescue_solver = make_window_solver_scan(rescue_cfg)
            else:
                self._rescue_solver = make_window_solver(rescue_cfg)
        wolfe_res = self._solve_one(self._rescue_solver, staged, prior, False)
        f_a = float(armijo_res.theta_opt_states[0].fun_val)
        f_w = float(wolfe_res.theta_opt_states[0].fun_val)
        self.n_rescue_attempts += 1
        warn(
            f"[{idx}] armijo anomaly (lvl-0 f={f_a:.6f} vs prior "
            f"f={float(armijo_res.prior_loss_lvl0):.6f}); wolfe rescue "
            f"f={f_w:.6f}"
        )
        if f_w <= f_a or not np.isfinite(f_a):
            self.n_rescued += 1
            return wolfe_res
        return armijo_res

    def _delete_checkpoints_if_configured(self):
        if self.cfg.phases.delete_checkpoints_at_end:
            for p in self.ckpt_dir.glob("checkpoint_*.npz"):
                p.unlink()

    def save_checkpoint(self, idx: int, total: int):
        path = self.ckpt_dir / f"checkpoint_{idx}_{total}.npz"
        save_opt_results(path, self.opt_results, self.cfg.to_dict())
        log(f"checkpoint saved: {path}")

    # ------------------------------------------------------------------ eval

    def _final_theta_full(self, idx: int):
        rec = self.opt_results[f"datasample_idx_{idx}"]
        theta0 = np.asarray(
            rec["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"]
        )
        return scale_theta_to_sensor_size(
            jnp.asarray(theta0),
            tuple(self.cfg.dataset.sensor_size),
            self.cfg.solver.scale_theta_to_sensor_size_method,
        )

    def run_eval(self, opt_results_path: Optional[str] = None):
        if opt_results_path is None and not self.opt_results:
            # EVAL-only invocation (phases.solve=false): load this
            # experiment's saved artifact, like the reference's
            # opt_results_from_mem=False path (exp_mgr.py:556-559, 836-848)
            default = self.out_dir / "opt_results.npz"
            if default.exists():
                opt_results_path = str(default)
                log(f"loading opt_results from {default}")
        if opt_results_path is not None:
            loader = EINCMOutputLoader()
            self.opt_results = loader.load_opt_results(opt_results_path)
        assert self.opt_results, "no opt_results in memory or on disk"
        if self.cfg.phases.parallel_eval:
            if self.cfg.phases.eval_intermediate:
                warn(
                    "phases.parallel_eval ignores eval_intermediate "
                    "(per-iterate trajectories evaluate serially); running "
                    "the serial eval path"
                )
            else:
                return self.run_eval_parallel()
        dl = self._prepare_dataloader()
        indices = sorted(
            int(k.replace("datasample_idx_", "")) for k in self.opt_results
        )
        from eincm_tpu.data.prefetch import StagingPrefetcher

        # overlap host staging (edge extraction) with the device evaluations
        for idx, staged in StagingPrefetcher(dl, indices, self.stage, depth=2):
            key = f"datasample_idx_{idx}"
            gt, mask, eval_inputs = self._eval_one_window(idx, staged)
            if self.cfg.phases.eval_intermediate:
                inter = self._eval_intermediate(
                    key, staged, gt, mask, eval_inputs
                )
                if inter is not None:
                    self.eval_results[key]["intermediate"] = inter

        save_eval_results(
            self.out_dir / "eval_results.npz", self.eval_results, self.cfg.to_dict()
        )
        scores = self.extract_scores()
        self.write_scores(scores)
        return self.eval_results

    def _eval_one_window(self, idx: int, staged: StagedSample):
        """Evaluate one solved window (shared by the EVAL phase's serial
        loop and the eager in-solve evaluation, exp_mgr.py:646-651).

        Returns (gt, mask, eval_inputs) so the intermediate-iterate path
        can reuse the hoisted statics."""
        key = f"datasample_idx_{idx}"
        theta_full = self._final_theta_full(idx)
        gt = staged.gt_flow
        mask = self._hood_mask()
        mask = None if mask is None else jnp.asarray(mask)

        # pad the eval events and compute the window's theta-independent
        # statistics ONCE; the final evaluation and every recorded iterate
        # share them
        from eincm_tpu.evals.theta_metrics import prepare_eval_inputs

        ev = staged.eval_events
        sensor = tuple(self.cfg.dataset.sensor_size)
        exs, eys, ets, wstat = prepare_eval_inputs(
            jnp.asarray(ev["x"], jnp.float32),
            jnp.asarray(ev["y"], jnp.float32),
            jnp.asarray(ev["t"], jnp.float32),
            staged.window.edges,
            sensor,
            dtype=theta_full.dtype,
        )
        eval_inputs = (exs, eys, ets, wstat)
        time_str, eval_str, evals, _ = evaluate_theta_array(
            theta_full,
            exs,
            eys,
            ets,
            staged.window.edges,
            staged.window.edge_ts,
            None if gt is None else jnp.asarray(gt, jnp.float32),
            self.cfg.loss_params,
            sensor,
            err_eval_event_mask=mask,
            window_statics=wstat,
        )
        self.eval_results[key] = {
            "evals": {k: np.asarray(v) for k, v in evals.items()},
            "eval_ts": np.asarray(staged.eval_ts),
            "eval_ts_units": staged.eval_ts_units,
        }
        log(f"{time_str} {key}: {eval_str.strip()}")
        return gt, mask, eval_inputs

    def _eager_hooks(self, idx: int, staged: StagedSample):
        """Eager per-window EVAL/PLOT right after a window's solve results
        are finalized (reference exp_mgr.py:646-656 with the every-N
        gates)."""
        ph = self.cfg.phases
        if ph.eager_eval and idx % max(1, ph.eager_eval_every) == 0:
            self._eval_one_window(idx, staged)
        if ph.eager_plot and idx % max(1, ph.eager_plot_every) == 0:
            if getattr(self, "_eager_plotter", None) is None:
                from eincm_tpu.experiments.plotters import (
                    EINCMExperimentPlotter,
                )

                self._eager_plotter = EINCMExperimentPlotter(
                    self.cfg, self.out_dir / "plots"
                )
            self._eager_plotter.plot_end_results(
                idx, staged, self._final_theta_full(idx)
            )

    def _hood_mask(self):
        if (
            self.cfg.dataset.kind == "mvsec"
            and self.cfg.dataset.sequence_name == "outdoor_day1"
        ):
            # car-hood mask: rows >= 190 excluded (exp_mgr.py:429-432)
            mask = np.ones(tuple(self.cfg.dataset.sensor_size), bool)
            mask[190:] = False
            return mask
        return None

    def run_eval_parallel(self):
        """EVAL sharded over the device mesh (VERDICT r3 item 5).

        Windows are independent at eval time (no prior chain), so this is
        pure data parallelism: staged windows stream through the prefetcher
        into chunks of n_dev * parallel_eval_windows_per_device, each chunk
        evaluated in ONE sharded dispatch (parallel.batch.eval_batch_sharded
        runs each device's windows sequentially via lax.map — identical
        per-window shapes to the serial path). Reference scope:
        exp_mgr.py:662-714 (a serial loop).
        """
        import jax

        from eincm_tpu.evals.theta_metrics import format_eval_result
        from eincm_tpu.parallel.batch import eval_batch_sharded, make_window_mesh

        dl = self._prepare_dataloader()
        indices = sorted(
            int(k.replace("datasample_idx_", "")) for k in self.opt_results
        )
        mesh = make_window_mesh()
        n_dev = mesh.devices.size
        chunk = n_dev * max(1, self.cfg.phases.parallel_eval_windows_per_device)
        sensor = tuple(self.cfg.dataset.sensor_size)
        pvec = jnp.asarray(
            [
                self.cfg.loss_params.alpha,
                self.cfg.loss_params.beta,
                self.cfg.loss_params.gamma,
                self.cfg.loss_params.delta,
            ],
            jnp.float32,
        )
        mask = self._hood_mask()
        mask_j = None if mask is None else jnp.asarray(mask)

        des = self.cfg.dataset.des_n_events
        if not des:
            raise ValueError(
                "phases.parallel_eval requires dataset.des_n_events (eval "
                "event windows must pad to one fixed length to stack/shard)"
            )
        base_pad_e = max(8192, -(-int(des) // 8192) * 8192)

        from eincm_tpu.data.prefetch import StagingPrefetcher

        def flush(chunk_items):
            idxs = [i for i, _ in chunk_items]
            staged_list = [s for _, s in chunk_items]
            b = len(idxs)
            # pad the batch to a device-count multiple by repeating the
            # last window (its extra results are discarded)
            b_pad = -(-b // n_dev) * n_dev
            staged_list = staged_list + [staged_list[-1]] * (b_pad - b)
            rep_idxs = idxs + [idxs[-1]] * (b_pad - b)

            # eval_events are boundary-sliced from the raw stream and NOT
            # capped by des_n_events, so a busy window can exceed the
            # des-derived capacity; grow to the chunk max in 8192 buckets
            # (one retrace per new bucket, bounded by the busiest window)
            chunk_max = max(len(s.eval_events["x"]) for s in staged_list)
            pad_e = max(base_pad_e, -(-chunk_max // 8192) * 8192)

            def padded_events(s):
                ev = s.eval_events
                e = len(ev["x"])
                out = np.full((3, pad_e), np.nan, np.float32)
                out[0, :e] = ev["x"]
                out[1, :e] = ev["y"]
                out[2, :e] = ev["t"]
                return out

            evs = np.stack([padded_events(s) for s in staged_list])
            theta = np.stack(
                [
                    np.asarray(
                        self.opt_results[f"datasample_idx_{i}"][
                            "solver_final_results"
                        ]["final_theta_pyr"]["pyr_lvl_0"],
                        np.float32,
                    )
                    for i in rep_idxs
                ]
            )
            edges = np.stack(
                [np.asarray(s.window.edges) for s in staged_list]
            )
            edge_ts = np.stack(
                [np.asarray(s.window.edge_ts) for s in staged_list]
            )
            has_gt = staged_list[0].gt_flow is not None
            if any((s.gt_flow is not None) != has_gt for s in staged_list):
                raise ValueError(
                    "parallel_eval chunk mixes windows with and without "
                    "gt_flow; GT presence must be uniform per sequence"
                )
            gt = (
                np.stack(
                    [
                        np.asarray(s.gt_flow, np.float32)
                        for s in staged_list
                    ]
                )
                if has_gt
                else None
            )

            small = eval_batch_sharded(
                jnp.asarray(theta),
                jnp.asarray(evs[:, 0]),
                jnp.asarray(evs[:, 1]),
                jnp.asarray(evs[:, 2]),
                jnp.asarray(edges),
                jnp.asarray(edge_ts),
                None if gt is None else jnp.asarray(gt),
                mask_j,
                pvec,
                mesh,
                sensor,
                self.cfg.solver.scale_theta_to_sensor_size_method,
            )
            for i, (idx, staged) in enumerate(zip(idxs, staged_list)):
                per_win = jax.tree_util.tree_map(lambda a: a[i], small)
                time_str, eval_str, evals = format_eval_result(
                    per_win, sensor, has_gt
                )
                key = f"datasample_idx_{idx}"
                self.eval_results[key] = {
                    "evals": {k: np.asarray(v) for k, v in evals.items()},
                    "eval_ts": np.asarray(staged.eval_ts),
                    "eval_ts_units": staged.eval_ts_units,
                }
                log(f"{time_str} {key}: {eval_str.strip()}")

        pending = []
        for idx, staged in StagingPrefetcher(dl, indices, self.stage, depth=2):
            pending.append((idx, staged))
            if len(pending) == chunk:
                flush(pending)
                pending = []
        if pending:
            flush(pending)

        save_eval_results(
            self.out_dir / "eval_results.npz", self.eval_results, self.cfg.to_dict()
        )
        scores = self.extract_scores()
        self.write_scores(scores)
        ok(
            f"parallel eval: {len(indices)} windows over {n_dev} device(s), "
            f"chunks of {chunk}"
        )
        return self.eval_results

    def _eval_intermediate(self, key, staged, gt, mask, eval_inputs):
        """Evaluate every recorded level-0 BFGS iterate of one window.

        Post-hoc equivalent of the reference's eval-during-solve callback
        (src/eincm/callbacks.py:140-149): the solver records the full theta
        trajectory on device (models/bfgs.py BFGSHistory); here each iterate
        is upscaled and run through the jitted evaluation bundle.
        `eval_inputs` is the (padded events, window statics) tuple computed
        once per window by the caller — the theta-independent zero-warp
        splat is NOT redone per iterate.
        """
        rec = self.opt_results[key]["solver_intermediate_results"]["theta_opt"]
        thetas = rec.get("thetas", {}).get("pyr_lvl_0")
        if thetas is None:
            warn(
                "phases.eval_intermediate needs solver.collect_intermediate; "
                "no recorded iterates found"
            )
            return None
        shape = (*self.solver_cfg.level_shape(0), 2)
        sensor = tuple(self.cfg.dataset.sensor_size)
        exs, eys, ets, wstat = eval_inputs
        per_iter: Dict[str, list] = {}
        for it in range(thetas.shape[0]):
            theta_full = scale_theta_to_sensor_size(
                jnp.asarray(np.asarray(thetas[it]).reshape(shape)),
                sensor,
                self.cfg.solver.scale_theta_to_sensor_size_method,
            )
            _, _, evals_i, _ = evaluate_theta_array(
                theta_full,
                exs,
                eys,
                ets,
                staged.window.edges,
                staged.window.edge_ts,
                None if gt is None else jnp.asarray(gt, jnp.float32),
                self.cfg.loss_params,
                sensor,
                err_eval_event_mask=mask,
                window_statics=wstat,
            )
            for k, v in evals_i.items():
                arr = np.asarray(v)
                if arr.ndim == 0:
                    per_iter.setdefault(k, []).append(float(arr))
        return {k: np.asarray(v) for k, v in per_iter.items()}

    # ---------------------------------------------------------------- scores

    def extract_scores(self) -> Dict[str, Dict[str, float]]:
        """Aggregate per-window metrics into min | mean+-std | max
        (exp_mgr.py:821-833)."""
        per_metric: Dict[str, list] = {}
        for rec in self.eval_results.values():
            for k, v in rec["evals"].items():
                arr = np.asarray(v)
                if arr.ndim == 0:
                    per_metric.setdefault(k, []).append(float(arr))
        scores = {}
        for k, vals in per_metric.items():
            a = np.asarray(vals)
            scores[k] = {
                "min": float(a.min()),
                "mean": float(a.mean()),
                "std": float(a.std()),
                "max": float(a.max()),
            }
            if self.cfg.dataset.kind == "dsec" and self.cfg.dataset.extended:
                sub = a[_EXTENDED_SUBSET][1:]
                if len(sub):
                    scores[k]["orig_subset_mean"] = float(sub.mean())
                    scores[k]["orig_subset_std"] = float(sub.std())
        return scores

    def write_scores(self, scores: Dict[str, Dict[str, float]]):
        path = self.out_dir / "scores.txt"
        with open(path, "w") as f:
            f.write(f"# {self.cfg.experiment_name} — per-metric aggregation\n")
            f.write("# metric: min | mean±std | max\n")
            for k in sorted(scores):
                s = scores[k]
                line = (
                    f"{k}: {s['min']:.6f} | {s['mean']:.6f}±{s['std']:.6f} "
                    f"| {s['max']:.6f}"
                )
                if "orig_subset_mean" in s:
                    line += (
                        f"  (orig-ts subset: "
                        f"{s['orig_subset_mean']:.6f}±{s['orig_subset_std']:.6f})"
                    )
                f.write(line + "\n")
        ok(f"scores.txt written: {path}")

    # ------------------------------------------------------------------ plot

    def run_plot(self, opt_results_path=None, eval_results_path=None):
        from eincm_tpu.experiments.plotters import EINCMExperimentPlotter

        if self.cfg.mpl_rcparams:
            # reference: mpl_rcparams config group applied before plotting
            # (src/experiments/e00/__main__.py:29-31)
            import matplotlib

            matplotlib.rcParams.update(self.cfg.mpl_rcparams)
        if opt_results_path is None and not self.opt_results:
            # PLOT-only invocation: load this experiment's saved artifacts
            default = self.out_dir / "opt_results.npz"
            if default.exists():
                opt_results_path = str(default)
        if eval_results_path is None and not self.eval_results:
            default_ev = self.out_dir / "eval_results.npz"
            if default_ev.exists():
                eval_results_path = str(default_ev)
        if opt_results_path is not None:
            self.opt_results = EINCMOutputLoader().load_opt_results(
                opt_results_path
            )
        if eval_results_path is not None:
            self.eval_results = EINCMOutputLoader().load_eval_results(
                eval_results_path
            )
        dl = self._prepare_dataloader()
        plotter = EINCMExperimentPlotter(self.cfg, self.out_dir / "plots")
        for key in sorted(
            self.opt_results, key=lambda k: int(k.replace("datasample_idx_", ""))
        ):
            idx = int(key.replace("datasample_idx_", ""))
            staged = self.stage(dl[idx])
            theta_full = self._final_theta_full(idx)
            plotter.plot_end_results(idx, staged, theta_full)

            # handover diagnostic at the finest level (reference
            # plotters.py:448-473): solved / prior / blended theta with the
            # solved weight. First windows skip handover (final == pre).
            fin = self.opt_results[key]["solver_final_results"]
            w0 = float(
                np.asarray(fin["final_handover_weight_pyr"]["pyr_lvl_0"])
            )
            pre0 = np.asarray(fin["pre_handover_theta_pyr"]["pyr_lvl_0"])
            post0 = np.asarray(fin["final_theta_pyr"]["pyr_lvl_0"])
            if not np.array_equal(pre0, post0):
                plotter.plot_handover(
                    idx,
                    pre0,
                    np.asarray(fin["prior_theta_pyr"]["pyr_lvl_0"]),
                    post0,
                    alpha_ho=w0,
                    pyr=0,
                )

            # per-step figures from recorded iterates (reference
            # plotters.py:493-645, driven here by the on-device history)
            inter = self.opt_results[key]["solver_intermediate_results"][
                "theta_opt"
            ]
            thetas = inter.get("thetas", {}).get("pyr_lvl_0")
            if thetas is not None and len(thetas):
                shape = (*self.solver_cfg.level_shape(0), 2)
                sensor = tuple(self.cfg.dataset.sensor_size)
                picks = sorted({0, len(thetas) // 2, len(thetas) - 1})
                prev_full = None
                for it in picks:
                    th_full = np.asarray(
                        scale_theta_to_sensor_size(
                            jnp.asarray(np.asarray(thetas[it]).reshape(shape)),
                            sensor,
                            self.cfg.solver.scale_theta_to_sensor_size_method,
                        )
                    )
                    plotter.plot_step_result_detail(
                        idx, staged, th_full, prev_full, itr=it, pyr=0
                    )
                    prev_full = th_full
        if self.eval_results:
            plotter.plot_metric_sequences(self.eval_results)
        plotter.assemble_video()
        return plotter

    # ------------------------------------------------------------------- run

    def run(self):
        if self.cfg.phases.solve:
            self.run_solver()
        if self.cfg.phases.eval:
            self.run_eval()
        if self.cfg.phases.plot:
            self.run_plot()
        return self
