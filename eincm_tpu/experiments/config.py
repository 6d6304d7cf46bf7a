"""Experiment configuration: typed dataclasses + YAML + dotted overrides.

Replaces the reference's hydra/omegaconf stack (src/experiments/e00/configs/**,
24 YAML files with `_target_` instantiation and custom resolvers) with a
self-contained system: a dataclass tree, YAML loading, and `key.path=value`
command-line overrides. The reference's known config inconsistencies
(SURVEY.md §5 "Config") are deliberately not replicated.

Only reading a YAML file needs PyYAML; defaults and overrides do not.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from eincm_tpu.models.loss import LossParams
from eincm_tpu.models.pyramid import HandoverSettings, SolverConfig
from eincm_tpu.parallel.distributed import DistributedConfig


@dataclass
class DatasetConfig:
    kind: str = "synthetic"  # synthetic | ecd | mvsec | dsec
    root_dir: str = ""
    sequence_name: str = "synthetic"
    des_n_events: int = 8192
    sensor_size: Tuple[int, int] = (64, 64)
    delta_idx: int = 1  # MVSEC/ECD image-timestamp stride ("dt")
    data_split: str = "test"  # DSEC
    extended: bool = False  # DSEC extended eval timestamps
    load_more_images: bool = False  # MVSEC multi-reference
    use_new_pruning_limits: bool = False  # MVSEC
    prefer_latest_events: bool = True
    # synthetic-only
    n_windows: int = 4
    velocity: Tuple[float, float] = (3.0, -2.0)
    seed: int = 0
    shear: float = 0.0  # vx(y) slope; requires velocity[1] == 0

    def make_loader(self):
        if self.kind == "synthetic":
            from eincm_tpu.data.synthetic import SyntheticDataLoader

            return SyntheticDataLoader(
                sensor_size=tuple(self.sensor_size),
                n_windows=self.n_windows,
                des_n_events=self.des_n_events,
                velocity=tuple(self.velocity),
                prefer_latest_events=self.prefer_latest_events,
                seed=self.seed,
                shear=self.shear,
            )
        if self.kind == "ecd":
            from eincm_tpu.data.ecd import ECDDataLoader

            return ECDDataLoader(
                self.root_dir, self.sequence_name, self.des_n_events,
                self.delta_idx, self.prefer_latest_events,
            )
        if self.kind == "mvsec":
            from eincm_tpu.data.mvsec import MVSECDataLoader

            return MVSECDataLoader(
                self.root_dir, self.sequence_name, self.delta_idx,
                self.des_n_events, self.load_more_images,
                self.use_new_pruning_limits, self.prefer_latest_events,
            )
        if self.kind == "dsec":
            from eincm_tpu.data.dsec import DSECDataLoader

            return DSECDataLoader(
                self.root_dir, self.sequence_name, self.des_n_events,
                self.data_split, self.extended, self.prefer_latest_events,
                sensor_size=tuple(self.sensor_size),
            )
        raise ValueError(f"unknown dataset kind {self.kind!r}")


@dataclass
class EdgeConfig:
    """Edge extraction settings (reference: configs/edge_extraction/*.yaml)."""

    enable_image_preprocessing: bool = True
    canny_aperture: int = 3
    canny_th1: float = 30.0
    canny_th2: float = 80.0
    smoothen_method: str = "gaussian"  # gaussian | eincm_iedt | rtef_iedt
    smoothen_k_size: float = 1.0
    smoothen_sigma: float = 1.0
    iedt_alpha: float = 6.0
    rtef_d_sat: float = 6.0
    rtef_formulation: str = "exponential"
    preprocess_kwargs: Dict[str, Any] = field(default_factory=dict)

    def make_edge_fn(self):
        from eincm_tpu.edge import pipeline as ep

        if self.smoothen_method == "gaussian":
            smoothen = lambda e: ep.smoothen_edges(
                e, self.smoothen_k_size, self.smoothen_sigma
            )
        elif self.smoothen_method == "eincm_iedt":
            smoothen = lambda e: ep.eincm_inv_exp_dist_transform(
                e, self.iedt_alpha
            )
        elif self.smoothen_method == "rtef_iedt":
            smoothen = lambda e: ep.rtef_inv_exp_dist_transform(
                e, self.rtef_d_sat, None, self.rtef_formulation
            )
        else:
            raise ValueError(self.smoothen_method)

        return lambda images: ep.extract_edges(
            images,
            preprocess=self.enable_image_preprocessing,
            smoothen_fn=smoothen,
            canny_th1=self.canny_th1,
            canny_th2=self.canny_th2,
            canny_aperture=self.canny_aperture,
            preprocess_kwargs=self.preprocess_kwargs,
        )


@dataclass
class SolverSettings:
    """Reference: configs/main.yaml solver_params + pyramid settings."""

    n_pyr_lvls: int = 5
    pyramid_bases: Optional[Tuple[int, ...]] = None
    theta_miniter: int = 10
    theta_maxiter: int = 25
    handover_miniter: int = 5
    handover_maxiter: int = 15
    use_growing_maxiters: bool = True
    maxiters_grow_order: float = 1.0
    theta_gtol: float = 1e-4
    n_extra_attempts: Dict[int, int] = field(default_factory=dict)
    pyramid_upscale_method: str = "repeat"
    pyramid_downscale_method: str = "bilinear"
    scale_theta_to_sensor_size_method: str = "bilinear"
    # line-search evaluation budget; None resolves by line search — 6 for
    # 'armijo' (10-vs-6 A/B: AEE neutral, probes −37%, PARITY.md — most
    # probes beyond the first few are line-search-failure detection at the
    # f32 noise floor), 10 for 'wolfe'
    # (bracket+zoom budget, a different meaning; its round-2 validation was
    # at 10). Explicit values always win; the armijo rescue's wolfe
    # re-solve pins >= 10 internally.
    max_ls_evals: Optional[int] = None
    # 'armijo' (default; 1.6x faster, accuracy-validated vs wolfe — PARITY.md)
    # | 'wolfe' (strong Wolfe, scipy-parity semantics)
    line_search: str = "armijo"
    # quadratic-interpolated backtracking for 'armijo' (scipy
    # scalar_search_armijo); off pending on-hardware A/B validation
    armijo_interpolate: bool = False
    # noise-floor termination: end a level after theta_ftol_patience
    # consecutive iterations with relative loss improvement <= theta_ftol
    # (skips the exhausted probes + retry re-run that otherwise detect the
    # f32 noise floor). DEFAULT 1e-5: on 3 DSEC-scale GT regimes
    # (constant/rotating/shear, 8-window chains) AEE was neutral-to-better
    # in every regime (PARITY.md). None restores exact reference retry
    # semantics (src/eincm/solver.py:218-239); the library-level
    # SolverConfig default stays None so parity harnesses and direct
    # constructions keep reference behavior unless opted in.
    theta_ftol: Optional[float] = 1e-5
    theta_ftol_patience: int = 2
    # tail safeguard for the armijo default (serial solve path): when a
    # window's level-0 optimum ends worse than simply keeping the prior
    # window's theta (or the solve hit NaN), re-solve that window with
    # strong Wolfe and keep the better result. Costs one prior-loss
    # evaluation per window plus a per-window sync; rescues are rare
    # (<10% by design — see PARITY.md validation)
    armijo_rescue: bool = True
    # record per-iteration (theta, loss) trajectories on device — the
    # equivalent of the reference's collecting callbacks
    # (src/eincm/callbacks.py:100-364); required by phases.eval_intermediate
    collect_intermediate: bool = False
    # live per-iteration loss printing during a solve (jax.debug.callback) —
    # the reference's printing callback (src/eincm/callbacks.py:131-151);
    # opt-in: each iteration then pays a host hop
    progress_heartbeat: bool = False
    # scan-over-levels shared-trace solver (models/pyramid_scan.py): ONE
    # traced level body instead of one per pyramid level, which cuts cold
    # compile time several-fold at MVSEC and DSEC scale with per-level
    # numerics unchanged (tests/test_pyramid_scan.py). Ignored (with a log
    # line) when collect_intermediate or progress_heartbeat require the
    # per-level build; set false to force the per-level build.
    scan_levels: bool = True

    def growing_maxiters(self, miniter: int, maxiter: int) -> Tuple[int, ...]:
        """Per-level iteration budgets: more at coarse... actually more at the
        FINEST level (p=0 -> maxiter), fewer at coarse (p=1 -> miniter).

        Reference: exp_mgr.py:169-187 (`prepare_maxiters`).
        """
        out = []
        for lvl in range(self.n_pyr_lvls):
            if self.n_pyr_lvls == 1:
                p = 0.0
            else:
                p = lvl / (self.n_pyr_lvls - 1)
            o = self.maxiters_grow_order
            if self.use_growing_maxiters:
                out.append(int(np.ceil(miniter * p**o + maxiter * (1 - p) ** o)))
            else:
                out.append(maxiter)
        return tuple(out)


@dataclass
class PhaseSettings:
    solve: bool = True
    eval: bool = True
    plot: bool = False
    n_repeat_solve: int = 1
    run_idx_range: Optional[Tuple[int, int]] = None
    # multiple [start, end) ranges — the reference's outdoor_day1 'split'
    # range mode (exp_mgr.py:261-265)
    run_idx_ranges: Optional[Tuple[Tuple[int, int], ...]] = None
    # serial-path mid-sequence checkpoint cadence; 0 (or >=100) disables
    checkpoint_every_percent: float = 25.0
    # parallel-mode super-step checkpointing cadence. None (default) keeps
    # the whole-sequence single-batch schedule. NOTE: enabling this changes
    # the parallel solve's numerics slightly (and deliberately, toward the
    # sequential reference schedule): each super-step's first window gets
    # the previous super-step's exact final theta as its prior instead of
    # the two-pass/ppermute approximation — which is why this is a separate
    # knob from the (serial-path) checkpoint_every_percent rather than a
    # silent behavior change keyed off a checkpoint-I/O setting.
    parallel_checkpoint_every_percent: Optional[float] = None
    delete_checkpoints_at_end: bool = True
    run_from_checkpoint: Optional[str] = None
    # solve all windows sharded over the available device mesh
    # (SURVEY.md §2.3 / §7 prior-chain strategy)
    parallel_windows: bool = False
    # 'two_pass': all windows in parallel, priors from pass 1 (fastest);
    # 'sequence_shard': contiguous chunks per device with the exact in-chunk
    # handover chain and ppermute boundary prior exchange (closest to the
    # reference's sequential schedule)
    parallel_mode: str = "two_pass"
    # evaluate every recorded level-0 BFGS iterate against ground truth
    # during EVAL — the post-hoc equivalent of the reference's
    # eval-during-solve callback (src/eincm/callbacks.py:140-149); requires
    # solver.collect_intermediate
    eval_intermediate: bool = False
    # EAGER per-window EVAL/PLOT inside the solve loop (reference
    # exp_mgr.py:646-656: theta_evaluation.eager / plot.eager with their
    # every-N gates). Each eager eval/plot runs right after its window's
    # results are finalized; the standalone EVAL/PLOT phases still run (and
    # re-evaluate) when enabled, exactly like the reference.
    eager_eval: bool = False
    eager_eval_every: int = 1
    eager_plot: bool = False
    eager_plot_every: int = 1
    # shard the EVAL phase over the device mesh (windows are independent at
    # eval time — no prior chain); falls back to serial when
    # eval_intermediate is set (per-iterate trajectories stay serial)
    parallel_eval: bool = False
    # windows evaluated per device per sharded dispatch (bounds device
    # memory for DSEC-extended-scale sequences)
    parallel_eval_windows_per_device: int = 4


@dataclass
class ExperimentConfig:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    edge: EdgeConfig = field(default_factory=EdgeConfig)
    solver: SolverSettings = field(default_factory=SolverSettings)
    handover: HandoverSettings = field(default_factory=HandoverSettings)
    phases: PhaseSettings = field(default_factory=PhaseSettings)
    # multi-host runtime (jax.distributed); off by default
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    alpha: float = 60.0
    beta: float = 60.0
    gamma: float = 0.0
    delta: float = 0.0
    output_dir: str = "outputs"
    experiment_name: str = "eincm"
    seed: int = 0
    # raw jax.config flags applied at startup (reference: configs/jax_config/)
    jax_config: Dict[str, Any] = field(default_factory=dict)
    # matplotlib rcParams applied before the PLOT phase (reference:
    # configs/mpl_rcparams/{default,paper,video}.yaml, applied by
    # src/experiments/e00/__main__.py:29-31)
    mpl_rcparams: Dict[str, Any] = field(default_factory=dict)
    # persistent XLA compilation cache (the reference ships this commented
    # out, configs/jax_config/default.yaml:3-7). JAX_COMPILATION_CACHE_DIR,
    # when set, wins; None means <checkout>/.jax_cache
    # (utils/jax_helpers.py:enable_compilation_cache)
    compilation_cache_dir: Optional[str] = None

    @property
    def loss_params(self) -> LossParams:
        return LossParams(self.alpha, self.beta, self.gamma, self.delta)

    def solver_config(self) -> SolverConfig:
        s = self.solver
        return SolverConfig(
            n_pyr_lvls=s.n_pyr_lvls,
            sensor_size=tuple(self.dataset.sensor_size),
            params=self.loss_params,
            theta_opt_maxiters=s.growing_maxiters(s.theta_miniter, s.theta_maxiter),
            handover_opt_maxiters=s.growing_maxiters(
                s.handover_miniter, s.handover_maxiter
            ),
            theta_gtol=s.theta_gtol,
            n_extra_attempts=dict(s.n_extra_attempts),
            pyramid_bases=(
                tuple(s.pyramid_bases) if s.pyramid_bases is not None else None
            ),
            pyramid_upscale_method=s.pyramid_upscale_method,
            pyramid_downscale_method=s.pyramid_downscale_method,
            scale_to_sensor_size_method=s.scale_theta_to_sensor_size_method,
            handover=self.handover,
            # None resolves per line search in SolverConfig.__post_init__
            # (6 armijo / 10 wolfe) — one resolution point for both the
            # YAML path and direct SolverConfig construction
            max_ls_evals=s.max_ls_evals,
            line_search=s.line_search,
            armijo_interpolate=s.armijo_interpolate,
            theta_ftol=s.theta_ftol,
            theta_ftol_patience=s.theta_ftol_patience,
            collect_intermediate=s.collect_intermediate
            or self.phases.eval_intermediate,
            progress_heartbeat=s.progress_heartbeat,
        )

    # ------------------------------------------------------------- serialize

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ExperimentConfig":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config key {k!r} for {tp.__name__}")
                    ftype = fields[k].type
                    sub = _DATACLASS_FIELDS.get((tp, k))
                    kwargs[k] = build(sub, v) if sub else v
                return tp(**kwargs)
            return val

        _DATACLASS_FIELDS = {
            (cls, "dataset"): DatasetConfig,
            (cls, "edge"): EdgeConfig,
            (cls, "solver"): SolverSettings,
            (cls, "handover"): HandoverSettings,
            (cls, "phases"): PhaseSettings,
            (cls, "distributed"): DistributedConfig,
        }
        return build(cls, d)


_YAML_WORDS = {"true": "True", "false": "False", "null": "None", "~": "None"}
_BARE_WORD = re.compile(r"(?<![\w.'\"])(true|false|null|~)(?![\w'\"])", re.I)


def _parse_value(s: str) -> Any:
    """Parse one override value the way YAML would for the values configs
    use: numbers (also a bare '1e-5'), true/false/null, quoted strings, and
    [lists] / {dicts} of those. Anything else stays a plain string."""
    text = _BARE_WORD.sub(lambda m: _YAML_WORDS[m.group(1).lower()], s.strip())
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return s


def apply_overrides(cfg: ExperimentConfig, overrides) -> ExperimentConfig:
    """Apply `a.b.c=value` style command-line overrides (hydra-like)."""
    d = cfg.to_dict()
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, raw = ov.partition("=")
        val = _parse_value(raw)
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                raise KeyError(f"unknown config path {key!r}")
            node = node[p]
        leaf = parts[-1]
        if leaf not in node and not isinstance(node.get(leaf, None), dict):
            if leaf not in node:
                raise KeyError(f"unknown config key {key!r}")
        node[leaf] = val
    return ExperimentConfig.from_dict(d)


def load_config(
    path: Optional[str] = None, overrides=()
) -> ExperimentConfig:
    """Load a YAML config (or defaults) and apply overrides."""
    if path is None:
        cfg = ExperimentConfig()
    else:
        import yaml  # only YAML files need PyYAML

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        cfg = ExperimentConfig.from_dict(d)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg
