"""Coarse-to-fine multi-level EINCM solver, one XLA computation per window.

Functional redesign of the reference's `MultipleLevelEINCMSolver`
(src/eincm/solver.py:10-384). Differences, all to keep the solve on the
device:

- The per-level BFGS (and its convergence-retry loop,
  src/eincm/solver.py:218-239) runs on device via `lax.while_loop` — no
  scipy, no host round-trips, no jaxopt patch.
- Theta-independent window statistics are computed once per window and shared
  by every level, attempt, and handover evaluation.
- The handover weight is solved with a jitted bounded golden-section search
  instead of host L-BFGS-B (src/eincm/solver.py:175-183).
- State is explicit: priors go in, results come out; nothing is mutated.

The whole multi-level solve jits as a single function of
(sample, prior_pyramid); two variants compile (first sample / subsequent)
because the first sample statically skips handover
(src/eincm/solver.py:305-306).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from eincm_tpu.models.bfgs import (
    BFGSHistory,
    BFGSResult,
    minimize_bfgs,
    minimize_bounded_scalar,
)
from eincm_tpu.models.loss import (
    LossParams,
    LossStatics,
    WindowStatics,
    compute_window_statics,
    solver_loss,
)
from eincm_tpu.ops.resize import downscale_theta, upscale_theta


class WindowSample(NamedTuple):
    """One staged event window (fixed shapes).

    Matches the datasample contract fed to the reference solver
    (src/eincm/solver.py:185-194): event coords/timestamps plus edge maps at
    their (normalized) timestamps.
    """

    xs: jax.Array  # (E,)
    ys: jax.Array  # (E,)
    ts: jax.Array  # (E,) normalized to [0, 1]
    edges: jax.Array  # (n_refs, H, W)
    edge_ts: jax.Array  # (n_refs,)


@dataclass(frozen=True)
class HandoverSettings:
    """Reference: handover_settings dict, src/eincm/solver.py:30-52,87-101."""

    use_handover: bool = True
    solve_handover_for_levels: Tuple[int, ...] = ()
    use_downscaled_finest_priors: bool = True
    clip_solved_handover: bool = False
    clip_solved_handover_limits: Tuple[float, float] = (0.0, 1.0)
    alpha_handover: float = 0.5
    handover_limits: Tuple[float, float] = (0.0, 1.0)
    init_handover_weight: float = 0.5
    # >= 3 seeds the golden-section weight solve with one vmapped uniform
    # grid over the limits (robust to multi-modal handover landscapes,
    # which a single-basin bracketing solve — or the reference's L-BFGS-B
    # from one init, src/eincm/solver.py:175-183 — can miss); 0 disables.
    handover_grid_probes: int = 0


@dataclass(frozen=True)
class SolverConfig:
    """Static configuration of the multi-level solve."""

    n_pyr_lvls: int
    sensor_size: Tuple[int, int]
    params: LossParams
    theta_opt_maxiters: Tuple[int, ...]  # per level (index = level)
    handover_opt_maxiters: Tuple[int, ...] = ()
    theta_gtol: float = 1e-5
    n_extra_attempts: Dict[int, int] = field(default_factory=dict)
    pyramid_bases: Tuple[int, ...] | None = None
    pyramid_upscale_method: str = "repeat"
    pyramid_downscale_method: str = "bilinear"
    scale_to_sensor_size_method: str = "bilinear"
    handover: HandoverSettings = field(default_factory=HandoverSettings)
    # line-search evaluation budget per iteration. None resolves by line
    # search in __post_init__: 6 for 'armijo', 10 for 'wolfe' — the budgets
    # mean different things. For 'armijo' it caps the value-only probes:
    # 10 kept accuracy identical to 25 (round 2), and 6 to 10 (round-3 A/B,
    # PARITY.md — AEE neutral, probes −37%: beyond
    # the first few probes the search is almost always detecting line-search
    # failure at the f32 noise floor, not finding steps). For 'wolfe' it is
    # the bracket+zoom budget, validated at 10 (round 2); wolfe parity
    # studies should set 10-25 (the reference-parity harness uses 25).
    max_ls_evals: Optional[int] = None
    # 'armijo' = backtracking with value-only probes (a probe costs a forward
    # pass, not forward+backward) — the default after validation against
    # strong Wolfe: ~1.6x faster per window with mixed-sign AEE deltas within
    # ±0.07 px mean over 3 tunings x 10 synthetic windows (see PARITY.md).
    # 'wolfe' = strong Wolfe (scipy-parity semantics).
    line_search: str = "armijo"
    # 'armijo' only: quadratic-interpolated backtracking (scipy
    # scalar_search_armijo) instead of plain halving — usually fewer
    # value-only probes per accepted step. Off by default pending a paired
    # on-hardware A/B against the validated halving default.
    armijo_interpolate: bool = False
    # opt-in noise-floor termination (BFGSResult status 4): stop a level
    # after theta_ftol_patience consecutive iterations whose relative loss
    # improvement is <= theta_ftol, skipping the exhausted line search +
    # extra-attempt re-run that otherwise detect the f32 noise floor the
    # expensive way. None (default) preserves exact reference retry
    # semantics (src/eincm/solver.py:218-239). See PARITY.md for the
    # paired A/B that sets the recommended value.
    theta_ftol: Optional[float] = None
    theta_ftol_patience: int = 2
    # record per-iteration (theta, loss) trajectories per level — the
    # on-device equivalent of the reference's collecting solver callbacks
    # (src/eincm/callbacks.py:100-221)
    collect_intermediate: bool = False
    # live per-iteration loss printing via jax.debug.callback — the opt-in
    # equivalent of the reference's printing callback
    # (src/eincm/callbacks.py:131-151); each firing is a host hop
    progress_heartbeat: bool = False
    # emit SolveResult.prior_loss_lvl0 (the armijo-rescue anomaly signal).
    # Costs one full finest-level loss evaluation per non-first window, so
    # it is opt-in: the manager enables it only when the rescue is active
    # (parallel/sharded paths never pay it)
    compute_prior_loss: bool = False

    def __post_init__(self):
        bases = self.pyramid_bases
        if bases is None:
            bases = (2,) * (self.n_pyr_lvls - 1)
            object.__setattr__(self, "pyramid_bases", bases)
        assert len(self.theta_opt_maxiters) == self.n_pyr_lvls
        assert len(bases) == self.n_pyr_lvls - 1
        if not self.handover_opt_maxiters:
            object.__setattr__(
                self, "handover_opt_maxiters", (15,) * self.n_pyr_lvls
            )
        if self.max_ls_evals is None:
            object.__setattr__(
                self, "max_ls_evals", 6 if self.line_search == "armijo" else 10
            )

    # -- pyramid geometry ---------------------------------------------------

    def base_between(self, fine_lvl: int) -> int:
        """Scale factor between level `fine_lvl` and `fine_lvl + 1`.

        Reference indexing: src/eincm/solver.py:143-151,247-248,288-289.
        """
        return self.pyramid_bases[-fine_lvl - 1]

    def level_shape(self, lvl: int) -> Tuple[int, int]:
        h = w = 1
        for fine in range(lvl, self.n_pyr_lvls - 1):
            b = self.base_between(fine)
            h *= b
            w *= b
        return (h, w)

    @property
    def loss_statics(self) -> LossStatics:
        return LossStatics(
            sensor_size=self.sensor_size,
            n_pyr_lvls=self.n_pyr_lvls,
            scale_to_sensor_size_method=self.scale_to_sensor_size_method,
        )

    def zero_pyramid(self, dtype=jnp.float32) -> Tuple[jax.Array, ...]:
        """All-zero theta pyramid, finest (level 0) first."""
        return tuple(
            jnp.zeros((*self.level_shape(l), 2), dtype)
            for l in range(self.n_pyr_lvls)
        )


class SolveResult(NamedTuple):
    """Mirror of the reference solve() output dict (src/eincm/solver.py:259-267)."""

    prior_theta_pyr: Tuple[jax.Array, ...]
    pre_opt_theta_pyr: Tuple[jax.Array, ...]
    pre_handover_theta_pyr: Tuple[jax.Array, ...]
    final_theta_pyr: Tuple[jax.Array, ...]
    theta_opt_states: Tuple[BFGSResult, ...]
    final_handover_weights: Tuple[jax.Array, ...]
    theta_histories: Tuple[BFGSHistory, ...] = ()  # per level, when collected
    # per level, when collected AND the weight was solved (else None): the
    # golden-section probe trajectory of the handover solve
    handover_histories: Tuple = ()
    # loss of the PRIOR window's level-0 theta under THIS window's objective
    # (+inf on the first window). A solve whose level-0 optimum is worse than
    # simply keeping the prior is anomalous — the signal behind the manager's
    # armijo->wolfe rescue (one extra loss evaluation per window).
    prior_loss_lvl0: jax.Array = None


def _solve_theta_level(
    cfg: SolverConfig,
    lvl: int,
    theta0: jax.Array,
    sample: WindowSample,
    wstat: WindowStatics,
) -> Tuple[jax.Array, BFGSResult]:
    """BFGS at one pyramid level, with the reference's retry-on-failure loop."""
    shape = theta0.shape
    statics = cfg.loss_statics

    def fun_and_grad(flat):
        theta = flat.reshape(shape)
        loss, grad = jax.value_and_grad(solver_loss)(
            theta,
            sample.xs,
            sample.ys,
            sample.ts,
            sample.edges,
            sample.edge_ts,
            cfg.params,
            lvl,
            statics,
            wstat,
        )
        return loss, grad.reshape(-1)

    def fun_only(flat):
        return solver_loss(
            flat.reshape(shape),
            sample.xs,
            sample.ys,
            sample.ts,
            sample.edges,
            sample.edge_ts,
            cfg.params,
            lvl,
            statics,
            wstat,
        )

    heartbeat = None
    if cfg.progress_heartbeat:
        def heartbeat(k, f, _lvl=lvl):
            print(f"  [lvl {_lvl}] iter {int(k):3d}  loss {float(f):.6f}")

    out = minimize_bfgs(
        fun_and_grad,
        theta0.reshape(-1),
        maxiter=cfg.theta_opt_maxiters[lvl],
        gtol=cfg.theta_gtol,
        max_ls_evals=cfg.max_ls_evals,
        n_extra_attempts=cfg.n_extra_attempts.get(lvl, 0),
        record_history=cfg.collect_intermediate,
        line_search=cfg.line_search,
        armijo_interpolate=cfg.armijo_interpolate,
        fun=fun_only,
        heartbeat_fn=heartbeat,
        ftol=cfg.theta_ftol,
        ftol_patience=cfg.theta_ftol_patience,
    )
    if cfg.collect_intermediate:
        res, hist = out
    else:
        res, hist = out, None
    return res.x.reshape(shape), res, hist


def _solve_handover_weight(
    cfg: SolverConfig,
    lvl: int,
    prior_theta: jax.Array,
    theta: jax.Array,
    sample: WindowSample,
    wstat: WindowStatics,
) -> jax.Array:
    """Golden-section solve of the blend weight at one level.

    For levels > 0 the weight is solved at the next-finer scale with the
    upscaled optimized theta (reference: src/eincm/solver.py:311-335).
    """
    ho = cfg.handover
    if lvl > 0:
        loss_lvl = lvl - 1
        maxiter = cfg.handover_opt_maxiters[lvl - 1]
    else:
        loss_lvl = lvl
        maxiter = cfg.handover_opt_maxiters[lvl]

    def fun(w):
        theta_ho = w * prior_theta + (1.0 - w) * theta
        return solver_loss(
            theta_ho,
            sample.xs,
            sample.ys,
            sample.ts,
            sample.edges,
            sample.edge_ts,
            cfg.params,
            loss_lvl,
            cfg.loss_statics,
            wstat,
        )

    out = minimize_bounded_scalar(
        fun, ho.handover_limits, maxiter=maxiter,
        record_history=cfg.collect_intermediate,
        n_grid_probes=ho.handover_grid_probes,
    )
    if cfg.collect_intermediate:
        (w_star, _), hist = out
    else:
        w_star, _ = out
        hist = None
    if ho.clip_solved_handover:
        w_star = jnp.clip(w_star, *ho.clip_solved_handover_limits)
    return w_star, hist


def stage_prior_pyramid(
    cfg: SolverConfig, prior_pyr: Sequence[jax.Array]
) -> Tuple[jax.Array, ...]:
    """Optionally rebuild coarse priors by downscaling the finest prior.

    Reference: src/eincm/solver.py:283-289 (`_stage_prior_theta_pyr`).
    """
    prior = list(prior_pyr)
    if cfg.handover.use_downscaled_finest_priors:
        for lvl in range(1, cfg.n_pyr_lvls):
            prior[lvl] = downscale_theta(
                prior[lvl - 1],
                base=cfg.base_between(lvl - 1),
                method=cfg.pyramid_downscale_method,
            )
    return tuple(prior)


def solve_window(
    cfg: SolverConfig,
    sample: WindowSample,
    prior_pyr: Sequence[jax.Array],
    is_first_sample: bool,
) -> SolveResult:
    """Full coarse-to-fine solve of one event window.

    Reference: src/eincm/solver.py:197-267 (`solve`). `is_first_sample` is
    static — it removes handover work entirely from the first window's trace.
    """
    n = cfg.n_pyr_lvls
    ho = cfg.handover

    wstat = compute_window_statics(
        sample.xs, sample.ys, sample.edges, cfg.sensor_size
    )

    prior = stage_prior_pyramid(cfg, prior_pyr)

    if is_first_sample or not cfg.compute_prior_loss:
        prior_loss0 = jnp.asarray(jnp.inf, prior[0].dtype)
    else:
        prior_loss0 = solver_loss(
            prior[0], sample.xs, sample.ys, sample.ts, sample.edges,
            sample.edge_ts, cfg.params, 0, cfg.loss_statics, wstat,
        )

    pre_opt: list = [None] * n
    opt: list = [None] * n
    final: list = [None] * n
    opt_states: list = [None] * n
    weights: list = [None] * n
    histories: list = [None] * n
    ho_histories: list = [None] * n

    pre_opt[n - 1] = prior[n - 1]

    for lvl in reversed(range(n)):
        opt[lvl], opt_states[lvl], histories[lvl] = _solve_theta_level(
            cfg, lvl, pre_opt[lvl], sample, wstat
        )

        # ---- handover (reference: src/eincm/solver.py:302-347) ----
        if is_first_sample or not ho.use_handover:
            weights[lvl] = jnp.asarray(ho.init_handover_weight, opt[lvl].dtype)
            final[lvl] = opt[lvl]
            if (
                cfg.collect_intermediate
                and ho.use_handover
                and lvl in ho.solve_handover_for_levels
            ):
                # first-sample results must be pytree-structurally identical
                # to non-first ones: the parallel schedules tree_map-splice
                # the two (parallel/batch.py), and a None here against a
                # recorded history there is a structure-mismatch crash.
                # Empty (n=0) history, same shapes/dtypes as the solve's.
                maxiter = cfg.handover_opt_maxiters[max(lvl - 1, 0)]
                cap = max(2, ho.handover_grid_probes) + 2 + maxiter
                ho_histories[lvl] = BFGSHistory(
                    xs=jnp.zeros((cap,), jnp.float32),
                    fs=jnp.zeros((cap,), opt[lvl].dtype),
                    n=jnp.int32(0),
                )
        else:
            if lvl in ho.solve_handover_for_levels:
                if lvl > 0:
                    prior_for_solve = prior[lvl - 1]
                    theta_for_solve = upscale_theta(
                        opt[lvl],
                        base=cfg.base_between(lvl - 1),
                        method=cfg.pyramid_upscale_method,
                    )
                else:
                    prior_for_solve = prior[lvl]
                    theta_for_solve = opt[lvl]
                w, ho_histories[lvl] = _solve_handover_weight(
                    cfg, lvl, prior_for_solve, theta_for_solve, sample, wstat
                )
            else:
                w = jnp.asarray(ho.alpha_handover, opt[lvl].dtype)
            weights[lvl] = w
            final[lvl] = w * prior[lvl] + (1.0 - w) * opt[lvl]

        if lvl > 0:
            pre_opt[lvl - 1] = upscale_theta(
                final[lvl],
                base=cfg.base_between(lvl - 1),
                method=cfg.pyramid_upscale_method,
            )

    return SolveResult(
        prior_theta_pyr=tuple(prior),
        pre_opt_theta_pyr=tuple(pre_opt),
        pre_handover_theta_pyr=tuple(opt),
        final_theta_pyr=tuple(final),
        theta_opt_states=tuple(opt_states),
        final_handover_weights=tuple(weights),
        theta_histories=(
            tuple(histories) if cfg.collect_intermediate else ()
        ),
        handover_histories=(
            tuple(ho_histories) if cfg.collect_intermediate else ()
        ),
        prior_loss_lvl0=prior_loss0,
    )


def make_window_solver(cfg: SolverConfig):
    """Jitted (sample, prior_pyr, is_first) -> SolveResult.

    `is_first` selects between the two compiled variants.
    """
    first_fn = jax.jit(partial(solve_window, cfg, is_first_sample=True))
    rest_fn = jax.jit(partial(solve_window, cfg, is_first_sample=False))

    def run(sample: WindowSample, prior_pyr, is_first: bool) -> SolveResult:
        fn = first_fn if is_first else rest_fn
        return fn(sample, prior_pyr)

    return run
