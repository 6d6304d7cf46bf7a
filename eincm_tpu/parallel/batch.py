"""Multi-window batching and multi-chip sharding of the EINCM solve.

The reference is strictly single-device and sequential over event windows
(src/experiments/e00/exp_mgr.py:620). Here the dominant axis of scale is
the window axis: windows are independent given their priors, so they batch
under `vmap` and shard over a `jax.sharding.Mesh` ("windows" axis = data
parallelism; SURVEY.md §2.3).

The sequential handover prior chain (window i depends on i-1,
src/eincm/solver.py:254-255) is handled by a two-pass schedule:

  pass 1: all windows solve in parallel with no prior (is_first semantics);
  pass 2: priors taken from the previous window's pass-1 result, all windows
          re-solve the (cheap) handover blend in parallel.

This trades one extra blend pass for full parallelism across chips — the
strategy pre-identified in SURVEY.md §7 "hard parts".
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from eincm_tpu.models.pyramid import (
    SolveResult,
    SolverConfig,
    WindowSample,
    solve_window,
)


def make_window_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D device mesh over the window (data-parallel) axis."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} JAX devices are available"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("windows",))


# The sharded solvers close a multi-minute-to-compile solver program over
# (cfg, mesh); rebuilding jax.jit(jax.shard_map(...)) per call would discard
# jit's tracing/compilation cache between super-steps of a checkpointed
# parallel run (manager.run_solver_parallel calls these once per super-step
# with identical shapes). Cache the wrappers keyed on the identities of the
# objects the closure captures; values pin those objects so an id can't be
# recycled while its entry lives.
_SHARD_FN_CACHE: dict = {}
_SHARD_FN_CACHE_MAX = 8


def _cached_jit(key_kind, pinned, build):
    key = (key_kind,) + tuple(id(o) for o in pinned)
    hit = _SHARD_FN_CACHE.get(key)
    if hit is not None:
        return hit[1]
    fn = build()
    if len(_SHARD_FN_CACHE) >= _SHARD_FN_CACHE_MAX:
        _SHARD_FN_CACHE.pop(next(iter(_SHARD_FN_CACHE)))
    _SHARD_FN_CACHE[key] = (pinned, fn)
    return fn


def solve_window_batch(
    cfg: SolverConfig,
    batch: WindowSample,
    prior_pyrs: Optional[Tuple[jax.Array, ...]] = None,
    is_first: bool = True,
) -> SolveResult:
    """vmapped multi-window solve (single device or under outer sharding).

    Args:
        batch: WindowSample with a leading batch axis on every field.
        prior_pyrs: optional tuple of (B, h_l, w_l, 2) priors per level.
    """
    b = batch.xs.shape[0]
    if prior_pyrs is None:
        prior_pyrs = tuple(
            jnp.broadcast_to(z, (b, *z.shape))
            for z in cfg.zero_pyramid(batch.xs.dtype)
        )
    fn = jax.vmap(partial(solve_window, cfg, is_first_sample=is_first))
    return fn(batch, prior_pyrs)


def solve_window_batch_sharded(
    cfg: SolverConfig,
    batch: WindowSample,
    mesh: Mesh,
    prior_pyrs: Optional[Tuple[jax.Array, ...]] = None,
    is_first: bool = True,
) -> SolveResult:
    """Multi-window solve sharded across `mesh` on the leading batch axis.

    Uses `shard_map` (manual SPMD), NOT vmap-then-partition: the per-window
    BFGS/line-search `while_loop` trip counts are data-dependent, and vmap
    converts them to lockstep execution — measured 16x slower than sequential
    at MVSEC scale. Under shard_map each device runs its own solver program
    with its own trip counts; windows within a device's shard run
    sequentially via `lax.map` for the same reason. Windows are independent,
    so no collectives are needed.
    """
    shard = NamedSharding(mesh, P("windows"))
    n_dev = mesh.devices.size
    b = batch.xs.shape[0]
    assert b % n_dev == 0, f"batch {b} must divide over {n_dev} devices"

    if prior_pyrs is None:
        prior_pyrs = tuple(
            jnp.broadcast_to(z, (b, *z.shape))
            for z in cfg.zero_pyramid(batch.xs.dtype)
        )

    batch = jax.tree_util.tree_map(lambda x: jax.device_put(x, shard), batch)
    prior_pyrs = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, shard), prior_pyrs
    )

    def build():
        solve = partial(solve_window, cfg, is_first_sample=is_first)

        def per_device(local_batch, local_priors):
            # local leading axis = b // n_dev windows, solved sequentially
            return jax.lax.map(
                lambda args: solve(*args), (local_batch, local_priors)
            )

        specs = P("windows")
        return jax.jit(
            jax.shard_map(
                per_device,
                mesh=mesh,
                in_specs=(specs, specs),
                out_specs=specs,
                # unvarying scan carries (zero-initialized frames) mix with
                # varying event data inside the solver; skip the vma check
                check_vma=False,
            )
        )

    fn = _cached_jit(("batch_sharded", is_first), (cfg, mesh), build)
    return fn(batch, prior_pyrs)


def sequence_shard_solve(
    cfg: SolverConfig,
    batch: WindowSample,
    mesh: Mesh,
    boundary_prior: Optional[Tuple[jax.Array, ...]] = None,
) -> Tuple[SolveResult, Tuple[jax.Array, ...]]:
    """Sequence-sharded solve with ppermute boundary prior exchange.

    The alternative to `two_pass_sequence_solve` pre-identified in SURVEY.md
    §7: each device takes a *contiguous chunk* of the window sequence and
    solves it sequentially with the true in-chunk handover chain
    (src/eincm/solver.py:254-255 semantics); only the chunk boundaries are
    approximate. Schedule:

      pass 1: every chunk solves in parallel; chunk-first windows use
              first-sample semantics (no handover).
      exchange: each chunk's final theta pyramid travels to the next device
              over the mesh via `lax.ppermute` (one ICI hop).
      pass 2: chunks re-solve with the received boundary prior seeding their
              first window's handover; the in-chunk chain is re-run exactly.
              Device 0 has no predecessor — its pass-1 chunk (whose first
              window is the true global first sample) is kept.

    Cost is 2x one pass (same as `two_pass_sequence_solve`), but the
    handover chain is exact *within* chunks instead of approximated
    everywhere; the only deviation from the sequential reference schedule is
    that a chunk's boundary prior is its neighbor's pass-1 (not pass-2)
    final. Windows must be ordered; batch size must divide the mesh.

    `boundary_prior` (one window's theta pyramid) seeds the GLOBAL first
    window: it is the prior-chain carry from an earlier super-step when a
    long sequence is solved in checkpointable chunks (exp_mgr.py:511-519
    parity for the parallel path). With it, the first window uses normal
    handover semantics (pass 2 everywhere) instead of first-sample
    semantics.

    Returns:
        (SolveResult with leading window axis, final theta pyramids).
    """
    n_dev = mesh.devices.size
    b = batch.xs.shape[0]
    assert b % n_dev == 0, f"batch {b} must divide over {n_dev} devices"
    chunk = b // n_dev

    shard = NamedSharding(mesh, P("windows"))
    batch = jax.tree_util.tree_map(lambda x: jax.device_put(x, shard), batch)
    has_boundary = boundary_prior is not None

    def build():
        solve_first = partial(solve_window, cfg, is_first_sample=True)
        solve_rest = partial(solve_window, cfg, is_first_sample=False)

        def chunk_chain(local_batch, bp, first_is_global_first: bool):
            """Solve this device's chunk sequentially with the handover
            chain."""
            head = jax.tree_util.tree_map(lambda x: x[0], local_batch)
            if first_is_global_first:
                res0 = solve_first(head, cfg.zero_pyramid(local_batch.xs.dtype))
            else:
                res0 = solve_rest(head, bp)

            def step(prior, sample):
                res = solve_rest(sample, prior)
                return res.final_theta_pyr, res

            tail = jax.tree_util.tree_map(lambda x: x[1:], local_batch)
            last_prior, res_tail = jax.lax.scan(
                step, res0.final_theta_pyr, tail
            )
            res = jax.tree_util.tree_map(
                lambda a, b_: jnp.concatenate([a[None], b_], axis=0),
                res0,
                res_tail,
            )
            return res, last_prior

        perm = [(i, i + 1) for i in range(n_dev - 1)]

        def per_device(local_batch, bp0):
            zero_prior = cfg.zero_pyramid(local_batch.xs.dtype)
            if n_dev == 1:
                # single device: ONE chunk chain is already the exact
                # sequential answer — seeded by the super-step carry when
                # present, first-sample semantics otherwise. The two-pass
                # boundary exchange below would solve the whole chunk twice
                # and discard pass 1 wholesale.
                if has_boundary:
                    res, _ = chunk_chain(
                        local_batch, bp0, first_is_global_first=False
                    )
                else:
                    res, _ = chunk_chain(
                        local_batch, zero_prior, first_is_global_first=True
                    )
                return res, res
            # pass 1: chunk-first windows run first-sample semantics
            res1, chunk_final = chunk_chain(
                local_batch, zero_prior, first_is_global_first=True
            )
            # boundary exchange: chunk i's final -> device i+1 (device 0
            # receives zeros; with a carried super-step boundary prior,
            # device 0 uses that instead and takes pass 2 like everyone
            # else)
            boundary = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, axis_name="windows", perm=perm),
                chunk_final,
            )
            if has_boundary:
                is_dev0 = jax.lax.axis_index("windows") == 0
                boundary = jax.tree_util.tree_map(
                    lambda recv, carry: jnp.where(is_dev0, carry, recv),
                    boundary,
                    bp0,
                )
            # pass 2: re-run the chunk chain seeded by the received prior
            res2, _ = chunk_chain(
                local_batch, boundary, first_is_global_first=False
            )
            return res1, res2

        specs = P("windows")
        return jax.jit(
            jax.shard_map(
                per_device,
                mesh=mesh,
                in_specs=(specs, P()),
                out_specs=(specs, specs),
                check_vma=False,
            )
        )

    bp_arg = (
        boundary_prior
        if has_boundary
        else cfg.zero_pyramid(batch.xs.dtype)
    )
    fn = _cached_jit(("seq_shard", has_boundary), (cfg, mesh), build)
    res1, res2 = fn(batch, bp_arg)

    if has_boundary:
        # every chunk (incl. device 0) was seeded with a real prior
        res = res2
    else:
        # device 0 (global windows [0, chunk)) keeps pass 1; the rest pass 2
        idx = jnp.arange(b)
        keep1 = idx < chunk

        def pick(a, b_):
            m = keep1.reshape((b,) + (1,) * (a.ndim - 1))
            return jnp.where(m, a, b_)

        res = jax.tree_util.tree_map(pick, res1, res2)
    return res, res.final_theta_pyr


def eval_batch_sharded(
    theta_coarse: jax.Array,
    xs: jax.Array,
    ys: jax.Array,
    ts: jax.Array,
    edges: jax.Array,
    edge_ts: jax.Array,
    gt_flow: Optional[jax.Array],
    err_mask: Optional[jax.Array],
    pvec: jax.Array,
    mesh: Mesh,
    sensor_size: Tuple[int, int],
    upscale_method: str = "bilinear",
):
    """Evaluate a batch of windows sharded across `mesh` ("windows" axis).

    The EVAL phase's data-parallel path (reference scope:
    exp_mgr.py:662-714, a serial per-window loop): each device takes
    batch/n_dev windows and evaluates them sequentially via `lax.map` —
    like the sharded solver, per-window shapes stay identical to the serial
    path (nothing is vmapped over windows), so results match the serial
    eval.
    Windows are independent; no collectives.

    Args:
        theta_coarse: (B, h0, w0, 2) solver-final level-0 thetas (upscaled
            to sensor size on device).
        xs/ys/ts: (B, E) NaN-padded eval events, ONE shared pad length.
        edges/edge_ts: (B, R, H, W) / (B, R).
        gt_flow: (B, H, W, 2) or None (test splits).
        err_mask: (H, W) bool or None — replicated (e.g. outdoor_day1 hood).
        pvec: (4,) loss weights (alpha, beta, gamma, delta).

    Returns:
        small-bundle pytree with a leading (B,) window axis, on host.
    """
    from eincm_tpu.evals.theta_metrics import eval_window_small

    n_dev = mesh.devices.size
    b = theta_coarse.shape[0]
    assert b % n_dev == 0, f"batch {b} must divide over {n_dev} devices"

    has_gt = gt_flow is not None
    has_mask = err_mask is not None
    if gt_flow is None:
        gt_flow = jnp.zeros((b, 1, 1, 2), theta_coarse.dtype)
    if err_mask is None:
        err_mask = jnp.zeros((1, 1), bool)

    shard = NamedSharding(mesh, P("windows"))
    rep = NamedSharding(mesh, P())
    batch = (theta_coarse, xs, ys, ts, edges, edge_ts, gt_flow)
    batch = jax.tree_util.tree_map(lambda x: jax.device_put(x, shard), batch)
    err_mask = jax.device_put(err_mask, rep)
    pvec = jax.device_put(pvec, rep)

    def build():
        def per_device(local_batch, err_mask_, pvec_):
            def eval_one(args):
                th, exs, eys, ets, edg, edg_ts, gt = args
                return eval_window_small(
                    th, exs, eys, ets, edg, edg_ts, gt, err_mask_, pvec_,
                    sensor_size, has_gt, has_mask, upscale_method,
                )

            return jax.lax.map(eval_one, local_batch)

        specs = P("windows")
        return jax.jit(
            jax.shard_map(
                per_device,
                mesh=mesh,
                in_specs=(specs, P(), P()),
                out_specs=specs,
                check_vma=False,
            )
        )

    fn = _cached_jit(
        ("eval_batch", sensor_size, has_gt, has_mask, upscale_method),
        (mesh,),
        build,
    )
    return jax.device_get(fn(batch, err_mask, pvec))


def two_pass_sequence_solve(
    cfg: SolverConfig,
    batch: WindowSample,
    mesh: Optional[Mesh] = None,
    boundary_prior: Optional[Tuple[jax.Array, ...]] = None,
) -> Tuple[SolveResult, Tuple[jax.Array, ...]]:
    """Whole-sequence solve with the two-pass handover schedule.

    Pass 1 solves every window in parallel without priors. Pass 2 shifts the
    pass-1 final pyramids by one window (window i gets window i-1's result as
    its prior) and re-solves in parallel with handover enabled. Window 0 keeps
    its pass-1 result (first-sample semantics, src/eincm/solver.py:305-306) —
    unless `boundary_prior` (the prior-chain carry from an earlier
    checkpointed super-step) is given, in which case window 0's pass-2 prior
    is that carry and its pass-2 result is kept like every other window's.

    Returns:
        (SolveResult with window 0 spliced from pass 1 when it is the global
        first window, final theta pyramids per window).
    """
    solve = (
        partial(solve_window_batch_sharded, cfg, mesh=mesh)
        if mesh is not None
        else partial(solve_window_batch, cfg)
    )

    pass1 = solve(batch, is_first=True)

    # priors for window i = pass-1 result of window i-1; window 0 gets the
    # super-step carry, or itself (its handover result discarded below).
    prior_pyrs = tuple(
        jnp.concatenate([lvl[:1], lvl[:-1]], axis=0)
        for lvl in pass1.final_theta_pyr
    )
    if boundary_prior is not None:
        prior_pyrs = tuple(
            lvl.at[0].set(jnp.asarray(bp, lvl.dtype))
            for lvl, bp in zip(prior_pyrs, boundary_prior)
        )
    pass2 = solve(batch, prior_pyrs=prior_pyrs, is_first=False)

    if boundary_prior is not None:
        return pass2, pass2.final_theta_pyr

    # window 0 keeps its ENTIRE pass-1 record (thetas, opt states, losses,
    # handover weights) — its pass-2 re-solve used itself as prior and is
    # discarded; splicing only final_theta_pyr would pair window 0's kept
    # theta with opt states from the discarded solve
    res = jax.tree_util.tree_map(
        lambda p1, p2: jnp.concatenate([p1[:1], p2[1:]], axis=0)
        if getattr(p1, "ndim", 0) > 0
        else p2,
        pass1,
        pass2,
    )
    return res, res.final_theta_pyr
