"""On-device BFGS with strong-Wolfe line search, fully inside `jit`.

The reference drives scipy's host-side BFGS through jaxopt, paying a
host<->device round-trip per function/gradient evaluation plus a hand-patched
jaxopt for callbacks (reference: src/eincm/solver.py:165-183, README.md:92-126).
Here the entire optimization — direction, line search, Hessian update,
convergence and retry logic — runs as one XLA computation via
`lax.while_loop`, so a per-level solve is a single device dispatch.

The parameter vector is tiny (a coarse theta, <= ~2k floats), so we keep the
dense inverse-Hessian approximation exactly like scipy's BFGS:

    H <- (I - rho s y^T) H (I - rho y s^T) + rho s s^T

Convergence mirrors scipy: sup-norm of the gradient <= gtol. The reference's
convergence-retry loop ("extra attempts", src/eincm/solver.py:218-239) is
folded into the same while_loop: on a failed attempt the Hessian resets to
identity and iteration continues from the current iterate.

Line search: Nocedal & Wright Algs. 3.5/3.6 (bracket + zoom) with
safeguarded-bisection interpolation. The objective appears at exactly ONE
call site per `lax.while_loop` body — XLA compile time on this backend scales
with traced-graph size, and the objective graph (warp + splat + filters +
reductions, twice for value_and_grad) dominates it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class BFGSResult(NamedTuple):
    x: jax.Array  # (D,) final parameters
    fun_val: jax.Array  # () final loss
    grad: jax.Array  # (D,) final gradient
    iter_num: jax.Array  # () int32, iterations in the LAST attempt
    total_iters: jax.Array  # () int32, iterations across all attempts
    n_fun_evals: jax.Array  # () int32, loss+grad evaluations
    n_attempts: jax.Array  # () int32, 1 + retries performed
    success: jax.Array  # () bool, gradient sup-norm <= gtol
    # () int32: 0 ok, 1 maxiter, 2 line-search fail, 3 nan,
    # 4 ftol noise-floor stop (opt-in; counts as terminal, never retried)
    status: jax.Array


class _WolfeState(NamedTuple):
    stage: jax.Array  # 0 bracket, 1 zoom, 2 done
    a_prev: jax.Array
    phi_prev: jax.Array
    dphi_prev: jax.Array
    g_prev: jax.Array  # gradient at a_prev (keeps the lo triple consistent)
    a_lo: jax.Array
    phi_lo: jax.Array
    dphi_lo: jax.Array
    g_lo: jax.Array  # gradient at the best point seen (fallback)
    a_hi: jax.Array
    phi_hi: jax.Array
    dphi_hi: jax.Array
    a_next: jax.Array  # trial step for the next bracket evaluation
    n_evals: jax.Array
    first: jax.Array  # bool, first bracket iteration
    a_star: jax.Array
    phi_star: jax.Array
    g_star: jax.Array
    ok: jax.Array  # bool, Wolfe conditions satisfied


def _zoom_trial(s: _WolfeState) -> jax.Array:
    """Safeguarded quadratic interpolation inside [a_lo, a_hi]."""
    d = s.a_hi - s.a_lo
    denom = 2.0 * (s.phi_hi - s.phi_lo - s.dphi_lo * d)
    a_q = s.a_lo - s.dphi_lo * d * d / jnp.where(denom == 0, 1.0, denom)
    mid = s.a_lo + 0.5 * d
    lo_b = jnp.minimum(s.a_lo, s.a_hi)
    hi_b = jnp.maximum(s.a_lo, s.a_hi)
    margin = 0.1 * (hi_b - lo_b)
    bad = (
        (denom == 0)
        | ~jnp.isfinite(a_q)
        | (a_q < lo_b + margin)
        | (a_q > hi_b - margin)
    )
    return jnp.where(bad, mid, a_q)


def _strong_wolfe(
    phi_fn: Callable[[jax.Array], Tuple[jax.Array, jax.Array, jax.Array]],
    phi0: jax.Array,
    dphi0: jax.Array,
    g0: jax.Array,
    alpha1: jax.Array,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_evals: int = 25,
):
    """Strong-Wolfe line search; `phi_fn` is traced exactly once.

    Args:
        phi_fn: alpha -> (phi(alpha), dphi(alpha), grad_vector(alpha)).
        phi0, dphi0, g0: values at alpha = 0.
        alpha1: initial trial step.

    Returns:
        (alpha, phi, grad, n_evals, ok).
    """
    dtype = phi0.dtype
    zero = jnp.zeros((), dtype)

    def cond(s: _WolfeState):
        return (s.stage < 2) & (s.n_evals < max_evals)

    def body(s: _WolfeState) -> _WolfeState:
        in_bracket = s.stage == 0
        a = jnp.where(in_bracket, s.a_next, _zoom_trial(s))
        phi, dphi, g = phi_fn(a)  # the ONE objective call site
        n = s.n_evals + 1

        armijo_ref = jnp.where(in_bracket, s.phi_prev, s.phi_lo)
        armijo_fail = (phi > phi0 + c1 * a * dphi0) | (
            (phi >= armijo_ref) & (~s.first | ~in_bracket)
        )
        curvature_ok = jnp.abs(dphi) <= -c2 * dphi0

        def bracket_update(s: _WolfeState) -> _WolfeState:
            def to_zoom_lo_prev(s):  # bracket [a_prev, a]
                return s._replace(
                    stage=jnp.int32(1),
                    a_lo=s.a_prev, phi_lo=s.phi_prev, dphi_lo=s.dphi_prev,
                    g_lo=s.g_prev,
                    a_hi=a, phi_hi=phi, dphi_hi=dphi,
                )

            def to_done(s):
                return s._replace(
                    stage=jnp.int32(2), a_star=a, phi_star=phi, g_star=g,
                    ok=jnp.bool_(True),
                )

            def to_zoom_lo_cur(s):  # ascending: bracket [a, a_prev]
                return s._replace(
                    stage=jnp.int32(1),
                    a_lo=a, phi_lo=phi, dphi_lo=dphi, g_lo=g,
                    a_hi=s.a_prev, phi_hi=s.phi_prev, dphi_hi=s.dphi_prev,
                )

            def extend(s):
                better = phi < s.phi_lo
                return s._replace(
                    a_prev=a, phi_prev=phi, dphi_prev=dphi, g_prev=g,
                    a_next=jnp.minimum(2.0 * a, jnp.asarray(1e3, dtype)),
                    first=jnp.bool_(False),
                    a_lo=jnp.where(better, a, s.a_lo),
                    phi_lo=jnp.where(better, phi, s.phi_lo),
                    g_lo=jnp.where(better, g, s.g_lo),
                )

            branch = jnp.where(
                armijo_fail,
                0,
                jnp.where(curvature_ok, 1, jnp.where(dphi >= 0, 2, 3)),
            )
            return jax.lax.switch(
                branch, [to_zoom_lo_prev, to_done, to_zoom_lo_cur, extend], s
            )

        def zoom_update(s: _WolfeState) -> _WolfeState:
            def shrink_hi(s):
                return s._replace(a_hi=a, phi_hi=phi, dphi_hi=dphi)

            def done(s):
                return s._replace(
                    stage=jnp.int32(2), a_star=a, phi_star=phi, g_star=g,
                    ok=jnp.bool_(True),
                )

            def move_lo(s):
                flip = dphi * (s.a_hi - s.a_lo) >= 0
                return s._replace(
                    a_lo=a, phi_lo=phi, dphi_lo=dphi, g_lo=g,
                    a_hi=jnp.where(flip, s.a_lo, s.a_hi),
                    phi_hi=jnp.where(flip, s.phi_lo, s.phi_hi),
                    dphi_hi=jnp.where(flip, s.dphi_lo, s.dphi_hi),
                )

            branch = jnp.where(armijo_fail, 0, jnp.where(curvature_ok, 1, 2))
            return jax.lax.switch(branch, [shrink_hi, done, move_lo], s)

        s = jax.lax.cond(in_bracket, bracket_update, zoom_update, s)
        return s._replace(n_evals=n)

    init = _WolfeState(
        stage=jnp.int32(0),
        a_prev=zero, phi_prev=phi0, dphi_prev=dphi0, g_prev=g0,
        a_lo=zero, phi_lo=phi0, dphi_lo=dphi0, g_lo=g0,
        a_hi=zero, phi_hi=phi0, dphi_hi=dphi0,
        a_next=alpha1,
        n_evals=jnp.int32(0),
        first=jnp.bool_(True),
        a_star=zero, phi_star=phi0, g_star=g0,
        ok=jnp.bool_(False),
    )
    out = jax.lax.while_loop(cond, body, init)
    # On failure fall back to the best (lowest-phi) point seen, if it improves.
    improved = out.phi_lo < phi0
    alpha = jnp.where(out.ok, out.a_star, jnp.where(improved, out.a_lo, zero))
    phi = jnp.where(out.ok, out.phi_star, jnp.where(improved, out.phi_lo, phi0))
    g = jnp.where(out.ok, out.g_star, jnp.where(improved, out.g_lo, g0))
    return alpha, phi, g, out.n_evals, out.ok | improved


class BFGSHistory(NamedTuple):
    """Fixed-size per-iteration trajectory (on-device callback replacement).

    The reference collects intermediate thetas/losses through host-side scipy
    callbacks requiring a patched jaxopt (src/eincm/callbacks.py:100-221,
    README.md:92-126); here the while_loop writes into preallocated buffers.
    Entries beyond `n` are undefined.
    """

    xs: jax.Array  # (capacity, D) iterates
    fs: jax.Array  # (capacity,) losses
    n: jax.Array  # () int32 valid entries


def _armijo_backtrack(
    fun,
    fun_and_grad,
    x,
    p,
    f0,
    dphi0,
    g0,
    alpha1,
    c1: float,
    max_evals: int,
    interpolate: bool = False,
):
    """Backtracking line search with value-only probes.

    Shrinks alpha until the Armijo condition f(x+ap) <= f0 + c1*a*dphi0 holds
    (or the probe budget runs out), then evaluates the gradient once at the
    accepted point. Returns the same tuple shape as `_strong_wolfe`.

    With `interpolate` the next trial is the minimizer of the quadratic
    through (0, f0) with slope dphi0 and (alpha, f_trial) — scipy's
    `scalar_search_armijo` strategy — safeguarded into [0.1, 0.5]*alpha.
    A badly overshot first step shrinks up to 10x per probe instead of 2x,
    and a barely-failing one lands near the Armijo boundary, so acceptance
    typically needs fewer value-only probes than plain halving.
    """
    dtype = f0.dtype

    def cond(carry):
        alpha, f_trial, n, done = carry
        return (~done) & (n < max_evals)

    def body(carry):
        alpha, _, n, _ = carry
        f_trial = fun(x + alpha * p)
        ok = f_trial <= f0 + c1 * alpha * dphi0
        if interpolate:
            denom = 2.0 * (f_trial - f0 - dphi0 * alpha)
            a_q = -dphi0 * alpha * alpha / jnp.where(denom == 0, 1.0, denom)
            shrunk = jnp.where(
                (denom == 0) | ~jnp.isfinite(a_q),
                0.5 * alpha,
                jnp.clip(a_q, 0.1 * alpha, 0.5 * alpha),
            )
        else:
            shrunk = alpha * 0.5
        alpha_next = jnp.where(ok, alpha, shrunk)
        return alpha_next, f_trial, n + 1, ok

    alpha, f_trial, n, ok = jax.lax.while_loop(
        cond, body, (alpha1, f0, jnp.int32(0), jnp.bool_(False))
    )
    # value-only probes count ~1/3 of a value+grad eval; round up to 1 each
    # for the n_fun_evals accounting plus the final gradient evaluation.
    alpha = jnp.where(ok, alpha, jnp.zeros((), dtype))
    f_new, g_new = fun_and_grad(x + alpha * p)
    improved = ok & (f_new < f0)
    f_new = jnp.where(improved, f_new, f0)
    g_new = jnp.where(improved, g_new, g0)
    alpha = jnp.where(improved, alpha, 0.0)
    return alpha, f_new, g_new, n + 1, improved


class _BFGSState(NamedTuple):
    x: jax.Array
    f: jax.Array
    g: jax.Array
    h_inv: jax.Array
    f_old: jax.Array  # previous f, for the initial line-search step heuristic
    k_att: jax.Array  # iterations within the current attempt
    k_total: jax.Array
    attempt: jax.Array
    n_evals: jax.Array
    status: jax.Array  # -1 = running
    n_small: jax.Array  # consecutive iterations below the ftol floor
    hist_xs: jax.Array  # (capacity, D) or (0, D)
    hist_fs: jax.Array  # (capacity,) or (0,)


def minimize_bfgs(
    fun_and_grad: Callable[[jax.Array], Tuple[jax.Array, jax.Array]],
    x0: jax.Array,
    maxiter: int,
    gtol: float = 1e-5,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_ls_evals: int = 25,
    n_extra_attempts: int = 0,
    record_history: bool = False,
    unit_initial_step: bool = False,
    line_search: str = "wolfe",
    armijo_interpolate: bool = False,
    fun: "Callable[[jax.Array], jax.Array] | None" = None,
    heartbeat_fn: "Callable | None" = None,
    h0: "jax.Array | None" = None,
    return_h_inv: bool = False,
    ftol: "float | None" = None,
    ftol_patience: int = 2,
):
    """Dense-Hessian BFGS, jittable; semantics follow scipy's 'BFGS'.

    Args:
        fun_and_grad: x (D,) -> (f (), g (D,)).
        x0: initial parameters, flat array.
        maxiter: max iterations per attempt.
        n_extra_attempts: failed-convergence restarts (H reset to identity),
            mirroring the reference solver's retry loop
            (src/eincm/solver.py:218-239).
        record_history: also return a BFGSHistory of per-iteration iterates.
        line_search: 'wolfe' (strong Wolfe, scipy-parity) or 'armijo'
            (backtracking with value-only probes — a probe costs a forward
            pass instead of forward+backward; the gradient is evaluated once
            at the accepted point; BFGS updates are curvature-skipped).
        armijo_interpolate: 'armijo' only — quadratic-interpolated
            backtracking (scipy `scalar_search_armijo`) instead of plain
            halving; usually fewer value-only probes per accepted step.
        fun: value-only objective, required for 'armijo'.
        heartbeat_fn: optional host callback (iter: int32, f: scalar) fired
            once per iteration via `jax.debug.callback` — the on-device
            replacement for the reference's per-iteration loss printing
            (src/eincm/callbacks.py:131-151). Each firing is a host hop,
            so it stays opt-in.
        h0: optional (D, D) initial inverse-Hessian approximation (e.g. a
            previous related solve's final one — warm start); identity when
            None (scipy-parity). Non-finite or non-descent inits are safe:
            the body falls back to steepest descent and the retry loop
            resets to identity.
        return_h_inv: also return the final inverse-Hessian (appended last
            to the return tuple) so a caller can chain warm starts.
        ftol: opt-in noise-floor termination: when the relative loss
            improvement (f_k - f_{k+1}) / max(|f_k|, |f_{k+1}|, 1) stays
            <= ftol for `ftol_patience` CONSECUTIVE iterations, stop with
            status 4 instead of descending into the f32 noise floor — where
            the line search burns its full probe budget proving no step
            improves and the extra-attempt retry re-runs the level (the
            round-3 latency accounting: ~100 of ~185 value probes per MVSEC
            window are this failure detection). Status 4 is terminal: it is
            never retried. None (default) preserves exact reference
            semantics (src/eincm/solver.py:218-239 retry behavior).
        ftol_patience: consecutive below-floor iterations required. Clamped
            to >= 2: at patience 1 an isolated line-search exhaustion would
            become terminal status 4 immediately, skipping the status-2
            Hessian-reset retry the docstring above guarantees.

    Returns:
        BFGSResult, with BFGSHistory appended when record_history and the
        final (D, D) inverse-Hessian appended when return_h_inv.
    """
    assert line_search in ("wolfe", "armijo")
    if line_search == "armijo":
        assert fun is not None, "'armijo' needs the value-only objective"
    ftol_patience = max(int(ftol_patience), 2)
    dtype = x0.dtype
    d = x0.shape[0]
    eye = jnp.eye(d, dtype=dtype)
    gtol_a = jnp.asarray(gtol, dtype)

    f0, g0 = fun_and_grad(x0)

    def cond(s: _BFGSState):
        return s.status == -1

    def body(s: _BFGSState) -> _BFGSState:
        p = -s.h_inv @ s.g
        dphi0 = jnp.vdot(p, s.g)

        # If the direction is not a descent direction (numerical breakdown),
        # restart from steepest descent.
        bad_dir = (dphi0 >= 0) | ~jnp.isfinite(dphi0)
        p = jnp.where(bad_dir, -s.g, p)
        dphi0 = jnp.where(bad_dir, -jnp.vdot(s.g, s.g), dphi0)

        def phi_fn(alpha):
            xk = s.x + alpha * p
            f, g = fun_and_grad(xk)
            return f, jnp.vdot(g, p), g

        if unit_initial_step:
            # BFGS steps approach the unit Newton step superlinearly; trying
            # alpha=1 first typically accepts immediately and spares the
            # bracket-extension evaluations of the scipy heuristic.
            alpha1 = jnp.asarray(1.0, dtype)
        else:
            # scipy's heuristic: alpha1 = min(1, 1.01*2*(f-f_old)/dphi0)
            rel = 1.01 * 2.0 * (s.f - s.f_old) / jnp.where(dphi0 == 0, 1.0, dphi0)
            alpha1 = jnp.where(
                jnp.isfinite(rel) & (rel > 0),
                jnp.minimum(1.0, rel),
                jnp.asarray(1.0, dtype),
            )

        if line_search == "armijo":
            alpha, f_new, g_new, ls_evals, ls_ok = _armijo_backtrack(
                fun, fun_and_grad, s.x, p, s.f, dphi0, s.g, alpha1, c1,
                max_ls_evals, interpolate=armijo_interpolate,
            )
        else:
            alpha, f_new, g_new, ls_evals, ls_ok = _strong_wolfe(
                phi_fn, s.f, dphi0, s.g, alpha1, c1, c2, max_ls_evals
            )

        x_new = s.x + alpha * p
        sk = x_new - s.x
        yk = g_new - s.g
        ys = jnp.vdot(yk, sk)

        # BFGS inverse-Hessian update; skip when curvature condition fails.
        rho = 1.0 / jnp.where(ys == 0, 1.0, ys)
        vl = eye - rho * jnp.outer(sk, yk)
        h_new = vl @ s.h_inv @ vl.T + rho * jnp.outer(sk, sk)
        do_update = (ys > 1e-10 * jnp.vdot(sk, sk)) & jnp.isfinite(ys)
        h_inv = jnp.where(do_update, h_new, s.h_inv)

        k_att = s.k_att + 1
        gnorm = jnp.max(jnp.abs(g_new))
        nan_hit = ~jnp.isfinite(f_new) | ~jnp.isfinite(gnorm)
        converged = gnorm <= gtol_a
        if ftol is not None:
            # acceptance guarantees f_new <= s.f; a failed line search gives
            # f_new == s.f (improvement exactly 0 <= ftol). An exhausted
            # search that arrives with the floor already indicated
            # (n_small >= 1) COMPLETES the patience — it just burned the
            # full probe budget proving no improving step exists, which is
            # stronger evidence than another tiny accepted step. An isolated
            # exhaustion after real progress keeps the normal status-2 retry
            # path (it may be a curvature breakdown a Hessian reset fixes),
            # so at most one retry re-run happens per level before the
            # floor is declared.
            denom = jnp.maximum(
                jnp.maximum(jnp.abs(s.f), jnp.abs(f_new)),
                jnp.asarray(1.0, dtype),
            )
            small_step = (s.f - f_new) / denom <= jnp.asarray(ftol, dtype)
            inc = jnp.where(
                ls_ok,
                jnp.int32(1),
                jnp.where(
                    s.n_small >= 1, jnp.int32(ftol_patience), jnp.int32(1)
                ),
            )
            n_small = jnp.where(small_step, s.n_small + inc, jnp.int32(0))
            ftol_stop = n_small >= ftol_patience
        else:
            n_small = s.n_small
            ftol_stop = jnp.bool_(False)
        status = jnp.where(
            nan_hit,
            3,
            jnp.where(
                converged,
                0,
                jnp.where(
                    ftol_stop,
                    4,
                    jnp.where(
                        ~ls_ok, 2, jnp.where(k_att >= maxiter, 1, -1)
                    ),
                ),
            ),
        ).astype(jnp.int32)

        # Retry on failure (status 1/2/3) with attempts remaining: reset
        # the Hessian and keep iterating from the current point. The ftol
        # stop (4) is a deliberate termination, not a failure — no retry.
        retry = (
            (status > 0) & (status != 4)
            & (s.attempt < n_extra_attempts) & (k_att > 0)
        )
        status = jnp.where(retry, -1, status)
        h_inv = jnp.where(retry, eye, h_inv)

        if record_history:
            hist_xs = jax.lax.dynamic_update_slice(
                s.hist_xs, x_new[None, :], (s.k_total, jnp.int32(0))
            )
            hist_fs = s.hist_fs.at[s.k_total].set(f_new)
        else:
            hist_xs, hist_fs = s.hist_xs, s.hist_fs

        if heartbeat_fn is not None:
            jax.debug.callback(heartbeat_fn, s.k_total + 1, f_new)

        return _BFGSState(
            x=x_new,
            f=f_new,
            g=g_new,
            h_inv=h_inv,
            f_old=s.f,
            k_att=jnp.where(retry, 0, k_att),
            k_total=s.k_total + 1,
            attempt=jnp.where(retry, s.attempt + 1, s.attempt),
            n_evals=s.n_evals + ls_evals,
            status=status,
            # n_small survives a retry: failure -> Hessian-reset retry ->
            # failure again is exactly the floor confirmation; any genuinely
            # improving post-reset step clears it via small_step = False
            n_small=n_small,
            hist_xs=hist_xs,
            hist_fs=hist_fs,
        )

    capacity = maxiter * (n_extra_attempts + 1) if record_history else 0
    if h0 is None:
        h_init = eye
    else:
        # a poisoned warm start must not poison the solve: any non-finite
        # entry falls back to identity wholesale
        h_init = jnp.where(jnp.all(jnp.isfinite(h0)), h0, eye)
    init = _BFGSState(
        x=x0,
        f=f0,
        g=g0,
        h_inv=h_init,
        f_old=f0 + jnp.linalg.norm(g0) / 2.0 + 1.0,
        k_att=jnp.int32(0),
        k_total=jnp.int32(0),
        attempt=jnp.int32(0),
        n_evals=jnp.int32(1),
        status=jnp.where(jnp.max(jnp.abs(g0)) <= gtol_a, 0, -1).astype(jnp.int32),
        n_small=jnp.int32(0),
        hist_xs=jnp.zeros((capacity, d), dtype),
        hist_fs=jnp.zeros((capacity,), dtype),
    )
    out = jax.lax.while_loop(cond, body, init)

    success = jnp.max(jnp.abs(out.g)) <= gtol_a
    result = BFGSResult(
        x=out.x,
        fun_val=out.f,
        grad=out.g,
        iter_num=out.k_att,
        total_iters=out.k_total,
        n_fun_evals=out.n_evals,
        n_attempts=out.attempt + 1,
        success=success,
        status=out.status,
    )
    rets = (result,)
    if record_history:
        rets += (BFGSHistory(xs=out.hist_xs, fs=out.hist_fs, n=out.k_total),)
    if return_h_inv:
        rets += (out.h_inv,)
    return rets if len(rets) > 1 else result


def minimize_bounded_scalar(
    fun: Callable[[jax.Array], jax.Array],
    bounds: Tuple[float, float],
    maxiter: int = 30,
    record_history: bool = False,
    n_grid_probes: int = 0,
):
    """Bounded scalar minimization via golden-section search, jittable.

    Replaces the reference's 1-D L-BFGS-B handover-weight solve
    (src/eincm/solver.py:175-183, 302-347) with a derivative-free bracketing
    method — robust in f32 and free of the host round-trip. The objective is
    traced twice (one vmapped init over the probe points incl. the bounds,
    one call in the loop body).

    Golden-section (like the reference's L-BFGS-B from a single init) only
    finds the basin it starts in; `n_grid_probes >= 3` first evaluates a
    uniform grid over the bounds in ONE vmapped batch (cheap — the
    probes share a compiled objective) and shrinks the bracket to the best
    probe's neighbors, making the solve robust to multi-modal handover
    landscapes.

    Returns:
        (x_star, f_star), or ((x_star, f_star), BFGSHistory) with
        `record_history`: the probe trajectory (grid/bounds probes, the two
        interior inits, then one probe per iteration) — the on-device
        equivalent of the reference's handover solver callback collection
        (src/eincm/callbacks.py:223-364).
    """
    lo, hi = bounds
    invphi = 0.6180339887498949
    n_init = max(2, n_grid_probes)
    xs_init = jnp.linspace(lo, hi, n_init, dtype=jnp.float32)
    fs_init = jax.vmap(fun)(xs_init)
    i_init = jnp.argmin(fs_init)
    # bracket the best probe's basin (the full bounds when n_init == 2)
    a = xs_init[jnp.maximum(i_init - 1, 0)]
    b = xs_init[jnp.minimum(i_init + 1, n_init - 1)]
    fa = fs_init[jnp.maximum(i_init - 1, 0)]
    fb = fs_init[jnp.minimum(i_init + 1, n_init - 1)]
    c = b - (b - a) * invphi
    d_ = a + (b - a) * invphi
    fc, fd = jax.vmap(fun)(jnp.stack([c, d_]))

    cap = n_init + 2 + maxiter if record_history else 0
    hist_xs = jnp.zeros((cap,), a.dtype)
    hist_fs = jnp.zeros((cap,), fc.dtype)
    if record_history:
        hist_xs = hist_xs.at[:n_init].set(xs_init)
        hist_fs = hist_fs.at[:n_init].set(fs_init)
        hist_xs = hist_xs.at[n_init : n_init + 2].set(jnp.stack([c, d_]))
        hist_fs = hist_fs.at[n_init : n_init + 2].set(jnp.stack([fc, fd]))
    n_pre = n_init + 2

    def body(i, carry):
        a, b, c, d_, fc, fd, hx, hf = carry

        def go_left(carry):
            # keep [a, d]; old c becomes the new d; probe the new c
            a, b, c, d_, fc, fd = carry
            b2 = d_
            c2 = b2 - (b2 - a) * invphi
            return a, b2, c2, c, fc, c2

        def go_right(carry):
            # keep [c, b]; old d becomes the new c; probe the new d
            a, b, c, d_, fc, fd = carry
            a2 = c
            d2 = a2 + (b - a2) * invphi
            return a2, b, d_, d2, fd, d2

        a2, b2, c2, d2, keep, probe = jax.lax.cond(
            fc < fd, go_left, go_right, (a, b, c, d_, fc, fd)
        )
        f_probe = fun(probe)  # the ONE loop-body objective call site
        left = fc < fd
        fc2 = jnp.where(left, f_probe, keep)
        fd2 = jnp.where(left, keep, f_probe)
        if record_history:
            hx = hx.at[n_pre + i].set(probe)
            hf = hf.at[n_pre + i].set(f_probe)
        return a2, b2, c2, d2, fc2, fd2, hx, hf

    a0, b0 = a, b  # (fa, fb) belong to THESE points; the loop shrinks a/b
    a, b, c, d_, fc, fd, hist_xs, hist_fs = jax.lax.fori_loop(
        0, maxiter, body, (a, b, c, d_, fc, fd, hist_xs, hist_fs)
    )
    x_star = jnp.where(fc < fd, c, d_)
    f_star = jnp.minimum(fc, fd)
    # include the (pre-evaluated) bracket ends and best init probe via a
    # consistent argmin so the returned (x, f) always belong to the same
    # candidate (interior wins ties, preserving the strict-< preference of
    # the bracketing loop)
    xs_cand = jnp.stack([x_star, a0, b0, xs_init[i_init]])
    fs_cand = jnp.stack([f_star, fa, fb, fs_init[i_init]])
    i_best = jnp.argmin(fs_cand)
    if record_history:
        hist = BFGSHistory(
            xs=hist_xs, fs=hist_fs, n=jnp.int32(n_pre + maxiter)
        )
        return (xs_cand[i_best], fs_cand[i_best]), hist
    return xs_cand[i_best], fs_cand[i_best]
