"""Smoke test of the EINCM main path on NVIDIA GPUs.

Run from the root of a checkout, with nothing else using the card:

    python chip_smoke.py               # one GPU
    python chip_smoke.py --devices 4   # four GPUs: the multi-card path only

One GPU runs three phases in one process:

1. environment: the card's name and power limit, JAX, the optional modules;
2. parity at real widths (MVSEC 256x336 / 30k events, DSEC 480x640 / 1.5M
   events, 2 reference frames): the splat (forward and gradient), the
   coarse-theta interpolation and `solver_loss` (value and gradient) on the
   GPU in float32, each against the plain reference evaluated on the CPU
   device in float64;
3. the main path: `python -m eincm_tpu.experiments` at the DSEC-test tuning
   (configs/dsec_test.yaml) on the synthetic loader, 3 windows, SOLVE and
   EVAL, with compile time, warm per-window solve time, BFGS counts, peak
   device memory and AEE against the synthetic ground truth.

`--devices 4` runs only the multi-card path: the `two_pass` and
`sequence_shard` schedules and the sharded EVAL over a 1-D mesh of 4 cards,
each compared with the serial single-card chain on the same windows.

Any failed check exits non-zero. Without a GPU it exits non-zero before any
phase. The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "outputs", "chip_smoke")

# (sensor (H, W), events per window, objective weights α, β) of the parity
# cases: the MVSEC-indoor and DSEC tunings (upstream run.sh:41-72, :99-121)
PARITY_CASES = {
    "mvsec": ((256, 336), 30_000, (20.0, 35.0)),
    "dsec": ((480, 640), 1_500_000, (2000.0, 4000.0)),
}
N_REFS = 2

# float32 on the GPU against float64 on the CPU, both fed the same
# float32-representable inputs. No matmul is involved in the splat (so no
# TF32); the error is f32 rounding of the pdf values plus the order in which
# atomic adds sum a texel's contributions, which changes from run to run.
# Errors are relative to the largest reference magnitude.
SPLAT_TOL = 1e-5
# the interpolation's matmul is pinned to Precision.HIGHEST (full f32)
INTERP_TOL = 1e-5
# the loss sums f32 image statistics over the whole sensor; the CPU's own
# float32 errors at these shapes are ~4e-6 (value) and 1e-4..3e-4 (gradient)
LOSS_TOL = 1e-4
LOSS_GRAD_TOL = 1e-3

# DSEC-test tuning (configs/dsec_test.yaml, upstream run.sh:99-121) on the
# synthetic loader, whose ground-truth flow is (3, -2) px per window. Edge
# surfaces are the Canny + EINCM IEDT pipeline of the benchmark harness
# (utils/benchmarks.py): with the Gaussian-smoothed default the correlation
# term pulls the synthetic fixture away from alignment (PARITY.md, edge
# sensitivity).
DSEC_SMOKE_OVERRIDES = [
    "dataset.kind=synthetic",
    "edge.smoothen_method=eincm_iedt",
    "edge.enable_image_preprocessing=false",
    "dataset.sensor_size=[480, 640]",
    "dataset.des_n_events=1500000",
    "alpha=2000",
    "beta=4000",
    "solver.n_pyr_lvls=5",
    "solver.theta_miniter=10",
    "solver.theta_maxiter=40",
    "solver.n_extra_attempts={0: 2, 1: 2, 2: 2, 3: 2, 4: 2}",
    "handover.use_handover=true",
    "handover.solve_handover_for_levels=[0]",
    "phases.solve=true",
    "phases.eval=true",
    "phases.plot=false",
]
GT_SPEED = float(np.hypot(3.0, -2.0))
# a recovered flow: a solve that stays at theta = 0 scores |V| = 3.61 px
AEE_MAX_PX = 0.5
# a prior-chain schedule may differ from the serial chain by this much in
# mean AEE (two_pass takes its priors from a prior-free first pass)
SCHEDULE_AEE_BAND_PX = 0.1
# the sharded EVAL evaluates the same thetas as the serial EVAL
EVAL_AEE_TOL_PX = 1e-4


def _f32(*arrays):
    """Inputs rounded to float32 once: the f32 run gets these values and
    the f64 reference gets exactly the same values, widened."""
    return [np.asarray(a, np.float32) for a in arrays]


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


def _check(name: str, err: float, tol: float, note: str) -> None:
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max err {err:.3e} (tol {tol:.0e}; {note}) {status}",
          flush=True)
    if not err <= tol:
        raise SystemExit(f"parity check {name} failed")


def _events(sensor, n, seed, n_refs=N_REFS):
    """Warped coordinates as the solver sees them: integer events displaced
    by up to ~8 px (so windows spill over the sensor edge), with the last
    1% set to the padding sentinel (-1e4) of models/loss.py."""
    h, w = sensor
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, w, n).astype(np.float64)
    ys = rng.integers(0, h, n).astype(np.float64)
    ts = rng.uniform(0, 1, n)
    t_refs = np.linspace(0, 1, n_refs)
    v = rng.normal(0, 3, (n, 2))
    dts = ts[None] - t_refs[:, None]
    wx = xs[None] - v[None, :, 0] * dts
    wy = ys[None] - v[None, :, 1] * dts
    n_pad = n // 100
    wx[:, n - n_pad:] = -1e4
    wy[:, n - n_pad:] = -1e4
    cot = rng.normal(0, 1, (n_refs, h, w))
    return wx, wy, cot


def splat_parity(name, sensor, n, device, seed=0):
    """The splat on `device` (f32) vs the scatter oracle on the CPU (f64),
    forward and gradient w.r.t. the warped coordinates."""
    import jax

    from eincm_tpu.ops.splat import events_to_pdf_frame_scatter, splat_multi_ref

    args = _f32(*_events(sensor, n, seed))

    def fg(splat, wx, wy, cot):
        def loss(a, b):
            frames = splat(a, b)
            return (frames * cot).sum(), frames

        (_, frames), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True
        )(wx, wy)
        return frames, grads

    ours = jax.jit(lambda a, b, c: fg(
        lambda x, y: splat_multi_ref(x, y, sensor), a, b, c))
    frames, (gx, gy) = ours(*(jax.device_put(v, device) for v in args))
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        oracle = jax.jit(lambda a, b, c: fg(
            lambda x, y: jax.vmap(
                lambda p, q: events_to_pdf_frame_scatter(p, q, sensor)
            )(x, y), a, b, c))
        rf, (rgx, rgy) = oracle(*(jax.device_put(v.astype(np.float64), cpu)
                                  for v in args))
        rf, rgx, rgy = (np.asarray(v) for v in (rf, rgx, rgy))
    note = "relative; f32 vs f64, atomic summation order"
    _check(f"{name} splat forward", _rel(frames, rf), SPLAT_TOL, note)
    _check(f"{name} splat d/dx", _rel(gx, rgx), SPLAT_TOL, note)
    _check(f"{name} splat d/dy", _rel(gy, rgy), SPLAT_TOL, note)


def _level0_theta(sensor, seed):
    from eincm_tpu.models.loss import LossParams
    from eincm_tpu.models.pyramid import SolverConfig

    cfg = SolverConfig(n_pyr_lvls=5, sensor_size=sensor,
                       params=LossParams(1.0, 1.0),
                       theta_opt_maxiters=(1,) * 5)
    rng = np.random.default_rng(seed)
    return rng.normal(0, 3, (*cfg.level_shape(0), 2))


def interp_parity(name, sensor, n, device, seed=1):
    """Coarse-theta interpolation on `device` (f32) vs the gather of the
    upscaled field on the CPU (f64)."""
    import jax

    from eincm_tpu.ops.resize import scale_theta_to_sensor_size
    from eincm_tpu.ops.warp import gather_theta_at_events, interp_theta_at_events

    h, w = sensor
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, w, n).astype(np.float64)
    ys = rng.integers(0, h, n).astype(np.float64)
    args = _f32(_level0_theta(sensor, seed), xs, ys)
    ours = jax.jit(lambda t, x, y: interp_theta_at_events(t, x, y, sensor))
    got = ours(*(jax.device_put(v, device) for v in args))
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        ref = jax.jit(lambda t, x, y: gather_theta_at_events(
            scale_theta_to_sensor_size(t, sensor, "bilinear"), x, y))(
            *(jax.device_put(v.astype(np.float64), cpu) for v in args))
        ref = np.asarray(ref)
    _check(f"{name} interp", _rel(got, ref), INTERP_TOL,
           "relative; f32 HIGHEST matmul vs f64 gather")


def loss_parity(name, sensor, n, device, weights, seed=2):
    """`solver_loss` value and gradient at a fixed level-0 theta, objective
    weights (α, β): `device` in f32 vs the CPU in f64."""
    import jax

    from eincm_tpu.models.loss import (
        LossParams,
        LossStatics,
        compute_window_statics,
        solver_loss,
    )

    h, w = sensor
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, w, n).astype(np.float64)
    ys = rng.integers(0, h, n).astype(np.float64)
    ts = np.sort(rng.uniform(0, 1, n))
    edges = rng.uniform(0, 1, (N_REFS, h, w))
    edge_ts = np.linspace(0, 1, N_REFS)
    theta = _level0_theta(sensor, seed)
    statics = LossStatics(sensor_size=sensor, n_pyr_lvls=5)
    params = LossParams(*weights)

    def fg(th, xs, ys, ts, edges, edge_ts):
        wstat = compute_window_statics(xs, ys, edges, sensor)
        return jax.value_and_grad(solver_loss)(
            th, xs, ys, ts, edges, edge_ts, params, 0, statics, wstat)

    args = _f32(theta, xs, ys, ts, edges, edge_ts)
    f, g = jax.jit(fg)(*(jax.device_put(v, device) for v in args))
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        rf, rg = jax.jit(fg)(*(jax.device_put(v.astype(np.float64), cpu)
                               for v in args))
        rf, rg = float(rf), np.asarray(rg)
    note = "relative; f32 vs f64"
    _check(f"{name} solver_loss", _rel(f, rf), LOSS_TOL, note)
    _check(f"{name} solver_loss grad", _rel(g, rg), LOSS_GRAD_TOL, note)


def run_parity(device, cases=PARITY_CASES):
    for name, (sensor, n, weights) in cases.items():
        print(f"parity at {name} width: sensor {sensor}, {n} events, "
              f"{N_REFS} refs", flush=True)
        splat_parity(name, sensor, n, device)
        interp_parity(name, sensor, n, device)
        loss_parity(name, sensor, n, device, weights)


class _CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax.monitoring

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def _aees(exp):
    return np.array([
        float(np.asarray(exp.eval_results[k]["evals"]["AEE"]))
        for k in sorted(exp.eval_results,
                        key=lambda k: int(k.rsplit("_", 1)[1]))
    ])


def _run_cli(overrides):
    from eincm_tpu.experiments.__main__ import main as cli_main

    return cli_main(list(overrides))


def main_path(overrides=DSEC_SMOKE_OVERRIDES, n_windows=3, warm_reps=3,
              aee_max=AEE_MAX_PX):
    """Drive the CLI entry point and report what a user pays for."""
    import jax

    from eincm_tpu.utils.benchmarks import solve_diag_str

    clock = _CompileClock()
    t0 = time.perf_counter()
    exp = _run_cli([*overrides, f"dataset.n_windows={n_windows}",
                    f"output_dir={OUT}", "experiment_name=main_path"])
    wall = time.perf_counter() - t0
    print(f"main path: {n_windows} windows SOLVE+EVAL in {wall:.1f} s wall, "
          f"of which compile {clock.seconds:.1f} s (set-up)", flush=True)

    # warm per-window solve: the last window again, from its real prior,
    # through the already-compiled solver
    last = n_windows - 1
    staged = exp.stage(exp.dataloader[last])
    window = jax.device_put(staged.window)
    pyr = exp.opt_results[f"datasample_idx_{last - 1}"][
        "solver_final_results"]["final_theta_pyr"]
    prior = tuple(jax.device_put(np.asarray(pyr[f"pyr_lvl_{l}"]))
                  for l in range(len(pyr)))
    jax.block_until_ready(exp.window_solver(window, prior, is_first=False))
    times = []
    for _ in range(warm_reps):
        t = time.perf_counter()
        res = jax.block_until_ready(
            exp.window_solver(window, prior, is_first=False))
        times.append(time.perf_counter() - t)
    print(f"warm window solve: p50 {np.median(times) * 1e3:.1f} ms "
          f"(min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}, "
          f"n={warm_reps})", flush=True)
    print(f"BFGS per level (finest first): {solve_diag_str(res)}", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}", flush=True)

    aees = _aees(exp)
    print(f"AEE per window (px): {np.round(aees, 4).tolist()} "
          f"(band [0, {aee_max}]; |V| = {GT_SPEED:.2f} px)", flush=True)
    if not (np.all(np.isfinite(aees)) and np.all(aees <= aee_max)):
        raise SystemExit("main path AEE outside its band")
    return aees


def multi_device_path(n_devices, overrides=DSEC_SMOKE_OVERRIDES, n_windows=8,
                      aee_max=AEE_MAX_PX):
    """The parallel schedules and the sharded EVAL over a 1-D mesh of
    `n_devices`, each against the serial single-device chain."""
    import jax

    if len(jax.devices()) < n_devices:
        raise SystemExit(f"--devices {n_devices}: JAX has {jax.devices()}")
    base = [*overrides, f"dataset.n_windows={n_windows}", f"output_dir={OUT}"]

    serial = _run_cli([*base, "experiment_name=serial"])
    ref = _aees(serial)
    print(f"serial chain AEE (px): {np.round(ref, 4).tolist()}", flush=True)
    if not (np.all(np.isfinite(ref)) and np.all(ref <= aee_max)):
        raise SystemExit("serial chain AEE outside its band")

    # sharded EVAL of the serial chain's thetas vs its serial EVAL
    serial.cfg.phases.parallel_eval = True
    serial.eval_results = {}
    serial.run_eval()
    err = float(np.max(np.abs(_aees(serial) - ref)))
    _check(f"sharded EVAL over {n_devices} devices (AEE px)", err,
           EVAL_AEE_TOL_PX, "absolute px; same thetas")

    for mode in ("two_pass", "sequence_shard"):
        exp = _run_cli([*base, f"experiment_name={mode}",
                        "phases.parallel_windows=true",
                        f"phases.parallel_mode={mode}",
                        "phases.parallel_eval=true"])
        aees = _aees(exp)
        d = abs(float(aees.mean()) - float(ref.mean()))
        print(f"{mode} over {n_devices} devices AEE (px): "
              f"{np.round(aees, 4).tolist()}; mean {aees.mean():.4f} vs "
              f"serial {ref.mean():.4f}", flush=True)
        if not (np.all(np.isfinite(aees)) and np.all(aees <= aee_max)
                and d <= SCHEDULE_AEE_BAND_PX):
            raise SystemExit(
                f"{mode}: AEE outside [0, {aee_max}] or mean more than "
                f"{SCHEDULE_AEE_BAND_PX} px from the serial chain")


def environment():
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print("nvidia-smi --query-gpu=name,power.limit:", flush=True)
    print(smi, flush=True)
    print(f"jax {jax.__version__}, devices {jax.devices()}", flush=True)
    found = {}
    for mod in ("yaml", "h5py", "matplotlib", "PIL"):
        try:
            importlib.import_module(mod)
            found[mod] = True
        except ImportError:
            found[mod] = False
    print(f"optional modules importable: {found}", flush=True)
    from eincm_tpu.native import events as native_events

    print("native event library: "
          + ("built" if native_events.available() else "not built; numpy "
             "fallback in use"), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 runs only the multi-card path")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "eincm_tpu")):
        sys.exit(f"chip_smoke: run it from a checkout; {REPO} has no eincm_tpu")

    # the f64 references run on JAX's CPU device beside the GPU
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (devices {jax.devices()})")
    from eincm_tpu.utils.jax_helpers import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    environment()
    if args.devices == 1:
        run_parity(dev)
        main_path()
    else:
        multi_device_path(args.devices)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
