"""Benchmark: window-solve latency and warp+splat throughput on the GPU.

Prints one JSON line per metric; every line names the device it ran on
(platform, device_kind, device count):
    {"metric": "window_solve_p50", ...}               (MVSEC scale)
    {"metric": "dsec_window_solve_p50", ...}          (DSEC scale)
    {"metric": "parallel_solve_p50_per_window", ...}  (batched DP solve)
    {"metric": "warp_splat_throughput", ...}          (DSEC scale)

Every timed region ends in `jax.block_until_ready`. Compilation happens
before the timed rounds. A run without a GPU exits non-zero.
Skip the slow sections with EINCM_BENCH_SKIP_DSEC_SOLVE=1 and
EINCM_BENCH_SKIP_PARALLEL=1.
"""

import json
import os
import sys

# one fixed cache path: the path is part of the cache key
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
)

import numpy as np


def _device() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _emit(metric: str, value: float, unit: str, n: int, device: dict):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "n_samples": n, "device": device}), flush=True)


def main():
    device = _device()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {device}")

    from eincm_tpu.utils.benchmarks import (
        DSEC_N_EVENTS,
        DSEC_N_REFS,
        build_dsec_solve_bench,
        build_dsec_throughput_bench,
        build_mvsec_solve_bench,
        build_parallel_solve_bench,
        solve_diag_str,
    )

    # MVSEC-scale chained window solve (rotating GT velocity; see
    # eincm_tpu.utils.benchmarks)
    one_round, res = build_mvsec_solve_bench()
    print(f"# solve diag: {solve_diag_str(res)}", file=sys.stderr)
    samples = [one_round() for _ in range(5)]
    _emit("window_solve_p50", float(np.median(samples) * 1e3), "ms",
          len(samples), device)

    if os.environ.get("EINCM_BENCH_SKIP_DSEC_SOLVE", "0") != "1":
        one_round_dsec, dsec_res = build_dsec_solve_bench()
        print(f"# dsec solve diag: {solve_diag_str(dsec_res)}",
              file=sys.stderr)
        dsec_samples = [one_round_dsec() for _ in range(2)]
        _emit("dsec_window_solve_p50", float(np.median(dsec_samples) * 1e3),
              "ms", len(dsec_samples), device)

    if os.environ.get("EINCM_BENCH_SKIP_PARALLEL", "0") != "1":
        one_round_par, _ = build_parallel_solve_bench()
        par_samples = [one_round_par() for _ in range(3)]
        _emit("parallel_solve_p50_per_window",
              float(np.median(par_samples) * 1e3), "ms", len(par_samples),
              device)

    one_round = build_dsec_throughput_bench()
    rounds = [one_round() for _ in range(3)]
    mev = DSEC_N_EVENTS * DSEC_N_REFS / float(np.median(rounds)) / 1e6
    _emit("warp_splat_throughput", mev, "Mevents/s/device", len(rounds),
          device)


if __name__ == "__main__":
    main()
