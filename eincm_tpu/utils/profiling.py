"""Profiling and tracing utilities (SURVEY.md §5: first-class profiling).

The reference has only wall-clock progress prints (exp_mgr.py:484-508) and
commented-out compilation-cache hooks. Here:

- `trace(dir)` wraps a block in a jax.profiler trace (view in TensorBoard /
  xprof);
- `timed` / `Timer` measure wall time up to `jax.block_until_ready` on the
  result, so the device work is inside the measured region;
- `annotate` adds named regions to profiles.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context; open `log_dir` with TensorBoard to view."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


annotate = jax.profiler.TraceAnnotation


class Timer:
    """Accumulating named wall-clock timers; `sync_on` is waited for."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                jax.block_until_ready(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: total {t:.3f}s over {c} calls ({t/c*1000:.1f} ms/call)")
        return "\n".join(lines)


def timed(fn, *args, iters: int = 10, warmup: int = 1):
    """Amortized timing of a jitted callable, waiting once at the end.

    Returns (seconds_per_call, last_output).
    """
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out
