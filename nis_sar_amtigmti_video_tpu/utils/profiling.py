"""Tracing / profiling hooks.

The reference's only observability is carriage-return progress prints
(sar_satellite_sim.py:265) and tqdm (sar_batch_sim.py:281). Here:

* ``stage_timer`` — wall-clock per pipeline stage, fenced by ``sync()``
  (``jax.block_until_ready`` on every leaf of the result).
* ``trace`` — context manager around ``jax.profiler`` emitting a Perfetto
  trace directory.
* ``named_scope`` — re-export of jax.named_scope for annotating CSA phases
  etc. in the profile.
* ``Counters`` — frames/sec + per-CPI latency accumulators (the BASELINE
  metrics) with a one-line JSON dump.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict

import jax
import numpy as np

named_scope = jax.named_scope


def sync(x) -> None:
    """Device fence: wait until every array in the pytree ``x`` is ready."""
    jax.block_until_ready(x)


class StageTimer:
    """Accumulates wall-clock per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result_to_sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result_to_sync is not None:
                sync(result_to_sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(out)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        return out

    def report(self) -> dict:
        return {name: {"total_s": round(t, 4),
                       "mean_ms": round(1000 * t / max(1, self.counts[name]), 3),
                       "count": self.counts[name]}
                for name, t in sorted(self.totals.items())}

    def __str__(self):
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/sar_trace"):
    """jax.profiler trace around a region; open with Perfetto/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class Counters:
    """BASELINE metrics: frames formed + per-CPI latencies."""

    def __init__(self):
        self.frames = 0
        self.t0 = time.perf_counter()
        self.cpi_latencies = []

    def add_frames(self, n: int):
        self.frames += n

    def add_cpi_latency(self, seconds: float):
        self.cpi_latencies.append(seconds)

    def report(self) -> dict:
        dt = time.perf_counter() - self.t0
        lat = np.asarray(self.cpi_latencies) if self.cpi_latencies else None
        return {
            "frames": self.frames,
            "elapsed_s": round(dt, 3),
            "frames_per_sec": round(self.frames / dt, 3) if dt > 0 else 0.0,
            "cpi_latency_ms_p50": round(1e3 * float(np.median(lat)), 2) if lat is not None else None,
            "cpi_latency_ms_p95": round(1e3 * float(np.percentile(lat, 95)), 2) if lat is not None else None,
        }
