"""Structured run logging (JSON lines).

The reference redirects stdout to ad-hoc text logs
(``sar_satellite_sim.py:10-12``) with parameter dumps and SNR prints; this is
the structured equivalent: one JSONL event stream per run carrying the radar
budget, per-stage timings (utils/profiling.StageTimer), product metrics
(utils/metrics) and free-form events — machine-readable observability for
production campaigns.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import numpy as np


class RunLogger:
    """Append-only JSONL event log; every event gets ts + elapsed."""

    def __init__(self, path: Optional[str], run_id: str = "run",
                 echo: bool = False):
        self._path = path
        self._run_id = run_id
        self._echo = echo
        self._t0 = time.time()
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def event(self, kind: str, **fields: Any) -> dict:
        rec = {"ts": round(time.time(), 3),
               "elapsed_s": round(time.time() - self._t0, 3),
               "run": self._run_id, "event": kind}
        rec.update(_jsonable(fields))
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
        if self._echo:
            print(line)
        return rec

    def params(self, scenario) -> dict:
        """Log the radar-budget parameter dump (the reference's printed
        header, sar_satellite_sim.py:61-70)."""
        from nis_sar_amtigmti_video_tpu.utils.metrics import radar_budget_report
        return self.event("params", **radar_budget_report(scenario))

    def timings(self, stage_timer) -> dict:
        return self.event("timings", stages=stage_timer.report())

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist() if obj.size <= 64 else f"<array {obj.shape}>"
    if hasattr(obj, "dtype") and hasattr(obj, "shape"):
        # jax Array (possibly still on device): logging a metric straight off
        # a computation is the common case — fetch it
        if obj.dtype.kind == "c":
            from nis_sar_amtigmti_video_tpu.utils.cplx import to_host
            a = to_host(obj)
            return {"re": _jsonable(np.real(a)), "im": _jsonable(np.imag(a))}
        a = np.asarray(obj)
        return _jsonable(a if a.ndim else a.item())
    return obj
