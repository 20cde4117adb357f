"""Driver-contract smoke tests for bench.py.

bench.py prints ONE JSON line and measures the GPU only: without one it
exits non-zero and reports no metric. BENCH_SMOKE=1 runs every section's
code on any platform at a tiny size and reports no timing, which is what
these CPU tests use to check the artifact's contract: every metric KEY
present, a per-section status map with explicit skip reasons and the path
each section ran, and the device named.
"""

import json
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_METRIC_KEYS = (
    "metric", "value", "unit", "vs_baseline", "gmti_latency_ms",
    "csa_formation_fps", "bp_frame_ms", "bp_stream_frame_ms", "sim_pass_s",
    "hrws_recon_ms", "hrws_ghost_db", "e2e_fullscale_s", "numpy_gmti_fps",
    "numpy_gmti_s_raw", "numpy_warm_spread", "numpy_stable", "timing",
    "fft_impl", "device", "card", "total_elapsed_s", "sections",
)

_SECTIONS = ("gmti", "e2e_fullscale", "bp_frame", "bp_stream",
             "csa_formation", "hrws", "numpy_baseline")

# device metrics: a CPU run may never fill these with a number
_DEVICE_METRICS = ("value", "gmti_latency_ms", "csa_formation_fps",
                   "bp_frame_ms", "bp_stream_frame_ms", "sim_pass_s",
                   "hrws_recon_ms", "e2e_fullscale_s", "vs_baseline")


def _bench(**env_extra):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", BENCH_SIZE="256", BENCH_NCPI="1",
               BENCH_ITERS="1", BENCH_SKIP_E2E="1", BENCH_SKIP_BP="1",
               BENCH_SKIP_BP_STREAM="1", BENCH_NUMPY_PASSES="4",
               BENCH_NUMPY_COLD="1", **env_extra)
    return subprocess.run([sys.executable, os.path.join(_ROOT, "bench.py")],
                          env=env, capture_output=True, text=True,
                          timeout=900)


def test_bench_refuses_without_gpu():
    res = _bench()
    assert res.returncode != 0
    lines = [ln for ln in res.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["value"] is None and "no GPU" in d["error"]
    assert d["device"]["platform"] == "cpu"


@pytest.mark.skipif(os.environ.get("NIS_SAR_SKIP_BENCH_SMOKE") == "1",
                    reason="explicitly skipped")
def test_bench_cpu_smoke_contract():
    res = _bench(BENCH_SMOKE="1")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [ln for ln in res.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, ("stdout must be exactly ONE JSON line "
                             f"(got {len(lines)})")
    d = json.loads(lines[0])
    for k in _METRIC_KEYS:
        assert k in d, f"metric key {k!r} missing from the artifact"
    assert d["unit"] == "frames/sec"
    assert d["device"] == {"platform": "cpu", "kind": d["device"]["kind"],
                           "count": d["device"]["count"]}
    assert d["timing"].startswith("not measured")
    for k in _DEVICE_METRICS:
        assert d[k] is None, f"CPU smoke run reported {k}={d[k]!r}"
    # every section accounted for, with explicit statuses
    secs = d["sections"]
    for name in _SECTIONS:
        assert name in secs, f"section {name!r} missing"
        st = secs[name]["status"]
        assert st == "ok" or st.startswith(("skipped:", "error:")), st
        assert "elapsed_s" in secs[name]
    # env-skipped sections carry the reason
    assert secs["e2e_fullscale"]["status"] == "skipped: BENCH_SKIP_E2E=1"
    assert secs["bp_frame"]["status"] == "skipped: BENCH_SKIP_BP=1"
    # sections that ran name their path; the host-side NumPy reference is
    # a host measurement, not a device one
    for name in ("gmti", "csa_formation", "hrws"):
        assert secs[name]["status"] == "ok", secs[name]
        assert secs[name]["path"]
    assert d["hrws_ghost_db"] < -20.0
    assert secs["numpy_baseline"]["status"] == "ok"
    assert d["numpy_gmti_fps"] > 0
    assert isinstance(d["numpy_stable"], bool)
