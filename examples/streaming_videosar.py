"""Streaming VideoSAR: per-pulse forward-spectrum caching across the
80%-overlapped CPIs, end to end at reduced scale.

The VideoSAR product (sar_batch_sim.py:244-306) re-forms a 2,500-pulse CPI
every 500 pulses, so each received pulse contributes to ~5 frames. The
streaming path (models/videosar.py run(stream_spectra=True)) computes every
pulse's matched-filtered forward FFT ONCE per collect
(ops/bp_fast.py::forward_spectra) and forms each frame from the cached
spectra — only the recentre ramp, presum, inverse transform and the
backprojection accumulate run per frame. Noise is drawn per pulse
segment (the physical sensor semantics), which is what makes the cache
valid across overlapping frames.

This demo forms the same collect both ways and saves the per-frame images
plus their difference (expected at f32 rounding: the presum runs before
the inverse FFT on one path and after it on the other):

Run: python examples/streaming_videosar.py [--outdir .]
(JAX uses its default platform; JAX_PLATFORMS=cpu pins the CPU.)
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from nis_sar_amtigmti_video_tpu import config as cfg
from nis_sar_amtigmti_video_tpu.models import videosar
from nis_sar_amtigmti_video_tpu.scene import targets as T


def reduced_scenario():
    """Reference-geometry VideoSAR scaled so the demo runs on CPU in ~2 min
    while keeping the FFT length inside the streaming kernel's range
    (nfft >= 16384)."""
    sc = cfg.videosar()
    return sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6,
                                  prf_hz=1000.0),
        collect=dataclasses.replace(sc.collect,
                                    window_length_s=9000 / 150e6),
        processing=dataclasses.replace(sc.processing, bp_grid=32,
                                       bp_scene_size_m=400.0),
        video=cfg.VideoConfig(duration_s=1.0, fps=5.0, cpi_s=0.4),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=".")
    args = ap.parse_args()

    sc = reduced_scenario()
    tgt = T.point_target((0.0, 0.0, 0.0), 50.0)
    key = jax.random.PRNGKey(7)
    common = dict(heading_deg=90.0, speed_mps=30.0, algorithm="mbp",
                  frames_per_batch=2, key=key, noise_mode="per_segment",
                  bp_backend="fast_factor")

    t0 = time.perf_counter()
    per_frame = videosar.run(sc, tgt, **common)
    t_frame = time.perf_counter() - t0

    t0 = time.perf_counter()
    stream = videosar.run(sc, tgt, stream_spectra=True, **common)
    t_stream = time.perf_counter() - t0

    diff = np.abs(stream.images - per_frame.images).max()
    scale = np.abs(per_frame.images).max()
    n = per_frame.images.shape[0]
    print(f"{n} frames | per-frame path {t_frame:.1f} s | "
          f"streaming path {t_stream:.1f} s | "
          f"max image delta {diff / scale:.2e} (f32 rounding class)")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(2, n, figsize=(3 * n, 6.2))
        for f in range(n):
            for row, (ims, name) in enumerate(
                    ((per_frame.images, "per-frame"),
                     (stream.images, "streaming"))):
                a = 20 * np.log10(np.abs(ims[f]) + 1e-12)
                axes[row, f].imshow(a, vmin=a.max() - 40, vmax=a.max(),
                                    cmap="gray")
                axes[row, f].set_title(f"{name} f{f}", fontsize=9)
                axes[row, f].axis("off")
        fig.suptitle("Streaming VideoSAR: cached forward spectra vs the "
                     "per-frame path")
        out = os.path.join(args.outdir, "streaming_videosar.png")
        fig.savefig(out, dpi=110, bbox_inches="tight")
        print(f"wrote {out}")
    except Exception as e:  # matplotlib optional in minimal envs
        print(f"(no figure: {type(e).__name__})")


if __name__ == "__main__":
    main()
