"""Headless rendering of SAR products — viewer parity without an event loop.

The reference ships four interactive matplotlib viewers
(sar_interactive_viewer.py, sar_satellite_viewer.py,
sar_satellite_moving_viewer.py, sar_ati_dcpa_viewer_csa.py). Their
*computational* behaviors — dB/linear/phase display, zoom-adaptive
percentile color limits, magnitude-masked phase, zoom statistics with the
cancellation ratio — are implemented here as pure functions; the figure
builders consume them headlessly (Agg) so products render on any pod.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


def to_db(mag: np.ndarray, floor: float = 1e-12) -> np.ndarray:
    return 20.0 * np.log10(np.abs(mag) + floor)


def percentile_clim(data: np.ndarray, lo: float = 1.0, hi: float = 99.0
                    ) -> Tuple[float, float]:
    """Zoom-adaptive color limits from visible-percentiles
    (sar_interactive_viewer.py:190-219)."""
    return float(np.percentile(data, lo)), float(np.percentile(data, hi))


def region_stats(mag: np.ndarray, dpca_mag: Optional[np.ndarray] = None
                 ) -> dict:
    """The viewer's printed zoom statistics (sar_ati_dcpa_viewer_csa.py:79-154):
    mean/peak/std in dB, plus DPCA cancellation ratio when provided."""
    a = np.abs(mag)
    out = {
        "mean_db": float(20 * np.log10(a.mean() + 1e-300)),
        "peak_db": float(20 * np.log10(a.max() + 1e-300)),
        "std_db": float(20 * np.log10(a.std() + 1e-300)),
        "pixels": int(a.size),
    }
    if dpca_mag is not None:
        d = np.abs(dpca_mag)
        ratio = a.mean() / (d.mean() + 1e-300)
        out["cancellation_ratio"] = float(ratio)
        out["cancellation_db"] = float(20 * np.log10(ratio))
    return out


def masked_phase_display(slc1: np.ndarray, slc2: np.ndarray,
                         threshold: float = 0.05) -> np.ndarray:
    """ATI phase masked on channel-1 magnitude (sar_ati_dcpa_sim_csa.py:447-449)."""
    phase = np.angle(slc1 * np.conj(slc2))
    mask = np.abs(slc1) > threshold * np.abs(slc1).max()
    return np.where(mask, phase, 0.0)


# ---------------------------------------------------------------------------
# figure builders (Agg backend; import matplotlib lazily)
# ---------------------------------------------------------------------------

def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_image(path: str, data: np.ndarray, *, title: str = "",
               extent: Optional[Sequence[float]] = None, db: bool = True,
               dynamic_range_db: float = 40.0, cmap: str = "gray",
               is_phase: bool = False, xlabel: str = "Range (m)",
               ylabel: str = "Cross-Range (m)"):
    """One product image, reference-style: dB with a top-percentile ceiling
    and fixed dynamic range (sar_ati_dcpa_sim_csa.py:424-443), or hsv phase."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 8))
    if is_phase:
        im = ax.imshow(data, aspect="auto", origin="lower", extent=extent,
                       cmap="hsv", vmin=-math.pi, vmax=math.pi)
        fig.colorbar(im, ax=ax, label="Phase (rad)")
    elif db:
        d = to_db(data)
        vmax = float(np.percentile(d, 99.9))
        im = ax.imshow(d, aspect="auto", origin="lower", extent=extent,
                       cmap=cmap, vmin=vmax - dynamic_range_db, vmax=vmax)
        fig.colorbar(im, ax=ax, label="Magnitude (dB)")
    else:
        im = ax.imshow(np.abs(data), aspect="auto", origin="lower",
                       extent=extent, cmap=cmap)
        fig.colorbar(im, ax=ax, label="Magnitude (linear)")
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def save_pipeline_steps(path: str, prod, sc=None):
    """The step-browser as a contact sheet: raw -> range-comp -> RD map ->
    RCMC -> image (sar_interactive_viewer.py's six steps on one canvas)."""
    plt = _plt()
    inter = prod.intermediates
    steps = [("Raw phase history", prod.raw)]
    if inter is not None:
        steps += [("Range compressed", inter.compressed),
                  ("Range-Doppler", inter.rd_map),
                  ("RCMC corrected", inter.rd_rcmc)]
    steps += [("Focused image", prod.image)]
    n = len(steps)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 5))
    if n == 1:
        axes = [axes]
    for ax, (title, data) in zip(axes, steps):
        d = to_db(np.abs(prod_mag(data)))
        vmin, vmax = percentile_clim(d)
        ax.imshow(d, aspect="auto", origin="lower", cmap="viridis",
                  vmin=vmin, vmax=vmax)
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def save_gmti_panel(path: str, prod):
    """The ATI/DPCA viewer's seven products as one panel."""
    plt = _plt()
    s1 = np.abs(np.asarray(prod_mag(prod.slc1)))
    s2 = np.abs(np.asarray(prod_mag(prod.slc2)))
    panels = [
        ("Ch1 magnitude (dB)", to_db(s1), "bone", None),
        ("Ch2 magnitude (dB)", to_db(s2), "bone", None),
        ("DPCA |diff| (dB)", to_db(np.asarray(prod_mag(prod.dpca_mag))),
         "magma", None),
        ("ATI phase", np.asarray(prod_mag(prod.ati_phase)), "hsv",
         (-math.pi, math.pi)),
        ("Velocity map (m/s)", np.asarray(prod_mag(prod.velocity_map)),
         "coolwarm", None),
        ("CFAR SNR", np.asarray(prod_mag(prod.detections.snr)), "inferno",
         None),
    ]
    fig, axes = plt.subplots(2, 3, figsize=(16, 9))
    for ax, (title, data, cmap, vlim) in zip(axes.ravel(), panels):
        kw = {}
        if vlim:
            kw = {"vmin": vlim[0], "vmax": vlim[1]}
        elif data.dtype.kind == "f" and "dB" in title:
            vmax = float(np.percentile(data, 99.9))
            kw = {"vmin": vmax - 40, "vmax": vmax}
        ax.imshow(data, aspect="auto", origin="lower", cmap=cmap, **kw)
        ax.set_title(title)
    fig.suptitle(f"GMTI products — cancellation "
                 f"{20*np.log10(float(np.asarray(prod_mag(prod.cancellation_ratio)))+1e-30):.1f} dB, "
                 f"v_amb {prod.v_amb:.1f} m/s")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def prod_mag(x):
    """Device-or-host array to host (complex-safe)."""
    from nis_sar_amtigmti_video_tpu.utils import cplx
    return cplx.to_host(x)


def save_gif(path: str, frames: np.ndarray, fps: float = 10.0,
             normalize: str = "global"):
    """VideoSAR GIF assembly (sar_batch_sim.py:333-355): global max
    normalization across frames, grayscale."""
    from PIL import Image
    mags = np.abs(prod_mag(frames))
    gmax = mags.max() if normalize == "global" else None
    imgs = []
    for f in mags:
        m = f / (gmax if gmax else (f.max() + 1e-30))
        imgs.append(Image.fromarray((np.clip(m, 0, 1) * 255).astype(np.uint8)))
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path


def save_targets_preview(path: str, vehicles: Optional[dict] = None):
    """3D scatter preview of the vehicle models with RCS-sized markers —
    behavior of view_targets.py:5-75."""
    plt = _plt()
    from nis_sar_amtigmti_video_tpu.scene.targets import VEHICLES
    vehicles = vehicles or VEHICLES
    n = len(vehicles)
    fig = plt.figure(figsize=(5 * n, 5))
    for i, (name, gen) in enumerate(vehicles.items()):
        t = gen()
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        s = 10 + 200 * t.rcs / t.rcs.max()
        ax.scatter(t.positions[:, 0], t.positions[:, 1], t.positions[:, 2],
                   s=s, c=t.rcs, cmap="plasma")
        ax.set_title(f"{name} ({t.num} pts, {t.total_rcs:.0f} m$^2$)")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def save_moving_scenarios(path: str, directory: str, zoom=None):
    """Headless comparative sheet over the moving-scenario npz set: all
    available scenarios side by side with ONE shared zoom/extent (the
    reference's shared-zoom interaction, sar_satellite_moving_viewer.py:
    144-171, rendered non-interactively). ``zoom`` = ((x0,x1),(y0,y1)) in
    world meters, default full extent. Returns the path."""
    from nis_sar_amtigmti_video_tpu.viz.interactive import (
        MovingScenarioViewer)

    scen = MovingScenarioViewer.scenario_paths(directory)
    if not scen:
        raise ValueError(f"no moving-scenario npz files in {directory}")
    plt = _plt()
    n = len(scen)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4.4), squeeze=False)
    for ax, (label, p) in zip(axes[0], scen):
        z = np.load(p)
        img = to_db(np.abs(np.asarray(z["final_image"])))
        ra, cr = np.asarray(z["range_axis"]), np.asarray(z["cross_range"])
        ext = [ra[0], ra[-1], cr[0], cr[-1]]
        im = ax.imshow(img, aspect="auto", origin="lower", cmap="viridis",
                       extent=ext, vmin=np.percentile(img, 1),
                       vmax=np.percentile(img, 99))
        if zoom is not None:
            ax.set_xlim(*zoom[0])
            ax.set_ylim(*zoom[1])
        ax.set_title(f"{label}\n{float(z['ship_speed']):.0f} m/s @ "
                     f"{float(z['ship_heading']):.0f} deg", fontsize=9)
        ax.set_xlabel("Range (m)")
    axes[0][0].set_ylabel("Cross range (m)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
