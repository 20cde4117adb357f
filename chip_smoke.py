"""Smoke run of the SAR / GMTI / VideoSAR main path on the GPU.

    python chip_smoke.py                      # five phases on one GPU
    python chip_smoke.py --fullscale-oracle   # + the f64 oracle at 7,200 x 13,200
    python chip_smoke.py --four               # only the mesh phase, on 4 GPUs

Every phase drives the package's own entry points (models/gmti.py,
models/videosar.py, models/stripmap.py, models/hrws.py, the sharded steps)
at the sizes the reference toolkit defines (BASELINE.md, "Reference workload
definitions") and checks what comes out against the repo's plain
references: the f64 NumPy oracle (oracle/), direct backprojection
(ops/bp.py) and the single-device result of every sharded step.

Each phase prints one line: its status, the first call's extra seconds over
a warm call (compilation, mostly), the warm call's seconds, and the
device's peak bytes in use so far. The line before the last gives the
card's ``name, power.limit`` as nvidia-smi reports them; the last line is
one JSON object naming the device. A failing phase makes the exit code 1
and no JSON line is printed; a process without a GPU exits with 2 before
any phase runs. The script runs in one process; only the f64 oracle,
which never touches JAX, is spread over CPU worker processes.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The reference sizes, and a tiny set the CPU tests use for the same code.
FULL = dict(
    gmti_shape=None,                # config.ati_dpca(): 7,200 x 13,200
    gmti_clutter=5000,              # ocean_clutter_field points (+ the ship)
    # DPCA cancellation of the ship + ocean-clutter scene, in dB (20 log10
    # of mean|ch1| / mean|ch1 - ch2|): 45.1 dB in the CPU run of the
    # 1,800 x 3,328 cut, +-15 dB
    cancel_db=(30.0, 60.0),
    oracle_shape=(1800, 3328),      # tests/test_midscale_acceptance.py
    video_frames=4,
    video_small=False,
    stripmap_small=False,
    hrws_n=4096,
    four_csa_n=4096,
    four_gmti_n=4096,
    four_bp_small=False,
    four_hrws_n=4096,
)
TINY = dict(
    gmti_shape=(400, 1280),
    gmti_clutter=500,
    cancel_db=(20.0, 45.0),         # 32.6 dB in the CPU run
    oracle_shape=(128, 2048),
    video_frames=2,
    video_small=True,
    stripmap_small=True,
    hrws_n=256,
    four_csa_n=256,
    four_gmti_n=256,
    four_bp_small=True,
    four_hrws_n=256,
)

# fidelity budgets (BASELINE.md): focused intensity and ATI phase at strong
# pixels against the f64 oracle
BUDGET_DB = 0.1
BUDGET_RAD = 1e-3
# streaming (ring-buffered cached spectra) vs per-frame VideoSAR frames: the
# presum runs before the inverse FFT on one path and after it on the other,
# so the two agree to f32 rounding, far inside this bound
STREAM_TOL = 1e-3


# --------------------------------------------------------------------------
# f64 NumPy oracle on CPU worker processes (never imports JAX)
# --------------------------------------------------------------------------

def _oracle_echo(args):
    import oracle
    return oracle.echo_bistatic(*args)


def oracle_two_channel(pool, n_workers, ship, vel, traj, t0, opts, sc):
    """Both channels' f64 oracle SLCs (DPCA-shifted like the framework).
    The echo splits over pulse chunks on the worker pool; each channel's
    CSA focus then runs here, one at a time, so at most one full-size f64
    focus (about ten times its input in host memory) is alive at once."""
    import oracle

    from nis_sar_amtigmti_video_tpu.ops.echo import fast_time_grid

    grid = t0 + fast_time_grid(opts)
    n_p = len(traj.times)
    chunks = np.array_split(np.arange(n_p), max(1, n_workers // 2))
    futs = [[pool.submit(_oracle_echo, (
        ship.positions, ship.rcs, traj.positions[c], traj.velocities[c], grid,
        opts.fc_hz, opts.chirp_rate, opts.pulse_width_s, off, vel,
        traj.times[c])) for c in chunks] for off in sc.channels.rx_offsets()]
    g, r = sc.geometry, sc.radar
    slcs = []
    for ch, fs in enumerate(futs):
        raw = np.concatenate([f.result() for f in fs])
        raw = raw[1:] if ch == 0 else raw[:-1]
        slcs.append(oracle.focus_csa(
            raw, r.wavelength_m, r.chirp_rate, r.fs_hz, r.prf_hz,
            g.effective_velocity_mps, g.slant_range_m, t0)[0].T)
        del raw
    return slcs[0], slcs[1]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _twice(fn):
    """(result, first-call extra seconds, warm seconds) of ``fn``."""
    import jax
    t = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t
    t = time.perf_counter()
    out = jax.block_until_ready(fn())
    warm = time.perf_counter() - t
    return out, max(first - warm, 0.0), warm


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _fidelity(s1f, s2f, s1o, s2o):
    """(max |intensity dB|, max |ATI phase| rad) at strong oracle pixels."""
    strong = np.abs(s1o) > 0.05 * np.abs(s1o).max()
    ratio_db = 20 * np.log10(np.abs(s1f[strong]) / np.abs(s1o[strong]))
    dphi = np.angle(np.exp(1j * (np.angle(s1f * np.conj(s2f))[strong]
                                 - np.angle(s1o * np.conj(s2o))[strong])))
    return float(np.abs(ratio_db).max()), float(np.abs(dphi).max())


def gmti_scenario(backend, shape=None):
    """config.ati_dpca() on the given echo engine, optionally cut to
    ``shape`` = (pulses, samples) the way tests/test_midscale_acceptance.py
    cuts it (300 MHz / 2 us waveform)."""
    import dataclasses

    from nis_sar_amtigmti_video_tpu import config as cfg
    sc = cfg.ati_dpca()
    if shape is not None:
        sc = sc.replace(
            radar=dataclasses.replace(sc.radar, bandwidth_hz=300e6,
                                      pulse_width_s=2e-6),
            collect=dataclasses.replace(
                sc.collect, integration_time_s=shape[0] / sc.radar.prf_hz,
                window_length_s=shape[1] / sc.radar.fs_hz))
    if backend == "freq":
        # the NUFFT engine needs the uniform fast-time grid of the
        # 'centered' window (the CLI's --fast-sim switch)
        sc = sc.replace(collect=dataclasses.replace(
            sc.collect, echo_backend="freq", window_start_mode="centered"))
    return sc


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_gmti_fullscale(sz):
    """Ship + ocean clutter through models/gmti.run on the NUFFT echo
    engine, dual CSA and products: finite products, DPCA cancellation in
    band, CA-CFAR detects the mover."""
    import jax

    from nis_sar_amtigmti_video_tpu.models import gmti as gmti_model
    from nis_sar_amtigmti_video_tpu.scene import targets as T
    from nis_sar_amtigmti_video_tpu.scene.clutter import ocean_clutter_field

    sc = gmti_scenario("freq", sz["gmti_shape"])
    ship = T.destroyer()
    clutter = ocean_clutter_field(np.random.default_rng(0),
                                  num_points=sz["gmti_clutter"])
    vel = np.array([15.0, 0.0, 0.0])      # the CLI ati-dpca mover
    prod, first, warm = _twice(
        lambda: gmti_model.run(sc, ship, vel, clutter))
    n_p = sc.collect.num_pulses(sc.radar.prf_hz)
    n_s = sc.collect.num_samples(sc.radar.fs_hz)
    _check(prod.slc1.shape == (n_p - 1, n_s), f"slc shape {prod.slc1.shape}")
    for name in ("slc1", "slc2", "ati_phase", "dpca_mag", "velocity_map"):
        _check(bool(jax.numpy.isfinite(getattr(prod, name)).all()),
               f"non-finite {name}")
    cancel_db = 20 * math.log10(float(prod.cancellation_ratio))
    lo, hi = sz["cancel_db"]
    _check(lo <= cancel_db <= hi,
           f"DPCA cancellation {cancel_db:.2f} dB outside [{lo}, {hi}]")
    # the clutter cancels, the mover survives: the DPCA magnitude peak must
    # be a CA-CFAR detection carrying the mover's closing velocity (from
    # the geometry at mid-aperture) on the ATI velocity map
    det = np.asarray(prod.detections.detections)
    iy, ix = np.unravel_index(np.argmax(np.asarray(prod.dpca_mag)),
                              det.shape)
    _check(det[iy, ix], f"the DPCA peak at {(iy, ix)} is no CFAR detection")
    from nis_sar_amtigmti_video_tpu.geometry import orbit
    g = sc.geometry
    traj = orbit.make_trajectory(g, orbit.slow_time_grid(
        sc.collect.integration_time_s, n_p))
    los = traj.positions[n_p // 2]
    v_r = float(vel @ (los / np.linalg.norm(los)))
    v_det = float(np.asarray(prod.velocity_map)[iy, ix])
    _check(abs(v_det - v_r) < 0.25 * abs(v_r),
           f"the DPCA peak at {(iy, ix)} reads {v_det:.2f} m/s, "
           f"mover closes at {v_r:.2f} m/s")
    detail = (f"shape=({n_p - 1},{n_s}) targets={ship.num + clutter.num} "
              f"cancel={cancel_db:.2f}dB detections={int(det.sum())} "
              f"mover v_r={v_r:.2f} det_v={v_det:.2f}m/s")
    return first, warm, detail


def _gmti_framework(backend, shape):
    """The framework's two SLCs for the oracle scene (Destroyer moving at
    4 m/s along track), timed: (scenario, ship, vel, traj, t0, (s1, s2),
    first-call extra s, warm s)."""
    from nis_sar_amtigmti_video_tpu.models import gmti as gmti_model
    from nis_sar_amtigmti_video_tpu.scene import targets as T

    sc = gmti_scenario(backend, shape)
    ship = T.destroyer().rotate_z(90.0)
    vel = np.array([0.0, 4.0, 0.0])

    def collect_and_focus():
        raw2, traj, t0 = gmti_model.simulate_two_channel(sc, ship, vel)
        prod = gmti_model.focus_and_products(raw2, sc, t0, balance=False)
        return prod.slc1, prod.slc2, traj, t0

    (s1, s2, traj, t0), first, warm = _twice(collect_and_focus)
    return (sc, ship, vel, traj, t0, (np.asarray(s1), np.asarray(s2)),
            first, warm)


def phase_gmti_oracle(sz, shape="mid", workers=None):
    """Both echo engines (direct 'jnp' and NUFFT 'freq') through
    simulate_two_channel + focus_and_products against the f64 NumPy oracle
    at the mid-scale cut (``shape='mid'``) or the native full-scale collect
    (``shape=None``)."""
    from nis_sar_amtigmti_video_tpu.models.stripmap import echo_opts_for

    shape = sz["oracle_shape"] if shape == "mid" else shape
    n_workers = workers or min(8, os.cpu_count() or 1)
    firsts, warms, parts = 0.0, 0.0, []
    with ProcessPoolExecutor(n_workers,
                             mp_context=get_context("spawn")) as pool:
        for backend in ("jnp", "freq"):
            (sc, ship, vel, traj, t0, (s1f, s2f), first,
             warm) = _gmti_framework(backend, shape)
            s1o, s2o = oracle_two_channel(pool, n_workers, ship, vel, traj,
                                          t0, echo_opts_for(sc), sc)
            db, rad = _fidelity(s1f, s2f, s1o, s2o)
            _check(db < BUDGET_DB and rad < BUDGET_RAD,
                   f"{backend}: {db:.4f} dB / {rad:.2e} rad vs the f64 "
                   f"oracle (budgets {BUDGET_DB} dB / {BUDGET_RAD} rad)")
            firsts += first
            warms += warm
            parts.append(f"{backend}: {db:.4f}dB {rad:.2e}rad")
    return firsts, warms, f"shape={s1f.shape} " + " ".join(parts)


def videosar_scenario(small):
    import dataclasses

    from nis_sar_amtigmti_video_tpu import config as cfg
    sc = cfg.videosar()
    if small:
        # a physical small waveform (bandwidth < fs), PRF 1 kHz, 0.2 s CPIs
        # (1.5 km aperture: the 6 m pixels sample its ~5 m resolution)
        sc = sc.replace(
            radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                      pulse_width_s=2e-6, fs_hz=150e6,
                                      prf_hz=1000.0),
            collect=dataclasses.replace(sc.collect,
                                        window_length_s=2048 / 150e6),
            processing=dataclasses.replace(sc.processing, bp_grid=64,
                                           bp_scene_size_m=400.0),
            video=cfg.VideoConfig(duration_s=0.5, fps=10.0, cpi_s=0.2))
    return sc


def direct_bp_frame(sc, tgt, frame, heading_deg, speed_mps, u=8):
    """Frame ``frame`` of ``videosar.run`` re-formed by direct f64
    backprojection (ops/bp.py) over every pulse of its CPI, on u-times
    FFT-upsampled range data — the oracle of tests/test_bp_fast.py.
    Returns (image, the presum factor the model applies)."""
    import jax.numpy as jnp

    from nis_sar_amtigmti_video_tpu.geometry import orbit
    from nis_sar_amtigmti_video_tpu.models import videosar
    from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
    from nis_sar_amtigmti_video_tpu.ops.echo import (phase_history,
                                                     window_start_time)
    from nis_sar_amtigmti_video_tpu.video import scheduler

    r, g, v = sc.radar, sc.geometry, sc.video
    sched = scheduler.make_schedule(v, r.prf_hz)
    times = np.linspace(-v.duration_s / 2.0, v.duration_s / 2.0,
                        sched.total_pulses)
    traj = orbit.make_trajectory(g, times)
    i0 = int(sched.starts[frame])
    sl = traj.slice(i0, i0 + sched.cpi_pulses)
    phi = np.radians(heading_deg)
    vel = np.array([speed_mps * np.cos(phi), speed_mps * np.sin(phi), 0.0])
    opts = videosar.spotlight_echo_opts(
        sc, videosar.antenna_length_for_swath(sc,
                                              sc.processing.bp_scene_size_m))
    t0 = window_start_time(g.slant_range_m, opts, sc.collect.window_length_s,
                           "centered")
    raw = phase_history(sl, tgt.rotate_z(heading_deg), opts, t_start=t0,
                        target_velocity=vel)
    p = videosar.bp_params_for(sc, opts, "f64")
    presum = sc.processing.bp_presum or bp_ops.presum_factor(
        p, r.prf_hz, r.wavelength_m, g.slant_range_m,
        g.effective_velocity_mps)
    rc = bp_ops.bp_range_compress(raw, p)
    n_p, ns = rc.shape
    spec = jnp.fft.fft(rc, axis=-1)
    h = ns // 2
    spec_u = jnp.concatenate([spec[:, :h], jnp.zeros((n_p, ns * (u - 1)),
                                                      spec.dtype),
                              spec[:, -h:]], axis=1)
    spec_u = spec_u.at[:, h].multiply(0.5).at[:, -h].multiply(0.5)
    rc_u = jnp.fft.ifft(spec_u, axis=-1) * u
    del rc, spec, spec_u
    p_u = bp_ops.BpParams(fc_hz=p.fc_hz, chirp_rate=p.chirp_rate,
                          fs_hz=p.fs_hz * u, pulse_width_s=p.pulse_width_s,
                          num_samples=ns * u, nx=p.nx, ny=p.ny,
                          scene_size_m=p.scene_size_m, precision="f64")
    t0_u = jnp.float64(t0 + 0.5 * (u - 1) / (u * p.fs_hz))
    pos, ve, ts = (jnp.asarray(sl.positions), jnp.asarray(sl.velocities),
                   jnp.asarray(sl.times))
    vf = jnp.asarray(vel, jnp.float64)
    return np.asarray(bp_ops.backproject(rc_u, pos, ve, ts, vf, t0_u,
                                         p_u)), presum


def phase_videosar(sz):
    """config.videosar() frames through models/videosar.run (mBP, default
    fast BP backend), the same frames through the ring-buffered streaming
    path, and one frame against direct f64 backprojection."""
    from nis_sar_amtigmti_video_tpu.models import videosar
    from nis_sar_amtigmti_video_tpu.scene import targets as T

    sc = videosar_scenario(sz["video_small"])
    tgt = T.destroyer()
    kw = dict(heading_deg=30.0, speed_mps=15.0, algorithm="mbp",
              num_frames=sz["video_frames"])
    out, first, warm = _twice(lambda: videosar.run(sc, tgt, **kw))
    imgs = out.images
    _check(imgs.shape[0] == sz["video_frames"] and np.isfinite(imgs).all(),
           f"frames {imgs.shape} finite={np.isfinite(imgs).all()}")
    ring = videosar.run(sc, tgt, stream_spectra="ring", **kw).images
    stream_err = _rel(ring, imgs)
    _check(stream_err < STREAM_TOL,
           f"ring-streamed frames differ by {stream_err:.2e} "
           f"(bound {STREAM_TOL})")
    want, presum = direct_bp_frame(sc, tgt, 0, kw["heading_deg"],
                                   kw["speed_mps"])
    got = imgs[0]
    a_f, a_w = np.abs(got), np.abs(want)
    pk = np.unravel_index(a_w.argmax(), a_w.shape)
    peak_db = abs(20 * np.log10(a_f[pk] / a_w[pk]))
    peak_rad = abs(float(np.angle(got[pk] * np.conj(want[pk]))))
    field = float(np.abs(a_f - a_w).max() / a_w.max())
    # tests/test_bp_fast.py's presum budgets (presum adds its own validated
    # +0.03 dB / <1% field error on top of the plain 0.1 dB / 0.01 rad / 1%)
    lim = (0.15, 0.02, 0.015) if presum > 1 else (0.1, 0.01, 0.01)
    _check(peak_db < lim[0] and peak_rad < lim[1] and field < lim[2],
           f"frame 0 vs direct BP: {peak_db:.4f} dB, {peak_rad:.2e} rad, "
           f"field {field:.2e} (limits {lim})")
    detail = (f"frames={imgs.shape} stream_rel={stream_err:.2e} "
              f"direct_bp: {peak_db:.4f}dB {peak_rad:.2e}rad "
              f"field={field:.2e} presum={presum}")
    return first, warm, detail


def stripmap_scenario(small):
    import dataclasses

    from nis_sar_amtigmti_video_tpu import config as cfg
    sc = cfg.satellite_stripmap()
    if small:
        sc = sc.replace(
            radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                      pulse_width_s=2e-6, fs_hz=150e6),
            collect=dataclasses.replace(sc.collect,
                                        integration_time_s=256 / 6000.0,
                                        window_length_s=768 / 150e6))
    return sc


def hrws_case(n):
    """K=4 channels of an (n/4, n) sub-Nyquist collect whose one aliasing
    tone the reconstruction must move home: returns (channels, params,
    ghost frequency)."""
    import jax.numpy as jnp

    from nis_sar_amtigmti_video_tpu.models import hrws

    k_ch = 4
    p_az = n // k_ch
    prf, v = 6000.0, 7612.0
    ph = hrws.HrwsParams(num_channels=k_ch,
                         spacing_m=2.0 * v / (k_ch * prf), prf_hz=prf,
                         velocity_mps=v)
    t = np.arange(p_az) / prf
    df = prf / p_az
    tones = [(round(0.17 * p_az) * df, 1.0), (round(1.31 * p_az) * df, 1.0),
             (round(-1.62 * p_az) * df, 0.7)]
    ch = np.zeros((k_ch, p_az, 1), np.complex64)
    for k, x in enumerate(ph.rx_offsets()):
        tk = t + x / (2.0 * v)
        ch[k, :, 0] = sum(a * np.exp(2j * np.pi * f * tk) for f, a in tones)
    chans = jnp.broadcast_to(jnp.asarray(ch), (k_ch, p_az, n))
    return chans, ph, tones[1][0]


def ghost_db(rec_col, ph, f_ghost):
    """Alias-bin over true-bin level of the reconstructed spectrum, dB."""
    spec = np.abs(np.fft.fft(np.asarray(rec_col)))
    fr = np.fft.fftfreq(spec.shape[0], 1.0 / ph.effective_prf)
    b_alias = int(np.argmin(np.abs(fr - (f_ghost - ph.prf_hz))))
    b_true = int(np.argmin(np.abs(fr - f_ghost)))
    return 20 * math.log10(max(spec[b_alias] / spec[b_true], 1e-12))


def phase_stripmap_hrws(sz):
    """config.satellite_stripmap() through models/stripmap with RDA (the
    point target must focus at (R0, 0)), and one 4-channel HRWS
    reconstruction whose ghost must sit >= 20 dB down (tests/test_hrws.py's
    margin)."""
    import jax

    from nis_sar_amtigmti_video_tpu.constants import C
    from nis_sar_amtigmti_video_tpu.models import hrws, stripmap
    from nis_sar_amtigmti_video_tpu.ops.echo import window_start_time
    from nis_sar_amtigmti_video_tpu.scene import targets as T

    sc = stripmap_scenario(sz["stripmap_small"])
    prod, first, warm = _twice(
        lambda: stripmap.run(sc, T.point_target((0.0, 0.0, 0.0), 100.0)))
    img = np.abs(np.asarray(prod.image))
    ia, ir = np.unravel_index(img.argmax(), img.shape)
    # The RDA range axis puts R0 at the window's centre sample. The echo
    # model's 'leading' chirp convention (sar_satellite_sim.py:290-299)
    # centres each return Tp/2 after its delay, so a target at R0
    # compresses c*Tp/4 further out; dr is the offset from that position.
    opts = stripmap.echo_opts_for(sc)
    t_start = window_start_time(sc.geometry.slant_range_m, opts,
                                sc.collect.window_length_s,
                                sc.collect.window_start_mode)
    t_pk = 2.0 * sc.geometry.slant_range_m / C + opts.pulse_width_s / 2.0
    n_s = opts.num_samples
    want_r = ((t_pk - t_start) - (n_s // 2) / opts.fs_hz) * C / 2.0
    dr = float(prod.range_axis[ir] - want_r)
    dx = float(prod.cross_range[ia])
    dr_bin = float(prod.range_axis[1] - prod.range_axis[0])
    dx_bin = float(abs(prod.cross_range[1] - prod.cross_range[0]))
    _check(abs(dr) <= 3 * dr_bin and abs(dx) <= 3 * dx_bin,
           f"point target peaks at dR={dr:.3f} m, x={dx:.3f} m")
    _check(img.max() / img.mean() > 150.0,
           f"peak/mean {img.max() / img.mean():.1f} <= 150")
    del prod, img
    chans, ph, f_ghost = hrws_case(sz["hrws_n"])
    rec, h_first, h_warm = _twice(lambda: hrws.reconstruct(chans, ph))
    g_db = ghost_db(rec[:, 0], ph, f_ghost)
    _check(g_db <= -20.0, f"HRWS ghost at {g_db:.1f} dB (needs <= -20 dB)")
    _check(bool(jax.numpy.isfinite(rec).all()), "non-finite HRWS output")
    detail = (f"rda image={img_shape(sc)} peak dR={dr:.3f}m x={dx:.3f}m; "
              f"hrws rec={tuple(rec.shape)} ghost={g_db:.1f}dB "
              f"(first {h_first:.2f}s warm {h_warm:.4f}s)")
    return first + h_first, warm + h_warm, detail


def img_shape(sc):
    return (sc.collect.num_pulses(sc.radar.prf_hz),
            sc.collect.num_samples(sc.radar.fs_hz))


def phase_four(sz, devices):
    """The sharded paths on four devices, each against its one-device
    twin: corner-turned CSA over seq=4, the data-parallel two-channel GMTI
    step over 'data', the halo-exchange CFAR (one CPI over 'seq'),
    pulse-sharded fast BP at the VideoSAR reference scale, and the
    range-sharded HRWS reconstruction."""
    import jax
    import jax.numpy as jnp

    from nis_sar_amtigmti_video_tpu.models import distributed, hrws
    from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
    from nis_sar_amtigmti_video_tpu.parallel import corner_turn
    from nis_sar_amtigmti_video_tpu.parallel import mesh as mesh_mod

    devs = list(devices)[:4]
    _check(len(devs) == 4, f"needs 4 devices, got {len(devs)}")
    one = mesh_mod.make_mesh((1, 1, 1), devs[:1])
    parts, firsts, warms = [], 0.0, 0.0

    def csa_params(n_az, n_rg):
        from nis_sar_amtigmti_video_tpu import config as cfg
        sc = cfg.ati_dpca()
        g, r = sc.geometry, sc.radar
        return csa_ops.CsaParams(
            wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate,
            fs_hz=r.fs_hz, prf_hz=r.prf_hz,
            velocity_mps=g.effective_velocity_mps,
            range_ref_m=g.slant_range_m,
            t_start_fast=2.0 * g.slant_range_m / 299792458.0 - 11e-6,
            num_pulses=n_az, num_samples=n_rg)

    def rand_c(key, shape):
        k1, k2 = jax.random.split(jax.random.PRNGKey(key))
        return jax.lax.complex(jax.random.normal(k1, shape, jnp.float32),
                               jax.random.normal(k2, shape, jnp.float32))

    # 1. corner-turned CSA over seq=4
    n = sz["four_csa_n"]
    p = csa_params(n, n)
    phases = csa_ops.csa_phases(p)
    raw = rand_c(1, (n, n))
    seq4 = mesh_mod.make_mesh((1, 1, 4), devs)
    got, f1, w1 = _twice(lambda: corner_turn.csa_sharded(raw, phases, seq4))
    want = np.asarray(csa_ops.apply_csa(raw, phases))
    err = _rel(got, want)
    _check(err < 5e-4, f"csa_sharded seq=4 vs one device: {err:.2e}")
    parts.append(f"csa_sharded({n}^2) {err:.1e}")
    firsts, warms = firsts + f1, warms + w1
    del got, raw

    # 2./3. the two-channel GMTI step: frames over 'data' (4 CPIs, one per
    # device) and one CPI over 'seq' (the halo CFAR), each vs one device
    n = sz["four_gmti_n"]
    p = csa_params(n, n)
    for shape, frames, name in (((4, 1, 1), 4, "data"),
                                ((1, 1, 4), 1, "seq")):
        mesh = mesh_mod.make_mesh(shape, devs)
        raw = rand_c(2, (frames, 2, n, n))
        step = distributed.make_gmti_step(mesh, p, shift_pulses=0)
        got, f1, w1 = _twice(lambda: step(jax.device_put(
            raw, distributed.raw_sharding(mesh))))
        want = distributed.make_gmti_step(one, p, shift_pulses=0)(raw)
        errs = [_rel(a, b) for a, b in zip(
            (got.dpca_mag, got.cfar_snr), (want.dpca_mag, want.cfar_snr))]
        d_ph = float(np.abs(np.angle(np.exp(1j * (
            np.asarray(got.ati_phase) - np.asarray(want.ati_phase))))).max())
        c_err = abs(float(got.cancellation) / float(want.cancellation) - 1)
        _check(max(errs) < 1e-3 and d_ph < 1e-2 and c_err < 1e-4,
               f"gmti step over {name}: dpca {errs[0]:.1e} cfar "
               f"{errs[1]:.1e} phase {d_ph:.1e} cancel {c_err:.1e}")
        parts.append(f"gmti_step/{name}({frames}x2x{n}^2) "
                     f"{max(errs):.1e}")
        firsts, warms = firsts + f1, warms + w1
        del got, want, raw

    # 4. pulse-sharded fast BP at the VideoSAR reference scale
    err, f1, w1, shape = _four_bp(sz, devs)
    _check(err < 2e-4, f"bp_fast_sharded vs one device: {err:.2e}")
    parts.append(f"bp_fast_sharded{shape} {err:.1e}")
    firsts, warms = firsts + f1, warms + w1

    # 5. range-sharded HRWS reconstruction
    chans, ph, _ = hrws_case(sz["four_hrws_n"])
    got, f1, w1 = _twice(lambda: hrws.reconstruct_sharded(chans, ph, seq4))
    err = _rel(got, hrws.reconstruct(chans, ph))
    _check(err < 1e-4, f"hrws.reconstruct_sharded vs one device: {err:.2e}")
    parts.append(f"hrws_sharded({tuple(chans.shape)}) {err:.1e}")
    firsts, warms = firsts + f1, warms + w1
    return firsts, warms, "; ".join(parts)


def _four_bp(sz, devs):
    import jax.numpy as jnp

    from nis_sar_amtigmti_video_tpu.geometry import orbit
    from nis_sar_amtigmti_video_tpu.models import videosar
    from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
    from nis_sar_amtigmti_video_tpu.ops import bp_fast
    from nis_sar_amtigmti_video_tpu.ops.echo import (phase_history,
                                                     window_start_time)
    from nis_sar_amtigmti_video_tpu.parallel import corner_turn
    from nis_sar_amtigmti_video_tpu.parallel import mesh as mesh_mod
    from nis_sar_amtigmti_video_tpu.scene import targets as T

    sc = videosar_scenario(sz["four_bp_small"])
    r, g = sc.radar, sc.geometry
    n_p = sc.video.cpi_pulses(r.prf_hz)
    opts = videosar.spotlight_echo_opts(
        sc, videosar.antenna_length_for_swath(sc,
                                              sc.processing.bp_scene_size_m))
    t0 = window_start_time(g.slant_range_m, opts, sc.collect.window_length_s,
                           "centered")
    p = videosar.bp_params_for(sc, opts)
    d = bp_ops.presum_factor(p, r.prf_hz, r.wavelength_m, g.slant_range_m,
                             g.effective_velocity_mps)
    n_p -= n_p % (4 * d)                 # whole presum groups per shard
    traj = orbit.make_trajectory(g, np.linspace(-n_p / r.prf_hz / 2,
                                                n_p / r.prf_hz / 2, n_p))
    vel = np.array([15.0, 0.0, 0.0])
    raw = phase_history(traj, T.destroyer(), opts, t_start=t0,
                        target_velocity=vel)
    plan = bp_fast.make_plan(p, traj.positions, traj.times, float(t0),
                             factorize=True)
    acc = bp_fast.pick_accumulate(plan)
    pos, ve, ts = (jnp.asarray(traj.positions), jnp.asarray(traj.velocities),
                   jnp.asarray(traj.times))
    vf = jnp.asarray(vel, jnp.float64)
    seq4 = mesh_mod.make_mesh((1, 1, 4), devs)
    got, f1, w1 = _twice(lambda: corner_turn.bp_fast_sharded(
        raw, pos, ve, ts, vf, jnp.float64(t0), p, plan, seq4, presum=d,
        accumulate=acc, fit_stride=16))
    want = bp_fast.backproject_fast(raw, pos, ve, ts, vf, p, plan, presum=d,
                                    compress=True, accumulate=acc,
                                    fit_stride=16)
    # per-shard sub-aperture anchors move only the band-limited merge's
    # interpolation error (tests/test_parallel.py's factor bound is 2e-3)
    return _rel(got, want), f1, w1, (n_p, opts.num_samples, acc, d)


PHASES = (("gmti_fullscale", phase_gmti_fullscale),
          ("gmti_oracle", phase_gmti_oracle),
          ("videosar", phase_videosar),
          ("stripmap_hrws", phase_stripmap_hrws))


def run_phase(name, fn, *args):
    """Run one phase and print its line; True when it passed."""
    t = time.perf_counter()
    try:
        first, warm, detail = fn(*args)
    except Exception as e:  # noqa: BLE001 — reported, and fails the run
        traceback.print_exc()
        print(f"[phase] {name}: FAILED after {time.perf_counter() - t:.1f}s"
              f": {type(e).__name__}: {e}", flush=True)
        return False
    print(f"[phase] {name}: ok compile_s={first:.2f} warm_s={warm:.4f} "
          f"peak_bytes={_peak_bytes()} wall_s={time.perf_counter() - t:.1f}"
          f" | {detail}", flush=True)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four", action="store_true",
                      help="run only the mesh phase, on 4 GPUs")
    mode.add_argument("--fullscale-oracle", action="store_true",
                      help="also compare both echo engines with the f64 "
                           "oracle at 7,200 x 13,200")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        import jax

        import nis_sar_amtigmti_video_tpu as nst
        from nis_sar_amtigmti_video_tpu.utils import runtime
    except ImportError as e:
        print(f"chip_smoke: cannot import the package ({e}); run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2

    cache = runtime.enable_compile_cache()
    devs = jax.devices()
    dev = runtime.device_record()
    need = 4 if args.four else 1
    if dev["platform"] != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX finds {len(devs)} "
              f"{dev['platform']} device(s)", file=sys.stderr)
        return 2
    print(f"[phase] device: ok jax={jax.__version__} devices={devs} "
          f"kind={dev['kind']} x64={jax.config.jax_enable_x64} "
          f"package={nst.__version__} compile_cache={cache}", flush=True)
    card = runtime.card_info()
    print(f"[device] nvidia-smi: {card}", flush=True)

    if args.four:
        ok = run_phase("four", phase_four, FULL, devs)
    else:
        ok = True
        for name, fn in PHASES:
            ok = run_phase(name, fn, FULL) and ok
        if args.fullscale_oracle:
            ok = run_phase("gmti_oracle_fullscale", phase_gmti_oracle, FULL,
                           None) and ok
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(card)
    dev["count"] = len(devs) if args.four else 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
