"""VideoSAR pipeline: overlapped-CPI frame formation over a spotlight collect.

End-to-end re-design of the reference batch runner (sar_batch_sim.py:240-361,
SURVEY.md §3.3): a 5 s collect at PRF 5 kHz becomes 50 half-second CPIs at
10 fps (80% overlap), each focused by moving-grid backprojection (mBP),
standard BP, or CSA.

Design: each pulse of the collect is simulated exactly once — the stream
is synthesized in step-sized segments that a rolling cache assembles into the
80%-overlapped CPIs (5 overlapping frames share every segment; re-simulating
per frame would multiply the dominant echo cost ~5x). Formation is vmapped
over the leading frame axis — which XLA shards over the mesh 'data' axis
(see parallel/). Frames are processed in bounded-size batches so HBM never
holds the full overlapped stack; each batch is a self-contained re-driveable
unit (failure recovery = re-run the batch).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nis_sar_amtigmti_video_tpu.config import ScenarioConfig
from nis_sar_amtigmti_video_tpu.geometry import orbit
from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
from nis_sar_amtigmti_video_tpu.ops import bp_fast
from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu.ops import noise as noise_ops
from nis_sar_amtigmti_video_tpu.ops.echo import (EchoOpts, phase_history,
                                                 window_start_time)
from nis_sar_amtigmti_video_tpu.scene.targets import PointTargets
from nis_sar_amtigmti_video_tpu.parallel import pipeline
from nis_sar_amtigmti_video_tpu.video import scheduler
from nis_sar_amtigmti_video_tpu.utils import cplx


# fast-BP backend name -> ops/bp_fast.py accumulate
_FAST_ACC = {"fast": "xla", "fast_factor": "factor", "fast_factor2": "factor2"}
BP_BACKENDS = ("exact",) + tuple(_FAST_ACC)


class VideoFrames(NamedTuple):
    images: np.ndarray        # (F, ny, nx) complex on host
    schedule: scheduler.FrameSchedule
    scene_size_m: float


def spotlight_echo_opts(sc: ScenarioConfig, l_ant_m: float) -> EchoOpts:
    r, c = sc.radar, sc.collect
    return EchoOpts(
        fc_hz=r.fc_hz, chirp_rate=r.chirp_rate, pulse_width_s=r.pulse_width_s,
        fs_hz=r.fs_hz, num_samples=c.num_samples(r.fs_hz, even=True),
        endpoint_grid=False, chirp_centering="centered", amplitude="rcs",
        stop_and_go=True, antenna_length_m=l_ant_m,
        backend=c.echo_backend, freq_oversample=c.echo_oversample)


def antenna_length_for_swath(sc: ScenarioConfig, swath_m: float) -> float:
    """L_ant = lambda * R0 / swath (sar_batch_sim.py:291)."""
    return sc.radar.wavelength_m * sc.geometry.slant_range_m / swath_m


def bp_params_for(sc: ScenarioConfig, opts: EchoOpts,
                  precision: str = "f32") -> bp_ops.BpParams:
    pr = sc.processing
    return bp_ops.BpParams(
        fc_hz=sc.radar.fc_hz, chirp_rate=sc.radar.chirp_rate,
        fs_hz=sc.radar.fs_hz, pulse_width_s=sc.radar.pulse_width_s,
        num_samples=opts.num_samples, nx=pr.bp_grid, ny=pr.bp_grid,
        scene_size_m=pr.bp_scene_size_m, precision=precision)


@partial(jax.jit, static_argnames=("p", "presum", "backend", "plan"))
def form_frames_bp(raw_frames, pos_frames, vel_frames, t_frames, vel_focus,
                   t_start, p: bp_ops.BpParams, presum: int = 1,
                   backend: str = "exact", plan=None, spectra_frames=None):
    """Vmapped mBP/StdBP formation: (F, cpi, Ns) -> (F, ny, nx) complex64.
    The leading F axis is the data-parallel (shardable) axis. ``presum > 1``
    decimates slow time first (bp_ops.presum_recenter) — choose it with
    bp_ops.presum_factor; it cuts per-frame BP cost ~presum-fold.

    backend: 'exact' keeps the reference-semantics per-pixel path
    (ops/bp.py); 'fast' uses the gather-free iso-range kernel
    (ops/bp_fast.py, one shared static ``plan`` for every CPI — build it
    with bp_fast.make_plan over the whole collect's trajectory; the range
    matched filter fuses into its recentre FFT, so raw pulses go in).
    The 'fast_factor*' variants select the factorized (sub-aperture)
    accumulate — 'fast_factor' (single level) and 'fast_factor2'
    (two-level, where plan.sub_raw1 > 0) — the production paths (the plan
    must be built with factorize=True).

    ``spectra_frames`` (F, cpi, nfft): per-frame slices of cached
    forward spectra (bp_fast.forward_spectra) — the streaming path for
    overlapped CPIs; ``raw_frames`` is then ignored (pass None) and only
    the recentre ramp/presum/inverse run per frame."""
    if backend not in BP_BACKENDS:
        raise ValueError(f"unknown BP backend {backend!r}; options: "
                         f"{', '.join(BP_BACKENDS)}")
    acc = _FAST_ACC.get(backend)
    fast = acc is not None
    if spectra_frames is not None and not fast:
        raise ValueError("spectra_frames needs a fast-BP backend")
    rc = raw_frames if fast else bp_ops.bp_range_compress(raw_frames, p)

    def one(r_, po, ve, ts, sp=None):
        if fast:
            img = bp_fast.backproject_fast(
                r_, po, ve, ts, vel_focus, p, plan, presum=presum,
                compress=True, accumulate=acc,
                fit_stride=16 if acc.startswith("factor") else 0,
                raw_spectra=sp)
            if presum > 1:
                corr = bp_ops.presum_droop_correction(po, ve, ts, vel_focus,
                                                      p, presum)
                return presum * corr * img
            return img
        if presum > 1:
            corr = bp_ops.presum_droop_correction(po, ve, ts, vel_focus, p,
                                                  presum)
            r_, po, ve, ts = bp_ops.presum_recenter(
                r_, po, ve, ts, vel_focus, t_start, p, presum)
            return presum * corr * bp_ops.backproject(r_, po, ve, ts,
                                                      vel_focus, t_start, p)
        return bp_ops.backproject(r_, po, ve, ts, vel_focus, t_start, p)

    if spectra_frames is not None:
        return jax.vmap(lambda sp, po, ve, ts: one(None, po, ve, ts, sp))(
            spectra_frames, pos_frames, vel_frames, t_frames)
    return jax.vmap(one)(rc, pos_frames, vel_frames, t_frames)


def form_frames_csa(raw_frames, p: csa_ops.CsaParams, fused: bool = True,
                    fft_impl: str = "xla"):
    """Vmapped CSA formation: (F, cpi, Ns) -> (F, cpi, Ns) SLC frames. The
    phase factors do not depend on the frame axis, so XLA hoists them."""
    if fused:
        return csa_ops.apply_csa_fused(raw_frames, csa_ops.csa_factors(p),
                                       fft_impl)
    return csa_ops.apply_csa(raw_frames, csa_ops.csa_phases(p), fft_impl)


def simulate_cpi(sc: ScenarioConfig, targets: PointTargets, traj_slice,
                 opts: EchoOpts, t0: float, target_velocity, key=None,
                 snr_db_raw: float | None = None):
    """One CPI of spotlight echo (+K-noise at peak-referenced SNR)."""
    raw = phase_history(traj_slice, targets, opts, t_start=t0,
                        target_velocity=target_velocity)
    if key is not None and snr_db_raw is not None:
        raw = noise_ops.add_ocean_noise(key, raw, snr_db_raw,
                                        sc.noise.scr_db, sc.noise.k_shape,
                                        ref_power_mode="peak")
    return raw


def run(sc: ScenarioConfig, targets: PointTargets, *, heading_deg: float = 0.0,
        speed_mps: float = 0.0, algorithm: str = "mbp",
        frames_per_batch: int = 4, key=None,
        avg_rcs: float | None = None, num_frames: int | None = None,
        frame_indices=None, precision: str = "f32",
        bp_backend: str = "fast", noise_mode: str = "per_frame",
        stream_spectra: bool | str = False) -> VideoFrames:
    """Full VideoSAR product: schedule -> per-frame sim -> batched formation.

    algorithm: 'mbp' (focus on target velocity), 'stdbp' (zero focus
    velocity) — the reference's algo matrix (sar_batch_sim.py:276-279) —
    or 'csa'. ``frame_indices`` selects a subset of schedule frames (the
    recovery path: see :func:`resume`); determinism holds because noise keys
    fold the *schedule* frame index, not the batch position.

    bp_backend: 'fast' (default — gather-free iso-range BP, ops/bp_fast.py),
    'fast_factor' (factorized sub-aperture accumulation: resolves to the
    accumulate the plan supports best, bp_fast.pick_accumulate), or
    'exact' (reference-semantics per-pixel path, ops/bp.py). Unsupported
    plan shapes fall back toward 'fast'.

    noise_mode: 'per_frame' draws fresh noise on each assembled CPI — the
    reference semantics (shared pulses get DIFFERENT noise in overlapping
    frames: sar_batch_sim.py re-simulates every CPI). 'per_segment' draws
    noise once per step-sized pulse segment — the physical sensor
    semantics (each received pulse is noisy once) and the prerequisite
    for ``stream_spectra``. SNR referencing is then per segment.

    stream_spectra: cache each pulse's matched-filtered forward FFT
    (bp_fast.forward_spectra) across the 80%-overlapped frames, so the
    frame-independent half of the fast-BP recentre runs once per pulse
    per collect instead of once per frame. Needs a fast BP backend and
    noise_mode='per_segment'. ``'ring'`` additionally keeps the
    cached-spectra window as a device-resident RING buffer advanced by one
    dynamic_update_slice per frame (a step's spectra written per frame at
    reference scale) instead of re-concatenating the whole window every
    frame — the sequential streaming product path (frames form one at a
    time, so ``frames_per_batch`` is ignored). Needs contiguous schedule
    frames and step % presum == 0.
    """
    r, g, v = sc.radar, sc.geometry, sc.video
    sched = scheduler.make_schedule(v, r.prf_hz)
    orig_idx = np.arange(sched.num_frames)
    if num_frames is not None:
        sched = sched._replace(starts=sched.starts[:num_frames])
        orig_idx = orig_idx[:num_frames]
    if frame_indices is not None:
        frame_indices = sorted(int(i) for i in frame_indices)
        sched = sched._replace(starts=sched.starts[frame_indices])
        orig_idx = np.asarray(frame_indices)

    times = np.linspace(-v.duration_s / 2.0, v.duration_s / 2.0,
                        sched.total_pulses)
    traj = orbit.make_trajectory(g, times)

    phi = np.radians(heading_deg)
    tgt = targets.rotate_z(heading_deg)
    vel_tgt = np.array([speed_mps * np.cos(phi), speed_mps * np.sin(phi), 0.0])

    swath = sc.processing.bp_scene_size_m
    l_ant = antenna_length_for_swath(sc, swath)
    opts = spotlight_echo_opts(sc, l_ant)
    t0 = window_start_time(g.slant_range_m, opts, sc.collect.window_length_s,
                           "centered")

    snr_raw = None
    if key is not None:
        rcs = avg_rcs if avg_rcs is not None else 5000.0
        snr_raw, _ = noise_ops.snr_db(sc.noise, g.slant_range_m, rcs,
                                      r.wavelength_m, r.bandwidth_hz, None)

    vel_focus = vel_tgt if algorithm == "mbp" else np.zeros(3)
    p_bp = bp_params_for(sc, opts, precision)
    presum = sc.processing.bp_presum or bp_ops.presum_factor(
        p_bp, r.prf_hz, r.wavelength_m, g.slant_range_m,
        g.effective_velocity_mps)
    if bp_backend not in BP_BACKENDS:
        raise ValueError(f"unknown BP backend {bp_backend!r}; options: "
                         f"{', '.join(BP_BACKENDS)}")
    bp_plan = None
    if algorithm in ("mbp", "stdbp") and bp_backend.startswith("fast"):
        # one static plan for the whole collect (per-CPI geometry is traced)
        factor = bp_backend.startswith("fast_factor")
        bp_plan = bp_fast.make_plan(p_bp, traj.positions, traj.times,
                                    float(t0), factorize=factor)
        if factor:
            bp_backend = {acc: name for name, acc in _FAST_ACC.items()}[
                bp_fast.pick_accumulate(bp_plan)]

    # Overlapped CPIs share pulses: synthesize the stream once, in step-sized
    # segments, and assemble each frame from its cached segments (the default
    # 80% overlap would otherwise re-simulate every pulse ~5x). Noise is
    # still drawn per frame on the assembled CPI, matching the reference.
    step = sched.step_pulses
    use_segments = (sched.num_frames > 1 and sched.cpi_pulses % step == 0
                    and all(int(s) % step == 0 for s in sched.starts))
    segs_per_cpi = sched.cpi_pulses // step if use_segments else 0
    seg_cache = {}
    spec_cache = {}

    if noise_mode not in ("per_frame", "per_segment"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if stream_spectra:
        if algorithm not in ("mbp", "stdbp") \
                or not bp_backend.startswith("fast"):
            raise ValueError("stream_spectra needs a fast-BP backend "
                             f"(algorithm={algorithm!r}, "
                             f"bp_backend={bp_backend!r})")
        if key is not None and noise_mode != "per_segment":
            raise ValueError(
                "stream_spectra caches per-pulse forward spectra across "
                "overlapped frames, so noise must be drawn per pulse: pass "
                "noise_mode='per_segment'")
        if not use_segments:
            raise ValueError("stream_spectra needs a segment-aligned "
                             "schedule (cpi/starts multiples of the step)")
        if stream_spectra not in (True, "concat", "ring"):
            raise ValueError(f"unknown stream_spectra {stream_spectra!r} "
                             "(True | 'concat' | 'ring')")
        if stream_spectra == "ring":
            starts_i = np.asarray(sched.starts, np.int64)
            if len(starts_i) > 1 and not np.all(np.diff(starts_i) == step):
                raise ValueError("stream_spectra='ring' advances one step "
                                 "per frame: schedule frames must be "
                                 "contiguous (no frame_indices gaps)")
            if step % max(1, presum) != 0:
                raise ValueError(
                    f"stream_spectra='ring' needs step % presum == 0 "
                    f"(ring_offset must not straddle a presum group): "
                    f"step={step}, presum={presum}")

    def segment(s):
        if s not in seg_cache:
            sl = traj.slice(s * step, (s + 1) * step)
            raw_s = phase_history(sl, tgt, opts, t_start=t0,
                                  target_velocity=vel_tgt)
            if (noise_mode == "per_segment" and key is not None
                    and snr_raw is not None):
                ks = jax.random.fold_in(key, 1_000_000 + s)
                raw_s = noise_ops.add_ocean_noise(ks, raw_s, snr_raw,
                                                  sc.noise.scr_db,
                                                  sc.noise.k_shape,
                                                  ref_power_mode="peak")
            seg_cache[s] = raw_s
        return seg_cache[s]

    def segment_spectra(s):
        if s not in spec_cache:
            spec_cache[s] = bp_fast.forward_spectra(segment(s), p_bp)
        return spec_cache[s]

    def _drop_stale(s0):
        for cache in (seg_cache, spec_cache):
            for s in [k for k in cache if k < s0]:
                del cache[s]       # earlier frames never need them again

    def frame_raw(f):
        if use_segments:
            s0 = int(sched.starts[f]) // step
            raw = jnp.concatenate([segment(s0 + j)
                                   for j in range(segs_per_cpi)], axis=0)
            _drop_stale(s0)
            kf = (None if key is None
                  else jax.random.fold_in(key, int(orig_idx[f])))
            if (kf is not None and snr_raw is not None
                    and noise_mode == "per_frame"):
                raw = noise_ops.add_ocean_noise(kf, raw, snr_raw,
                                                sc.noise.scr_db,
                                                sc.noise.k_shape,
                                                ref_power_mode="peak")
            return raw
        if noise_mode == "per_segment":
            raise ValueError("noise_mode='per_segment' needs a segment-"
                             "aligned schedule (cpi/starts multiples of "
                             "the step)")
        sl = traj.slice(int(sched.starts[f]),
                        int(sched.starts[f]) + sched.cpi_pulses)
        kf = (None if key is None
              else jax.random.fold_in(key, int(orig_idx[f])))
        return simulate_cpi(sc, tgt, sl, opts, t0, vel_tgt, kf, snr_raw)

    def frame_spectra(f):
        s0 = int(sched.starts[f]) // step
        sp = jnp.concatenate([segment_spectra(s0 + j)
                              for j in range(segs_per_cpi)], axis=0)
        _drop_stale(s0)
        return sp

    f_total = sched.num_frames

    if stream_spectra == "ring":
        # Sequential streaming product: ONE device-resident spectra window,
        # advanced in place per frame (see docstring). The chain through
        # spec_buf serializes frames, so no batching/pipelining applies;
        # JAX async dispatch still overlaps host frame fetch with device
        # formation.
        acc = _FAST_ACC[bp_backend]
        fs = 16 if acc.startswith("factor") else 0
        vfj = jnp.asarray(vel_focus)

        @jax.jit
        def ring_step(spec_buf, wp, new_spec, po, ve, ts):
            zero = jnp.zeros((), wp.dtype)
            spec_buf = jax.lax.dynamic_update_slice(spec_buf, new_spec,
                                                    (wp, zero))
            wp = (wp + step) % sched.cpi_pulses
            img = bp_fast.focus_bp_fast(
                None, po, ve, ts, vfj, float(t0), p_bp, presum=presum,
                plan=bp_plan, accumulate=acc, fit_stride=fs,
                raw_spectra=spec_buf, ring_offset=wp)
            return spec_buf, wp, img

        imgs_dev, spec_buf, wp = [], None, jnp.int32(0)
        for f in range(f_total):
            i0 = int(sched.starts[f])
            s0 = i0 // step
            sl = traj.slice(i0, i0 + sched.cpi_pulses)
            po = jnp.asarray(sl.positions)
            ve = jnp.asarray(sl.velocities)
            ts = jnp.asarray(sl.times)
            if spec_buf is None:
                spec_buf = frame_spectra(f)    # chronological first fill
                img = bp_fast.focus_bp_fast(
                    None, po, ve, ts, vfj, float(t0), p_bp, presum=presum,
                    plan=bp_plan, accumulate=acc, fit_stride=fs,
                    raw_spectra=spec_buf)
            else:
                new_sp = segment_spectra(s0 + segs_per_cpi - 1)
                _drop_stale(s0)
                spec_buf, wp, img = ring_step(spec_buf, wp, new_sp,
                                              po, ve, ts)
            imgs_dev.append(img)
        images = np.stack([cplx.to_host(im) for im in imgs_dev])
        return VideoFrames(images=images, schedule=sched,
                           scene_size_m=swath)

    def dispatch_batch(b0):
        """Enqueue one frame batch (async under JAX dispatch); the pipeline
        fetches batch k while batch k+1's formation runs on device."""
        b1 = min(b0 + frames_per_batch, f_total)
        raws, poss, vels, ts = [], [], [], []
        for f in range(b0, b1):
            i0 = int(sched.starts[f])
            sl = traj.slice(i0, i0 + sched.cpi_pulses)
            raws.append(frame_spectra(f) if stream_spectra
                        else frame_raw(f))
            poss.append(sl.positions); vels.append(sl.velocities); ts.append(sl.times)
        raw_b = jnp.stack(raws)
        pos_b = jnp.asarray(np.stack(poss))
        vel_b = jnp.asarray(np.stack(vels))
        t_b = jnp.asarray(np.stack(ts))
        if algorithm in ("mbp", "stdbp"):
            if stream_spectra:
                return form_frames_bp(None, pos_b, vel_b, t_b,
                                      jnp.asarray(vel_focus),
                                      jnp.float64(t0), p_bp, presum,
                                      backend=bp_backend, plan=bp_plan,
                                      spectra_frames=raw_b)
            return form_frames_bp(raw_b, pos_b, vel_b, t_b,
                                  jnp.asarray(vel_focus), jnp.float64(t0),
                                  p_bp, presum, backend=bp_backend,
                                  plan=bp_plan)
        elif algorithm == "csa":
            p_csa = csa_ops.CsaParams(
                wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate,
                fs_hz=r.fs_hz, prf_hz=r.prf_hz,
                velocity_mps=g.effective_velocity_mps,
                range_ref_m=g.slant_range_m, t_start_fast=t0,
                num_pulses=sched.cpi_pulses, num_samples=opts.num_samples)
            return form_frames_csa(raw_b, p_csa,
                                   fused=sc.processing.csa_fused,
                                   fft_impl=sc.processing.fft_impl)
        raise ValueError(f"unknown algorithm {algorithm!r}")

    images = list(pipeline.pipelined(
        dispatch_batch, range(0, f_total, frames_per_batch),
        depth=2, fetch=cplx.to_host))
    return VideoFrames(images=np.concatenate(images, axis=0),
                       schedule=sched, scene_size_m=swath)


def resume(sc: ScenarioConfig, targets: PointTargets, frame_dir: str,
           prefix: str = "frame", **run_kwargs):
    """Re-form only the frames missing from a checkpointed run.

    The failure-recovery loop (SURVEY §5): a preempted/crashed campaign left
    a partial per-frame .npy stack (io/products.write_video_frames); this
    computes the missing schedule indices, re-simulates/forms exactly those
    (same noise keys — frame index, not batch position, seeds the RNG), and
    fills the gaps on disk. Returns the list of recovered indices.
    """
    from nis_sar_amtigmti_video_tpu.io.products import (missing_frames,
                                                        write_video_frames)
    import os

    sched = scheduler.make_schedule(sc.video, sc.radar.prf_hz)
    total = sched.num_frames
    if "num_frames" in run_kwargs and run_kwargs["num_frames"]:
        total = min(total, run_kwargs["num_frames"])
    missing = missing_frames(frame_dir, total, prefix)
    if not missing:
        return []
    out = run(sc, targets, frame_indices=missing, **run_kwargs)
    for pos, f in enumerate(missing):
        np.save(os.path.join(frame_dir, f"{prefix}_{f:05d}.npy"),
                out.images[pos])
    return missing
