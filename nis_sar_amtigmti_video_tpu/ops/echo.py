"""Unified point-target raw-echo engine (forward model).

One vmapped, chunk-scanned generator replaces the reference's five separate
engines (SURVEY.md §2.3): monostatic static/moving targets
(``sar_satellite_sim.py:211-305``, ``sar_satellite_moving_sim.py:111-159``,
``sar_vehicle_sim.py:83-126``), bistatic two-phase-center
(``sar_ati_dcpa_sim_csa.py:106-181``) and spotlight with sinc^2 antenna gain +
stop-and-go Rx correction (``sar_batch_sim.py:83-169``). Receive channels,
target motion, antenna pattern and stop-and-go are options on the same kernel.

Design
------
* Geometry (positions -> delays -> carrier phase) runs in float64: at ~507 km
  slant range the two-way phase needs sub-mm range accuracy. The carrier phase
  is wrapped mod 2pi in f64 and *then* cast to f32, so the large
  (pulses x targets x samples) tensor work is pure float32/complex64.
* The pulse axis is processed by a ``lax.scan`` over fixed-size chunks with an
  inner ``fori_loop`` over target chunks — static shapes, bounded memory
  footprint, no data-dependent control flow.
* The slow-time (pulse) axis is the natural sharding axis ("seq"); callers
  shard by slicing trajectories per device (see parallel/).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nis_sar_amtigmti_video_tpu.utils.cplx import expj

_TWO_PI = 2.0 * math.pi
BACKENDS = ("jnp", "freq")


@dataclass(frozen=True)
class EchoOpts:
    """Static configuration of the echo kernel (hashable; jit-static)."""

    fc_hz: float
    chirp_rate: float            # K_r [Hz/s]
    pulse_width_s: float
    fs_hz: float
    num_samples: int
    # fast-time grid flavor: True reproduces the reference's
    # linspace(0, N/fs, N) endpoint quirk (sar_satellite_sim.py:254);
    # False is a uniform arange(N)/fs grid (sar_batch_sim.py:90).
    endpoint_grid: bool = True
    # 'leading': echo occupies [tau, tau+Tp], phase pi*Kr*(t-tau-Tp/2)^2
    #            (sar_satellite_sim.py:290-299)
    # 'centered': echo occupies [tau-Tp/2, tau+Tp/2], phase pi*Kr*(t-tau)^2
    #            (sar_batch_sim.py:146-148)
    chirp_centering: str = "leading"
    # 'sqrt_rcs' (all engines except spotlight) | 'rcs' (sar_batch_sim.py:150)
    amplitude: str = "sqrt_rcs"
    stop_and_go: bool = False    # advance Rx by v_sat * tau (sar_batch_sim.py:130-133)
    antenna_length_m: float = 0.0  # >0: sinc^2 azimuth pattern (sar_batch_sim.py:135-144)
    # chunking (elements of the f32 work tensor per step ~ pulse_chunk*target_chunk*Ns)
    max_elements: int = 1 << 25
    target_chunk: int = 512
    # 'jnp' (scan + XLA fusion) | 'freq' (NUFFT convolution + exact gate
    # edges, ops/echo_freq.py — golden-grade and fast for clutter-heavy
    # scenes; requires endpoint_grid=False)
    backend: str = "jnp"
    freq_oversample: int = 2    # spreading-grid oversampling for 'freq'
    # raised-cosine flank width (native samples) carried by the NUFFT path;
    # the flanks themselves are synthesized exactly. 0 = round-1 approximate
    # mode (no exact-edge pass, ~-25 dB field floor)
    freq_edge_taper: float = 4.0
    # 'auto' | 'dense' | 'scatter': how the NUFFT impulses reach the grid
    # (scatter = f32 scatter-add; dense = one-hot matmul spreading, targets
    # delay-sorted below so its group windows stay narrow;
    # 'auto' = ops/echo_freq.py::AUTO_SPREADER)
    freq_spreader: str = "auto"
    # dense-spreader group sizing overrides (None = module defaults): the
    # (grp, B/grp, win) one-hot is the dense path's HBM bill; tighter
    # windows cut it linearly while each group's delay span fits win
    freq_spread_win: Optional[int] = None
    freq_spread_grp: Optional[int] = None
    # independent exact-edge-pass window override (None = half the main
    # window rule): the edge pass's one-hot bill scales with this window —
    # callers with a bounded scene delay span (equality-gated) can shrink it
    freq_spread_win_edge: Optional[int] = None
    # slow-time stride of the exact f64 geometry pass for backend='freq'
    # (quadratic anchor interpolation between; 0/1 = exact at every pulse)
    freq_geom_stride: int = 8
    # 'f64': interpolate the delay field in f64 and wrap the carrier per
    # (pulse, target). 'split': f64 only at the anchors, inter-anchor
    # deltas in f32 (~1e-5 rad carrier class)
    freq_geom_interp: str = "f64"

    @property
    def half_width(self) -> float:
        return self.pulse_width_s / 2.0

    @property
    def chirp_shift(self) -> float:
        return self.half_width if self.chirp_centering == "leading" else 0.0


def fast_time_grid(opts: EchoOpts):
    """Fast-time sample offsets from window start, float64 (host numpy)."""
    n, fs = opts.num_samples, opts.fs_hz
    if opts.endpoint_grid:
        return np.linspace(0.0, n / fs, n)
    return np.arange(n) / fs


def window_start_time(r0: float, opts: EchoOpts, window_length_s: float,
                      mode: str = "reference") -> float:
    """Receive-window opening time.

    'reference': 2R0/c - Tp/2 - 1us (sar_satellite_sim.py:252)
    'centered' : 2R0/c - win/2     (sar_batch_sim.py:89)
    """
    c = 299792458.0
    if mode == "reference":
        return 2.0 * r0 / c - opts.pulse_width_s / 2.0 - 1e-6
    if mode == "centered":
        return 2.0 * r0 / c - window_length_s / 2.0
    raise ValueError(f"window mode must be 'reference' or 'centered', got {mode!r}")


def _wrap_pi(x):
    """Wrap to (-pi, pi] in the input dtype."""
    return x - _TWO_PI * jnp.round(x / _TWO_PI)


def _pad_axis0(x, n_to, edge=False):
    pad = n_to - x.shape[0]
    if pad == 0:
        return x
    cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, cfg, mode="edge" if edge else "constant")


@partial(jax.jit, static_argnames=("opts",))
def _phase_history(t_slow, sat_pos, sat_vel, tgt_pos, tgt_rcs, tgt_vel,
                   rx_offset, t_start, opts: EchoOpts):
    """Core kernel. All array args float64; returns (P, Ns) complex64."""
    c = 299792458.0
    num_p = t_slow.shape[0]
    num_b = tgt_pos.shape[0]
    ns = opts.num_samples
    n_chan = 1 if rx_offset.ndim == 0 else rx_offset.shape[0]
    if num_b == 0:  # empty scene: pure zeros
        return jnp.zeros((n_chan * num_p, ns), jnp.complex64) \
            if rx_offset.ndim else jnp.zeros((num_p, ns), jnp.complex64)

    # --- static chunk plan ---
    tb = min(opts.target_chunk, num_b)
    pc = max(1, min(num_p, opts.max_elements // max(1, tb * ns)))
    b_pad = -(-num_b // tb) * tb
    p_pad = -(-num_p // pc) * pc
    n_chunks = p_pad // pc
    n_tchunks = b_pad // tb

    # --- padded inputs (target pad: rcs=0 kills contribution; pulse pad: edge
    # replicate keeps geometry finite, rows discarded after the scan) ---
    tgt_pos_p = _pad_axis0(tgt_pos, b_pad)
    tgt_rcs_p = _pad_axis0(tgt_rcs, b_pad)
    t_slow_p = _pad_axis0(t_slow, p_pad, edge=True).reshape(n_chunks, pc)
    sat_pos_p = _pad_axis0(sat_pos, p_pad, edge=True).reshape(n_chunks, pc, 3)
    sat_vel_p = _pad_axis0(sat_vel, p_pad, edge=True).reshape(n_chunks, pc, 3)

    if opts.amplitude == "sqrt_rcs":
        amp_b = jnp.sqrt(tgt_rcs_p)
    else:
        amp_b = tgt_rcs_p

    t_fast_rel = jnp.asarray(fast_time_grid(opts))  # f64 (Ns,)
    t_fast_f32 = t_fast_rel.astype(jnp.float32)
    k_pi = jnp.float32(math.pi * opts.chirp_rate)
    shift = jnp.float32(opts.chirp_shift)
    half = jnp.float32(opts.half_width)

    def geometry_core(j, ts, ps, vs, off=None):
        """f64 geometry for target chunk j of one pulse chunk: (tau (f64),
        amp (f32)), each (pc, tb). ts:(pc,), ps/vs:(pc,3). ``off`` is the
        along-track Rx offset (per-channel in the batched freq form)."""
        if off is None:
            off = rx_offset
        pos0 = jax.lax.dynamic_slice(tgt_pos_p, (j * tb, 0), (tb, 3))
        amp0 = jax.lax.dynamic_slice(amp_b, (j * tb,), (tb,))

        # ---------- float64 geometry ----------
        p_t = pos0[None, :, :] + tgt_vel[None, None, :] * ts[:, None, None]
        diff_tx = p_t - ps[:, None, :]                      # (pc, tb, 3)
        d_tx = jnp.linalg.norm(diff_tx, axis=-1)            # (pc, tb)

        v_norm = jnp.linalg.norm(vs, axis=-1, keepdims=True)
        v_dir = vs / jnp.where(v_norm == 0.0, 1.0, v_norm)
        p_rx = ps[:, None, :] + v_dir[:, None, :] * off
        if opts.stop_and_go:
            tau_a = 2.0 * d_tx / c
            p_rx = p_rx + vs[:, None, :] * tau_a[:, :, None]
        d_rx = jnp.linalg.norm(p_t - p_rx, axis=-1)
        tau = (d_tx + d_rx) / c

        amp = amp0[None, :]
        if opts.antenna_length_m > 0.0:
            look = -ps / jnp.linalg.norm(ps, axis=-1, keepdims=True)
            cos_off = jnp.clip(
                jnp.sum(look[:, None, :] * (diff_tx / d_tx[..., None]), axis=-1),
                -1.0, 1.0)
            lam = c / opts.fc_hz
            x = (math.pi * opts.antenna_length_m / lam) * jnp.sin(jnp.arccos(cos_off))
            sinc = jnp.where(jnp.abs(x) > 1e-6, jnp.sin(x) / jnp.where(x == 0, 1.0, x), 1.0)
            amp = amp * (sinc ** 2)
        amp = jnp.broadcast_to(amp, tau.shape).astype(jnp.float32)
        return tau, amp

    def geometry_block(j, ts, ps, vs, off=None):
        """geometry_core -> f32 scalars (tau_rel, carrier, amp)."""
        tau, amp = geometry_core(j, ts, ps, vs, off)
        carrier = _wrap_pi(-_TWO_PI * opts.fc_hz * tau).astype(jnp.float32)
        tau_rel = (tau - t_start).astype(jnp.float32)       # (pc, tb), < ~50 us
        return tau_rel, carrier, amp

    def target_block(j, carry, ts, ps, vs):
        """Echo of target chunk j accumulated onto carry (pc, Ns)."""
        tau_rel, carrier, amp = geometry_block(j, ts, ps, vs)
        # ---------- float32 echo accumulation ----------
        t_local = t_fast_f32[None, None, :] - tau_rel[:, :, None]   # (pc, tb, Ns)
        arg = t_local - shift
        mask = jnp.abs(arg) <= half
        phase = carrier[:, :, None] + k_pi * (arg * arg)
        sig = jnp.where(mask, amp[:, :, None], jnp.float32(0.0)) * expj(phase)
        return carry + jnp.sum(sig, axis=1)

    if opts.backend == "freq":
        # delay-sort the scene once (mid-pulse ranges): the dense spreader's
        # group windows need consecutive targets to span a narrow delay band;
        # the echo is a sum over targets, so order never changes the output
        d_mid = jnp.linalg.norm(
            tgt_pos_p - sat_pos[num_p // 2][None, :], axis=1)
        order = jnp.argsort(jnp.where(jnp.arange(b_pad) < num_b, d_mid,
                                      jnp.inf))
        tgt_pos_p = tgt_pos_p[order]
        tgt_rcs_p = tgt_rcs_p[order]
        amp_b = amp_b[order]

    if opts.backend not in BACKENDS:
        raise ValueError(f"unknown echo backend {opts.backend!r}; options: "
                         f"{', '.join(BACKENDS)}")
    if opts.backend == "freq":
        # two-pass: chunk-scanned f64 geometry -> (P, B) f32 scalars, then
        # the NUFFT synthesis of the (P, Ns) field.
        h_geo = opts.freq_geom_stride
        if opts.freq_geom_interp not in ("f64", "split"):
            raise ValueError(
                f"unknown freq_geom_interp {opts.freq_geom_interp!r}")
        # Channel-batched form: a (C,) rx_offset runs each channel's
        # geometry through the same anchored pipeline and stacks the
        # scalar fields on the pulse axis, so ONE synthesize call (one
        # program, one scan tail) serves every channel; the caller
        # slices the (C*P, Ns) result per channel.
        offs_c = ([rx_offset] if rx_offset.ndim == 0
                  else [rx_offset[c] for c in range(rx_offset.shape[0])])
        taus_c, cars_c, amps_c = [], [], []
        for off_c in offs_c:
            if h_geo > 1 and num_p > 3 * h_geo:
                # anchored geometry: the f64 pass runs only every
                # h_geo-th pulse; the delay field interpolates quadratically in
                # slow time (residual ~1e-19 s at reference orbital jerk — see
                # utils/anchors.py), and the carrier derives from the
                # interpolated f64 delay, so its wrap stays exact.
                from nis_sar_amtigmti_video_tpu.utils.anchors import anchor_plan
                needed, trip, w_np = anchor_plan(num_p, h_geo)
                na = len(needed)
                na_pad = -(-na // pc) * pc

                def pad_a(x):
                    return _pad_axis0(x[jnp.asarray(needed)], na_pad, edge=True)

                ts_a = pad_a(t_slow).reshape(-1, pc)
                ps_a = pad_a(sat_pos).reshape(-1, pc, 3)
                vs_a = pad_a(sat_vel).reshape(-1, pc, 3)

                def geom_chunk64(carry, xs):
                    ts, ps, vs = xs
                    outs = [geometry_core(j, ts, ps, vs, off_c)
                            for j in range(n_tchunks)]
                    tau_c = jnp.concatenate([o[0] for o in outs], axis=1)
                    amp_c = jnp.concatenate([o[1] for o in outs], axis=1)
                    return carry, (tau_c, amp_c)

                _, (tau_a, amp_a) = jax.lax.scan(geom_chunk64, 0,
                                                 (ts_a, ps_a, vs_a))
                tau_a = tau_a.reshape(na_pad, b_pad)[:na]
                amp_a = amp_a.reshape(na_pad, b_pad)[:na]
                w64 = jnp.asarray(w_np)
                a0, a1, a2 = (jnp.asarray(trip[:, k]) for k in range(3))
                w32 = w64.astype(jnp.float32)
                amp_all = (w32[:, 0, None] * amp_a[a0]
                           + w32[:, 1, None] * amp_a[a1]
                           + w32[:, 2, None] * amp_a[a2])[:num_p]
                if opts.freq_geom_interp == "split":
                    # sum(w) = 1, so tau = tau[a1] + w0*(tau[a0] - tau[a1])
                    # + w2*(tau[a2] - tau[a1]); the deltas are ~ns-scale (f64
                    # subtraction exact, f32 cast ~1e-16 s) and the carrier
                    # wraps ONCE per anchor in f64 — the per-pulse residual
                    # phase is tens of rad, safe to wrap in f32
                    car_a = _wrap_pi(-_TWO_PI * opts.fc_hz * tau_a
                                     ).astype(jnp.float32)
                    rel_a = (tau_a - t_start).astype(jnp.float32)
                    d0 = (tau_a[a0] - tau_a[a1]).astype(jnp.float32)
                    d2 = (tau_a[a2] - tau_a[a1]).astype(jnp.float32)
                    dly = w32[:, 0, None] * d0 + w32[:, 2, None] * d2
                    tau_all = (rel_a[a1] + dly)[:num_p]
                    dph = jnp.float32(-_TWO_PI * opts.fc_hz) * dly
                    car_all = _wrap_pi(car_a[a1] + dph)[:num_p]
                else:
                    tau64 = (w64[:, 0, None] * tau_a[a0]
                             + w64[:, 1, None] * tau_a[a1]
                             + w64[:, 2, None] * tau_a[a2])
                    car_all = _wrap_pi(-_TWO_PI * opts.fc_hz * tau64
                                       ).astype(jnp.float32)[:num_p]
                    tau_all = (tau64 - t_start).astype(jnp.float32)[:num_p]
            else:
                def geom_chunk(carry, xs):
                    ts, ps, vs = xs
                    outs = [geometry_block(j, ts, ps, vs, off_c)
                            for j in range(n_tchunks)]
                    tau_c = jnp.concatenate([o[0] for o in outs], axis=1)
                    car_c = jnp.concatenate([o[1] for o in outs], axis=1)
                    amp_c = jnp.concatenate([o[2] for o in outs], axis=1)
                    return carry, (tau_c, car_c, amp_c)

                _, (tau_all, car_all, amp_all) = jax.lax.scan(
                    geom_chunk, 0, (t_slow_p, sat_pos_p, sat_vel_p))
                tau_all = tau_all.reshape(p_pad, b_pad)[:num_p]
                car_all = car_all.reshape(p_pad, b_pad)[:num_p]
                amp_all = amp_all.reshape(p_pad, b_pad)[:num_p]
            taus_c.append(tau_all)
            cars_c.append(car_all)
            amps_c.append(amp_all)
        tau_all = (taus_c[0] if len(taus_c) == 1
                   else jnp.concatenate(taus_c, axis=0))
        car_all = (cars_c[0] if len(cars_c) == 1
                   else jnp.concatenate(cars_c, axis=0))
        amp_all = (amps_c[0] if len(amps_c) == 1
                   else jnp.concatenate(amps_c, axis=0))
        if opts.endpoint_grid:
            raise ValueError(
                "backend='freq' needs a uniform fast-time grid "
                "(endpoint_grid=False)")
        from nis_sar_amtigmti_video_tpu.ops.echo_freq import synthesize
        return synthesize(tau_all, car_all, amp_all, opts,
                          oversample=opts.freq_oversample,
                          edge_taper=opts.freq_edge_taper,
                          spreader=opts.freq_spreader,
                          spread_win=opts.freq_spread_win,
                          spread_grp=opts.freq_spread_grp,
                          spread_win_edge=opts.freq_spread_win_edge)

    if rx_offset.ndim:
        raise ValueError(
            "batched (C,) rx_offset is only supported on the 'freq' "
            "backend; vmap the 'jnp' engine instead")

    def pulse_chunk(carry, xs):
        ts, ps, vs = xs
        acc = jnp.zeros((pc, ns), dtype=jnp.complex64)
        acc = jax.lax.fori_loop(
            0, n_tchunks, lambda j, a: target_block(j, a, ts, ps, vs), acc)
        return carry, acc

    _, out = jax.lax.scan(pulse_chunk, 0, (t_slow_p, sat_pos_p, sat_vel_p))
    return out.reshape(p_pad, ns)[:num_p]


def phase_history(trajectory, targets, opts: EchoOpts, *,
                  t_start: float,
                  target_velocity=(0.0, 0.0, 0.0),
                  rx_offset: float = 0.0):
    """Simulate one channel's raw phase history.

    Parameters
    ----------
    trajectory: geometry.orbit.Trajectory (or any (times, positions,
        velocities) triple of float64 arrays).
    targets: scene.targets.PointTargets (positions (B,3), rcs (B,)).
    t_start: receive-window opening time [s] (see ``window_start_time``).
    target_velocity: rigid velocity of the whole target cluster [m/s].
    rx_offset: along-track Rx phase-center offset from the Tx [m].

    Returns (num_pulses, num_samples) complex64 on device.
    """
    t, p, v = trajectory.times, trajectory.positions, trajectory.velocities
    return _phase_history(
        jnp.asarray(t, jnp.float64),
        jnp.asarray(p, jnp.float64),
        jnp.asarray(v, jnp.float64),
        jnp.asarray(targets.positions, jnp.float64),
        jnp.asarray(targets.rcs, jnp.float64),
        jnp.asarray(target_velocity, jnp.float64),
        jnp.float64(rx_offset),
        jnp.float64(t_start),
        opts,
    )


def multi_channel_phase_history(trajectory, targets, opts: EchoOpts, *,
                                t_start: float,
                                rx_offsets,
                                target_velocity=(0.0, 0.0, 0.0),
                                channels_as_tuple: Optional[bool] = None):
    """Simulate all receive channels.

    Returns a (num_channels, P, Ns) complex64 array for the direct
    backend (the channel axis is a leading batch axis — shard it over the
    mesh 'chan' axis for multichannel GMTI/HRWS collections), or a TUPLE
    of per-channel (P, Ns) arrays for backend='freq' (see the branch
    below).

    ``channels_as_tuple`` pins the return form for consumers that need one
    contract across backends: True always returns the per-channel tuple;
    False always returns the stacked (C, P, Ns) array (for 'freq' the stack
    happens post-synthesis and copies every channel once more);
    None (default) keeps the backend-dependent auto behavior above.
    """
    t = jnp.asarray(trajectory.times, jnp.float64)
    p = jnp.asarray(trajectory.positions, jnp.float64)
    v = jnp.asarray(trajectory.velocities, jnp.float64)

    def one(off):
        return _phase_history(
            t, p, v,
            jnp.asarray(targets.positions, jnp.float64),
            jnp.asarray(targets.rcs, jnp.float64),
            jnp.asarray(target_velocity, jnp.float64),
            off, jnp.float64(t_start), opts)

    if opts.backend == "freq":
        # ONE batched dispatch: every channel's scalar fields stack on the
        # pulse axis inside _phase_history, so a single synthesize program
        # (one scan tail, one spread/conv pipeline, shared delay sort)
        # serves all channels. The result stays 2-D (C*P, Ns), sliced per
        # channel here and returned as a TUPLE: consumers index channels,
        # and the full-scale pipeline never needs a stacked copy.
        offs = np.asarray(rx_offsets, np.float64)
        if len(offs) == 1:
            chans = (one(jnp.float64(offs[0])),)
        else:
            n_p = int(np.asarray(trajectory.times).shape[0])
            flat = one(jnp.asarray(offs))               # (C*P, Ns)
            chans = tuple(flat[c * n_p:(c + 1) * n_p]
                          for c in range(len(offs)))
        return jnp.stack(chans, axis=0) if channels_as_tuple is False \
            else chans
    out = jax.vmap(one)(jnp.asarray(rx_offsets, jnp.float64))
    return tuple(out[i] for i in range(out.shape[0])) \
        if channels_as_tuple is True else out
