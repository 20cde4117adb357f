"""Time-domain backprojection (TDBP) — moving-grid (mBP) and standard BP.

Behavior of ``tdbp_gpu`` (sar_batch_sim.py:171-238): FFT matched-filter range
compression, then per pixel/pulse: moving-grid shift g + v_focus*(t - t_mean),
radial-velocity Doppler re-centering t_shift = -fc*(2 v_rad/c)/Kr, stop-and-go
Rx advance, fractional-sample lookup at (index - 0.5) with zero fill
(grid_sample semantics), phase rotation exp(j*2*pi*fc*tau), coherent pulse sum.

Design — delta-range arithmetic
-------------------------------
BP needs mm-scale range accuracy at ~507 km without f64 on the pixel grid.
Instead of |g - p| in f64, ranges are computed as d = d0 + delta, where
d0 = |p| (slant range to the scene origin) is a per-pulse float64 scalar
folded into a wrapped carrier phase, and

    delta = (|g|^2 - 2 g.p) / (2 d0 + delta1)       (one Newton refinement)

is computed in float32: every f32 quantity is either small (pixel coords,
velocity offsets) or enters only through dot products with small vectors, so
absolute range error stays ~1e-4 m (phase ~0.01 rad, incoherent across the
aperture). The hot loop is pure f32/c64 work over (pulse-block x pixel)
tiles via ``lax.scan``. ``dtype=f64`` runs the same code in float64 for
golden tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nis_sar_amtigmti_video_tpu.ops.interp import interp_uniform
from nis_sar_amtigmti_video_tpu.utils.cplx import expj

_TWO_PI = 2.0 * math.pi
_C = 299792458.0


@dataclass(frozen=True)
class BpParams:
    fc_hz: float
    chirp_rate: float
    fs_hz: float
    pulse_width_s: float
    num_samples: int
    nx: int = 512
    ny: int = 512
    scene_size_m: float = 500.0
    pulse_block: int = 16
    precision: str = "f32"   # 'f32' (delta-range fast path) | 'f64' (tests)


def bp_range_compress(raw, p: BpParams):
    """FFT matched filter (sar_batch_sim.py:180-186): reference chirp sampled
    at int(Tp*fs) points, fftshifted, conj-multiplied in frequency."""
    n_ref = int(p.pulse_width_s * p.fs_hz)
    t_ref = np.linspace(-p.pulse_width_s / 2.0, p.pulse_width_s / 2.0, n_ref)
    ref = np.exp(1j * np.pi * p.chirp_rate * t_ref ** 2)
    ref_f = np.fft.fft(np.fft.fftshift(ref), n=p.num_samples)
    ref_conj = jnp.asarray(np.conj(ref_f).astype(np.complex64))
    return jnp.fft.ifft(jnp.fft.fft(raw, axis=-1) * ref_conj, axis=-1)


def pixel_grid(p: BpParams):
    """(nx*ny, 3) float64 pixel centers, row-major in y (matches the
    reference's meshgrid(indexing='xy') + flatten)."""
    x = np.linspace(-p.scene_size_m / 2.0, p.scene_size_m / 2.0, p.nx)
    y = np.linspace(-p.scene_size_m / 2.0, p.scene_size_m / 2.0, p.ny)
    gx, gy = np.meshgrid(x, y, indexing="xy")
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(p.nx * p.ny)], axis=1)


@partial(jax.jit, static_argnames=("p",))
def backproject(rc, sat_pos, sat_vel, t_slow, vel_focus, t_start, p: BpParams,
                t_mean=None):
    """Backproject range-compressed data onto the (moving) pixel grid.

    rc:       (P, Ns) complex64 range-compressed pulses
    sat_pos:  (P, 3) float64, sat_vel: (P, 3) float64, t_slow: (P,) float64
    vel_focus:(3,) float64 — focus velocity (mBP); zeros = standard BP
    t_start:  receive-window opening time (float64 scalar)
    t_mean:   moving-grid reference time; defaults to mean(t_slow). Pass the
              global CPI mean when t_slow is a pulse shard (parallel/
              corner_turn.bp_sharded), else each shard would recentre its
              grid on its own mid-time.

    Returns (ny, nx) complex64 image.
    """
    ft = jnp.float64 if p.precision == "f64" else jnp.float32
    num_p = sat_pos.shape[0]
    npix = p.nx * p.ny

    # ---------------- per-pulse float64 scalars ----------------
    d0 = jnp.linalg.norm(sat_pos, axis=1)                   # (P,) slant range to origin
    carrier0 = ((_TWO_PI * p.fc_hz) * (2.0 * d0 / _C))
    carrier0 = (carrier0 - _TWO_PI * jnp.round(carrier0 / _TWO_PI)).astype(ft)
    toff = (2.0 * d0 / _C - t_start).astype(ft)             # window-relative delay of origin

    t_ref_grid = jnp.mean(t_slow) if t_mean is None else t_mean
    dt = (t_slow - t_ref_grid).astype(ft)                   # mBP grid time
    pos_f = sat_pos.astype(ft)
    vel_f = sat_vel.astype(ft)
    vf = vel_focus.astype(ft)
    g0 = jnp.asarray(pixel_grid(p)).astype(ft)              # (Npix, 3)

    pb = max(1, min(p.pulse_block, num_p))
    p_pad = -(-num_p // pb) * pb

    def padp(x):
        cfgp = [(0, p_pad - num_p)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfgp, mode="edge").reshape((p_pad // pb, pb) + x.shape[1:])

    # zero out padded pulses' contribution via a weight
    w_pad = jnp.pad(jnp.ones((num_p,), jnp.float32),
                    (0, p_pad - num_p)).reshape(-1, pb)

    xs = (padp(pos_f), padp(vel_f), padp(d0.astype(ft)), padp(carrier0),
          padp(toff), padp(dt), padp(rc), w_pad)

    k_doppler = ft(-p.fc_hz * 2.0 / (_C * p.chirp_rate))

    def block(img, x):
        pos_b, vel_b, d0_b, car_b, toff_b, dt_b, rc_b, w_b = x
        # moving pixel grid for this block: (pb, Npix, 3)
        g = g0[None, :, :] + vf[None, None, :] * dt_b[:, None, None]
        # ---- delta range to Tx: d_tx = d0 + delta ----
        gp = jnp.sum(g * pos_b[:, None, :], axis=-1)        # g.p  (pb, Npix)
        g2 = jnp.sum(g * g, axis=-1)
        num = g2 - 2.0 * gp
        d1 = num / (2.0 * d0_b[:, None])
        delta = num / (2.0 * d0_b[:, None] + d1)
        d_tx = d0_b[:, None] + delta

        # ---- radial velocity & Doppler re-centering ----
        u = g - pos_b[:, None, :]                            # (pb, Npix, 3)
        v_rel = vel_b[:, None, :] - vf[None, None, :]
        v_rad = jnp.sum(v_rel * u, axis=-1) / d_tx
        t_shift = k_doppler * v_rad

        # ---- stop-and-go Rx: d_rx = d_tx + delta_rx ----
        tau_a = 2.0 * d_tx / _C
        w_vec = (vf[None, None, :] - vel_b[:, None, :]) * tau_a[..., None]
        uw = 2.0 * jnp.sum(u * w_vec, axis=-1) + jnp.sum(w_vec * w_vec, axis=-1)
        drx1 = uw / (2.0 * d_tx)
        delta_rx = uw / (2.0 * d_tx + drx1)

        # ---- sample + phase + accumulate ----
        dtau = (2.0 * delta + delta_rx) / _C                 # pixel-relative delay
        idx = (toff_b[:, None] + dtau + t_shift) * ft(p.fs_hz) - 0.5
        samp = interp_uniform(rc_b, idx.astype(jnp.float32))
        phase = car_b[:, None] + (_TWO_PI * p.fc_hz / _C) * (2.0 * delta + delta_rx)
        phase = phase - _TWO_PI * jnp.round(phase / _TWO_PI)
        contrib = samp * expj(phase.astype(jnp.float32)) * w_b[:, None]
        return img + jnp.sum(contrib, axis=0).astype(jnp.complex64), None

    img0 = jnp.zeros((npix,), jnp.complex64)
    img, _ = jax.lax.scan(block, img0, xs)
    return img.reshape(p.ny, p.nx)


def presum_factor(p: BpParams, prf_hz: float, wavelength_m: float,
                  slant_range_m: float, velocity_mps: float) -> int:
    """Largest safe azimuth-presum factor for this scene geometry.

    After recentring to the (moving) scene origin, the residual Doppler of a
    scene-corner pixel is f_c = 2 V (diag/2) / (lambda R). The box presum's
    per-pixel sinc droop is corrected exactly afterwards
    (:func:`presum_droop_correction`), so D is capped only by the aliasing
    margin: the decimated rate PRF/D must keep >2x headroom over the
    residual band. Movers are presummed in the vel_focus frame (mBP), so
    the focused target sits at DC and is untouched."""
    diag = p.scene_size_m * math.sqrt(2.0)
    f_corner = 2.0 * velocity_mps * (diag / 2.0) / (wavelength_m * slant_range_m)
    if f_corner <= 0:
        return 1
    # 3.5x margin keeps corner-pixel error < 0.1 dB / 1% field (measured;
    # at 2.5x the aliased box-filter sidelobes reach ~2% of the field)
    return max(1, int(prf_hz / (3.5 * f_corner)))


def presum_droop_correction(sat_pos, sat_vel, t_slow, vel_focus,
                            p: BpParams, d: int):
    """(ny, nx) real map undoing the box presum's per-pixel sinc droop.

    A static pixel g sits at one residual Doppler in the recentred frame,
    f(g) = (2/lambda) (v - v_f) . (u_g - u_0) evaluated at the CPI centre,
    so the D-pulse box average scales it by sinc(pi f D / PRF) exactly —
    invert it. Correction is clipped at 3x (pixels beyond the alias margin
    would otherwise blow up noise)."""
    num_p = t_slow.shape[0]
    c = num_p // 2
    lam = _C / p.fc_hz
    prf = (num_p - 1) / (t_slow[-1] - t_slow[0])
    dtc = t_slow[c] - jnp.mean(t_slow)
    org = vel_focus * dtc
    g = jnp.asarray(pixel_grid(p)) + org[None, :]           # (Npix, 3) f64
    ug = (sat_pos[c][None, :] - g)
    ug = ug / jnp.linalg.norm(ug, axis=-1, keepdims=True)
    u0 = (sat_pos[c] - org)
    u0 = u0 / jnp.linalg.norm(u0)
    v_rel = sat_vel[c] - vel_focus
    f_res = (2.0 / lam) * (ug @ v_rel - jnp.dot(u0, v_rel))  # (Npix,)
    x = jnp.pi * f_res * d / prf
    corr = jnp.where(jnp.abs(x) < 1e-6, 1.0, x / jnp.sin(x))
    corr = jnp.clip(corr, -3.0, 3.0)
    return corr.reshape(p.ny, p.nx).astype(jnp.float32)


@partial(jax.jit, static_argnames=("p", "d"))
def presum_recenter(rc, sat_pos, sat_vel, t_slow, vel_focus, t_start,
                    p: BpParams, d: int):
    """Coherent azimuth presum by ``d``: recenter every pulse to the moving
    scene origin (FFT fractional-delay shift + wrapped carrier removal), box-
    average blocks of ``d``, then re-insert the block-centre pulse's delay
    and carrier so the output is a valid pulse set at PRF/d for
    :func:`backproject`.

    This is the answer to BP's gather cost: per-pixel gathers scale with
    pulses x pixels, and the scene's residual Doppler band after recentring
    is tiny compared to the PRF (validated by :func:`presum_factor`), so
    decimating slow time first cuts the whole BP cost by ~d with sub-0.5 dB
    corner droop. Returns (rc2, pos2, vel2, t2) with P2 = ceil(P/d) pulses.
    """
    num_p = rc.shape[0]
    ns = rc.shape[1]
    dt = t_slow - jnp.mean(t_slow)
    org = vel_focus[None, :] * dt[:, None]
    d0 = jnp.linalg.norm(sat_pos - org, axis=1)             # (P,) f64

    # pad to a multiple of d with zero weight
    p_pad = -(-num_p // d) * d
    w = jnp.pad(jnp.ones((num_p,), jnp.float32), (0, p_pad - num_p))
    rc = jnp.pad(rc, ((0, p_pad - num_p), (0, 0)), mode="edge")
    d0_p = jnp.pad(d0, (0, p_pad - num_p), mode="edge")

    t_ref = 2.0 * jnp.mean(d0) / _C                         # fixed origin bin
    shift = (2.0 * d0_p / _C - t_ref) * p.fs_hz             # samples, f64
    # pad the shift FFTs to a power of two: odd native lengths (e.g. 22004)
    # fall off XLA's fast FFT path; the pad also turns the circular shift
    # into a linear one (shifted-out samples land in the pad, not wrapped)
    nfft = 1 << (ns - 1).bit_length()
    f_bins = jnp.fft.fftfreq(nfft)                          # f64 cycles/sample
    car = _TWO_PI * (2.0 * p.fc_hz / _C) * d0_p             # carrier at origin

    def ramp(phase64):                                      # wrapped c64
        ph = (phase64 - _TWO_PI * jnp.round(phase64 / _TWO_PI)
              ).astype(jnp.float32)
        return jax.lax.complex(jnp.cos(ph), jnp.sin(ph))

    # recenter: shift origin to bin t_ref and remove its carrier
    spec = jnp.fft.fft(rc, n=nfft, axis=-1)
    spec = spec * ramp(_TWO_PI * f_bins[None, :] * shift[:, None])
    rc_c = jnp.fft.ifft(spec, axis=-1) * ramp(car)[:, None]

    # box presum with pad weights; divide by d (not the real count) so the
    # final x d rescale reproduces the exact coherent pulse sum even when
    # the last block is ragged
    wb = w.reshape(-1, d)
    rc_b = (rc_c.reshape(-1, d, nfft) * wb[:, :, None].astype(jnp.complex64)
            ).sum(axis=1) / jnp.float32(d)

    # un-recenter at each block-centre pulse (exact geometry there)
    ci = jnp.arange(p_pad // d) * d + (d // 2)
    ci = jnp.minimum(ci, num_p - 1)
    d0_c = d0[ci]
    shift_c = (2.0 * d0_c / _C - t_ref) * p.fs_hz
    car_c = _TWO_PI * (2.0 * p.fc_hz / _C) * d0_c
    spec_b = jnp.fft.fft(rc_b, axis=-1)                     # already nfft long
    spec_b = spec_b * ramp(-_TWO_PI * f_bins[None, :] * shift_c[:, None])
    rc2 = jnp.fft.ifft(spec_b, axis=-1)[:, :ns] * ramp(-car_c)[:, None]
    return (rc2.astype(jnp.complex64), sat_pos[ci], sat_vel[ci], t_slow[ci])


def focus_bp(raw, sat_pos, sat_vel, t_slow, vel_focus, t_start, p: BpParams,
             presum: int = 1):
    """Range compression + backprojection (the reference's full tdbp_gpu).

    ``presum > 1`` decimates slow time first via :func:`presum_recenter`
    (choose with :func:`presum_factor`); the image is scaled by ``presum``
    so amplitudes match the undecimated sum."""
    rc = bp_range_compress(raw, p)
    pos = jnp.asarray(sat_pos, jnp.float64)
    vel = jnp.asarray(sat_vel, jnp.float64)
    ts = jnp.asarray(t_slow, jnp.float64)
    vf = jnp.asarray(vel_focus, jnp.float64)
    if presum > 1:
        corr = presum_droop_correction(pos, vel, ts, vf, p, presum)
        rc, pos, vel, ts = presum_recenter(rc, pos, vel, ts, vf,
                                           jnp.float64(t_start), p, presum)
        return presum * corr * backproject(rc, pos, vel, ts, vf,
                                           jnp.float64(t_start), p)
    return backproject(rc, pos, vel, ts, vf, jnp.float64(t_start), p)
