"""Gather-free fast backprojection (the counterpart of ``tdbp_gpu``).

Why
---
Classic per-pixel BP needs ``pulses x pixels`` fractional-sample lookups
(512^2 x 2,500 pulses at the reference workload, sar_batch_sim.py:171-238).
This module removes *every* per-pixel gather and turns the work into
FFTs, elementwise trig and batched matmuls:

1. **Recentre + presum** (ops/bp.py machinery): every pulse is resampled so
   the scene origin sits at a fixed sample bin, then slow time is coherently
   decimated by D (validated droop budget +0.03 dB).
2. **Iso-range internal grid**: pixels are laid out with rows along the
   CPI-centre iso-range direction and row pitch chosen so consecutive rows
   advance the range index by an *exact integer* ``stride`` of samples.
   Row windows of W samples then come out of the recentred pulses as W
   static strided slices — no gathers.
3. **Separable evaluation**: within a row, the true sample index of pixel
   (t, y, x) is A[t,y] + e_t(x) with e_t quadratic in x (curvature, squint,
   Doppler re-centering and stop-and-go all included — coefficients are fit
   from 3 exact delta-range evaluations per (t,y), so no term is dropped by
   hand). The tapered window is interpolated in its 32-point Fourier basis:

       value[t,y,x] = sum_m  (W^[t,y,m] e^{j2pi f_m A}) * (e^{j2pi f_m e_t(x)})
                      ------------------------------   -------------------
                            per-(t,y) ramp                per-t kernel

   — a per-pulse (ny x W) @ (W x nx) complex matmul.
4. **Phase** exp(j*phi[t,y,x]) is evaluated per pixel (that is the azimuth
   focusing) from a per-(t,y) quadratic-in-x fit of the exact f64 phase;
   cubic residuals are < 1e-3 rad at the reference geometry.
5. The internal image is mapped to the requested output grid by a
   gather-free affine resample: two chirp-Z passes whose per-slice start
   phases carry the shear terms (ops/czt.py).

The result is numerically *better* interpolation than the reference's
bilinear ``grid_sample`` (windowed-Fourier vs 2-tap linear); golden parity
with the reference semantics stays on ops/bp.py's exact path.

Reference behavior covered: sar_batch_sim.py:171-238 (tdbp_gpu: mBP/StdBP,
Doppler re-centering, stop-and-go Rx, grid_sample -0.5 offset).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace as _dc_replace
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from nis_sar_amtigmti_video_tpu.ops.bp import BpParams
from nis_sar_amtigmti_video_tpu.utils.cplx import expj

_TWO_PI = 2.0 * math.pi
_C = 299792458.0


# --------------------------------------------------------------------------
# plan (host-side, static): internal grid + band geometry
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FastBpPlan:
    """Static geometry of the internal iso-range grid (hashable: jit-static).

    Per-frame quantities (iso-range directions, row pitch, which rotate over
    a VideoSAR collect) are *traced*, computed in-graph by
    :func:`_frame_geometry` — one plan serves every CPI of a collect, so a
    vmapped multi-frame formation compiles once.
    """
    ny_i: int              # internal rows (iso-range lines)
    nx_i: int              # internal columns (along iso-range)
    w_win: int             # per-row window length (samples)
    stride: int            # integer samples of range walk per internal row
    band_start: int        # first recentred sample used by row 0's window
    nfft: int              # recentred fast-time length (power of two)
    dx_m: float            # internal column pitch (= output pitch)
    t_ref: float           # fixed recentre delay (s): origin bin position
    n_org: float           # (t_ref - t_start) * fs, the origin's sample index
    taper_pow: int = 4     # cos^p window taper power
    # factorized (sub-aperture) accumulation: raw pulses per sub-aperture and
    # coarse column count for the inner sums (0 = not planned; see
    # :func:`make_plan` factorize= and :func:`_accumulate_factor`)
    sub_raw: int = 0
    nx_c: int = 0
    # second factorization level (0 = not planned / infeasible): level-1
    # sub-apertures of ``sub_raw1`` raw pulses run their inner sums on
    # ``nx_c1`` columns (half of nx_c), and groups of ``grp`` level-1
    # images merge onto the nx_c grid before the final merge to the fine
    # grid — see :func:`_accumulate_factor2`
    sub_raw1: int = 0
    nx_c1: int = 0
    grp: int = 0


def _look_geometry(p: BpParams, pos_c: np.ndarray):
    """CPI-centre look geometry: in-plane range-gradient and iso-range dirs
    (host/numpy version, used for static plan sizing)."""
    u = pos_c / np.linalg.norm(pos_c)          # origin -> sat
    ug = np.array([u[0], u[1]])                # ground projection
    g = float(np.linalg.norm(ug))
    if g < 1e-12:                              # nadir: degenerate, pick +y
        ug = np.array([0.0, 1.0]); g = 1.0
    cdir = -ug / np.linalg.norm(ug)            # range increases along cdir
    rdir = np.array([cdir[1], -cdir[0]])       # iso-range direction
    if rdir[0] < 0:                            # keep roughly +x for sanity
        rdir = -rdir
    return (np.array([rdir[0], rdir[1], 0.0]),
            np.array([cdir[0], cdir[1], 0.0]), g)


def _frame_geometry(pos_c, p: BpParams, plan: FastBpPlan):
    """Traced per-CPI grid geometry from the centre-pulse position:
    (row_dir(3,), col_dir(3,), dy_m scalar), all f64."""
    u = pos_c / jnp.linalg.norm(pos_c)
    ug = u[:2]
    gn = jnp.linalg.norm(ug)
    ug = jnp.where(gn < 1e-12, jnp.asarray([0.0, 1.0], ug.dtype), ug / gn)
    gn = jnp.maximum(gn, 1e-12)
    cdir = jnp.concatenate([-ug, jnp.zeros((1,), ug.dtype)])
    rdir = jnp.asarray([cdir[1], -cdir[0], 0.0])
    rdir = jnp.where(rdir[0] < 0, -rdir, rdir)
    dy_m = plan.stride * (_C / (2.0 * p.fs_hz)) / gn
    return rdir, cdir, dy_m


def _factor_bounds(p: BpParams, sat_pos: np.ndarray, ny_i: int, nx_i: int,
                   dy_m: float, dx_m: float):
    """Host-side bandwidth bounds for the factorized accumulate sizing.

    Evaluates the exact monostatic two-way phase/index at the aperture
    start/centre/end for the internal grid's corner pixels (the moving-org
    and stop-and-go corrections are orders of magnitude below these bounds)
    and returns

      f_val    — x-bandwidth of the *value* field [cycles/pixel]: range
                 signal (<=0.5 cyc/sample) advected at the migration slope,
      dpb_raw  — max |d pb / d raw pulse| [rad/pixel/pulse]: the Doppler
                 (phase-slope) rate that sets how far a sub-aperture may
                 extend before its content exceeds the coarse-grid band,
      dpcx_raw — same for the quadratic term's edge contribution
                 |d (2 pc xi_max) / d pulse|.
    """
    pos_c = sat_pos[len(sat_pos) // 2]
    rdir, cdir, u_g = _look_geometry(p, pos_c)
    xi_max = (nx_i - 1) / 2.0
    a_max = xi_max * dx_m
    k_ph = 4.0 * math.pi * p.fc_hz / _C
    k_ix = 2.0 * p.fs_hz / _C

    pb_t, pcx_t = [], []
    f_val = 0.0
    for ci in (0, len(sat_pos) // 2, len(sat_pos) - 1):
        pos = sat_pos[ci]
        d0 = np.linalg.norm(pos)
        pb_y, pcx_y, bt_y, ctx_y = [], [], [], []
        for b in (-(ny_i - 1) / 2.0 * dy_m, 0.0, (ny_i - 1) / 2.0 * dy_m):
            g = (b * cdir[None, :]
                 + np.array([-a_max, 0.0, a_max])[:, None] * rdir[None, :])
            delta = np.linalg.norm(g - pos[None, :], axis=1) - d0
            ph = k_ph * delta
            ix = k_ix * delta
            pb_y.append((ph[2] - ph[0]) / (2.0 * xi_max))
            pcx_y.append((ph[2] + ph[0] - 2.0 * ph[1]) / (2.0 * xi_max ** 2)
                         * 2.0 * xi_max)
            bt_y.append((ix[2] - ix[0]) / (2.0 * xi_max))
            ctx_y.append((ix[2] + ix[0] - 2.0 * ix[1]) / (2.0 * xi_max ** 2)
                         * 2.0 * xi_max)
        pb_t.append(pb_y)
        pcx_t.append(pcx_y)
        f_val = max(f_val, 0.5 * (max(abs(v) for v in bt_y)
                                  + max(abs(v) for v in ctx_y)))
    n_half = max(1, (len(sat_pos) - 1) // 2)
    pb_t, pcx_t = np.asarray(pb_t), np.asarray(pcx_t)
    dpb_raw = float(np.abs(np.diff(pb_t, axis=0)).max() / n_half)
    dpcx_raw = float(np.abs(np.diff(pcx_t, axis=0)).max() / n_half)
    return f_val, dpb_raw, dpcx_raw


# merge-stage interpolation kernel (continuous Kaiser-windowed sinc): for
# inner-sum content held under 0.8 * coarse Nyquist these constants measure
# ~-100 dB reconstruction error
_UPS_FC = 0.4      # lowpass cutoff [cycles / coarse sample]
_UPS_D = 10        # one-sided support [coarse samples]
_UPS_BETA = 10.0   # Kaiser shape
# level-1 merge kernel (factor2): shorter support so the edge truncation
# stays inside the planned column margin at the doubled coarse pitch —
# measured -73 dB reconstruction error at the factor2 content budget
_UPS1_D = 6
_UPS1_BETA = 7.0


def _interp_matrix(n_from: int, n_to: int, h_from: float, h_to: float,
                   fc: float, d_sup: int, beta: float) -> np.ndarray:
    """(n_from, n_to) f32 band-limited Kaiser-sinc interpolation matrix
    between two centred grids with pitches ``h_from``/``h_to`` in fine-pixel
    units (host/numpy; plan-static). Tap distances are in source samples."""
    xt = (np.arange(n_to) - (n_to - 1) / 2.0) * h_to
    xf = (np.arange(n_from) - (n_from - 1) / 2.0) * h_from
    d = (xt[None, :] - xf[:, None]) / h_from
    w = np.zeros_like(d)
    m = np.abs(d) < d_sup
    w[m] = np.i0(beta * np.sqrt(1.0 - (d[m] / d_sup) ** 2)) / np.i0(beta)
    return (2.0 * fc * np.sinc(2.0 * fc * d) * w).astype(np.float32)


def _upsample_matrix(plan: FastBpPlan) -> np.ndarray:
    """(nx_c, nx_i) f32 band-limited interpolation matrix taking the coarse
    inner-sum columns to the fine internal grid (host/numpy; plan-static)."""
    return _interp_matrix(plan.nx_c, plan.nx_i, plan.nx_i / plan.nx_c, 1.0,
                          _UPS_FC, _UPS_D, _UPS_BETA)


def _upsample_matrix_l1(plan: FastBpPlan) -> np.ndarray:
    """(nx_c1, nx_c) f32 level-1 -> level-2 merge matrix (factor2)."""
    return _interp_matrix(plan.nx_c1, plan.nx_c, plan.nx_i / plan.nx_c1,
                          plan.nx_i / plan.nx_c, _UPS_FC, _UPS1_D, _UPS1_BETA)


def make_plan(p: BpParams, sat_pos: np.ndarray, t_slow: np.ndarray,
              t_start: float, w_win: int = 32,
              factorize: bool = False) -> FastBpPlan:
    """Build the static plan from *concrete* (numpy) trajectory geometry.

    ``sat_pos``/``t_slow`` may span a whole VideoSAR collect; sizing covers
    the worst-case look rotation across it.

    ``factorize=True`` additionally sizes the sub-aperture (factorized)
    accumulation: coarse column count ``nx_c`` and the largest raw-pulse
    sub-aperture length ``sub_raw`` whose Doppler span keeps the inner sums
    inside the coarse grid's alias-free band (with the extra column margin
    the merge interpolator needs). See :func:`_accumulate_factor`.
    """
    sat_pos = np.asarray(sat_pos, np.float64)
    t_slow = np.asarray(t_slow, np.float64)

    # integer-stride row pitch: one row advances range by stride samples.
    # stride > 1 is only safe when fs substantially oversamples the chirp
    # (row pitch must keep the range spectrum alias-free).
    bw = abs(p.chirp_rate) * p.pulse_width_s
    stride = max(1, int(p.fs_hz / max(bw, 1e-3)))
    dr_per_sample = _C / (2.0 * p.fs_hz)       # slant meters per sample
    dx_m = p.scene_size_m / (p.nx - 1)

    # coverage: output square corners projected on (row_dir, col_dir) at the
    # start/mid/end look geometry + resample margin + window guard
    half = p.scene_size_m / 2.0
    b_half, a_half, dy_min = 0.0, 0.0, np.inf
    for ci in (0, sat_pos.shape[0] // 2, sat_pos.shape[0] - 1):
        row_dir, col_dir, u_g = _look_geometry(p, sat_pos[ci])
        b_half = max(b_half, half * (abs(col_dir[0]) + abs(col_dir[1])))
        a_half = max(a_half, half * (abs(row_dir[0]) + abs(row_dir[1])))
        dy_min = min(dy_min, stride * dr_per_sample / u_g)
    margin_rows = 16
    # factorized merge: the Kaiser-sinc interpolator reaches _UPS_D coarse
    # samples (~_UPS_D * h fine px) past each fine pixel, so give the
    # columns that much extra margin to keep edge truncation off the scene
    margin_cols = 12 + (64 if factorize else 0)
    ny_req = 2 * (int(np.ceil(b_half / dy_min)) + margin_rows)
    nx_i = 2 * (int(np.ceil(a_half / dx_m)) + margin_cols)
    nx_i = -(-nx_i // 128) * 128          # 128-multiples

    nfft = 1 << (p.num_samples - 1).bit_length()
    d0 = np.linalg.norm(sat_pos, axis=1)
    t_ref = float(2.0 * np.mean(d0) / _C)
    n_org = (t_ref - float(t_start)) * p.fs_hz
    # prefer a 128-multiple row count; fall back to the minimal 8-multiple
    # when the padded band would overflow the window (tiny test scenes)
    # The fused matched filter (compress=True) is a circular convolution at
    # nfft. The linear convolution of the ns-sample window with the
    # n_ref-sample chirp spans ns + n_ref - 1 samples, so the circular wrap
    # contaminates exactly [0, ns + n_ref - 1 - nfft) — prefer placements
    # keeping the band clear of it; fall back to the loose in-window bound
    # with a warning (compression near the wrap interval then deviates from
    # linear-convolution semantics).
    n_ref = int(p.pulse_width_s * p.fs_hz)
    wrap_end = max(0, p.num_samples + n_ref - 1 - nfft)
    candidates = (-(-ny_req // 128) * 128, -(-ny_req // 8) * 8)

    def _placement(ny_i):
        bs = int(round(n_org - 0.5 - ((ny_i - 1) / 2.0) * stride
                       - w_win / 2.0))
        return bs, stride * (ny_i - 1) + w_win

    band_start = n_band = ny_i = 0
    for ny_i in candidates:
        band_start, n_band = _placement(ny_i)
        if band_start >= 0 and band_start + n_band <= nfft:
            break
    else:
        raise ValueError(
            f"scene band [{band_start}, {band_start + n_band}) does not fit "
            f"the receive window (nfft={nfft}); enlarge num_samples or "
            "reduce scene_size_m")
    if band_start < wrap_end:
        import warnings
        warnings.warn(
            f"fast-BP band [{band_start}, {band_start + n_band}) overlaps "
            f"the circular-convolution wrap interval [0, {wrap_end}) of "
            "the fused matched filter (compress=True); compression "
            "semantics deviate from the linear variant there",
            stacklevel=2)

    sub_raw = nx_c = 0
    sub_raw1 = nx_c1 = grp = 0
    if factorize:
        # coarse columns: a 128-multiple, ~4-6x coarser than the fine grid
        nx_c = 128 if nx_i >= 512 else max(32, nx_i // 4)
        h = nx_i / nx_c
        row_dir_c, col_dir_c, u_gc = _look_geometry(
            p, sat_pos[sat_pos.shape[0] // 2])
        dy_c = stride * dr_per_sample / u_gc
        f_val, dpb_raw, dpcx_raw = _factor_bounds(p, sat_pos, ny_i, nx_i,
                                                  dy_c, dx_m)
        # inner-sum content budget: 80% of the coarse Nyquist, minus the
        # value field's own bandwidth; the rest is Doppler span
        avail = 0.8 * 0.25 / h - f_val
        rate = dpb_raw + dpcx_raw            # rad/px per raw pulse
        if avail > 0.1 * 0.25 / h and rate > 0.0:
            sub_raw = int(2.0 * avail * _TWO_PI / rate)
            sub_raw = max(1, min(sub_raw, sat_pos.shape[0]))
        if sub_raw == 0:
            nx_c = 0                         # bounds refuse: fall back
        else:
            # second level: inner sums on nx_c1 = nx_c/2 columns. Budget
            # split on the nx_c grid: the level-1 images occupy their full
            # band B/h1; the rest (s2 = B/h2 - B/h1) is the level-1-anchor
            # Doppler-offset allowance, which bounds how many level-1
            # sub-apertures one group may span. Edge rule: the level-1
            # merge kernel's support must stay inside the planned column
            # margin (_UPS1_D * h1 <= margin_cols - mask guard).
            nx_c1 = nx_c // 2
            h1 = nx_i / nx_c1
            s1 = 0.8 * 0.25 / h1 - f_val
            s2 = 0.8 * 0.25 / h - 0.8 * 0.25 / h1
            if (nx_c1 >= 16 and s1 > 0.1 * 0.25 / h1 and rate > 0.0
                    and _UPS1_D * h1 <= margin_cols - 4):
                sub_raw1 = int(2.0 * s1 * _TWO_PI / rate)
                sub_raw1 = max(1, min(sub_raw1, sub_raw))
                grp = 1 + int(2.0 * s2 * _TWO_PI / (rate * sub_raw1))
            if sub_raw1 < 1 or grp < 2:
                sub_raw1 = nx_c1 = grp = 0   # no win: single level only
    return FastBpPlan(
        ny_i=ny_i, nx_i=nx_i, w_win=w_win, stride=stride,
        band_start=band_start, nfft=nfft, dx_m=float(dx_m),
        t_ref=t_ref, n_org=float(n_org), sub_raw=sub_raw, nx_c=nx_c,
        sub_raw1=sub_raw1, nx_c1=nx_c1, grp=grp)


# --------------------------------------------------------------------------
# recentred presum (shared machinery with ops/bp.py, minus the un-recentre)
# --------------------------------------------------------------------------

def matched_filter_spectrum(p: BpParams, nfft: int) -> jnp.ndarray:
    """Conjugate reference-chirp spectrum at the padded length ``nfft`` —
    the same centered/fftshifted construction as ops/bp.py::
    bp_range_compress (sar_batch_sim.py:180-186), evaluated once at the
    power-of-two length so compression fuses into the recentre FFT."""
    n_ref = int(p.pulse_width_s * p.fs_hz)
    t_ref = np.linspace(-p.pulse_width_s / 2.0, p.pulse_width_s / 2.0, n_ref)
    ref = np.exp(1j * np.pi * p.chirp_rate * t_ref ** 2)
    ref_f = np.fft.fft(np.fft.fftshift(ref), n=nfft)
    return np.conj(ref_f).astype(np.complex64)   # numpy: safe inside traces


def recenter_presum(rc, sat_pos, sat_vel, t_slow, vel_focus, p: BpParams,
                    d: int, t_ref: float, ref_conj=None, t_mean=None):
    """Recentre every pulse to the moving scene origin at the *fixed* delay
    ``t_ref`` and box-presum by ``d`` — identical math to
    ops/bp.py::presum_recenter (:213) but returning the *recentred* pulses
    (the fast path works in recentred coordinates, saving the un-recentre
    FFT round trip). Returns (rc_c2[P2, nfft], pos2, vel2, t2).

    ``ref_conj`` (nfft,) fuses range compression into the same FFT round
    trip (see :func:`matched_filter_spectrum`): the matched filter becomes
    a *linear* convolution at the padded power-of-two length instead of the
    reference's circular convolution at the native (often non-power-of-two,
    hence Bluestein-slow) length — identical away from the first/last
    ``len(ref)`` samples, which the scene band never touches (the plan
    guards the band placement)."""
    num_p = rc.shape[0]
    ns = rc.shape[1]
    dt = t_slow - (jnp.mean(t_slow) if t_mean is None else t_mean)
    org = vel_focus[None, :] * dt[:, None]
    d0 = jnp.linalg.norm(sat_pos - org, axis=1)

    p_pad = -(-num_p // d) * d
    w = jnp.pad(jnp.ones((num_p,), jnp.float32), (0, p_pad - num_p))
    rc = jnp.pad(rc, ((0, p_pad - num_p), (0, 0)), mode="edge")
    d0_p = jnp.pad(d0, (0, p_pad - num_p), mode="edge")

    shift = (2.0 * d0_p / _C - t_ref) * p.fs_hz
    nfft = 1 << (ns - 1).bit_length()
    f_bins = jnp.fft.fftfreq(nfft)
    car = _TWO_PI * (2.0 * p.fc_hz / _C) * d0_p

    def ramp(phase64):
        ph = (phase64 - _TWO_PI * jnp.round(phase64 / _TWO_PI)
              ).astype(jnp.float32)
        return jax.lax.complex(jnp.cos(ph), jnp.sin(ph))

    spec = jnp.fft.fft(rc, n=nfft, axis=-1)
    if ref_conj is not None:
        spec = spec * ref_conj[None, :]
    spec = spec * ramp(_TWO_PI * f_bins[None, :] * shift[:, None])
    rc_c = jnp.fft.ifft(spec, axis=-1) * ramp(car)[:, None]

    wb = w.reshape(-1, d)
    rc_b = (rc_c.reshape(-1, d, nfft) * wb[:, :, None].astype(jnp.complex64)
            ).sum(axis=1) / jnp.float32(d)

    ci = jnp.arange(p_pad // d) * d + (d // 2)
    ci = jnp.minimum(ci, num_p - 1)
    return (rc_b.astype(jnp.complex64), sat_pos[ci], sat_vel[ci], t_slow[ci])


# --------------------------------------------------------------------------
# exact per-(pulse,row) coefficients (f64 delta-range physics, 3-point fit)
# --------------------------------------------------------------------------

def _idx_phase_exact(g, pos, vel, vf, p: BpParams, plan: FastBpPlan):
    """Exact recentred (sample index, unwrapped phase) for pixel positions.

    g: (..., 3) moving-grid pixel positions, pos/vel: (..., 3) per-pulse
    (broadcastable). All f64. Mirrors ops/bp.py::backproject's block body
    (delta-range Newton, Doppler re-centering, stop-and-go Rx; see
    sar_batch_sim.py:207-235 for the semantics being reproduced).
    """
    d0 = jnp.linalg.norm(pos, axis=-1)
    gp = jnp.sum(g * pos, axis=-1)
    g2 = jnp.sum(g * g, axis=-1)
    num = g2 - 2.0 * gp
    d1 = num / (2.0 * d0)
    delta = num / (2.0 * d0 + d1)
    d_tx = d0 + delta

    u = g - pos
    v_rel = vel - vf
    v_rad = jnp.sum(v_rel * u, axis=-1) / d_tx
    t_shift = (-p.fc_hz * 2.0 / (_C * p.chirp_rate)) * v_rad

    tau_a = 2.0 * d_tx / _C
    w_vec = (vf - vel) * tau_a[..., None]
    uw = 2.0 * jnp.sum(u * w_vec, axis=-1) + jnp.sum(w_vec * w_vec, axis=-1)
    drx1 = uw / (2.0 * d_tx)
    delta_rx = uw / (2.0 * d_tx + drx1)

    dtau = (2.0 * delta + delta_rx) / _C
    idx = plan.n_org + (dtau + t_shift) * p.fs_hz - 0.5
    phase = (_TWO_PI * p.fc_hz / _C) * (2.0 * delta + delta_rx)
    return idx, phase


from nis_sar_amtigmti_video_tpu.utils.anchors import (anchor_plan as
                                                      _anchor_plan)


def _fit_coeffs(pos2, vel2, t2, vel_focus, p: BpParams, plan: FastBpPlan,
                t_mean, rdir, cdir, dy_m, fit_stride: int = 0):
    """Per-(t,y) window offset u0 and phase quadratic (Pa, Pb, Pc); per-t
    index quadratic (B, C). xi is the centred column index.

    ``fit_stride`` > 0 evaluates the exact f64 physics only at anchor
    pulses every ``fit_stride`` rows and quadratically interpolates the
    unwrapped (index, phase) fields in slow time — the f64
    geometry is the fit's whole cost, and the fields' cubic-in-t residual
    over a 2*stride window is ~1e-5 rad / ~1e-6 samples at the reference
    geometry (phase jerk ~700 rad/s^3), far inside the oracle budgets.
    """
    ny, nx = plan.ny_i, plan.nx_i
    b = (jnp.arange(ny, dtype=jnp.float64) - (ny - 1) / 2.0) * dy_m
    xi_max = (nx - 1) / 2.0
    a_max = xi_max * plan.dx_m

    num_p = pos2.shape[0]
    use_anchor = fit_stride > 1 and num_p > 3 * fit_stride
    if use_anchor:
        needed, trip, w_np = _anchor_plan(num_p, fit_stride)
        pos2_a, vel2_a, t2_a = pos2[needed], vel2[needed], t2[needed]
    else:
        pos2_a, vel2_a, t2_a = pos2, vel2, t2

    dt = (t2_a - t_mean)
    org = vel_focus[None, :] * dt[:, None]                    # (P,3) moving grid

    # Work in origin-relative coordinates: the recentre removed the delay and
    # carrier of the *moving* origin, so the delta-range reference must be
    # d0 = |pos - org|. Shifting both pixel and platform by -org keeps every
    # relative distance identical while making _idx_phase_exact's d0 the
    # recentred reference.
    base = b[None, :, None, None] * cdir[None, None, None, :]
    xoff = (jnp.asarray([-a_max, 0.0, a_max])[None, None, :, None]
            * rdir[None, None, None, :])
    g = base + xoff
    pos = (pos2_a - org)[:, None, None, :]
    vel = vel2_a[:, None, None, :]
    idx, ph = _idx_phase_exact(g, pos, vel, vel_focus, p, plan)
    row0 = plan.band_start + plan.stride * jnp.arange(ny)
    cidx = ny // 2

    if use_anchor:
        # Interpolate the DERIVED coefficients, not the raw (P, ny, 3) f64
        # fields: the quadratic interpolation is linear, so it commutes
        # with the differencing below, and every derived quantity except
        # the unwrapped pa is small enough for f32, so the (P, ny, 3)
        # multiply-add chains need no f64.
        w64 = jnp.asarray(w_np)                               # (P, 3) f64
        a0, a1, a2 = (jnp.asarray(trip[:, k]) for k in range(3))

        def qinterp(v, w):
            sh = (-1,) + (1,) * (v.ndim - 1)
            return (w[:, 0].reshape(sh) * v[a0]
                    + w[:, 1].reshape(sh) * v[a1]
                    + w[:, 2].reshape(sh) * v[a2])

        w32 = w64.astype(jnp.float32)
        f32 = jnp.float32
        u0 = qinterp((idx[..., 1] - row0[None, :]).astype(f32), w32)
        pb = qinterp(((ph[..., 2] - ph[..., 0]) / (2.0 * xi_max)
                      ).astype(f32), w32)
        pc = qinterp(((ph[..., 2] + ph[..., 0] - 2.0 * ph[..., 1])
                      / (2.0 * xi_max ** 2)).astype(f32), w32)
        b_t = qinterp(((idx[:, cidx, 2] - idx[:, cidx, 0])
                       / (2.0 * xi_max)).astype(f32), w32)
        c_t = qinterp(((idx[:, cidx, 2] + idx[:, cidx, 0]
                        - 2.0 * idx[:, cidx, 1])
                       / (2.0 * xi_max ** 2)).astype(f32), w32)
        # pa is ~1e6 rad unwrapped: split into per-anchor and per-row
        # marginals (1-D, kept f64) plus the ~1e3-rad cross residual
        # (f32-safe: 6e-8 relative ~ 1e-4 rad, inside the 1e-3 budget)
        pa_a = ph[..., 1]                                     # (Pa, ny)
        ca = pa_a[:, cidx]                                    # (Pa,) f64
        ea = pa_a[pa_a.shape[0] // 2] - ca[pa_a.shape[0] // 2]
        ra = (pa_a - ca[:, None] - ea[None, :]).astype(f32)

        def wrap64(v):
            return (v - _TWO_PI * jnp.round(v / _TWO_PI)).astype(f32)

        pa_sum = (wrap64(qinterp(ca, w64))[:, None] + wrap64(ea)[None, :]
                  + qinterp(ra, w32))
        pa_w = pa_sum - f32(_TWO_PI) * jnp.round(pa_sum / f32(_TWO_PI))
        return u0, pa_w, pb, pc, b_t, c_t

    # phase quadratic per (t, y) in centred column units
    pa = ph[..., 1]
    pb = (ph[..., 2] - ph[..., 0]) / (2.0 * xi_max)
    pc = (ph[..., 2] + ph[..., 0] - 2.0 * ph[..., 1]) / (2.0 * xi_max ** 2)
    pa_w = (pa - _TWO_PI * jnp.round(pa / _TWO_PI)).astype(jnp.float32)

    # window-local offset per (t, y): exact centre index minus window origin
    u0 = (idx[..., 1] - row0[None, :]).astype(jnp.float32)

    # index quadratic per t from the centre row (y-variation of the slope is
    # the xy cross-term, < 3e-3 samples at reference geometry)
    b_t = ((idx[:, cidx, 2] - idx[:, cidx, 0]) / (2.0 * xi_max)
           ).astype(jnp.float32)
    c_t = ((idx[:, cidx, 2] + idx[:, cidx, 0] - 2.0 * idx[:, cidx, 1])
           / (2.0 * xi_max ** 2)).astype(jnp.float32)
    return (u0, pa_w, pb.astype(jnp.float32), pc.astype(jnp.float32),
            b_t, c_t)


# --------------------------------------------------------------------------
# windowed-Fourier row interpolation + phase accumulation
# --------------------------------------------------------------------------

def _taper(u, w: int, power: int):
    """Continuous periodic cosine-power taper, >0 away from window edges."""
    return jnp.sin(jnp.pi * (u + 0.5) / w) ** power


def _extract_windows(band, plan: FastBpPlan):
    """(P, n_band) -> (P, ny_i, W), gather-free AND stride-free.

    The W-strided-slice formulation (one slice per window column) costs W
    strided reads of 8-byte elements at a 96-byte pitch. Because
    consecutive windows advance by a fixed stride k, the same windows are
    ceil(W/k) *contiguous* row-shifted views of the band reshaped to k-wide
    blocks: window y = [blk[y], blk[y+1], ..., blk[y+nb-1][:W-(nb-1)k]] —
    nb big sequential slices + one concat instead of W strided passes.
    Bit-identical output."""
    ny, w, k = plan.ny_i, plan.w_win, plan.stride
    nb = -(-w // k)
    need = (ny + nb - 1) * k
    pad = need - band.shape[-1]
    if pad > 0:
        # pad only feeds block rows >= ny of the reshape; every cell the
        # slices below actually read maps inside the original band
        band = jnp.pad(band, [(0, 0)] * (band.ndim - 1) + [(0, pad)])
    blk = band[..., :need].reshape(band.shape[:-1] + (ny + nb - 1, k))
    ax = blk.ndim - 2
    if nb == 1:
        return jax.lax.slice_in_dim(blk, 0, ny, 1, axis=ax)[..., :w]
    pieces = [jax.lax.slice_in_dim(blk, i, i + ny, 1, axis=ax)
              for i in range(nb - 1)]
    last = jax.lax.slice_in_dim(blk, nb - 1, nb - 1 + ny, 1, axis=ax)
    pieces.append(last[..., :w - (nb - 1) * k])
    return jnp.concatenate(pieces, axis=-1)


@lru_cache(maxsize=None)
def _window_filter(w: int, k: int, taper_pow: int) -> np.ndarray:
    """(2w, 2, w) f32 conv filter: tapered window DFT as a strided conv.

    Output channels [0, w) are the real parts of the w DFT bins (fftfreq
    order), [w, 2w) the imaginary parts; input channels are (re, im) of the
    band. Folding the taper and the 1/w DFT normalization into the filter
    makes `conv(band, filter, stride=k)` exactly fft(win * tap)/w per row.
    """
    s = np.arange(w)
    fmat = np.exp(-2j * np.pi * np.outer(s, s) / w) / w       # (s, m)
    tap = np.sin(np.pi * (s + 0.5) / w) ** taper_pow
    gmat = tap[:, None] * fmat
    filt = np.zeros((2 * w, 2, w), np.float32)
    filt[:w, 0, :] = gmat.real.T
    filt[:w, 1, :] = -gmat.imag.T
    filt[w:, 0, :] = gmat.imag.T
    filt[w:, 1, :] = gmat.real.T
    return filt


def _window_spectra(band, plan: FastBpPlan):
    """(T, n_band) complex -> (T, w, ny) tapered window spectra via ONE
    strided convolution straight from the flat band.

    Numerically equal (f32 class) to transposing
    ``fft(_extract_windows(band) * tap, axis=-1) / w`` to (t, m, y) — but
    with no (.., ny, w) intermediates: both conv operands and the output
    keep a full-length minor dim.
    """
    w, k = plan.w_win, plan.stride
    filt = jnp.asarray(_window_filter(w, k, plan.taper_pow))
    x = jnp.stack([jnp.real(band), jnp.imag(band)], axis=1)   # (T, 2, n)
    out = jax.lax.conv_general_dilated(
        x, filt, window_strides=(k,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)                  # (T, 2w, ny)
    return jax.lax.complex(out[:, :w], out[:, w:])


def _accumulate(rc2, u0, pa, pb, pc, b_t, c_t, plan: FastBpPlan,
                block: int = 32):
    """sum_t value[t,y,x] * expj(phase[t,y,x]) over pulse blocks."""
    num_p = rc2.shape[0]
    w = plan.w_win
    ny, nx = plan.ny_i, plan.nx_i
    f_m = jnp.fft.fftfreq(w).astype(jnp.float32)              # signed cyc/sample
    xi = (jnp.arange(nx, dtype=jnp.float32) - (nx - 1) / 2.0)

    band = jax.lax.slice_in_dim(
        rc2, plan.band_start,
        plan.band_start + plan.stride * (ny - 1) + w, 1, axis=1)

    pb_pad = -(-num_p // block) * block

    def padp(x):
        cfg = [(0, pb_pad - num_p)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfg).reshape((pb_pad // block, block) + x.shape[1:])

    w_live = jnp.pad(jnp.ones((num_p,), jnp.float32), (0, pb_pad - num_p))
    xs = (padp(band), padp(u0), padp(pa), padp(pb), padp(pc),
          padp(b_t), padp(c_t), w_live.reshape(-1, block))

    def step(img, x):
        band_b, u0_b, pa_b, pb_b, pc_b, bt_b, ct_b, wl_b = x
        w_hat = _window_spectra(band_b, plan)                 # (B, W, ny)
        # per-(t,y) ramp to the exact window offset
        g = w_hat * expj(_TWO_PI * f_m[None, :, None] * u0_b[:, None, :])
        # per-t kernel over columns: e_t(xi) = B xi + C xi^2
        e_t = bt_b[:, None] * xi[None, :] + ct_b[:, None] * xi[None, :] ** 2
        kern = expj(_TWO_PI * f_m[None, :, None] * e_t[:, None, :])
        val = jnp.einsum("tmy,tmx->tyx", g, kern,
                         precision=jax.lax.Precision.HIGHEST)
        # undo the taper at the true evaluation positions (floor keeps the
        # division finite for zero-padded pulses, whose weight is 0 anyway)
        u = u0_b[:, :, None] + e_t[:, None, :]
        val = val / jnp.maximum(_taper(u, w, plan.taper_pow), 1e-4)
        phase = (pa_b[:, :, None] + pb_b[:, :, None] * xi[None, None, :]
                 + pc_b[:, :, None] * xi[None, None, :] ** 2)
        contrib = val * expj(phase) * wl_b[:, None, None]
        return img + jnp.sum(contrib, axis=0), None

    img0 = jnp.zeros((ny, nx), jnp.complex64)
    img, _ = jax.lax.scan(step, img0, xs)
    return img


def _taper_field(u0_b, e_t, w: int, taper_pow: int):
    """Taper at u = u0[t,y] + e_t[t,x] via the angle-sum identity: trig on
    the (t,y) and (t,x) marginals only, never on the full (t,y,x) field
    (the plain path's single biggest trig bill)."""
    if taper_pow % 2 == 0:
        aa = (jnp.pi / w) * (u0_b + 0.5)                     # (sub, ny)
        bb = (jnp.pi / w) * e_t                              # (sub, nxc)
        s_u = (jnp.sin(aa)[:, :, None] * jnp.cos(bb)[:, None, :]
               + jnp.cos(aa)[:, :, None] * jnp.sin(bb)[:, None, :])
        t2_ = s_u * s_u
        return t2_ * t2_ if taper_pow == 4 else t2_ ** (taper_pow // 2)
    return _taper(u0_b[:, :, None] + e_t[:, None, :], w, taper_pow)


def _cein_tyx(g, kern, prec: str):
    """The factor-accumulate's (t,m,y)x(t,m,x)->(t,y,x) complex einsum with
    stated precision: 'highest' is full f32; 'bf16x3' is the explicit
    bf16 hi/lo split (~5e-6); 'default' is the backend's fastest f32 class
    (TF32 on the GPU, ~1e-3)."""
    if prec == "highest":
        return jnp.einsum("tmy,tmx->tyx", g, kern,
                          precision=jax.lax.Precision.HIGHEST)
    if prec == "default":
        return jnp.einsum("tmy,tmx->tyx", g, kern,
                          precision=jax.lax.Precision.DEFAULT)
    ein = partial(jnp.einsum, "tmy,tmx->tyx",
                  preferred_element_type=jnp.float32)

    def d3(a, b):
        ah = a.astype(jnp.bfloat16)
        al = (a - ah.astype(jnp.float32)).astype(jnp.bfloat16)
        bh = b.astype(jnp.bfloat16)
        bl = (b - bh.astype(jnp.float32)).astype(jnp.bfloat16)
        return ein(ah, bh) + ein(al, bh) + ein(ah, bl)

    gr, gi = jnp.real(g), jnp.imag(g)
    kr, ki = jnp.real(kern), jnp.imag(kern)
    return jax.lax.complex(d3(gr, kr) - d3(gi, ki),
                           d3(gr, ki) + d3(gi, kr))


def _accumulate_factor(rc2, u0, pa, pb, pc, b_t, c_t, plan: FastBpPlan,
                       sub_p: int, einsum_prec: str = "highest"):
    """Factorized (sub-aperture) accumulation — the algorithmic answer to
    the per-pulse-per-pixel trig floor.

    Within a sub-aperture of ``sub_p`` presummed pulses, split each pulse's
    focusing phase against the sub-aperture *anchor* (centre) pulse:

        exp(j ph_t(x)) = exp(j ph_c(x)) * exp(j (ph_t - ph_c)(x))

    The residual's x-slope is the pulse's Doppler offset from the anchor —
    bounded by the sub-aperture's Doppler span — so the inner sum

        J_s(y, xc) = sum_t val * exp(j d_ph)          (coarse columns xc)

    is band-limited and needs only ``plan.nx_c`` columns (~4-6x fewer
    pixels, hence that much less trig and matmul). Each J_s is brought to
    the fine grid by one banded interpolation matmul (Kaiser-sinc,
    ~-100 dB) and multiplied by its anchor carrier, evaluated once per
    sub-aperture instead of once per pulse:

        img = sum_s carrier_s * (J_s @ U)

    Trig count drops from P*ny*nx to P*ny*nx_c + S*ny*nx. Phase totals are
    exact (anchor + exact-fit residual); the only new approximation is the
    band-limited merge, sized by :func:`make_plan`'s measured Doppler-rate
    bounds. Same operand contract as :func:`_accumulate`. Reference
    semantics covered: sar_batch_sim.py:171-238.
    """
    num_p = rc2.shape[0]
    w = plan.w_win
    ny, nx, nxc = plan.ny_i, plan.nx_i, plan.nx_c
    h = nx / nxc
    f_m = jnp.fft.fftfreq(w).astype(jnp.float32)
    xi = (jnp.arange(nx, dtype=jnp.float32) - (nx - 1) / 2.0)
    xic = (jnp.arange(nxc, dtype=jnp.float32) - (nxc - 1) / 2.0
           ) * jnp.float32(h)
    u_mat = jnp.asarray(_upsample_matrix(plan))

    band = jax.lax.slice_in_dim(
        rc2, plan.band_start,
        plan.band_start + plan.stride * (ny - 1) + w, 1, axis=1)

    n_sub = -(-num_p // sub_p)
    p_pad = n_sub * sub_p
    m_prec = (jax.lax.Precision.DEFAULT if einsum_prec == "default"
              else jax.lax.Precision.HIGHEST)

    def padp(x, edge=False):
        cfg = [(0, p_pad - num_p)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfg, mode="edge" if edge else "constant").reshape(
            (n_sub, sub_p) + x.shape[1:])

    # anchor (centre-pulse) coefficient rows per sub-aperture; clipped so a
    # ragged final sub-aperture anchors on a live pulse
    ci = jnp.minimum(jnp.arange(n_sub) * sub_p + sub_p // 2, num_p - 1)
    pa_c, pb_c, pc_c = pa[ci], pb[ci], pc[ci]

    w_live = jnp.pad(jnp.ones((num_p,), jnp.float32), (0, p_pad - num_p))
    xs = (padp(band), padp(u0, edge=True), padp(pa, edge=True),
          padp(pb, edge=True), padp(pc, edge=True), padp(b_t, edge=True),
          padp(c_t, edge=True), w_live.reshape(n_sub, sub_p),
          pa_c, pb_c, pc_c)

    def step(img, x):
        (band_b, u0_b, pa_b, pb_b, pc_b, bt_b, ct_b, wl_b,
         pac, pbc, pcc) = x
        w_hat = _window_spectra(band_b, plan)                # (sub, W, ny)
        g = w_hat * expj(_TWO_PI * f_m[None, :, None] * u0_b[:, None, :])
        e_t = bt_b[:, None] * xic[None, :] + ct_b[:, None] * xic[None, :] ** 2
        kern = expj(_TWO_PI * f_m[None, :, None] * e_t[:, None, :])
        val = _cein_tyx(g, kern, einsum_prec)
        val = val / jnp.maximum(
            _taper_field(u0_b, e_t, w, plan.taper_pow), 1e-4)
        d_ph = ((pa_b - pac[None])[:, :, None]
                + (pb_b - pbc[None])[:, :, None] * xic[None, None, :]
                + (pc_b - pcc[None])[:, :, None] * xic[None, None, :] ** 2)
        j_s = jnp.sum(val * expj(d_ph) * wl_b[:, None, None], axis=0)
        # the merge matmul is tiny (one (ny, nxc) @ (nxc, nx) per
        # sub-aperture) — run it exact unless math_mode='fast' asked for
        # the single-pass bf16 class throughout
        j_up = jnp.matmul(j_s, u_mat, precision=m_prec)      # (ny, nx)
        carrier = expj(pac[:, None] + pbc[:, None] * xi[None, :]
                       + pcc[:, None] * xi[None, :] ** 2)
        return img + carrier * j_up, None

    img0 = jnp.zeros((ny, nx), jnp.complex64)
    img, _ = jax.lax.scan(step, img0, xs)
    return img


def _accumulate_factor2(rc2, u0, pa, pb, pc, b_t, c_t, plan: FastBpPlan,
                        sub_p1: int, grp: int,
                        einsum_prec: str = "highest"):
    """Two-level factorized accumulation (the follow-through to
    :func:`_accumulate_factor`).

    Every per-pulse cost of the single-level path — the inner-sum trig and
    taper fields, the (t, m, y) x (t, m, x) einsum, and the (t, y, nx_c)
    HBM intermediates — scales with the coarse column count, so running
    the inner sums on ``plan.nx_c1`` = nx_c/2 columns halves all of them.
    The price is a second (cheap) merge level:

        level 1:  J1_i(y, xc1) = sum_t val * exp(j(ph_t - ph_a1))     (nx_c1)
        level 2:  J2_j(y, xc2) = sum_{i in group j}
                      exp(j(ph_a1 - ph_a2)) * (J1_i @ U12)            (nx_c)
        final:    img += exp(j ph_a2) * (J2_j @ U)                    (nx_i)

    where a1/a2 are the level-1/level-2 anchor pulses. Phase totals stay
    exact (a2 + (a1 - a2) + (t - a1) telescopes); the new approximations
    are the level-1 band-limited merge (~-73 dB, :func:`_upsample_matrix_l1`)
    and the budget split sized by :func:`make_plan`: the level-1 images
    keep their full band on the nx_c grid, and the level-1-anchor Doppler
    offsets within a group are bounded by the remaining band (s2), so the
    final merge sees content inside the same alias-free budget as the
    single-level path. Same operand contract as :func:`_accumulate`.
    Reference semantics covered: sar_batch_sim.py:171-238.
    """
    num_p = rc2.shape[0]
    w = plan.w_win
    ny, nx, nxc, nxc1 = plan.ny_i, plan.nx_i, plan.nx_c, plan.nx_c1
    f_m = jnp.fft.fftfreq(w).astype(jnp.float32)
    xi = (jnp.arange(nx, dtype=jnp.float32) - (nx - 1) / 2.0)
    xic = (jnp.arange(nxc, dtype=jnp.float32) - (nxc - 1) / 2.0
           ) * jnp.float32(nx / nxc)
    xic1 = (jnp.arange(nxc1, dtype=jnp.float32) - (nxc1 - 1) / 2.0
            ) * jnp.float32(nx / nxc1)
    u_mat = jnp.asarray(_upsample_matrix(plan))
    u12 = jnp.asarray(_upsample_matrix_l1(plan))

    band = jax.lax.slice_in_dim(
        rc2, plan.band_start,
        plan.band_start + plan.stride * (ny - 1) + w, 1, axis=1)

    t_grp = grp * sub_p1                     # pulses per level-2 group
    n_sub2 = -(-num_p // t_grp)
    p_pad = n_sub2 * t_grp
    m_prec = (jax.lax.Precision.DEFAULT if einsum_prec == "default"
              else jax.lax.Precision.HIGHEST)

    def padp(x, edge=False):
        cfg = [(0, p_pad - num_p)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfg, mode="edge" if edge else "constant").reshape(
            (n_sub2, t_grp) + x.shape[1:])

    # level-1 anchors (one per sub-aperture, clipped to live pulses) and
    # level-2 anchors (one per group)
    i1 = jnp.arange(n_sub2 * grp)
    ci1 = jnp.minimum(i1 * sub_p1 + sub_p1 // 2, num_p - 1)
    cj = jnp.minimum(jnp.arange(n_sub2) * t_grp + t_grp // 2, num_p - 1)

    def a1(v):
        return v[ci1].reshape(n_sub2, grp, *v.shape[1:])

    w_live = jnp.pad(jnp.ones((num_p,), jnp.float32), (0, p_pad - num_p))
    xs = (padp(band), padp(u0, edge=True), padp(pa, edge=True),
          padp(pb, edge=True), padp(pc, edge=True), padp(b_t, edge=True),
          padp(c_t, edge=True), w_live.reshape(n_sub2, t_grp),
          a1(pa), a1(pb), a1(pc), pa[cj], pb[cj], pc[cj])

    def step(img, x):
        (band_b, u0_b, pa_b, pb_b, pc_b, bt_b, ct_b, wl_b,
         pa1, pb1, pc1, pa2, pb2, pc2) = x
        w_hat = _window_spectra(band_b, plan)               # (T, W, ny)
        g = w_hat * expj(_TWO_PI * f_m[None, :, None] * u0_b[:, None, :])
        e_t = (bt_b[:, None] * xic1[None, :]
               + ct_b[:, None] * xic1[None, :] ** 2)
        kern = expj(_TWO_PI * f_m[None, :, None] * e_t[:, None, :])
        val = _cein_tyx(g, kern, einsum_prec)               # (T, ny, nxc1)
        val = val / jnp.maximum(
            _taper_field(u0_b, e_t, w, plan.taper_pow), 1e-4)
        # residual phase vs the pulse's LEVEL-1 anchor
        pa_r = jnp.repeat(pa1, sub_p1, axis=0)              # (T, ny)
        pb_r = jnp.repeat(pb1, sub_p1, axis=0)
        pc_r = jnp.repeat(pc1, sub_p1, axis=0)
        d_ph = ((pa_b - pa_r)[:, :, None]
                + (pb_b - pb_r)[:, :, None] * xic1[None, None, :]
                + (pc_b - pc_r)[:, :, None] * xic1[None, None, :] ** 2)
        contrib = val * expj(d_ph) * wl_b[:, None, None]
        j1 = contrib.reshape(grp, sub_p1, ny, nxc1).sum(axis=1)
        # both merge matmuls are tiny — run them exact unless
        # math_mode='fast' asked for the single-pass bf16 class throughout
        j12 = jnp.einsum("gyc,cd->gyd", j1, u12,
                         precision=m_prec)                  # (grp, ny, nxc)
        car12 = expj((pa1 - pa2[None])[:, :, None]
                     + (pb1 - pb2[None])[:, :, None] * xic[None, None, :]
                     + (pc1 - pc2[None])[:, :, None] * xic[None, None, :] ** 2)
        j2 = jnp.sum(car12 * j12, axis=0)                   # (ny, nxc)
        j_up = jnp.matmul(j2, u_mat, precision=m_prec)      # (ny, nx)
        carrier = expj(pa2[:, None] + pb2[:, None] * xi[None, :]
                       + pc2[:, None] * xi[None, :] ** 2)
        return img + carrier * j_up, None

    img0 = jnp.zeros((ny, nx), jnp.complex64)
    img, _ = jax.lax.scan(step, img0, xs)
    return img


# --------------------------------------------------------------------------
# internal -> output grid resample (gather-free: FFT shears + sinc matmuls)
# --------------------------------------------------------------------------

def _resample_output(img_i, plan: FastBpPlan, p: BpParams, rdir, cdir, dy_m):
    """Internal (ny_i, nx_i) iso-range image -> (ny, nx) output grid.

    Output pixel (ix, iy) sits at world (x[ix], y[iy], 0); its internal
    coordinates are a = r.pos (columns), b = c.pos (rows). Decomposed as
    per-axis uniform scales (exact chirp-Z trig resampling, ops/czt.py) plus
    cross shifts (FFT ramps) — no gathers, no kernel droop.
    """
    from nis_sar_amtigmti_video_tpu.ops.czt import czt_eval

    r1, r2 = rdir[0], rdir[1]
    c1, c2 = cdir[0], cdir[1]
    half = p.scene_size_m / 2.0
    dy_out = p.scene_size_m / (p.ny - 1)
    dx_out = p.scene_size_m / (p.nx - 1)

    # pass 1 (rows axis): for points on output row iy at internal column a:
    # b(iy, a) = c1/r1 * a + (c2 - c1*r2/r1) * y[iy]. The per-column shear
    # term rides czt_eval's (now per-slice) start phase — no separate
    # FFT-ramp round trip (czt_eval docstring).
    a_cols = jnp.asarray(
        (np.arange(plan.nx_i) - (plan.nx_i - 1) / 2.0) * plan.dx_m)
    shear_b = (c1 / r1) * a_cols / dy_m                       # rows, per column
    scale_b = (c2 - c1 * r2 / r1)
    step_r = scale_b * dy_out / dy_m
    start_r = (scale_b * -half) / dy_m + (plan.ny_i - 1) / 2.0
    img = czt_eval(img_i, p.ny, step_r, start_r + shear_b, axis=0)

    # pass 2 (cols axis): a(ix, iy) = r1*x[ix] + r2*y[iy]
    y = jnp.asarray(np.linspace(-half, half, p.ny))
    shear_a = (r2 * y) / plan.dx_m                            # cols, per row
    step_c = r1 * dx_out / plan.dx_m
    start_c = (r1 * -half) / plan.dx_m + (plan.nx_i - 1) / 2.0
    return czt_eval(img, p.nx, step_c, start_c + shear_a, axis=1)


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

ACCUMULATES = ("xla", "factor", "factor2")


def pick_accumulate(plan: FastBpPlan) -> str:
    """The accumulate a factorized plan supports best: the two-level
    factorization where the plan sized a second level, the single level
    where it sized one, the plain scan otherwise."""
    if plan.sub_raw1 > 0:
        return "factor2"
    return "factor" if plan.sub_raw > 0 else "xla"


def accumulate_image(rc2, coeffs, plan: FastBpPlan, accumulate: str,
                     presum: int = 1, einsum_prec: str = "highest"):
    """Internal (ny_i, nx_i) image from recentred pulses ``rc2`` and the
    fit ``coeffs`` = (u0, pa, pb, pc, b_t, c_t) by the selected
    accumulate ('xla' scan, 'factor' or 'factor2' — the factorized forms
    fall back toward the plain scan when the plan sized no such level)."""
    if accumulate not in ACCUMULATES:
        raise ValueError(f"unknown BP accumulate {accumulate!r}; options: "
                         f"{', '.join(ACCUMULATES)}")
    d = max(1, presum)
    if accumulate == "factor2" and plan.sub_raw1 > 0:
        return _accumulate_factor2(rc2, *coeffs, plan,
                                   max(1, plan.sub_raw1 // d), plan.grp,
                                   einsum_prec=einsum_prec)
    if accumulate != "xla" and plan.sub_raw > 0:
        return _accumulate_factor(rc2, *coeffs, plan,
                                  max(1, plan.sub_raw // d),
                                  einsum_prec=einsum_prec)
    return _accumulate(rc2, *coeffs, plan)


@partial(jax.jit, static_argnames=("p", "plan", "presum", "compress",
                                   "accumulate", "fit_stride", "math_mode"))
def backproject_fast(rc, sat_pos, sat_vel, t_slow, vel_focus, p: BpParams,
                     plan: FastBpPlan, presum: int = 1, t_mean=None,
                     compress: bool = False, accumulate: str = "xla",
                     fit_stride: int = 0, math_mode: str = "exact",
                     raw_spectra=None, ring_offset=None):
    """Gather-free BP of range-compressed pulses onto the output grid.

    rc: (P, Ns) complex64; trajectory in f64; ``plan`` from :func:`make_plan`
    built with the *same* trajectory/t_start. Output matches
    ops/bp.py::backproject (with presum and high-quality interpolation) on
    (ny, nx). Scaling matches focus_bp's convention: the caller applies the
    ``presum`` rescale and droop correction.

    ``compress=True`` takes *raw* pulses and fuses the range matched filter
    into the recentre FFT round trip — at the production 22,004-sample shape
    this removes two non-power-of-two FFT passes (the power-of-two padded
    filter is the linear-convolution variant; see :func:`recenter_presum`).

    ``math_mode``: 'exact' keeps the factor einsums and merge matmuls at
    HIGHEST (f32-grade, the tested default); 'fast' runs them at the
    backend's DEFAULT precision (TF32 on the GPU) for the streaming-VideoSAR
    throughput path.

    ``raw_spectra``: cached (P, nfft) forward spectra from
    :func:`forward_spectra` (matched filter fused). Overlapped VideoSAR
    CPIs (80%: sar_batch_sim.py:244-252) share pulses, so the forward
    transform — the frame-independent half of the recentre pass — is
    computed once per pulse per collect; only the recentre ramp, presum and
    inverse run per frame (:func:`recentre_from_spectra`). Requires
    compress=True; ``rc`` is ignored (pass None).

    ``ring_offset`` (traced i32, pulses, a multiple of ``presum``): marks
    ``raw_spectra`` as a RING buffer — slot j holds chronological pulse
    (j - ring_offset) % P. The streaming product then advances its cached
    spectra window with one dynamic_update_slice per step instead of
    re-concatenating the full multi-hundred-MB window every frame.
    """
    if math_mode not in ("exact", "fast"):
        raise ValueError(f"unknown math_mode {math_mode!r}; options: "
                         "exact, fast")
    pos = jnp.asarray(sat_pos, jnp.float64)
    vel = jnp.asarray(sat_vel, jnp.float64)
    ts = jnp.asarray(t_slow, jnp.float64)
    vf = jnp.asarray(vel_focus, jnp.float64)
    t_mean_v = jnp.mean(ts) if t_mean is None else t_mean
    scope = jax.named_scope
    plan_acc = plan    # the plan the accumulate slices rc2 with (see below)
    with scope("bp_compress_recentre_presum"):
        if raw_spectra is not None:
            if not compress:
                raise ValueError("raw_spectra needs compress=True")
            if raw_spectra.shape[1] != plan.nfft:
                raise ValueError(
                    f"raw_spectra length ({raw_spectra.shape[1]}) does not "
                    f"match plan.nfft={plan.nfft}: the spectra were built "
                    "from pulses with a different num_samples than the "
                    "plan's")
            # only the iso-range band the accumulate reads comes back; rc2
            # is then band-relative, so only the accumulate's slicing plan
            # shifts (plan_acc) — the coefficient fit keeps the absolute-
            # sample plan (u0 is idx - row0 with BOTH terms absolute)
            band = (plan.band_start, plan.band_start
                    + plan.stride * (plan.ny_i - 1) + plan.w_win)
            rc2, pos2, vel2, t2 = recentre_from_spectra(
                raw_spectra, pos, vel, ts, vf, p, max(1, presum), plan.t_ref,
                t_mean=t_mean_v, out_band=band, ring_offset=ring_offset)
            plan_acc = _dc_replace(plan, band_start=0)
        else:
            ref_conj = (matched_filter_spectrum(p, plan.nfft)
                        if compress else None)
            rc2, pos2, vel2, t2 = recenter_presum(rc, pos, vel, ts, vf, p,
                                                  max(1, presum), plan.t_ref,
                                                  ref_conj=ref_conj,
                                                  t_mean=t_mean_v)
    with scope("bp_fit_coefficients"):
        rdir, cdir, dy_m = _frame_geometry(pos2[pos2.shape[0] // 2], p, plan)
        coeffs = _fit_coeffs(pos2, vel2, t2, vf, p, plan, t_mean_v, rdir,
                             cdir, dy_m, fit_stride=fit_stride)
    with scope("bp_accumulate"):
        img_i = accumulate_image(
            rc2, coeffs, plan_acc, accumulate, presum,
            einsum_prec="default" if math_mode == "fast" else "highest")

    return _finalize(img_i, coeffs[1:4], pos2, vel2, t2, vf, t_mean_v,
                     p, plan, rdir, cdir, dy_m)


def _finalize(img_i, phase_coeffs, pos2, vel2, t2, vf, t_mean_v, p: BpParams,
              plan: FastBpPlan, rdir, cdir, dy_m):
    """Post-accumulation pipeline shared by the single-device and sharded
    paths: margin mask -> centre-pulse carrier demodulation -> chirp-Z
    output resample -> analytic output-grid remodulation."""
    pa, pb, pc = phase_coeffs

    # The chirp-Z output resample is periodic: content in the margin
    # rows/cols (outside the requested scene footprint) would alias back
    # into the output — mask it to zero first (+small guard for the
    # interpolant's local support).
    half = p.scene_size_m / 2.0
    b_rows = (jnp.arange(plan.ny_i, dtype=jnp.float64)
              - (plan.ny_i - 1) / 2.0) * dy_m
    b_lim = half * (jnp.abs(cdir[0]) + jnp.abs(cdir[1])) + 4.0 * dy_m
    a_cols = jnp.asarray(
        (np.arange(plan.nx_i) - (plan.nx_i - 1) / 2.0) * plan.dx_m)
    a_lim = half * (jnp.abs(rdir[0]) + jnp.abs(rdir[1])) + 4.0 * plan.dx_m
    img_i = img_i * ((jnp.abs(b_rows) <= b_lim)[:, None]
                     & (jnp.abs(a_cols) <= a_lim)[None, :])

    # A BP image carries the spatial range carrier exp(-j*phi_tc(g)) (~2k u_g
    # rad/m), far beyond the grid Nyquist — demodulate with the exact
    # CPI-centre-pulse phase before resampling, remodulate on the output
    # grid with the same analytic phase.
    tc = pos2.shape[0] // 2
    xi = (jnp.arange(plan.nx_i, dtype=jnp.float32)
          - (plan.nx_i - 1) / 2.0)
    ph_int = (pa[tc][:, None] + pb[tc][:, None] * xi[None, :]
              + pc[tc][:, None] * xi[None, :] ** 2)
    img_i = img_i * expj(-ph_int)

    img = _resample_output(img_i, plan, p, rdir, cdir, dy_m)

    x = jnp.linspace(-p.scene_size_m / 2.0, p.scene_size_m / 2.0, p.nx)
    y = jnp.linspace(-p.scene_size_m / 2.0, p.scene_size_m / 2.0, p.ny)
    org_tc = vf * (t2[tc] - t_mean_v)
    pos_tc = (pos2[tc] - org_tc)[None, None, :]
    vel_tc = vel2[tc][None, None, :]

    h_out = 8
    if p.nx > 3 * h_out and p.ny > 3 * h_out:
        # anchored remodulation: exact f64 physics on a stride-8 sub-grid +
        # separable quadratic interpolation of the unwrapped phase (same
        # ~1e-5 rad residual class as the fit's slow-time anchors) — the
        # full-grid f64 evaluation was a measurable finalize cost
        nx_need, trip_x, w_x = _anchor_plan(p.nx, h_out)
        ny_need, trip_y, w_y = _anchor_plan(p.ny, h_out)
        gx, gy = jnp.meshgrid(x[nx_need], y[ny_need], indexing="xy")
        g_sub = jnp.stack([gx, gy, jnp.zeros_like(gx)], axis=-1
                          ).astype(jnp.float64)
        _, ph_sub = _idx_phase_exact(g_sub, pos_tc, vel_tc, vf, p, plan)
        phx = jnp.einsum("ank,nk->an", ph_sub[:, trip_x],
                         jnp.asarray(w_x))                    # (nya, nx)
        ph_out64 = jnp.einsum("mkn,mk->mn", phx[trip_y, :],
                              jnp.asarray(w_y))               # (ny, nx)
    else:
        gx, gy = jnp.meshgrid(x, y, indexing="xy")
        g_out = jnp.stack([gx, gy, jnp.zeros_like(gx)], axis=-1
                          ).astype(jnp.float64)
        _, ph_out64 = _idx_phase_exact(g_out, pos_tc, vel_tc, vf, p, plan)
    ph_out = (ph_out64 - _TWO_PI * jnp.round(ph_out64 / _TWO_PI)
              ).astype(jnp.float32)
    return img * expj(ph_out)


@partial(jax.jit, static_argnames=("p",))
def forward_spectra(raw, p: BpParams):
    """Cacheable forward half of the streaming fast-BP recentre: the
    matched-filtered forward spectra (P, nfft) complex64 of raw pulses, in
    natural FFT order at the plan's power-of-two length. Feed slices of
    the result to :func:`focus_bp_fast` / :func:`backproject_fast` via
    ``raw_spectra=`` — overlapped VideoSAR CPIs then pay the forward
    transform once per pulse instead of once per frame."""
    nfft = 1 << (raw.shape[-1] - 1).bit_length()
    ref_conj = matched_filter_spectrum(p, nfft)
    return jnp.fft.fft(raw, n=nfft, axis=-1) * ref_conj[None, :]


def recentre_from_spectra(spec, sat_pos, sat_vel, t_slow, vel_focus,
                          p: BpParams, d: int, t_ref: float, t_mean=None,
                          out_band: tuple[int, int] | None = None,
                          ring_offset=None):
    """Frame-dependent half of :func:`recenter_presum` (with the matched
    filter fused) on cached spectra from :func:`forward_spectra`: recentre
    ramp + carrier, frequency-domain presum by ``d``, inverse FFT. Same
    return contract as recenter_presum: (rc2[P2, n], pos2, vel2, t2).

    The presum runs before the inverse transform (both are linear), so
    only P/d inverse FFTs run. ``out_band=(s0, s1)`` returns only samples
    [s0, s1) of the recentred pulses (n = s1 - s0; the fast-BP accumulate
    reads only the iso-range band); None returns all nfft.

    ``ring_offset`` (traced i32 scalar, pulses, a multiple of ``d``): the
    spectra buffer is a RING — slot ``j`` holds chronological pulse
    ``(j - ring_offset) % P``. Only the per-pulse recentre scalars roll into
    ring order here, and the small presummed output rolls back to
    chronological order, so the (P, nfft) window is never copied. Requires
    ``P % d == 0`` (no pad row may interleave the ring).
    """
    num_p, nfft = spec.shape
    dt = t_slow - (jnp.mean(t_slow) if t_mean is None else t_mean)
    org = vel_focus[None, :] * dt[:, None]
    d0 = jnp.linalg.norm(sat_pos - org, axis=1)            # (P,) f64

    p_pad = -(-num_p // d) * d
    if ring_offset is not None and p_pad != num_p:
        raise ValueError(
            f"ring_offset needs P % d == 0 (a pad row would interleave the "
            f"ring): P={num_p}, d={d}")
    w = jnp.pad(jnp.ones((num_p,), jnp.float32), (0, p_pad - num_p))
    sp = spec if p_pad == num_p else jnp.pad(
        spec, ((0, p_pad - num_p), (0, 0)))
    d0_p = jnp.pad(d0, (0, p_pad - num_p), mode="edge")
    shift = (2.0 * d0_p / _C - t_ref) * p.fs_hz
    car = _TWO_PI * (2.0 * p.fc_hz / _C) * d0_p
    if ring_offset is not None:
        # scalars are chronological; the spectra are in ring order — move
        # the scalars to ring slots (roll(x, off)[j] = x[(j - off) % P])
        shift, car = (jnp.roll(x, ring_offset, axis=0) for x in (shift, car))

    def ramp(phase64):
        ph = (phase64 - _TWO_PI * jnp.round(phase64 / _TWO_PI)
              ).astype(jnp.float32)
        return jax.lax.complex(jnp.cos(ph), jnp.sin(ph))

    f_bins = jnp.fft.fftfreq(nfft)
    sp = (sp * ramp(_TWO_PI * f_bins[None, :] * shift[:, None])
          * (ramp(car) * w.astype(jnp.complex64))[:, None])
    sp_b = sp.reshape(-1, d, nfft).sum(axis=1) / jnp.float32(d)
    rc_b = jnp.fft.ifft(sp_b, axis=-1)
    if out_band is not None:
        s0, s1 = out_band
        if not 0 <= s0 < s1 <= nfft:
            raise ValueError(f"out_band {out_band} outside [0, {nfft}]")
        rc_b = rc_b[:, s0:s1]
    if ring_offset is not None:
        # presummed row m covers ring slots [m*d, (m+1)*d) — roll the rows
        # back to chronological order (ring_offset is a multiple of d, so no
        # presum group straddles the ring seam)
        rc_b = jnp.roll(rc_b, -(ring_offset // d), axis=0)
    ci = np.minimum(np.arange(p_pad // d) * d + (d // 2), num_p - 1)
    return rc_b.astype(jnp.complex64), sat_pos[ci], sat_vel[ci], t_slow[ci]


def focus_bp_fast(raw, sat_pos, sat_vel, t_slow, vel_focus, t_start,
                  p: BpParams, presum: int = 1, plan: FastBpPlan = None,
                  accumulate: str = "xla", fit_stride: int = 0,
                  math_mode: str = "exact", raw_spectra=None,
                  ring_offset=None):
    """Fused range compression + fast BP + presum rescale/droop (drop-in
    for ops/bp.py::focus_bp at production scale). The matched filter rides
    the recentre FFT (``compress=True``), so raw pulses see exactly one
    fast-time FFT round trip end to end. ``raw_spectra`` (from
    :func:`forward_spectra`) skips the forward transform for streaming
    overlapped CPIs; ``raw`` may then be None, and ``ring_offset`` marks
    the spectra as a ring buffer (see :func:`backproject_fast`)."""
    from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops

    if plan is None:
        plan = make_plan(p, np.asarray(sat_pos), np.asarray(t_slow),
                         float(t_start),
                         factorize=accumulate.startswith("factor"))
    img = backproject_fast(raw, sat_pos, sat_vel, t_slow, vel_focus, p, plan,
                           presum=presum, compress=True,
                           accumulate=accumulate, fit_stride=fit_stride,
                           math_mode=math_mode, raw_spectra=raw_spectra,
                           ring_offset=ring_offset)
    if presum > 1:
        corr = bp_ops.presum_droop_correction(
            jnp.asarray(sat_pos, jnp.float64), jnp.asarray(sat_vel, jnp.float64),
            jnp.asarray(t_slow, jnp.float64), jnp.asarray(vel_focus, jnp.float64),
            p, presum)
        return presum * corr * img
    return img
