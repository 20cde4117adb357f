"""Range-Doppler Algorithm (RDA).

Behavior of ``sar_focus_rda`` (sar_satellite_sim.py:356-448, duplicated in
sar_vehicle_sim.py:182-274 and sar_satellite_moving_sim.py:208-285):

    1. range compression   — 'same'-mode convolution with a Hamming-windowed
                             conjugate chirp, here one batched FFT convolution
                             instead of a per-pulse scipy loop
    2. azimuth Hamming + (fftshift-bracketed) FFT -> range-Doppler
    3. RCMC                — delta_R = R*fd^2*lam^2/(8 V^2); the reference
                             resamples from the *source-shifted* non-uniform
                             grid per Doppler bin with interp1d; implemented
                             as a vmapped searchsorted+gather ('exact') or a
                             target-indexed uniform gather ('fast')
    4. azimuth compression — H = exp(-j*pi*fd^2/Ka), Ka = 2 V^2/(lam R)
    5. azimuth IFFT -> image

Data layout: the reference passes (num_ranges, num_pulses); this module keeps
the framework-wide (azimuth, range) = (pulses, samples) layout and transposes
internally where the doctrine differs — outputs match the reference's arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from nis_sar_amtigmti_video_tpu.ops.interp import interp_nonuniform_src, interp_uniform
from nis_sar_amtigmti_video_tpu.ops.windows import get_window

_TWO_PI = 2.0 * math.pi
_C = 299792458.0


@dataclass(frozen=True)
class RdaParams:
    wavelength_m: float
    pulse_width_s: float
    chirp_rate: float
    fs_hz: float
    prf_hz: float
    velocity_mps: float
    range_ref_m: float        # group reference range (centers the range axis)
    num_pulses: int
    num_samples: int
    range_window: str = "hamming"
    azimuth_window: str = "hamming"
    rcmc_mode: str = "exact"  # 'exact' (reference interp1d semantics) |
                              # 'fast' (one gather) | 'phase' (gather-free
                              # Fourier shift; see phase_rcmc_inrow_cells)


class RdaProducts(NamedTuple):
    """All intermediates the reference saves for its viewers
    (sar_satellite_sim.py:483-500). Layout (azimuth, range)."""

    image: jax.Array        # complex SLC (the reference keeps magnitude only)
    compressed: jax.Array   # after range compression
    rd_map: jax.Array       # range-Doppler, before RCMC
    rd_rcmc: jax.Array      # after RCMC
    rd_az_comp: jax.Array   # after azimuth matched filter


def rda_axes(p: RdaParams):
    """(range_axis_m, range_axis_centered, cross_range_m, doppler_freq_hz)."""
    n_rg, n_az = p.num_samples, p.num_pulses
    t_ref = 2.0 * p.range_ref_m / _C
    if n_rg % 2 == 0:
        fast = (np.arange(n_rg) - n_rg / 2) / p.fs_hz + t_ref
    else:
        fast = (np.arange(n_rg) - (n_rg - 1) / 2) / p.fs_hz + t_ref
    if n_az % 2 == 0:
        slow = (np.arange(n_az) - n_az / 2) / p.prf_hz
        fd = np.arange(-n_az / 2, n_az / 2) * (p.prf_hz / n_az)
    else:
        slow = (np.arange(n_az) - (n_az - 1) / 2) / p.prf_hz
        fd = np.arange(-(n_az - 1) / 2, (n_az - 1) / 2 + 1) * (p.prf_hz / n_az)
    r = fast * _C / 2.0
    return r, r - r.mean(), p.velocity_mps * slow, fd


def matched_filter(p: RdaParams):
    """Hamming-windowed, unit-norm conjugate chirp (sar_satellite_sim.py:378-384)."""
    n_mf = int(np.floor(p.pulse_width_s * p.fs_hz)) + 1
    t = np.linspace(-p.pulse_width_s / 2.0, p.pulse_width_s / 2.0, n_mf)
    with jax.ensure_compile_time_eval():
        h = np.asarray(get_window(p.range_window, n_mf, dtype=jnp.float64))
    mf = np.exp(-1j * np.pi * p.chirp_rate * t ** 2) * h
    mf = mf / np.linalg.norm(mf)
    return jnp.asarray(mf.astype(np.complex64))


def range_compress(phist, p: RdaParams):
    """'same'-mode linear convolution along range via one batched FFT.

    phist: (..., n_az, n_rg). Equal to np.convolve(row, mf, 'same') per pulse.
    """
    mf = matched_filter(p)
    n_rg = phist.shape[-1]
    n_mf = mf.shape[0]
    # any nfft >= n_rg + n_mf - 1 gives the exact linear convolution; round
    # up to a power of two (odd composite lengths such as 16095 would take
    # a slower non-power-of-two FFT)
    nfft = 1 << (n_rg + n_mf - 2).bit_length()
    spec = jnp.fft.fft(phist, n=nfft, axis=-1) * jnp.fft.fft(mf, n=nfft)
    full = jnp.fft.ifft(spec, axis=-1)
    start = (n_mf - 1) // 2
    return jax.lax.slice_in_dim(full, start, start + n_rg, axis=-1)


def _wrap(x):
    return x - _TWO_PI * jnp.round(x / _TWO_PI)


@partial(jax.jit, static_argnames=("p",))
def _rda_grids(p: RdaParams):
    """Static per-geometry grids: (delta_R matrix, azimuth filter H, range_axis)."""
    r, _, _, fd = rda_axes(p)
    r = jnp.asarray(r)
    fd = jnp.asarray(fd)
    delta_r = (r[None, :] * fd[:, None] ** 2 * p.wavelength_m ** 2
               / (8.0 * p.velocity_mps ** 2))           # (n_az, n_rg) f64
    ka = 2.0 * p.velocity_mps ** 2 / (p.wavelength_m * r)
    hphase = _wrap(-math.pi * fd[:, None] ** 2 / ka[None, :]).astype(jnp.float32)
    h = jax.lax.complex(jnp.cos(hphase), jnp.sin(hphase))
    return delta_r, h, r


def phase_rcmc_inrow_cells(p: RdaParams) -> float:
    """Max variation of the RCM shift *within one Doppler row*, in range
    cells. ``rcmc_mode='phase'`` models the shift as constant per row, which
    is valid when this is << 1 (spaceborne stripmap: ~0.1 cells). delta_R =
    R * (lambda*f_d)^2 / (8 V^2) is linear in R, so the in-row spread is the
    swath extent times the same factor at the highest Doppler."""
    dr = 299792458.0 / (2.0 * p.fs_hz)
    extent_m = p.num_samples * dr
    f_dmax = p.prf_hz / 2.0
    k = (p.wavelength_m * f_dmax) ** 2 / (8.0 * p.velocity_mps ** 2)
    return extent_m * k / dr


def rcmc(rd, delta_r, range_axis, mode: str = "exact"):
    """Range-cell migration correction on (..., n_az, n_rg) range-Doppler data.

    'exact': reference semantics — resample from source grid r - delta_R(r)
    (per-Doppler-bin non-uniform interp, sar_satellite_sim.py:417-427).
    'fast': target-indexed uniform gather at r + delta_R(r) — standard RCMC,
    one gather, no searchsorted; differs from 'exact' by O(delta_R') terms.
    'phase': per-Doppler-row constant shift applied as a Fourier phase ramp
    (band-limited interpolation; no gathers). Valid when
    phase_rcmc_inrow_cells(p) << 1; edges wrap circularly over the outermost
    ~delta_R cells instead of zero-filling.
    'czt': per-Doppler-row *affine* resample via chirp-Z evaluation
    (ops/czt.py; ~3 extra FFT passes, still gather-free). delta_R is linear
    in R, so the row's target positions form an arithmetic progression —
    evaluated exactly, which lifts 'phase' mode's constant-per-row
    restriction for squinted/wide-RCM geometries (reference semantics:
    sar_satellite_sim.py:417-427). Edges wrap circularly like 'phase'.
    """
    if mode == "czt":
        from nis_sar_amtigmti_video_tpu.ops.czt import czt_eval

        dr = (range_axis[1] - range_axis[0])
        n = rd.shape[-1]
        # delta_R(row, r) = k_row * r  ->  u(j) = j*(1 + k_row) + r0*k_row/dr
        k_row = delta_r[..., -1] / range_axis[-1]         # (n_az,) f64
        step = 1.0 + k_row
        start = range_axis[0] * k_row / dr

        def one_row(row, st, s0):
            out = czt_eval(row, n, st, s0)
            # fill-zero semantics: positions whose source lies outside the
            # window are zeroed (computed analytically — no gathers); this
            # also kills the trig interpolant's periodic wrap there
            u = s0 + st * jnp.arange(n, dtype=jnp.float64)
            return jnp.where((u >= 0.0) & (u <= n - 1.0), out, 0.0)

        f = jax.vmap(one_row)
        if rd.ndim == 2:
            return f(rd, step, start)
        flat = rd.reshape((-1,) + rd.shape[-2:])
        return jax.vmap(lambda m: f(m, step, start))(flat).reshape(rd.shape)
    if mode == "phase":
        dr = (range_axis[1] - range_axis[0])
        n = rd.shape[-1]
        # shift at the swath-center range; in-row variation is sub-cell by
        # the validity contract checked in focus_rda
        s = delta_r[..., n // 2:n // 2 + 1] / dr          # (n_az, 1) cells
        f = jnp.fft.fftfreq(n)                            # cycles/sample f64
        ramp_phase = _wrap(_TWO_PI * f[None, :] * s).astype(jnp.float32)
        ramp = jax.lax.complex(jnp.cos(ramp_phase), jnp.sin(ramp_phase))
        return jnp.fft.ifft(jnp.fft.fft(rd, axis=-1) * ramp, axis=-1)
    if mode == "fast":
        dr = (range_axis[1] - range_axis[0])
        n = rd.shape[-1]
        base = jnp.arange(n, dtype=jnp.float64)
        u = base[None, :] + delta_r / dr
        return interp_uniform(rd, jnp.broadcast_to(u, rd.shape))
    # exact: vmap the non-uniform interp across Doppler bins
    src = range_axis[None, :] - delta_r                   # (n_az, n_rg)

    def one_bin(s, y):
        return interp_nonuniform_src(s, y, range_axis)

    f = jax.vmap(one_bin)
    if rd.ndim == 2:
        return f(src, rd)
    # batched frames: vmap over leading axes with shared src
    return jax.vmap(lambda m: f(src, m))(rd.reshape((-1,) + rd.shape[-2:])
                                          ).reshape(rd.shape)


@partial(jax.jit, static_argnames=("p",))
def focus_rda(phist, p: RdaParams) -> RdaProducts:
    """Full RDA chain on (n_az, n_rg) complex64 raw data."""
    if p.rcmc_mode == "phase":
        spread = phase_rcmc_inrow_cells(p)
        if spread > 0.5:
            raise ValueError(
                f"rcmc_mode='phase' models RCM as constant per Doppler row, "
                f"but this geometry varies {spread:.2f} cells across the "
                f"swath; use 'fast' or 'exact'")
    delta_r, h, range_axis = _rda_grids(p)
    n_az = p.num_pulses

    compressed = range_compress(phist, p)

    win_az = get_window(p.azimuth_window, n_az).astype(jnp.float32)
    windowed = compressed * win_az[:, None]
    # reference: fftshift -> fft -> fftshift along azimuth (axis -2)
    rd = jnp.fft.fftshift(
        jnp.fft.fft(jnp.fft.fftshift(windowed, axes=-2), axis=-2), axes=-2)

    rd_rcmc = rcmc(rd, delta_r, range_axis, p.rcmc_mode)

    rd_ac = rd_rcmc * h
    image = jnp.fft.ifftshift(
        jnp.fft.ifft(jnp.fft.ifftshift(rd_ac, axes=-2), axis=-2), axes=-2)
    return RdaProducts(image=image, compressed=compressed, rd_map=rd,
                       rd_rcmc=rd_rcmc, rd_az_comp=rd_ac)
