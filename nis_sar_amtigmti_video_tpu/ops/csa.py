"""Chirp Scaling Algorithm (CSA) — the north-star image-formation path.

Behavior of ``sar_focus_csa`` (sar_ati_dcpa_sim_csa.py:202-396): three
pointwise phase multiplies interleaved with azimuth/range FFT passes,

    az-FFT -> Phi1 (chirp scaling) -> rg-FFT -> Phi2 (range compression +
    bulk RCMC) -> rg-IFFT -> Phi3 (azimuth compression + residual) -> az-IFFT

Design
------
* No fftshifts. The reference brackets every FFT with fftshift/ifftshift
  pairs and applies phases on shifted grids; the pairs are exact inverse
  permutations, so evaluating the phase functions on natural fftfreq ordering
  gives bit-identical output while skipping four full-array rolls per image.
* Phases are *static* per (geometry, shape): :func:`csa_phases` computes them
  once in float64 (the azimuth-compression term 4*pi*R*D/lam is ~2e8 rad at
  507 km — it must be wrapped mod 2pi in f64 before the complex64 cast), and
  :func:`apply_csa` is the pure c64 FFT+multiply pipeline. Under ``vmap`` over
  a frame batch the phase computation does not depend on the batch axis, so
  XLA hoists it — per-frame cost is 4 FFT passes + 3 multiplies, all
  HBM-bandwidth bound.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_TWO_PI = 2.0 * math.pi
_C = 299792458.0


@dataclass(frozen=True)
class CsaParams:
    """Static focusing parameters (hashable, jit-static)."""

    wavelength_m: float
    chirp_rate: float        # K_r [Hz/s]
    fs_hz: float
    prf_hz: float
    velocity_mps: float      # effective platform velocity V_eff
    range_ref_m: float       # reference (mid-swath) range R_ref
    t_start_fast: float      # receive-window opening time [s]
    num_pulses: int
    num_samples: int


class CsaPhases(NamedTuple):
    phi1: jax.Array   # (n_az, n_rg) complex64 — chirp scaling
    phi2: jax.Array   # (n_az, n_rg) complex64 — range comp + bulk RCMC
    phi3: jax.Array   # (n_az, n_rg) complex64 — azimuth comp + residual


def _wrap(x):
    return x - _TWO_PI * jnp.round(x / _TWO_PI)


def _expj64(phase64):
    """exp(j*phase) with f64 wrap, complex64 result."""
    w = _wrap(phase64).astype(jnp.float32)
    return jax.lax.complex(jnp.cos(w), jnp.sin(w))


@partial(jax.jit, static_argnames=("p",))
def csa_phases(p: CsaParams) -> CsaPhases:
    """All three CSA phase grids, computed in f64 and wrapped to complex64."""
    n_az, n_rg = p.num_pulses, p.num_samples
    lam, kr, vr, r_ref = p.wavelength_m, p.chirp_rate, p.velocity_mps, p.range_ref_m

    tau = p.t_start_fast + jnp.arange(n_rg, dtype=jnp.float64) / p.fs_hz
    fr = jnp.fft.fftfreq(n_rg, 1.0 / p.fs_hz).astype(jnp.float64)
    fa = jnp.fft.fftfreq(n_az, 1.0 / p.prf_hz).astype(jnp.float64)

    arg = 1.0 - (lam * fa / (2.0 * vr)) ** 2
    d_fa = jnp.sqrt(jnp.where(arg < 0.0, 1e-9, arg))      # migration factor D(fa)
    cs = 1.0 / d_fa - 1.0                                  # scaling factor Cs(fa)

    # Phi1(tau, fa) = exp(-j*pi*Kr*Cs*(tau - 2*R_ref/(c*D))^2)
    tau_ref = 2.0 * r_ref / (_C * d_fa)
    phi1 = _expj64(-math.pi * kr * cs[:, None]
                   * (tau[None, :] - tau_ref[:, None]) ** 2)

    # Phi2(fr, fa) = exp(j*(pi*fr^2/(Kr*(1+Cs)) + 4*pi*R_ref*Cs*fr/c))
    phi2 = _expj64(math.pi * fr[None, :] ** 2 / (kr * (1.0 + cs[:, None]))
                   + (4.0 * math.pi / _C) * r_ref * cs[:, None] * fr[None, :])

    # Phi3(tau, fa) = exp(j*(4*pi*R*D/lam - pi*Kr*Cs*(1+Cs)*(tau - 2R_ref/c)^2))
    r_vec = _C * tau / 2.0
    tau_diff = tau - 2.0 * r_ref / _C
    phi3 = _expj64((4.0 * math.pi / lam) * r_vec[None, :] * d_fa[:, None]
                   - math.pi * kr * (cs * (1.0 + cs))[:, None]
                   * tau_diff[None, :] ** 2)
    return CsaPhases(phi1, phi2, phi3)


def apply_csa(phist, phases: CsaPhases, fft_impl: str = "xla"):
    """Pure complex64 CSA pipeline: (n_az, n_rg) raw -> (n_az, n_rg) SLC.

    Azimuth rows of the output are in natural (ifft of unshifted) order —
    identical ordering to the reference, whose shift pairs cancel.
    ``fft_impl='mxu'`` uses the matmul FFT (ops/fft.py).
    """
    from nis_sar_amtigmti_video_tpu.ops.fft import get_impl
    fft, ifft = get_impl(fft_impl)
    # named scopes label the profiler trace (utils/profiling) per CSA stage
    with jax.named_scope("csa_az_fft"):
        s = fft(phist, axis=-2)                 # azimuth FFT -> range-Doppler
    with jax.named_scope("csa_phi1_chirp_scaling"):
        s = s * phases.phi1
    with jax.named_scope("csa_rg_fft"):
        s = fft(s, axis=-1)                     # range FFT -> 2D frequency
    with jax.named_scope("csa_phi2_rc_rcmc"):
        s = s * phases.phi2                     # range compression + bulk RCMC
    with jax.named_scope("csa_rg_ifft"):
        s = ifft(s, axis=-1)                    # back to range-Doppler
    with jax.named_scope("csa_phi3_az_compress"):
        s = s * phases.phi3                     # azimuth compression + residual
    with jax.named_scope("csa_az_ifft"):
        return ifft(s, axis=-2)                 # azimuth IFFT -> SLC


class CsaFactors(NamedTuple):
    """Decomposed 1-D phase factors for the fused (grid-free) CSA path.

    Every 2-D phase is written as  phase(a, r) = row(a) + col(r) + small
    separable terms, where 'row'/'col' are wrapped mod 2pi in f64 at setup
    and every cross term is bounded to a few thousand rad — safely inside
    f32. The fused pipeline then computes exp(j*phase) inline, so each phase
    stage reads only the data array (no 2-D phase-grid traffic).

    Phi1 = c1(a) * (u(r) - w(a))^2          u = tau - 2R_ref/c (small)
         = c1*u^2 - 2*c1*w*u + c1*w^2       c1 = -pi*Kr*Cs(a), w = (2R_ref/c)*Cs(a)
    Phi2 = alpha(a)*fr^2 + beta(a)*fr       alpha = pi/(Kr(1+Cs)), beta = 4pi*R_ref*Cs/c
    Phi3 = rphase(a) + cphase(r) + g(a)*dr(r) - c3(a)*u^2
           rphase = wrap(4pi*R_ref*D/lam), cphase = wrap(4pi*dr/lam),
           g = (4pi/lam)(D-1), c3 = pi*Kr*Cs*(1+Cs), dr = c*u/2
    """

    u: jax.Array        # (n_rg,) f32 — tau - 2R_ref/c
    fr: jax.Array       # (n_rg,) f32
    dr: jax.Array       # (n_rg,) f32 — delta range c*u/2
    cphase: jax.Array   # (n_rg,) f32 — wrapped 4*pi*dr/lam
    c1: jax.Array       # (n_az,) f32
    w: jax.Array        # (n_az,) f32
    alpha: jax.Array    # (n_az,) f32
    beta: jax.Array     # (n_az,) f32
    rphase: jax.Array   # (n_az,) f32 — wrapped 4*pi*R_ref*D/lam
    g: jax.Array        # (n_az,) f32 — (4*pi/lam)*(D-1)
    c3: jax.Array       # (n_az,) f32


@partial(jax.jit, static_argnames=("p",))
def csa_factors(p: CsaParams) -> CsaFactors:
    n_az, n_rg = p.num_pulses, p.num_samples
    lam, kr, vr, r_ref = p.wavelength_m, p.chirp_rate, p.velocity_mps, p.range_ref_m

    tau = p.t_start_fast + jnp.arange(n_rg, dtype=jnp.float64) / p.fs_hz
    fr = jnp.fft.fftfreq(n_rg, 1.0 / p.fs_hz).astype(jnp.float64)
    fa = jnp.fft.fftfreq(n_az, 1.0 / p.prf_hz).astype(jnp.float64)

    arg = 1.0 - (lam * fa / (2.0 * vr)) ** 2
    d_fa = jnp.sqrt(jnp.where(arg < 0.0, 1e-9, arg))
    cs = 1.0 / d_fa - 1.0

    u = tau - 2.0 * r_ref / _C
    dr = _C * u / 2.0
    f32 = lambda x: x.astype(jnp.float32)
    return CsaFactors(
        u=f32(u), fr=f32(fr), dr=f32(dr),
        cphase=f32(_wrap((4.0 * math.pi / lam) * dr)),
        c1=f32(-math.pi * kr * cs),
        w=f32((2.0 * r_ref / _C) * cs),
        alpha=f32(math.pi / (kr * (1.0 + cs))),
        beta=f32((4.0 * math.pi / _C) * r_ref * cs),
        rphase=f32(_wrap((4.0 * math.pi / lam) * r_ref * d_fa)),
        g=f32((4.0 * math.pi / lam) * (d_fa - 1.0)),
        c3=f32(math.pi * kr * cs * (1.0 + cs)),
    )


def _expj32(phase):
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase))


def apply_csa_fused(phist, f: CsaFactors, fft_impl: str = "xla"):
    """Grid-free CSA: identical math to apply_csa with phases generated
    inline from the 1-D factors — XLA fuses trig+multiply into single passes
    over the data, cutting memory traffic by the three 2-D phase grids."""
    from nis_sar_amtigmti_video_tpu.ops.fft import get_impl
    fft, ifft = get_impl(fft_impl)
    u, fr = f.u[None, :], f.fr[None, :]
    s = fft(phist, axis=-2)
    du = u - f.w[:, None]
    s = s * _expj32(f.c1[:, None] * du * du)
    s = fft(s, axis=-1)
    s = s * _expj32((f.alpha[:, None] * fr + f.beta[:, None]) * fr)
    s = ifft(s, axis=-1)
    s = s * _expj32(f.rphase[:, None] + f.cphase[None, :]
                    + f.g[:, None] * f.dr[None, :]
                    - f.c3[:, None] * u * u)
    return ifft(s, axis=-2)


def apply_csa_fused_t(phist, f: CsaFactors):
    """Fused CSA with a single transpose pair so *all four* FFTs run on the
    middle-axis matmul DFT (ops/fft.py::_fft_middle):

        az-FFT(mid) -> x Phi1 -> T -> rg-FFT(mid) -> x Phi2' -> rg-IFFT(mid)
        -> x Phi3' -> T -> az-IFFT(mid)

    Identical math to apply_csa_fused; the transposed middle section applies
    the phases with swapped row/col roles.
    """
    from nis_sar_amtigmti_video_tpu.ops.fft import _fft_middle, supported

    n_az = phist.shape[-2]
    n_rg = phist.shape[-1]
    if not (supported(n_az) and supported(n_rg)):
        return apply_csa_fused(phist, f, "hybrid")

    s = _fft_middle(phist, n_az, inverse=False)
    du = f.u[None, :] - f.w[:, None]
    s = s * _expj32(f.c1[:, None] * du * du)
    s = jnp.swapaxes(s, -1, -2)                   # -> (..., rg, az)
    s = _fft_middle(s, n_rg, inverse=False)
    s = s * _expj32((f.alpha[None, :] * f.fr[:, None] + f.beta[None, :])
                    * f.fr[:, None])
    s = _fft_middle(s, n_rg, inverse=True)
    s = s * _expj32(f.rphase[None, :] + f.cphase[:, None]
                    + f.g[None, :] * f.dr[:, None]
                    - f.c3[None, :] * f.u[:, None] * f.u[:, None])
    s = jnp.swapaxes(s, -1, -2)                   # -> (..., az, rg)
    return _fft_middle(s, n_az, inverse=True)


def csa_axes(p: CsaParams):
    """(range_axis_m, cross_range_m) matching the reference outputs
    (sar_ati_dcpa_sim_csa.py:388-394)."""
    import numpy as np
    tau = p.t_start_fast + np.arange(p.num_samples) / p.fs_hz
    r_vec = _C * tau / 2.0
    t_slow = np.arange(p.num_pulses) / p.prf_hz
    t_slow -= t_slow.mean()
    return r_vec, t_slow * p.velocity_mps


def focus_csa(phist, p: CsaParams):
    """Convenience: phases + pipeline. Returns SLC as (n_az, n_rg); note the
    reference returns the transpose (range, azimuth) — transpose at the
    product/IO layer, not here, to keep the batched layout uniform."""
    return apply_csa(phist, csa_phases(p))
