"""Two-channel ATI/DPCA GMTI pipeline.

End-to-end slice of ``sar_ati_dcpa_sim_csa.py`` (SURVEY.md §3.2): bistatic
two-channel echo of (moving ship + stationary clutter), DPCA one-pulse-shift
co-registration, dual CSA focusing, ATI/DPCA products, channel balancing,
cancellation metric, radial-velocity map and CFAR detection.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nis_sar_amtigmti_video_tpu.config import ScenarioConfig
from nis_sar_amtigmti_video_tpu.geometry import orbit
from nis_sar_amtigmti_video_tpu.gmti import ati, cfar, dpca, velocity
from nis_sar_amtigmti_video_tpu.models.stripmap import echo_opts_for
from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu.ops.echo import (multi_channel_phase_history,
                                                 window_start_time)
from nis_sar_amtigmti_video_tpu.scene.targets import PointTargets


class GmtiProducts(NamedTuple):
    slc1: jax.Array            # channel-1 SLC (azimuth, range)
    slc2: jax.Array            # channel-2 SLC (balanced if requested)
    ati_phase: jax.Array       # interferometric phase [rad]
    dpca_mag: jax.Array        # |slc1 - slc2| clutter-cancelled magnitude
    velocity_map: jax.Array    # radial velocity from ATI phase [m/s]
    detections: cfar.CfarResult
    cancellation_ratio: jax.Array
    cal_phase: jax.Array       # applied channel-balance phase [rad]
    range_axis: np.ndarray
    cross_range: np.ndarray
    v_amb: float               # unambiguous radial velocity span [m/s]


def simulate_two_channel(sc: ScenarioConfig, moving: PointTargets,
                         target_velocity, static: Optional[PointTargets] = None):
    """Raw phase histories for both channels: a (2, P, Ns) complex64 array
    (direct backend) or a per-channel tuple (backend='freq' — see
    ops/echo.py::multi_channel_phase_history).

    Moving and stationary scatterer sets are simulated separately (each with
    its own rigid velocity) and summed — the reference's 4-pass structure
    (sar_ati_dcpa_sim_csa.py:189-197) collapsed into two vmapped calls.
    """
    r, g, c = sc.radar, sc.geometry, sc.collect
    n_p = c.num_pulses(r.prf_hz)
    traj = orbit.make_trajectory(g, orbit.slow_time_grid(c.integration_time_s, n_p))
    opts = echo_opts_for(sc)
    t0 = window_start_time(g.slant_range_m, opts, c.window_length_s,
                           c.window_start_mode)
    offs = sc.channels.rx_offsets()
    raw = multi_channel_phase_history(traj, moving, opts, t_start=t0,
                                      rx_offsets=offs,
                                      target_velocity=target_velocity)
    if static is not None and static.num > 0:
        raw_s = multi_channel_phase_history(traj, static, opts,
                                            t_start=t0, rx_offsets=offs)
        if isinstance(raw, tuple):              # 'freq': per-channel arrays
            raw = tuple(a + b for a, b in zip(raw, raw_s))
        else:
            raw = raw + raw_s
    return raw, traj, t0


def focus_and_products(raw2ch, sc: ScenarioConfig, t0: float, *,
                       shift_pulses: int = 1, balance: bool = True,
                       mask_threshold: float = 0.05,
                       cfar_params: cfar.CfarParams = cfar.CfarParams()
                       ) -> GmtiProducts:
    """DPCA shift -> dual CSA -> ATI/DPCA/velocity/CFAR products."""
    r, g = sc.radar, sc.geometry
    raw1, raw2 = dpca.pulse_shift_coregister(raw2ch[0], raw2ch[1],
                                             shift_pulses)
    n_p, n_s = raw1.shape
    p = csa_ops.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, t_start_fast=t0,
        num_pulses=n_p, num_samples=n_s)
    # fused grid-free CSA (bit-equivalent to the grid-phase path per
    # tests/test_fft_fused.py); sc.processing.fft_impl selects 'auto' |
    # 'xla' | 'hybrid' | 'mxu' (ops/fft.py). Channels are focused
    # per-array, so raw2ch may also be a (ch1, ch2) tuple.
    factors = csa_ops.csa_factors(p)
    # velocity inversion uses the *phase-center progression* speed (the
    # platform's true along-track velocity): the channel lag is B/(2*V_sat),
    # set by where the phase centers physically are — not the curved-earth
    # focusing velocity V_eff (which would bias v_r by ~2.6% at 350 km)
    v_platform = g.speed_mps
    v_amb = velocity.ambiguous_velocity(r.wavelength_m, v_platform,
                                        sc.channels.baseline_m)
    (slc1, slc2, cal, phase, dmag, vmap_, det,
     ratio) = _composed_core(raw1, raw2, factors,
                             fft_impl=sc.processing.fft_impl,
                             balance=balance, mask_threshold=mask_threshold,
                             cfar_params=cfar_params,
                             wavelength_m=r.wavelength_m,
                             v_platform=v_platform,
                             baseline_m=sc.channels.baseline_m)
    rax, cax = csa_ops.csa_axes(p)
    return GmtiProducts(slc1=slc1, slc2=slc2, ati_phase=phase, dpca_mag=dmag,
                        velocity_map=vmap_, detections=det,
                        cancellation_ratio=ratio, cal_phase=cal,
                        range_axis=rax, cross_range=cax, v_amb=v_amb)


@partial(jax.jit, static_argnames=("fft_impl", "balance", "mask_threshold",
                                   "cfar_params", "wavelength_m",
                                   "v_platform", "baseline_m"))
def _composed_core(raw1, raw2, factors, *, fft_impl, balance, mask_threshold,
                   cfar_params, wavelength_m, v_platform, baseline_m):
    """The composed focus+products chain under ONE jit: dual CSA, balance,
    ATI/DPCA, velocity map, CFAR, cancellation ratio — one program, so no
    eager dispatch and no intermediate round trips between the stages."""
    slc1 = csa_ops.apply_csa_fused(raw1, factors, fft_impl)
    slc2 = csa_ops.apply_csa_fused(raw2, factors, fft_impl)

    cal = ati.channel_balance_phase(slc1, slc2)
    if balance:
        slc2 = ati.apply_balance(slc2, cal)

    phase = ati.masked_phase(slc1, slc2, mask_threshold)
    diff = dpca.dpca_difference(slc1, slc2)
    dmag = jnp.abs(diff)
    vmap_ = velocity.velocity_from_phase(phase, wavelength_m, v_platform,
                                         baseline_m)
    det = cfar.ca_cfar(dmag ** 2, cfar_params)
    ratio = dpca.cancellation_ratio(slc1, diff)
    return slc1, slc2, cal, phase, dmag, vmap_, det, ratio


def run(sc: ScenarioConfig, moving: PointTargets, target_velocity,
        static: Optional[PointTargets] = None, **kw) -> GmtiProducts:
    raw, traj, t0 = simulate_two_channel(sc, moving, target_velocity, static)
    return focus_and_products(raw, sc, t0, **kw)
