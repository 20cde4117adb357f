"""BASELINE.json acceptance criteria, end to end.

"Outputs must match the reference NumPy pipeline to <1e-3 rad
interferometric (ATI) phase and <0.1 dB image intensity on identical
scenes." — this test runs the complete two-channel collect (bistatic echo x2
channels) through both the framework (f32 device path) and the oracle (f64
NumPy behaviors) and asserts exactly those tolerances.
"""

import dataclasses

import numpy as np
import pytest

import nis_sar_amtigmti_video_tpu as nst
import oracle
from nis_sar_amtigmti_video_tpu import config as cfg
from nis_sar_amtigmti_video_tpu.geometry import orbit
from nis_sar_amtigmti_video_tpu.gmti import dpca
from nis_sar_amtigmti_video_tpu.models import gmti as gmti_model
from nis_sar_amtigmti_video_tpu.models.stripmap import echo_opts_for
from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu.ops.echo import fast_time_grid, window_start_time
from nis_sar_amtigmti_video_tpu.scene import targets as T
from nis_sar_amtigmti_video_tpu.utils import cplx

C = 299792458.0


@pytest.fixture(scope="module", params=["jnp", "freq"])
def both_pipelines(request):
    """Framework and oracle runs of the same two-channel moving-ship scene.

    Parametrized over the echo backend: both the direct engine and the
    golden-grade NUFFT 'freq' backend must meet the acceptance budget
    against the f64 oracle. The 'freq' variant uses a physical waveform
    (BW < fs — its stated validity domain); 'jnp' keeps the sharper aliased
    reduced waveform for tighter focusing."""
    sc = cfg.ati_dpca()
    bw = 120e6 if request.param == "freq" else 300e6
    sc = sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=bw,
                                  pulse_width_s=2e-6, fs_hz=150e6),
        collect=dataclasses.replace(
            sc.collect, echo_backend=request.param,
            integration_time_s=192 / 6000.0,
            window_length_s=640 / 150e6,
            # 'freq' needs the uniform (non-endpoint) fast-time grid; both
            # pipelines share the same grid/t0 either way
            window_start_mode=("centered" if request.param == "freq"
                               else sc.collect.window_start_mode)))
    ship = T.PointTargets.concatenate([
        T.point_target((0.0, 0.0, 0.0), 3000.0),
        T.point_target((30.0, -20.0, 0.0), 1500.0),
    ])
    vel = np.array([4.0, 0.0, 0.0])

    # ---- framework (f32 device path) ----
    raw2, traj, t0 = gmti_model.simulate_two_channel(sc, ship, vel)
    prod = gmti_model.focus_and_products(raw2, sc, t0, balance=False)
    slc1_f = cplx.to_host(prod.slc1)
    slc2_f = cplx.to_host(prod.slc2)

    # ---- oracle (f64 host path, same scene/geometry) ----
    opts = echo_opts_for(sc)
    grid = t0 + fast_time_grid(opts)
    offs = sc.channels.rx_offsets()
    raws = [oracle.echo_bistatic(ship.positions, ship.rcs, traj.positions,
                                 traj.velocities, grid, opts.fc_hz,
                                 opts.chirp_rate, opts.pulse_width_s, off,
                                 vel, traj.times) for off in offs]
    r1, r2 = raws[0][1:, :], raws[1][:-1, :]
    g, r = sc.geometry, sc.radar
    slc1_o = oracle.focus_csa(r1, r.wavelength_m, r.chirp_rate, r.fs_hz,
                              r.prf_hz, g.effective_velocity_mps,
                              g.slant_range_m, t0)[0].T
    slc2_o = oracle.focus_csa(r2, r.wavelength_m, r.chirp_rate, r.fs_hz,
                              r.prf_hz, g.effective_velocity_mps,
                              g.slant_range_m, t0)[0].T
    return slc1_f, slc2_f, slc1_o, slc2_o


class TestBaselineAcceptance:
    def test_image_intensity_within_0p1_db(self, both_pipelines):
        s1f, _, s1o, _ = both_pipelines
        strong = np.abs(s1o) > 0.05 * np.abs(s1o).max()
        ratio_db = 20 * np.log10(np.abs(s1f[strong]) / np.abs(s1o[strong]))
        assert np.abs(ratio_db).max() < 0.1

    def test_ati_phase_within_1e3_rad(self, both_pipelines):
        s1f, s2f, s1o, s2o = both_pipelines
        ati_f = np.angle(s1f * np.conj(s2f))
        ati_o = np.angle(s1o * np.conj(s2o))
        strong = np.abs(s1o) > 0.05 * np.abs(s1o).max()
        dphi = np.angle(np.exp(1j * (ati_f[strong] - ati_o[strong])))
        assert np.abs(dphi).max() < 1e-3

    def test_slc_phase_within_1e3_rad(self, both_pipelines):
        """Stricter than required: absolute SLC phase agreement."""
        s1f, _, s1o, _ = both_pipelines
        strong = np.abs(s1o) > 0.1 * np.abs(s1o).max()
        dphi = np.angle(s1f[strong] * np.conj(s1o[strong]))
        assert np.abs(dphi).max() < 2e-3
