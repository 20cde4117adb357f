"""FULL-SCALE acceptance: the reference's exact 7,200 x 13,200 shape.

Closes the toy-scale loophole in test_baseline_acceptance.py (which shrinks
the scene): this runs the complete two-channel ATI/DPCA pipeline at the
reference workload shape (sar_ati_dcpa_sim_csa.py:46-47 — 1.2 s at PRF 6000
= 7,200 pulses; 22 us at 600 MHz = 13,200 samples) with the Destroyer ship
(36 scatterers; the 5,000-point clutter field only adds compute, not
phase-error growth) and asserts the BASELINE budgets against the f64 NumPy
oracle: <0.1 dB intensity and <1e-3 rad ATI phase at strong pixels.

Runtime is ~30-60 min on one CPU core, so the test is gated:

    NIS_SAR_FULLSCALE=1 python -m pytest tests/test_fullscale_acceptance.py -s

On the GPU, ``python chip_smoke.py --fullscale-oracle`` runs the same
comparison on both echo engines.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("NIS_SAR_FULLSCALE", "0") != "1",
    reason="full-scale run is ~1 h single-core; set NIS_SAR_FULLSCALE=1")


def test_fullscale_two_channel_acceptance():
    import dataclasses

    import nis_sar_amtigmti_video_tpu as nst  # noqa: F401  (x64 on)
    import oracle
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.models import gmti as gmti_model
    from nis_sar_amtigmti_video_tpu.models.stripmap import echo_opts_for
    from nis_sar_amtigmti_video_tpu.ops.echo import fast_time_grid
    from nis_sar_amtigmti_video_tpu.scene import targets as T
    from nis_sar_amtigmti_video_tpu.utils import cplx

    sc = cfg.ati_dpca()
    # NIS_SAR_FULLSCALE_BACKEND selects the echo engine under test:
    # 'jnp' (the preset default — direct engine) or 'freq' (the bench's
    # production NUFFT path at the shipped echo_oversample=2 default).
    # The freq backend needs a uniform grid.
    backend = os.environ.get("NIS_SAR_FULLSCALE_BACKEND", "jnp")
    if backend == "freq":
        # the NUFFT path needs the uniform fast-time grid, which
        # echo_opts_for derives from the 'centered' window mode; the
        # oracle below builds its grid from the same opts, so both sides
        # stay consistent
        sc = dataclasses.replace(
            sc, collect=dataclasses.replace(
                sc.collect, echo_backend="freq",
                window_start_mode="centered"))
    ship = T.destroyer().rotate_z(90.0)
    vel = np.array([0.0, 4.0, 0.0])     # along-track y: radial-ish mover

    # ---- framework (f32 device path; same code the bench exercises) ----
    raw2, traj, t0 = gmti_model.simulate_two_channel(sc, ship, vel)
    if isinstance(raw2, tuple):          # 'freq': per-channel arrays
        assert raw2[0].shape == (7200, 13200)
    else:
        assert raw2.shape == (2, 7200, 13200)  # the reference's exact shape
    prod = gmti_model.focus_and_products(raw2, sc, t0, balance=False)
    s1f = cplx.to_host(prod.slc1)
    s2f = cplx.to_host(prod.slc2)
    del raw2, prod

    # ---- oracle (f64 host path, identical scene) ----
    opts = echo_opts_for(sc)
    grid = t0 + fast_time_grid(opts)
    offs = sc.channels.rx_offsets()
    raws = [oracle.echo_bistatic(ship.positions, ship.rcs, traj.positions,
                                 traj.velocities, grid, opts.fc_hz,
                                 opts.chirp_rate, opts.pulse_width_s, off,
                                 vel, traj.times) for off in offs]
    r1, r2 = raws[0][1:, :], raws[1][:-1, :]
    del raws
    g, r = sc.geometry, sc.radar
    s1o = oracle.focus_csa(r1, r.wavelength_m, r.chirp_rate, r.fs_hz,
                           r.prf_hz, g.effective_velocity_mps,
                           g.slant_range_m, t0)[0].T
    del r1
    s2o = oracle.focus_csa(r2, r.wavelength_m, r.chirp_rate, r.fs_hz,
                           r.prf_hz, g.effective_velocity_mps,
                           g.slant_range_m, t0)[0].T
    del r2

    strong = np.abs(s1o) > 0.05 * np.abs(s1o).max()
    ratio_db = 20 * np.log10(np.abs(s1f[strong]) / np.abs(s1o[strong]))
    ati_f = np.angle(s1f * np.conj(s2f))
    ati_o = np.angle(s1o * np.conj(s2o))
    dphi = np.angle(np.exp(1j * (ati_f[strong] - ati_o[strong])))
    print(f"\nfull-scale: strong px {int(strong.sum())}, "
          f"|intensity| max {np.abs(ratio_db).max():.4f} dB, "
          f"|ATI phase| max {np.abs(dphi).max():.2e} rad")
    assert np.abs(ratio_db).max() < 0.1
    assert np.abs(dphi).max() < 1e-3
