"""GMTI physics tests: DPCA clutter null, ATI mover phase, CFAR, CRT."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import nis_sar_amtigmti_video_tpu as nst
from nis_sar_amtigmti_video_tpu import config as cfg
from nis_sar_amtigmti_video_tpu.gmti import ati, cfar, crt, dpca, velocity
from nis_sar_amtigmti_video_tpu.models import gmti as gmti_model
from nis_sar_amtigmti_video_tpu.scene import targets as T
from nis_sar_amtigmti_video_tpu.scene.clutter import ocean_clutter_field
from nis_sar_amtigmti_video_tpu.utils import cplx

C = 299792458.0


def reduced_ati_scenario(n_pulses=256):
    """ati_dpca preset shrunk: small aperture, 2 us / 150 MHz waveform."""
    import dataclasses
    sc = cfg.ati_dpca()
    sc = sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=300e6,
                                  pulse_width_s=2e-6, fs_hz=150e6),
        collect=dataclasses.replace(sc.collect,
                                    integration_time_s=n_pulses / 6000.0,
                                    window_length_s=768 / 150e6),
    )
    return sc


class TestDpcaPhysics:
    def test_stationary_scene_cancels(self, rng):
        """DPCA of an all-stationary scene must null the clutter deeply."""
        sc = reduced_ati_scenario()
        clut = ocean_clutter_field(rng, num_points=200, half_width_m=400.0)
        prod = gmti_model.run(sc, clut, (0.0, 0.0, 0.0),
                              balance=False)
        ratio = float(prod.cancellation_ratio)
        # reference-design baseline d=2V/PRF with 1-pulse shift: >30 dB null
        assert 20 * np.log10(ratio) > 30.0

    def test_mover_survives_cancellation(self, rng):
        """A radial mover must remain in the DPCA map while clutter nulls."""
        sc = reduced_ati_scenario()
        clut = ocean_clutter_field(rng, num_points=150, half_width_m=400.0)
        # ship much brighter than any single clutter spike (mean ~13.5k m^2)
        ship = T.point_target((0.0, 0.0, 0.0), rcs=400000.0)
        raw_m, traj, t0 = gmti_model.simulate_two_channel(
            sc, ship, (10.0, 0.0, 0.0), clut)
        prod = gmti_model.focus_and_products(raw_m, sc, t0, balance=False)
        dmag = cplx.to_host(prod.dpca_mag)
        s1 = np.abs(cplx.to_host(prod.slc1))
        # DPCA mover response = 2|sin(phi_ATI/2)| ~ 0.51 of its SLC peak here
        assert dmag.max() > 0.25 * s1.max()
        # and the DPCA peak is the mover's pixel (clutter spikes cancelled)
        assert np.unravel_index(dmag.argmax(), dmag.shape)[1] == pytest.approx(
            np.unravel_index(s1.argmax(), s1.shape)[1], abs=3)

    def test_ati_phase_tracks_radial_velocity(self):
        """ATI phase at the mover peak = 2*pi*B*v_r/(lambda*V) within 15%.

        v_r is the *closing* velocity: the sensor sits on the -x side, so a
        target moving +x recedes — v_r = -vx*sin(theta_inc)."""
        sc = reduced_ati_scenario()
        g, r = sc.geometry, sc.radar
        ship = T.point_target((0.0, 0.0, 0.0), rcs=1000.0)
        vx = 3.0   # small: keep phase well inside (-pi, pi]
        prod = gmti_model.run(sc, ship, (vx, 0.0, 0.0), balance=False)
        s1 = np.abs(cplx.to_host(prod.slc1))
        phase = cplx.to_host(prod.ati_phase)
        iy, ix = np.unravel_index(s1.argmax(), s1.shape)
        got = phase[iy, ix]
        v_r = -vx * np.sin(g.incidence_angle_rad)
        want = velocity.phase_from_velocity(
            v_r, r.wavelength_m, g.effective_velocity_mps,
            sc.channels.baseline_m)
        assert got == pytest.approx(want, rel=0.15)

    def test_velocity_map_inversion(self):
        sc = reduced_ati_scenario()
        g, r = sc.geometry, sc.radar
        ship = T.point_target((0.0, 0.0, 0.0), rcs=1000.0)
        vx = 2.5
        prod = gmti_model.run(sc, ship, (vx, 0.0, 0.0), balance=False)
        s1 = np.abs(cplx.to_host(prod.slc1))
        vmap_ = cplx.to_host(prod.velocity_map)
        iy, ix = np.unravel_index(s1.argmax(), s1.shape)
        assert vmap_[iy, ix] == pytest.approx(
            -vx * np.sin(g.incidence_angle_rad), rel=0.15)

    def test_channel_balance(self):
        """Balancing must remove a global phase offset between channels."""
        key = jax.random.PRNGKey(0)
        s1 = (jax.random.normal(key, (64, 64)) +
              1j * jax.random.normal(jax.random.fold_in(key, 1), (64, 64))
              ).astype(jnp.complex64)
        s2 = s1 * np.exp(1j * 0.7).astype(np.complex64)
        cal = ati.channel_balance_phase(s1, s2)
        assert float(cal) == pytest.approx(-0.7, abs=1e-3)
        s2b = ati.apply_balance(s2, cal)
        assert float(jnp.abs(s1 - s2b).max()) < 1e-3 * float(jnp.abs(s1).max())


class TestCfar:
    def test_detects_target_in_noise(self):
        key = jax.random.PRNGKey(7)
        noise = jax.random.exponential(key, (128, 128))
        power = noise.at[40, 90].add(500.0).at[100, 20].add(300.0)
        res = cfar.ca_cfar(power, cfar.CfarParams(guard=2, train=6, pfa=1e-6))
        det = np.asarray(res.detections)
        assert det[40, 90] and det[100, 20]
        # false alarms bounded (design Pfa 1e-6 over 16k cells -> ~0 expected;
        # allow a few boundary artifacts)
        assert det.sum() <= 6

    def test_detection_list(self):
        power = jnp.zeros((64, 64)).at[10, 12].set(1000.0)
        res = cfar.ca_cfar(power, cfar.CfarParams(guard=1, train=4, pfa=1e-4))
        rows, cols, snrs = cfar.detection_list(res, max_detections=8)
        assert int(rows[0]) == 10 and int(cols[0]) == 12
        assert int(rows[1]) == -1  # padded


class TestCrt:
    def test_reference_demo_case(self):
        """The CRT demo's own constants: lambda=0.03, v_amb=7600, R1=0.2,
        R2=5.0, phases (-2.503185, 0.276) — solver must find a consistent
        velocity with small residual."""
        sol = crt.solve(-2.503185, 0.276, 0.03, 7600.0, 0.2, 5.0, k_range=20)
        assert float(sol.residual) < 1.0
        v1 = 0.03 * 7600 / (4 * np.pi * 0.2) * (-2.503185 + 2 * np.pi * float(sol.k1))
        v2 = 0.03 * 7600 / (4 * np.pi * 5.0) * (0.276 + 2 * np.pi * float(sol.k2))
        assert float(sol.velocity) == pytest.approx(0.5 * (v1 + v2))

    def test_round_trip(self):
        """Synthesize wrapped phases from a known velocity; solver recovers it."""
        lam, v_amb, r1, r2 = 0.031, 7500.0, 0.3, 4.0
        v_true = 13.7
        c1 = lam * v_amb / (4 * np.pi * r1)
        c2 = lam * v_amb / (4 * np.pi * r2)
        p1 = np.angle(np.exp(1j * v_true / c1))
        p2 = np.angle(np.exp(1j * v_true / c2))
        sol = crt.solve(p1, p2, lam, v_amb, r1, r2, k_range=30)
        assert float(sol.velocity) == pytest.approx(v_true, abs=0.05)

    def test_solve_map(self):
        lam, v_amb, r1, r2 = 0.031, 7500.0, 0.3, 4.0
        v = np.array([[5.0, -8.0], [12.0, 0.5]])
        c1 = lam * v_amb / (4 * np.pi * r1)
        c2 = lam * v_amb / (4 * np.pi * r2)
        p1 = np.angle(np.exp(1j * v / c1))
        p2 = np.angle(np.exp(1j * v / c2))
        vmap_, res = crt.solve_map(jnp.asarray(p1), jnp.asarray(p2), lam,
                                   v_amb, r1, r2, k_range=30)
        np.testing.assert_allclose(np.asarray(vmap_), v, atol=0.05)


class TestReviewRegressions:
    def test_detection_list_batched(self):
        """Batched (F, H, W) CFAR stacks: per-image top-k, no crash."""
        power = jnp.zeros((3, 32, 32))
        power = power.at[0, 5, 7].set(500.0).at[2, 20, 11].set(400.0)
        res = cfar.ca_cfar(power, cfar.CfarParams(guard=1, train=3, pfa=1e-4))
        rows, cols, snrs = cfar.detection_list(res, max_detections=4)
        assert rows.shape == (3, 4)
        assert int(rows[0, 0]) == 5 and int(cols[0, 0]) == 7
        assert int(rows[1, 0]) == -1              # empty frame padded
        assert int(rows[2, 0]) == 20 and int(cols[2, 0]) == 11

    def test_pulse_shift_zero(self):
        a = jnp.ones((4, 8), jnp.complex64)
        b = jnp.ones((4, 8), jnp.complex64) * 2
        r1, r2 = dpca.pulse_shift_coregister(a, b, shift_pulses=0)
        assert r1.shape == r2.shape == (4, 8)

    def test_cfar_precision_after_bright_target(self):
        """A 100 dB scatterer must not poison training sums downstream."""
        power = jnp.full((64, 64), 1.0).at[5, 5].set(1e10)
        res = cfar.ca_cfar(power, cfar.CfarParams(guard=2, train=6, pfa=1e-6))
        noise = np.asarray(res.noise)
        # cells far from the target keep a ~1.0 noise estimate
        assert np.allclose(noise[40:, 40:], 1.0, atol=1e-3)


class TestFusedStep:
    def test_matches_composed_ops(self):
        import jax.numpy as jnp
        from nis_sar_amtigmti_video_tpu.gmti import ati, cfar, dpca
        from nis_sar_amtigmti_video_tpu.gmti.fused import gmti_product_step
        rng = np.random.default_rng(5)
        s1 = jnp.asarray((rng.standard_normal((96, 128))
                          + 1j * rng.standard_normal((96, 128))
                          ).astype(np.complex64))
        s2 = jnp.asarray(np.asarray(s1) * np.exp(1j * 0.31)
                         + 0.05 * (rng.standard_normal((96, 128))
                                   + 1j * rng.standard_normal((96, 128))
                                   ).astype(np.complex64))
        cp = cfar.CfarParams(guard=1, train=3)

        cal_c = ati.channel_balance_phase(s1, s2)
        s2b = ati.apply_balance(s2, cal_c)
        phase_c = ati.masked_phase(s1, s2b)
        diff_c = dpca.dpca_difference(s1, s2b)
        det_c = cfar.ca_cfar(jnp.abs(diff_c) ** 2, cp)

        cal, phase, dmag, det = gmti_product_step(s1, s2, cfar_params=cp)
        assert abs(float(cal) - float(cal_c)) < 1e-6
        np.testing.assert_allclose(np.asarray(phase), np.asarray(phase_c),
                                   atol=2e-5)
        np.testing.assert_allclose(np.asarray(dmag),
                                   np.abs(np.asarray(diff_c)), rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(det.snr),
                                   np.asarray(det_c.snr), rtol=2e-4,
                                   atol=1e-4)

    def test_no_balance(self):
        import jax.numpy as jnp
        from nis_sar_amtigmti_video_tpu.gmti import ati, dpca
        from nis_sar_amtigmti_video_tpu.gmti.fused import gmti_product_step
        rng = np.random.default_rng(6)
        s1 = jnp.asarray((rng.standard_normal((64, 128))
                          + 1j * rng.standard_normal((64, 128))
                          ).astype(np.complex64))
        s2 = s1 * np.complex64(np.exp(1j * 0.2))
        cal, phase, dmag, _ = gmti_product_step(s1, s2, balance=False)
        assert float(cal) == 0.0
        np.testing.assert_allclose(np.asarray(dmag),
                                   np.abs(np.asarray(s1 - s2)), rtol=2e-5,
                                   atol=1e-6)
