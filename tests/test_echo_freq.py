"""Frequency-domain (NUFFT) echo backend: fidelity class + speed contract."""

import numpy as np
import pytest

import nis_sar_amtigmti_video_tpu as nst
from nis_sar_amtigmti_video_tpu import config as cfg
from nis_sar_amtigmti_video_tpu.geometry import orbit
from nis_sar_amtigmti_video_tpu.ops.echo import (EchoOpts, phase_history,
                                                 window_start_time)
from nis_sar_amtigmti_video_tpu.scene import targets as T
from nis_sar_amtigmti_video_tpu.scene.clutter import ocean_clutter_field
from nis_sar_amtigmti_video_tpu.utils import cplx

KR = 50e6 / 2e-6   # BW 50 MHz < fs 60 MHz: physical waveform


def _opts(backend, **kw):
    base = dict(fc_hz=9.65e9, chirp_rate=KR, pulse_width_s=2e-6, fs_hz=60e6,
                num_samples=360, endpoint_grid=False,
                chirp_centering="leading", backend=backend)
    base.update(kw)
    return EchoOpts(**base)


def _compress(raw):
    mf = np.conj(np.exp(1j * np.pi * KR * np.linspace(-1e-6, 1e-6, 121) ** 2))
    return np.apply_along_axis(lambda r: np.convolve(r, mf, "same"), 1, raw)


class TestFreqBackend:
    @pytest.fixture(scope="class")
    def scene(self):
        g = cfg.satellite_stripmap().geometry
        traj = orbit.make_trajectory(g, orbit.slow_time_grid(8 / 6000.0, 8))
        rng = np.random.default_rng(0)
        tgts = T.PointTargets.concatenate(
            [T.destroyer(), ocean_clutter_field(rng, 100, 400.0)])
        t0 = window_start_time(g.slant_range_m, _opts("jnp"), 360 / 60e6,
                               "centered")
        return g, traj, tgts, t0

    def test_peak_fidelity_golden(self, scene):
        """Bright pixels in an interference-rich scene: <0.02 dB amplitude,
        <2e-3 rad phase vs the direct engine — inside the BASELINE golden
        budget (0.1 dB / 1e-3 rad applies to the focused image, where the
        per-pixel raw error averages further down)."""
        g, traj, tgts, t0 = scene
        a = _compress(cplx.to_host(
            phase_history(traj, tgts, _opts("jnp"), t_start=t0)))
        b = _compress(cplx.to_host(
            phase_history(traj, tgts, _opts("freq"), t_start=t0)))
        bright = np.abs(a) > 0.5 * np.abs(a).max()
        ratio = 20 * np.log10(np.abs(b[bright]) / np.abs(a[bright]))
        dphi = np.angle(b[bright] * np.conj(a[bright]))
        assert np.abs(ratio).max() < 0.02
        assert np.abs(dphi).max() < 2e-3

    def test_field_error_floor(self, scene):
        """Raw field RMS error < -55 dB (exact-edge split, os=2)."""
        g, traj, tgts, t0 = scene
        a = cplx.to_host(phase_history(traj, tgts, _opts("jnp"), t_start=t0))
        b = cplx.to_host(phase_history(
            traj, tgts, _opts("freq"), t_start=t0))
        err_db = 10 * np.log10(np.mean(np.abs(a - b) ** 2)
                               / np.mean(np.abs(a) ** 2))
        assert err_db < -55.0

    def test_approximate_mode_still_available(self, scene):
        """freq_edge_taper=0 keeps the cheaper approximate class
        (~-25 dB floor) for bulk data generation."""
        g, traj, tgts, t0 = scene
        a = cplx.to_host(phase_history(traj, tgts, _opts("jnp"), t_start=t0))
        b = cplx.to_host(phase_history(
            traj, tgts, _opts("freq", freq_oversample=4, freq_edge_taper=0.0),
            t_start=t0))
        err_db = 10 * np.log10(np.mean(np.abs(a - b) ** 2)
                               / np.mean(np.abs(a) ** 2))
        assert -40.0 < err_db < -25.0

    def test_dense_spreader_matches_scatter(self, scene):
        """The one-hot matmul spreader must reproduce the scatter path on a
        delay-sorted interference-rich scene — the adoption gate for every
        dense-path restructuring."""
        g, traj, tgts, t0 = scene
        a = cplx.to_host(phase_history(
            traj, tgts, _opts("freq", freq_spreader="scatter"), t_start=t0))
        b = cplx.to_host(phase_history(
            traj, tgts, _opts("freq", freq_spreader="dense"), t_start=t0))
        assert np.abs(b - a).max() < 2e-5 * np.abs(a).max()

    def test_dense_spreader_group_sizing(self, scene):
        """Tighter group windows (the memory-bill knob) must stay exact while
        every group's delay span fits the window."""
        g, traj, tgts, t0 = scene
        a = cplx.to_host(phase_history(
            traj, tgts, _opts("freq", freq_spreader="scatter"), t_start=t0))
        b = cplx.to_host(phase_history(
            traj, tgts, _opts("freq", freq_spreader="dense",
                              freq_spread_win=1024, freq_spread_grp=32),
            t_start=t0))
        assert np.abs(b - a).max() < 2e-5 * np.abs(a).max()

    @pytest.mark.parametrize("spreader", ["dense", "scatter"])
    def test_spreader_drops_all_taps_of_masked_targets(self, spreader):
        """Targets whose every tap falls off the spreading grid (echoes far
        before or after the window) deposit NOTHING: adding them to a
        delay-sorted scene leaves the synthesized field unchanged — the
        dense spreader's clamp-to-margin and the scatter spreader's
        in-grid mask, through the main and the exact-edge passes."""
        import jax.numpy as jnp
        from nis_sar_amtigmti_video_tpu.ops import echo_freq as ef
        opts = _opts("freq", freq_spreader=spreader)
        rng = np.random.default_rng(11)
        n_p, n_live, n_far = 3, 24, 4
        live = np.sort(rng.uniform(0.5e-6, 5.0e-6, (n_p, n_live)), axis=1)
        before = np.full((n_p, n_far), -60e-6) + 1e-7 * np.arange(n_far)
        after = np.full((n_p, n_far), 90e-6) + 1e-7 * np.arange(n_far)

        def synth(tau):
            b = tau.shape[1]
            car = rng.uniform(-np.pi, np.pi, (n_p, b)).astype(np.float32)
            amp = rng.uniform(0.5, 2.0, (n_p, b)).astype(np.float32)
            return car, amp

        car_l, amp_l = synth(live)
        car_f, amp_f = synth(np.concatenate([before, after], axis=1))
        tau_all = np.concatenate([before, live, after], axis=1)
        car_all = np.concatenate([car_f[:, :n_far], car_l, car_f[:, n_far:]],
                                 axis=1)
        amp_all = np.concatenate([amp_f[:, :n_far], amp_l, amp_f[:, n_far:]],
                                 axis=1)
        want = np.asarray(ef.synthesize(jnp.asarray(live), jnp.asarray(car_l),
                                        jnp.asarray(amp_l), opts,
                                        spreader=spreader))
        got = np.asarray(ef.synthesize(jnp.asarray(tau_all),
                                       jnp.asarray(car_all),
                                       jnp.asarray(amp_all), opts,
                                       spreader=spreader))
        assert np.abs(want).max() > 0
        assert np.abs(got - want).max() < 1e-6 * np.abs(want).max()

    @pytest.mark.parametrize("removed", ["dense_kernel", "dense_kernel_qr",
                                         "dense_kernel_interpret"])
    def test_removed_spreader_rejected(self, scene, removed):
        """Spreader values of the removed kernels raise, naming the valid
        choices, instead of silently picking another spreader."""
        g, traj, tgts, t0 = scene
        with pytest.raises(ValueError, match="auto, scatter, dense"):
            phase_history(traj, tgts, _opts("freq", freq_spreader=removed),
                          t_start=t0)

    def test_spread_win_edge_error_names_the_override(self, scene):
        """A bad edge-pass window names the override that failed (and the
        main window when the edge one is derived from it)."""
        g, traj, tgts, t0 = scene
        with pytest.raises(ValueError, match="spread_win_edge must"):
            phase_history(traj, tgts, _opts("freq", freq_spread_win_edge=200),
                          t_start=t0)
        with pytest.raises(ValueError, match=r"spread_win // 2 of 384"):
            phase_history(traj, tgts, _opts("freq", freq_spread_win=384),
                          t_start=t0)
        with pytest.raises(ValueError, match="spread_win must be"):
            phase_history(traj, tgts, _opts("freq", freq_spread_win=300),
                          t_start=t0)

    def test_geom_interp_split_matches_f64(self, scene):
        """freq_geom_interp='split' (f64 only at the anchors; f32 delta
        interpolation + per-anchor carrier wrap) vs the full-f64
        interpolation: ~1e-5 rad carrier class, far inside the golden
        budgets."""
        g, _, tgts, t0 = scene
        # 64 pulses > 3*stride so the anchored-interpolation branch (the
        # one 'split' changes) actually runs
        traj = orbit.make_trajectory(g, orbit.slow_time_grid(64 / 6000.0,
                                                             64))
        a = cplx.to_host(phase_history(
            traj, tgts, _opts("freq", freq_geom_stride=8), t_start=t0))
        b = cplx.to_host(phase_history(
            traj, tgts, _opts("freq", freq_geom_stride=8,
                              freq_geom_interp="split"), t_start=t0))
        assert np.abs(b - a).max() < 2e-4 * np.abs(a).max()

    def test_geom_interp_rejects_bad_string(self, scene):
        g, traj, tgts, t0 = scene
        with pytest.raises(ValueError, match="freq_geom_interp"):
            phase_history(traj, tgts,
                          _opts("freq", freq_geom_interp="fast"),
                          t_start=t0)

    def test_endpoint_grid_rejected(self, scene):
        g, traj, tgts, t0 = scene
        with pytest.raises(ValueError, match="uniform fast-time"):
            phase_history(traj, tgts,
                          _opts("freq", endpoint_grid=True), t_start=t0)

    def test_empty_window_targets_drop(self, scene):
        """Targets whose echo misses the window contribute nothing (no NaN,
        no wraparound)."""
        g, traj, _, t0 = scene
        far = T.point_target((0.0, 30000.0, 0.0), 1e6)   # way out of window
        r = cplx.to_host(phase_history(traj, far,
                                       _opts("freq"), t_start=t0))
        assert np.isfinite(r).all()
        assert np.abs(r).max() < 1e-3

    def test_multi_channel_batched_equals_per_channel(self):
        """The freq backend's channel-batched dispatch (both channels'
        scalar fields stacked on the pulse axis through ONE synthesize
        program — ops/echo.py::multi_channel_phase_history) must match
        per-channel calls to f32-ULP class: every per-row stage (group
        spread, conv row FFT, edge pass) is pulse-row independent, so
        only backend association order (the CPU scatter path re-orders
        adds under a different batch shape) may differ — never values.
        40 pulses exercises the anchored-geometry path (num_p >
        3*stride)."""
        from nis_sar_amtigmti_video_tpu.ops.echo import (
            multi_channel_phase_history)

        g = cfg.satellite_stripmap().geometry
        traj = orbit.make_trajectory(g, orbit.slow_time_grid(40 / 6000.0, 40))
        rng = np.random.default_rng(3)
        tgts = T.PointTargets.concatenate(
            [T.destroyer(), ocean_clutter_field(rng, 80, 400.0)])
        t0 = window_start_time(g.slant_range_m, _opts("jnp"), 360 / 60e6,
                               "centered")
        offs = (-1.3, 1.3)
        b1, b2 = multi_channel_phase_history(traj, tgts, _opts("freq"),
                                             t_start=t0, rx_offsets=offs)
        r1 = phase_history(traj, tgts, _opts("freq"), t_start=t0,
                           rx_offset=offs[0])
        r2 = phase_history(traj, tgts, _opts("freq"), t_start=t0,
                           rx_offset=offs[1])
        assert b1.shape == r1.shape
        for b, r in ((b1, r1), (b2, r2)):
            bh, rh = cplx.to_host(b), cplx.to_host(r)
            tol = 3e-6 * np.abs(rh).max()
            np.testing.assert_allclose(bh, rh, rtol=0, atol=tol)
