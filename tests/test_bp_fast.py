"""Gather-free fast backprojection vs the exact (oracle-grade) BP.

The comparison oracle is ops/bp.py::backproject in f64 fed with 8x
FFT-upsampled range data (linear-interp error drops 64x), with t_start
shifted so the reference's -0.5 grid_sample offset (defined at the original
sample rate, sar_batch_sim.py:225-230) stays at the original rate.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nis_sar_amtigmti_video_tpu import config as cfg
from nis_sar_amtigmti_video_tpu.constants import C
from nis_sar_amtigmti_video_tpu.geometry import orbit
from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
from nis_sar_amtigmti_video_tpu.ops import bp_fast
from nis_sar_amtigmti_video_tpu.ops.echo import (EchoOpts, phase_history,
                                                 window_start_time)
from nis_sar_amtigmti_video_tpu.scene import targets as T
from nis_sar_amtigmti_video_tpu.utils import cplx


def _scene(n_p=192, fs=180e6, ns=1024, vel=(0.0, 0.0, 0.0), t_offset=0.0):
    sc = cfg.videosar()
    g = sc.geometry
    times = orbit.slow_time_grid(n_p / 5000.0, n_p) + t_offset
    traj = orbit.make_trajectory(g, times)
    tgts = T.PointTargets.concatenate([
        T.point_target((0.0, 0.0, 0.0), 30.0),
        T.point_target((150.0, -120.0, 0.0), 20.0),
        T.point_target((-170.0, 140.0, 0.0), 25.0),
    ])
    lam = C / 9.65e9
    opts = EchoOpts(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6, pulse_width_s=2e-6,
                    fs_hz=fs, num_samples=ns, endpoint_grid=False,
                    chirp_centering="centered", amplitude="rcs",
                    stop_and_go=True,
                    antenna_length_m=lam * g.slant_range_m / 500.0)
    t0 = window_start_time(g.slant_range_m, opts, ns / fs, "centered")
    raw = cplx.to_host(phase_history(traj, tgts, opts, t_start=t0,
                                     target_velocity=np.asarray(vel)))
    p = bp_ops.BpParams(fc_hz=opts.fc_hz, chirp_rate=opts.chirp_rate,
                        fs_hz=fs, pulse_width_s=opts.pulse_width_s,
                        num_samples=ns, nx=64, ny=64, scene_size_m=400.0,
                        precision="f64")
    return raw, traj, p, float(t0)


def _oracle_upsampled(raw, traj, p, t0, vel_focus, u=8):
    """Exact f64 BP on u-times FFT-upsampled range data."""
    n_p, ns = raw.shape
    rc = np.asarray(bp_ops.bp_range_compress(cplx.to_device(raw), p))
    spec = np.fft.fft(rc, axis=-1)
    h = ns // 2
    spec_u = np.zeros((n_p, ns * u), np.complex128)
    spec_u[:, :h] = spec[:, :h]
    spec_u[:, -h:] = spec[:, -h:]
    spec_u[:, h] *= 0.5
    spec_u[:, -h] *= 0.5
    rc_u = (np.fft.ifft(spec_u, axis=-1) * u).astype(np.complex64)
    p_u = bp_ops.BpParams(fc_hz=p.fc_hz, chirp_rate=p.chirp_rate,
                          fs_hz=p.fs_hz * u, pulse_width_s=p.pulse_width_s,
                          num_samples=ns * u, nx=p.nx, ny=p.ny,
                          scene_size_m=p.scene_size_m, precision="f64")
    t0_u = t0 + 0.5 * (u - 1) / (u * p.fs_hz)
    return np.asarray(bp_ops.backproject(
        jnp.asarray(rc_u), jnp.asarray(traj.positions),
        jnp.asarray(traj.velocities), jnp.asarray(traj.times),
        jnp.asarray(vel_focus, jnp.float64), jnp.float64(t0_u), p_u))


def _check(fast, want, peak_db=0.1, peak_phase=0.01, field=0.01):
    a_f, a_w = np.abs(fast), np.abs(want)
    pk = np.unravel_index(a_w.argmax(), a_w.shape)
    assert abs(20 * np.log10(a_f[pk] / a_w[pk])) < peak_db
    assert abs(np.angle(fast[pk] * np.conj(want[pk]))) < peak_phase
    assert np.abs(a_f - a_w).max() / a_w.max() < field


def _stream_case(n_p, ns, seed):
    """Random pulses on a short VideoSAR trajectory for the recentre
    comparisons: (rc, pos, vel, ts, vf, p, t_ref)."""
    rng = np.random.default_rng(seed)
    g = cfg.videosar().geometry
    traj = orbit.make_trajectory(g, orbit.slow_time_grid(n_p / 5000.0, n_p))
    p = bp_ops.BpParams(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6, fs_hz=180e6,
                        pulse_width_s=2e-6, num_samples=ns, nx=64, ny=64,
                        scene_size_m=400.0)
    t_ref = float(2.0 * np.linalg.norm(traj.positions, axis=1).mean() / C)
    rc = jnp.asarray(rng.standard_normal((n_p, ns))
                     + 1j * rng.standard_normal((n_p, ns)), jnp.complex64)
    return (rc, jnp.asarray(traj.positions), jnp.asarray(traj.velocities),
            jnp.asarray(traj.times), jnp.zeros(3, jnp.float64), p, t_ref)


class TestFastBp:
    def test_static_scene_matches_exact(self):
        raw, traj, p, t0 = _scene()
        vf = np.zeros(3)
        want = _oracle_upsampled(raw, traj, p, t0, vf)
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p))
        _check(got, want)

    def test_mbp_moving_target(self):
        vel = (12.0, 5.0, 0.0)
        raw, traj, p, t0 = _scene(vel=vel)
        vf = np.asarray(vel)
        want = _oracle_upsampled(raw, traj, p, t0, vf)
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p))
        _check(got, want)
        # mover focused by mBP: peak on the start-position grid cell
        iy, ix = np.unravel_index(np.abs(got).argmax(), got.shape)
        x = np.linspace(-200, 200, 64)
        assert min(abs(x[ix] - 0.0), abs(x[ix] - 150.0),
                   abs(x[ix] + 170.0)) < 15

    def test_presum_within_budget(self):
        raw, traj, p, t0 = _scene(n_p=251)
        vf = np.zeros(3)
        d = bp_ops.presum_factor(p, 5000.0, C / 9.65e9,
                                 cfg.videosar().geometry.slant_range_m,
                                 cfg.videosar().geometry.effective_velocity_mps)
        assert d >= 2
        want = _oracle_upsampled(raw, traj, p, t0, vf)
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, presum=d))
        # presum adds its own validated +0.03 dB / <1% field budget
        _check(got, want, peak_db=0.15, peak_phase=0.02, field=0.015)

    def test_squinted_cpi(self):
        """CPI centred off broadside: sheared internal grid + rotated
        iso-range direction must still match the exact image."""
        raw, traj, p, t0 = _scene(n_p=192, t_offset=0.08)  # ~600 m along-track
        vf = np.zeros(3)
        plan = bp_fast.make_plan(p, traj.positions, traj.times, t0)
        rdir, _, _ = bp_fast._look_geometry(
            p, traj.positions[len(traj.times) // 2])
        assert abs(rdir[1]) > 1e-4           # genuinely rotated rows
        want = _oracle_upsampled(raw, traj, p, t0, vf)
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, plan=plan))
        _check(got, want, peak_db=0.12, peak_phase=0.02, field=0.012)

    def test_integer_stride_two(self):
        """fs/B = 2.4 exercises stride-2 window extraction."""
        raw, traj, p, t0 = _scene(fs=360e6, ns=2048)
        vf = np.zeros(3)
        plan = bp_fast.make_plan(p, traj.positions, traj.times, t0)
        assert plan.stride == 2
        want = _oracle_upsampled(raw, traj, p, t0, vf)
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, plan=plan))
        _check(got, want)

    def test_fused_compression_nonpow2(self):
        """num_samples=1000 pads to nfft=1024: the fused matched filter is
        a linear convolution at the padded length (the production shape's
        Bluestein-killer), which must still meet the oracle budgets."""
        raw, traj, p, t0 = _scene(ns=1000)
        vf = np.zeros(3)
        plan = bp_fast.make_plan(p, traj.positions, traj.times, t0)
        assert plan.nfft == 1024 and plan.nfft != p.num_samples
        want = _oracle_upsampled(raw, traj, p, t0, vf)
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, plan=plan))
        _check(got, want)

    @pytest.mark.parametrize("case", ["static", "mbp", "squint", "stride2",
                                      "presum"])
    def test_factorized_meets_oracle(self, case):
        """Factorized (sub-aperture) accumulation under the same oracle
        budgets as the plain fast path, across the geometry matrix."""
        kw = dict(static={}, mbp=dict(vel=(12.0, 5.0, 0.0)),
                  squint=dict(t_offset=0.08), stride2=dict(fs=360e6, ns=2048),
                  presum=dict(n_p=251))[case]
        raw, traj, p, t0 = _scene(**kw)
        vf = np.asarray(kw.get("vel", (0.0, 0.0, 0.0)), float)
        plan = bp_fast.make_plan(p, traj.positions, traj.times, t0,
                                 factorize=True)
        assert plan.sub_raw > 0 and plan.nx_c > 0
        presum = 1
        ck = {}
        if case == "presum":
            presum = bp_ops.presum_factor(
                p, 5000.0, C / 9.65e9, cfg.videosar().geometry.slant_range_m,
                cfg.videosar().geometry.effective_velocity_mps)
            ck = dict(peak_db=0.15, peak_phase=0.02, field=0.015)
        elif case == "squint":
            ck = dict(peak_db=0.12, peak_phase=0.02, field=0.012)
        want = _oracle_upsampled(raw, traj, p, t0, vf)
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, presum=presum, plan=plan,
            accumulate="factor"))
        _check(got, want, **ck)

    @pytest.mark.parametrize("case", ["static", "mbp", "squint", "stride2"])
    def test_factor2_meets_oracle(self, case):
        """Two-level factorized accumulation under the same oracle budgets
        as the single-level path, across the geometry matrix."""
        kw = dict(static={}, mbp=dict(vel=(12.0, 5.0, 0.0)),
                  squint=dict(t_offset=0.08),
                  stride2=dict(fs=360e6, ns=2048))[case]
        raw, traj, p, t0 = _scene(**kw)
        vf = np.asarray(kw.get("vel", (0.0, 0.0, 0.0)), float)
        plan = bp_fast.make_plan(p, traj.positions, traj.times, t0,
                                 factorize=True)
        assert plan.sub_raw1 > 0 and plan.nx_c1 > 0 and plan.grp >= 2
        ck = dict(peak_db=0.12, peak_phase=0.02,
                  field=0.012) if case == "squint" else {}
        want = _oracle_upsampled(raw, traj, p, t0, vf)
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, plan=plan, accumulate="factor2"))
        _check(got, want, **ck)

    def test_factor2_matches_single_level(self):
        """factor2 vs factor on the same operands: the only differences
        allowed are the level-1 band-limited merge (~-73 dB) and the
        budget re-split."""
        raw, traj, p, t0 = _scene()
        vf = np.zeros(3)
        plan = bp_fast.make_plan(p, traj.positions, traj.times, t0,
                                 factorize=True)
        assert plan.sub_raw1 > 0
        want = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, plan=plan, accumulate="factor"))
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, plan=plan, accumulate="factor2"))
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 5e-4, err

    def test_factorized_multi_subaperture_matches_plain(self):
        """Force several small sub-apertures (sub_p exercised > 1 anchor)
        and compare against the plain accumulate on the same operands: the
        only difference allowed is the band-limited merge error."""
        raw, traj, p, t0 = _scene()
        vf = np.zeros(3)
        plan0 = bp_fast.make_plan(p, traj.positions, traj.times, t0,
                                  factorize=True)
        # shrink sub-apertures well below the planned bound (more anchors,
        # still inside the coarse band budget)
        import dataclasses
        plan = dataclasses.replace(plan0, sub_raw=max(8, plan0.sub_raw // 8))
        assert -(-raw.shape[0] // plan.sub_raw) >= 4
        want = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, plan=plan, accumulate="xla"))
        got = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, plan=plan, accumulate="factor"))
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 2e-3, err

    def test_anchored_fit_matches_exact_fit(self):
        """The anchored fit + f32 derived-coefficient interpolation (the
        bench/model path) must match the exact per-pulse fit within the
        interpolation budget, and still pass the oracle gate — at BOTH
        stride 8 and the production stride 16."""
        raw, traj, p, t0 = _scene()
        vf = np.zeros(3)
        plan = bp_fast.make_plan(p, traj.positions, traj.times, t0,
                                 factorize=True)
        want = np.asarray(bp_fast.focus_bp_fast(
            cplx.to_device(raw), traj.positions, traj.velocities,
            traj.times, vf, t0, p, plan=plan, accumulate="factor",
            fit_stride=0))
        for stride in (8, 16):
            got = np.asarray(bp_fast.focus_bp_fast(
                cplx.to_device(raw), traj.positions, traj.velocities,
                traj.times, vf, t0, p, plan=plan, accumulate="factor",
                fit_stride=stride))
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err < 1e-3, (stride, err)
            _check(got, _oracle_upsampled(raw, traj, p, t0, vf))

    def test_streaming_spectra_split_matches_fused(self):
        """The streaming-VideoSAR recentre split (cacheable forward spectra
        + per-frame ramp/presum/inverse) must reproduce the fused XLA
        recentre (recenter_presum with the matched filter), and the
        focus_bp_fast raw_spectra= entry must match the raw-pulse path."""
        rc, pos, vel, ts, vf, p, t_ref = _stream_case(6, 10000, seed=8)
        d = 3
        ref_conj = bp_fast.matched_filter_spectrum(p, 16384)
        fused = bp_fast.recenter_presum(rc, pos, vel, ts, vf, p, d, t_ref,
                                        ref_conj=ref_conj)
        spec = bp_fast.forward_spectra(rc, p)
        assert spec.shape == (6, 16384)
        split = bp_fast.recentre_from_spectra(spec, pos, vel, ts, vf, p, d,
                                              t_ref)
        w0, g0 = np.asarray(fused[0]), np.asarray(split[0])
        assert g0.shape == w0.shape
        assert np.abs(g0 - w0).max() < 1e-5 * np.abs(w0).max()
        for a, b in zip(fused[1:], split[1:]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))
        # focus level: raw_spectra= == raw-pulse path
        t0 = t_ref - 0.5 * 10000 / p.fs_hz
        plan = bp_fast.make_plan(p, np.asarray(pos), np.asarray(ts),
                                 float(t0))
        want = np.asarray(bp_fast.focus_bp_fast(
            rc, pos, vel, ts, vf, t0, p, plan=plan, accumulate="xla"))
        got = np.asarray(bp_fast.focus_bp_fast(
            None, pos, vel, ts, vf, t0, p, plan=plan, accumulate="xla",
            raw_spectra=spec))
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-3, err

    def test_streaming_ring_offset_matches_chronological(self):
        """A ring-ordered spectra buffer (slot j = chronological pulse
        (j - off) % P) with ring_offset=off must reproduce the
        chronological call: the streaming product advances the
        cached-spectra window by dynamic_update_slice instead of
        re-concatenating it each frame."""
        rc, pos, vel, ts, vf, p, t_ref = _stream_case(12, 10000, seed=11)
        d = 3
        spec = bp_fast.forward_spectra(rc, p)
        want = bp_fast.recentre_from_spectra(spec, pos, vel, ts, vf, p, d,
                                             t_ref)
        for off in (3, 6, 9):
            got = bp_fast.recentre_from_spectra(
                jnp.roll(spec, off, axis=0), pos, vel, ts, vf, p, d, t_ref,
                ring_offset=jnp.int32(off))
            np.testing.assert_allclose(np.asarray(got[0]),
                                       np.asarray(want[0]), rtol=0,
                                       atol=5e-6 * float(
                                           np.abs(want[0]).max()))
            for a, b in zip(want[1:], got[1:]):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b))
        with pytest.raises(ValueError, match="ring_offset"):
            bp_fast.recentre_from_spectra(
                spec[:-2], pos[:-2], vel[:-2], ts[:-2], vf, p, d, t_ref,
                ring_offset=jnp.int32(3))
        # focus level: a ring-ordered buffer + ring_offset == chronological
        t0 = t_ref - 0.5 * 10000 / p.fs_hz
        plan = bp_fast.make_plan(p, np.asarray(pos), np.asarray(ts),
                                 float(t0))
        want_img = np.asarray(bp_fast.focus_bp_fast(
            None, pos, vel, ts, vf, t0, p, presum=d, plan=plan,
            accumulate="xla", raw_spectra=spec))
        got_img = np.asarray(bp_fast.focus_bp_fast(
            None, pos, vel, ts, vf, t0, p, presum=d, plan=plan,
            accumulate="xla", raw_spectra=jnp.roll(spec, 6, axis=0),
            ring_offset=jnp.int32(6)))
        err = np.abs(got_img - want_img).max() / np.abs(want_img).max()
        assert err < 1e-6, err

    @pytest.mark.parametrize("band", [None, (37, 613)],
                             ids=["full", "band"])
    @pytest.mark.parametrize("presum", [1, 3])
    @pytest.mark.parametrize("where", ["zero", "d", "mid", "last"])
    def test_recentre_from_spectra_matches_recenter_presum(self, where,
                                                           presum, band):
        """recentre_from_spectra on a ring-ordered buffer (offsets 0, d,
        mid and P-d) == recenter_presum on the chronological raw pulses,
        with and without the band-limited output."""
        n_p, ns = 12, 1000                     # nfft = 1024
        rc, pos, vel, ts, vf, p, t_ref = _stream_case(n_p, ns, seed=5)
        d = presum
        off = {"zero": 0, "d": d, "mid": (n_p // 2) // d * d,
               "last": n_p - d}[where]
        want = bp_fast.recenter_presum(
            rc, pos, vel, ts, vf, p, d, t_ref,
            ref_conj=bp_fast.matched_filter_spectrum(p, 1024))
        ring = jnp.roll(bp_fast.forward_spectra(rc, p), off, axis=0)
        got = bp_fast.recentre_from_spectra(
            ring, pos, vel, ts, vf, p, d, t_ref, out_band=band,
            ring_offset=jnp.int32(off))
        w0 = np.asarray(want[0])
        if band is not None:
            w0 = w0[:, band[0]:band[1]]
        g0 = np.asarray(got[0])
        assert g0.shape == w0.shape == (n_p // d, w0.shape[1])
        assert np.abs(g0 - w0).max() < 1e-5 * np.abs(w0).max()
        for a, b in zip(want[1:], got[1:]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))

    def test_recentre_from_spectra_rejects_bad_band(self):
        rc, pos, vel, ts, vf, p, t_ref = _stream_case(4, 1000, seed=2)
        with pytest.raises(ValueError, match="out_band"):
            bp_fast.recentre_from_spectra(
                bp_fast.forward_spectra(rc, p), pos, vel, ts, vf, p, 1,
                t_ref, out_band=(10, 2000))

    @pytest.mark.parametrize("removed", ["pallas", "factor_pallas",
                                         "factor_kernel", "factor2_pallas"])
    def test_removed_accumulate_rejected(self, removed):
        """Accumulate values of the removed kernels raise, naming the
        valid choices, instead of silently running another path."""
        plan = bp_fast.FastBpPlan(ny_i=8, nx_i=8, w_win=32, stride=1,
                                  band_start=0, nfft=64, dx_m=1.0,
                                  t_ref=1e-3, n_org=10.0)
        with pytest.raises(ValueError, match="xla, factor, factor2"):
            bp_fast.accumulate_image(None, (None,) * 6, plan, removed)

    def test_pick_accumulate_follows_plan_levels(self):
        base = dict(ny_i=8, nx_i=8, w_win=32, stride=1, band_start=0,
                    nfft=64, dx_m=1.0, t_ref=1e-3, n_org=10.0)
        pick = bp_fast.pick_accumulate
        assert pick(bp_fast.FastBpPlan(**base)) == "xla"
        assert pick(bp_fast.FastBpPlan(**base, sub_raw=4, nx_c=32)) == "factor"
        assert pick(bp_fast.FastBpPlan(**base, sub_raw=4, nx_c=32,
                                       sub_raw1=2, nx_c1=16, grp=2)
                    ) == "factor2"

    def test_band_does_not_fit_raises(self):
        raw, traj, p, t0 = _scene(ns=512)
        big = bp_ops.BpParams(fc_hz=p.fc_hz, chirp_rate=p.chirp_rate,
                              fs_hz=p.fs_hz, pulse_width_s=p.pulse_width_s,
                              num_samples=512, nx=64, ny=64,
                              scene_size_m=3000.0)
        with pytest.raises(ValueError, match="does not fit"):
            bp_fast.make_plan(big, traj.positions, traj.times, t0)
