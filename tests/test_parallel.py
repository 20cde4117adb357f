"""Multi-device tests on the 8-device virtual CPU mesh: sharded runs must
equal single-device runs (the framework's substitute for cluster tests)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import nis_sar_amtigmti_video_tpu as nst
from nis_sar_amtigmti_video_tpu import config as cfg
from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu.parallel import corner_turn, mesh as mesh_mod
from nis_sar_amtigmti_video_tpu.utils import cplx


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


class TestMeshShapes:
    def test_pick_shape(self):
        assert mesh_mod.pick_mesh_shape(8, 2) == (2, 2, 2)
        assert mesh_mod.pick_mesh_shape(4, 2) == (2, 2, 1)
        assert mesh_mod.pick_mesh_shape(2, 2) == (1, 2, 1)
        assert mesh_mod.pick_mesh_shape(1, 2) == (1, 1, 1)
        assert mesh_mod.pick_mesh_shape(8, 1) == (4, 1, 2)
        for n, c in [(8, 2), (4, 2), (16, 2), (8, 4)]:
            assert np.prod(mesh_mod.pick_mesh_shape(n, c)) == n

    @needs_8
    def test_make_mesh(self):
        m = mesh_mod.make_mesh((2, 2, 2))
        assert m.axis_names == ("data", "chan", "seq")
        assert m.devices.shape == (2, 2, 2)


@needs_8
class TestCornerTurn:
    def test_round_trip_identity(self):
        m = mesh_mod.make_mesh((1, 1, 8))
        x = jax.random.normal(jax.random.PRNGKey(0), (32, 64))

        def body(xl):
            y = corner_turn.corner_turn_local(xl, "seq", to_range_sharded=True)
            return corner_turn.corner_turn_local(y, "seq", to_range_sharded=False)

        f = jax.shard_map(body, mesh=m, in_specs=P("seq", None),
                          out_specs=P("seq", None))
        np.testing.assert_allclose(np.asarray(f(x)), np.asarray(x))

    def test_turn_moves_shard_axis(self):
        m = mesh_mod.make_mesh((1, 1, 8))
        x = jnp.arange(32 * 64, dtype=jnp.float32).reshape(32, 64)

        def body(xl):
            return corner_turn.corner_turn_local(xl, "seq",
                                                 to_range_sharded=True)

        f = jax.shard_map(body, mesh=m, in_specs=P("seq", None),
                          out_specs=P(None, "seq"))
        np.testing.assert_allclose(np.asarray(f(x)), np.asarray(x))


@needs_8
class TestDistributedCsa:
    def _phases_and_raw(self, n_az=64, n_rg=128):
        sc = cfg.ati_dpca()
        p = csa_ops.CsaParams(
            wavelength_m=sc.radar.wavelength_m, chirp_rate=150e6 / 2e-6,
            fs_hz=150e6, prf_hz=6000.0,
            velocity_mps=sc.geometry.effective_velocity_mps,
            range_ref_m=sc.geometry.slant_range_m,
            t_start_fast=2 * sc.geometry.slant_range_m / 299792458.0,
            num_pulses=n_az, num_samples=n_rg)
        key = jax.random.PRNGKey(3)
        raw = jax.lax.complex(
            jax.random.normal(key, (n_az, n_rg), jnp.float32),
            jax.random.normal(jax.random.fold_in(key, 1), (n_az, n_rg),
                              jnp.float32))
        return p, raw

    def test_matches_single_device(self):
        p, raw = self._phases_and_raw()
        phases = csa_ops.csa_phases(p)
        want = cplx.to_host(csa_ops.apply_csa(raw, phases))

        m = mesh_mod.make_mesh((1, 1, 8))
        raw_sh = jax.device_put(raw, NamedSharding(m, P(None, None)))
        got = cplx.to_host(corner_turn.csa_sharded(raw_sh, phases, m))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())

    def test_batched_frames(self):
        p, raw = self._phases_and_raw()
        phases = csa_ops.csa_phases(p)
        frames = jnp.stack([raw, raw * 2.0, raw * (0.5 + 1.0j), raw - 1.0])
        want = cplx.to_host(csa_ops.apply_csa(frames, phases))

        m = mesh_mod.make_mesh((4, 1, 2))
        fr_sh = jax.device_put(frames, NamedSharding(m, P("data", None, None)))
        got = cplx.to_host(corner_turn.csa_sharded(fr_sh, phases, m))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())


@needs_8
class TestDataParallelFormation:
    def test_sharded_equals_local(self):
        """Frame-batched CSA under jit with frames sharded over 'data' must
        be identical to the unsharded run."""
        sc = cfg.ati_dpca()
        p = csa_ops.CsaParams(
            wavelength_m=sc.radar.wavelength_m, chirp_rate=150e6 / 2e-6,
            fs_hz=150e6, prf_hz=6000.0,
            velocity_mps=sc.geometry.effective_velocity_mps,
            range_ref_m=sc.geometry.slant_range_m,
            t_start_fast=2 * sc.geometry.slant_range_m / 299792458.0,
            num_pulses=32, num_samples=64)
        key = jax.random.PRNGKey(5)
        frames = jax.lax.complex(
            jax.random.normal(key, (8, 32, 64), jnp.float32),
            jax.random.normal(jax.random.fold_in(key, 1), (8, 32, 64),
                              jnp.float32))
        phases = csa_ops.csa_phases(p)
        want = cplx.to_host(csa_ops.apply_csa(frames, phases))

        m = mesh_mod.make_mesh((8, 1, 1))
        sh = mesh_mod.frame_sharding(m)
        f = jax.jit(lambda x: csa_ops.apply_csa(x, phases),
                    in_shardings=sh, out_shardings=sh)
        got = cplx.to_host(f(jax.device_put(frames, sh)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


class TestPipelined:
    """parallel/pipeline.pipelined — the stage-overlap component
    (SURVEY §2.10 'pipeline parallel'; ref sar_batch_sim.py:312-328 is the
    serial loop it replaces)."""

    def test_order_and_results_match_serial_map(self):
        from nis_sar_amtigmti_video_tpu.parallel.pipeline import pipelined
        items = list(range(17))
        got = list(pipelined(lambda x: x * x, items, depth=3))
        assert got == [x * x for x in items]

    def test_depth_bounds_inflight(self):
        """At most `depth` dispatched-but-unfetched handles at any time."""
        from nis_sar_amtigmti_video_tpu.parallel.pipeline import pipelined
        live = set()
        peak = 0

        def dispatch(x):
            live.add(x)
            nonlocal peak
            peak = max(peak, len(live))
            return x

        def fetch(x):
            live.discard(x)
            return -x

        got = list(pipelined(dispatch, range(10), depth=2, fetch=fetch))
        assert got == [-x for x in range(10)]
        # the pipeline admits depth+1 momentarily (dispatch happens before
        # the oldest is fetched), never more
        assert peak <= 3

    def test_depth_validation_and_device_arrays(self):
        from nis_sar_amtigmti_video_tpu.parallel.pipeline import pipelined
        with pytest.raises(ValueError):
            list(pipelined(lambda x: x, [1], depth=0))
        # jax async-dispatch path: device compute in flight, fetched in order
        xs = [jnp.arange(4.0) + i for i in range(5)]
        f = jax.jit(lambda a: (a * 2.0).sum())
        got = list(pipelined(f, xs, depth=2, fetch=lambda h: float(h)))
        assert got == [float((x * 2).sum()) for x in xs]


@needs_8
class TestShardedBP:
    def test_pulse_sharded_equals_local(self):
        """Pulse-sharded BP (psum of partial images) == single-device BP,
        including the mBP moving grid (global CPI mid-time, not per-shard)."""
        from nis_sar_amtigmti_video_tpu.geometry import orbit
        from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
        from nis_sar_amtigmti_video_tpu.ops.echo import (
            EchoOpts, phase_history, window_start_time)
        from nis_sar_amtigmti_video_tpu.scene import targets as T

        sc = cfg.videosar()
        g = sc.geometry
        n_p, n_s = 64, 512
        traj = orbit.make_trajectory(g, orbit.slow_time_grid(n_p / 5000.0, n_p))
        opts = EchoOpts(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6,
                        pulse_width_s=2e-6, fs_hz=150e6, num_samples=n_s,
                        endpoint_grid=False, chirp_centering="centered",
                        amplitude="rcs", stop_and_go=True)
        t0 = window_start_time(g.slant_range_m, opts, n_s / opts.fs_hz,
                               "centered")
        vel = np.array([10.0, 0.0, 0.0])
        raw = phase_history(traj, T.point_target((0.0, 0.0, 0.0), 50.0),
                            opts, t_start=t0, target_velocity=vel)
        p = bp_ops.BpParams(fc_hz=opts.fc_hz, chirp_rate=opts.chirp_rate,
                            fs_hz=opts.fs_hz, pulse_width_s=opts.pulse_width_s,
                            num_samples=n_s, nx=32, ny=32, scene_size_m=200.0,
                            pulse_block=8)
        rc = bp_ops.bp_range_compress(raw, p)
        pos = jnp.asarray(traj.positions); ve = jnp.asarray(traj.velocities)
        ts = jnp.asarray(traj.times)
        vf = jnp.asarray(vel, jnp.float64)
        want = cplx.to_host(bp_ops.backproject(rc, pos, ve, ts, vf,
                                               jnp.float64(t0), p))
        m = mesh_mod.make_mesh((1, 1, 8))
        got = cplx.to_host(corner_turn.bp_sharded(
            rc, pos, ve, ts, vf, jnp.float64(t0), p, m, axis="seq"))
        np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())

    def test_fast_bp_pulse_sharded_equals_local(self):
        """Pulse-sharded fast BP (fused compress + local accumulate + psum
        of internal images) == single-device backproject_fast, mBP grid."""
        from nis_sar_amtigmti_video_tpu.geometry import orbit
        from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
        from nis_sar_amtigmti_video_tpu.ops import bp_fast
        from nis_sar_amtigmti_video_tpu.ops.echo import (
            EchoOpts, phase_history, window_start_time)
        from nis_sar_amtigmti_video_tpu.scene import targets as T

        sc = cfg.videosar()
        g = sc.geometry
        n_p, n_s = 64, 1024
        traj = orbit.make_trajectory(g, orbit.slow_time_grid(n_p / 5000.0,
                                                             n_p))
        opts = EchoOpts(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6,
                        pulse_width_s=2e-6, fs_hz=180e6, num_samples=n_s,
                        endpoint_grid=False, chirp_centering="centered",
                        amplitude="rcs", stop_and_go=True)
        t0 = window_start_time(g.slant_range_m, opts, n_s / opts.fs_hz,
                               "centered")
        vel = np.array([10.0, 0.0, 0.0])
        raw = phase_history(traj, T.point_target((0.0, 0.0, 0.0), 50.0),
                            opts, t_start=t0, target_velocity=vel)
        p = bp_ops.BpParams(fc_hz=opts.fc_hz, chirp_rate=opts.chirp_rate,
                            fs_hz=opts.fs_hz,
                            pulse_width_s=opts.pulse_width_s,
                            num_samples=n_s, nx=32, ny=32,
                            scene_size_m=200.0)
        plan = bp_fast.make_plan(p, np.asarray(traj.positions),
                                 np.asarray(traj.times), float(t0))
        pos = jnp.asarray(traj.positions)
        ve = jnp.asarray(traj.velocities)
        ts = jnp.asarray(traj.times)
        vf = jnp.asarray(vel, jnp.float64)
        want = cplx.to_host(bp_fast.backproject_fast(
            raw, pos, ve, ts, vf, p, plan, presum=2, compress=True))
        m = mesh_mod.make_mesh((1, 1, 8))
        got = cplx.to_host(corner_turn.bp_fast_sharded(
            raw, pos, ve, ts, vf, jnp.float64(t0), p, plan, m, axis="seq",
            presum=2))
        np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())

    def _bp_scene(self, w_win=32, factorize=False, n_s=1024):
        from nis_sar_amtigmti_video_tpu.geometry import orbit
        from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
        from nis_sar_amtigmti_video_tpu.ops import bp_fast
        from nis_sar_amtigmti_video_tpu.ops.echo import (
            EchoOpts, phase_history, window_start_time)
        from nis_sar_amtigmti_video_tpu.scene import targets as T

        sc = cfg.videosar()
        g = sc.geometry
        n_p = 64
        traj = orbit.make_trajectory(g, orbit.slow_time_grid(n_p / 5000.0,
                                                             n_p))
        opts = EchoOpts(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6,
                        pulse_width_s=2e-6, fs_hz=180e6, num_samples=n_s,
                        endpoint_grid=False, chirp_centering="centered",
                        amplitude="rcs", stop_and_go=True)
        t0 = window_start_time(g.slant_range_m, opts, n_s / opts.fs_hz,
                               "centered")
        vel = np.array([10.0, 0.0, 0.0])
        raw = phase_history(traj, T.point_target((0.0, 0.0, 0.0), 50.0),
                            opts, t_start=t0, target_velocity=vel)
        p = bp_ops.BpParams(fc_hz=opts.fc_hz, chirp_rate=opts.chirp_rate,
                            fs_hz=opts.fs_hz,
                            pulse_width_s=opts.pulse_width_s,
                            num_samples=n_s, nx=32, ny=32,
                            scene_size_m=200.0)
        plan = bp_fast.make_plan(p, np.asarray(traj.positions),
                                 np.asarray(traj.times), float(t0),
                                 w_win=w_win, factorize=factorize)
        return raw, traj, p, plan, float(t0), vel

    def test_fast_bp_sharded_factor_accumulate(self):
        """Sharded factorized (sub-aperture) accumulate vs the single-device
        factorized path: per-shard anchors change only the band-limited
        merge's ~-100 dB interpolation error, so a loose-but-tight bound
        holds."""
        from nis_sar_amtigmti_video_tpu.ops import bp_fast

        raw, traj, p, plan, t0, vel = self._bp_scene(factorize=True)
        assert plan.sub_raw > 0
        pos = jnp.asarray(traj.positions)
        ve = jnp.asarray(traj.velocities)
        ts = jnp.asarray(traj.times)
        vf = jnp.asarray(vel, jnp.float64)
        want = cplx.to_host(bp_fast.backproject_fast(
            raw, pos, ve, ts, vf, p, plan, presum=2, compress=True,
            accumulate="factor"))
        m = mesh_mod.make_mesh((1, 1, 8))
        got = cplx.to_host(corner_turn.bp_fast_sharded(
            raw, pos, ve, ts, vf, jnp.float64(t0), p, plan, m, axis="seq",
            presum=2, accumulate="factor"))
        np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max())

    def test_fast_bp_sharded_factor2_accumulate(self):
        """Sharded two-level factorized accumulate vs the single-device
        factor2 path (per-shard anchors again change only the band-limited
        merge error)."""
        from nis_sar_amtigmti_video_tpu.ops import bp_fast

        raw, traj, p, plan, t0, vel = self._bp_scene(factorize=True)
        assert plan.sub_raw1 > 0 and plan.grp >= 2
        pos = jnp.asarray(traj.positions)
        ve = jnp.asarray(traj.velocities)
        ts = jnp.asarray(traj.times)
        vf = jnp.asarray(vel, jnp.float64)
        want = cplx.to_host(bp_fast.backproject_fast(
            raw, pos, ve, ts, vf, p, plan, presum=2, compress=True,
            accumulate="factor2"))
        m = mesh_mod.make_mesh((1, 1, 8))
        got = cplx.to_host(corner_turn.bp_fast_sharded(
            raw, pos, ve, ts, vf, jnp.float64(t0), p, plan, m, axis="seq",
            presum=2, accumulate="factor2"))
        np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max())

    def test_fast_bp_sharded_spectra(self):
        """The sharded streaming raw_spectra feed (XLA recentre from cached
        spectra per shard) must match the single-device spectra path and
        the raw-pulse path."""
        from nis_sar_amtigmti_video_tpu.ops import bp_fast

        raw, traj, p, plan, t0, vel = self._bp_scene(n_s=9000)
        pos = jnp.asarray(traj.positions)
        ve = jnp.asarray(traj.velocities)
        ts = jnp.asarray(traj.times)
        vf = jnp.asarray(vel, jnp.float64)
        want = cplx.to_host(bp_fast.backproject_fast(
            raw, pos, ve, ts, vf, p, plan, presum=2, compress=True,
            accumulate="xla"))
        spec = bp_fast.forward_spectra(raw, p)
        local = cplx.to_host(bp_fast.backproject_fast(
            None, pos, ve, ts, vf, p, plan, presum=2, compress=True,
            accumulate="xla", raw_spectra=spec))
        np.testing.assert_allclose(local, want,
                                   atol=1e-3 * np.abs(want).max())
        m = mesh_mod.make_mesh((1, 1, 8))
        sspec = cplx.to_host(corner_turn.bp_fast_sharded(
            None, pos, ve, ts, vf, jnp.float64(t0), p, plan, m, axis="seq",
            presum=2, accumulate="xla", raw_spectra=spec))
        np.testing.assert_allclose(sspec, local,
                                   atol=2e-4 * np.abs(want).max())

    def test_fast_bp_sharded_rejects_removed_accumulate(self):
        from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
        from nis_sar_amtigmti_video_tpu.ops import bp_fast

        p = bp_ops.BpParams(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6,
                            fs_hz=180e6, pulse_width_s=2e-6,
                            num_samples=1024, nx=32, ny=32,
                            scene_size_m=200.0)
        plan = bp_fast.FastBpPlan(ny_i=128, nx_i=128, w_win=32, stride=1,
                                  band_start=7, nfft=1024, dx_m=1.0,
                                  t_ref=1e-3, n_org=100.0)
        m = mesh_mod.make_mesh((1, 1, 8))
        with pytest.raises(ValueError, match="xla, factor, factor2"):
            corner_turn.bp_fast_sharded(
                jnp.zeros((64, 1024), jnp.complex64), jnp.zeros((64, 3)),
                jnp.zeros((64, 3)), jnp.zeros(64), jnp.zeros(3),
                jnp.float64(0.0), p, plan, m, presum=2, accumulate="pallas")

    def test_fast_bp_sharded_rejects_ragged(self):
        from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
        from nis_sar_amtigmti_video_tpu.ops import bp_fast

        p = bp_ops.BpParams(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6,
                            fs_hz=180e6, pulse_width_s=2e-6,
                            num_samples=1024, nx=32, ny=32,
                            scene_size_m=200.0)
        plan = bp_fast.FastBpPlan(ny_i=128, nx_i=128, w_win=32, stride=1,
                                  band_start=7, nfft=1024, dx_m=1.0,
                                  t_ref=1e-3, n_org=100.0)
        m = mesh_mod.make_mesh((1, 1, 8))
        with pytest.raises(ValueError, match="divisible"):
            corner_turn.bp_fast_sharded(
                jnp.zeros((60, 1024), jnp.complex64), jnp.zeros((60, 3)),
                jnp.zeros((60, 3)), jnp.zeros(60), jnp.zeros(3),
                jnp.float64(0.0), p, plan, m, presum=2)
