"""Distributed model API: sharded pipeline equals the single-device one."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import nis_sar_amtigmti_video_tpu as nst
from nis_sar_amtigmti_video_tpu import config as cfg
from nis_sar_amtigmti_video_tpu.gmti import ati, cfar, dpca
from nis_sar_amtigmti_video_tpu.models import distributed
from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu.parallel import mesh as mesh_mod
from nis_sar_amtigmti_video_tpu.utils import cplx

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


def _params(n_az, n_rg):
    g = cfg.ati_dpca().geometry
    return csa_ops.CsaParams(
        wavelength_m=cfg.ati_dpca().radar.wavelength_m,
        chirp_rate=150e6 / 2e-6, fs_hz=150e6, prf_hz=6000.0,
        velocity_mps=g.effective_velocity_mps, range_ref_m=g.slant_range_m,
        t_start_fast=2 * g.slant_range_m / 299792458.0,
        num_pulses=n_az, num_samples=n_rg)


@needs_8
class TestShardedGmti:
    def test_matches_single_device(self):
        n_az, n_rg, n_f = 32, 64, 4
        p = _params(n_az, n_rg)
        key = jax.random.PRNGKey(0)
        raw = jax.lax.complex(
            jax.random.normal(key, (n_f, 2, n_az, n_rg), jnp.float32),
            jax.random.normal(jax.random.fold_in(key, 1),
                              (n_f, 2, n_az, n_rg), jnp.float32))

        mesh = mesh_mod.make_mesh((2, 2, 2))
        step = distributed.make_gmti_step(mesh, p, shift_pulses=0)
        out = step(jax.device_put(raw, distributed.raw_sharding(mesh)))

        # single-device reference with matching (global-mean) balance
        phases = csa_ops.csa_phases(p)
        slc = csa_ops.apply_csa(raw, phases)
        s1, s2 = slc[:, 0], slc[:, 1]
        ifg = s1 * jnp.conj(s2)
        m = jnp.sum(ifg)
        cal = m / jnp.abs(m)
        s2b = s2 * cal
        diff = s1 - s2b
        want_dpca = np.abs(cplx.to_host(diff))
        got_dpca = cplx.to_host(out.dpca_mag)
        np.testing.assert_allclose(got_dpca, want_dpca, rtol=0,
                                   atol=3e-4 * want_dpca.max())

        mag1 = np.abs(cplx.to_host(s1))
        want_phase = np.where(mag1 > 0.05 * mag1.max(),
                              np.angle(cplx.to_host(ifg * jnp.conj(cal))), 0.0)
        got_phase = cplx.to_host(out.ati_phase)
        strong = mag1 > 0.1 * mag1.max()
        np.testing.assert_allclose(got_phase[strong], want_phase[strong],
                                   atol=2e-3)
        assert np.isfinite(float(np.asarray(out.cancellation)))
        # CFAR must equal the single-device detector (halo-complete, no
        # zero-padded internal shard borders)
        from nis_sar_amtigmti_video_tpu.gmti import cfar as cfar_mod
        det = cfar_mod.ca_cfar(jnp.abs(diff) ** 2, cfar_mod.CfarParams())
        np.testing.assert_allclose(cplx.to_host(out.cfar_snr),
                                   cplx.to_host(det.snr), rtol=2e-3,
                                   atol=1e-3)

    def test_latency_mode_one_cpi(self):
        """Latency-mode composition: ONE CPI spread over the whole mesh —
        F=1 on a (1, 2, 4) mesh, so the 2 channels ride 'chan' and the
        range axis splits 4-way over 'seq'. Every product (balance, ATI,
        DPCA, CFAR, cancellation) must equal the composed single-device
        pipeline."""
        n_az, n_rg = 64, 256
        p = _params(n_az, n_rg)
        key = jax.random.PRNGKey(3)
        raw = jax.lax.complex(
            jax.random.normal(key, (1, 2, n_az, n_rg), jnp.float32),
            jax.random.normal(jax.random.fold_in(key, 1),
                              (1, 2, n_az, n_rg), jnp.float32))

        mesh = mesh_mod.make_mesh((1, 2, 4))
        step = distributed.make_gmti_step(mesh, p, shift_pulses=0)
        out = step(jax.device_put(raw, distributed.raw_sharding(mesh)))

        phases = csa_ops.csa_phases(p)
        slc = csa_ops.apply_csa(raw, phases)
        s1, s2 = slc[:, 0], slc[:, 1]
        ifg = s1 * jnp.conj(s2)
        m = jnp.sum(ifg)
        cal = m / jnp.abs(m)
        diff = s1 - s2 * cal
        want = np.abs(cplx.to_host(diff))
        got = cplx.to_host(out.dpca_mag)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-4 * want.max())
        det = cfar.ca_cfar(jnp.abs(diff) ** 2, cfar.CfarParams())
        np.testing.assert_allclose(cplx.to_host(out.cfar_snr),
                                   cplx.to_host(det.snr), rtol=2e-3,
                                   atol=1e-3)
        assert np.isfinite(float(np.asarray(out.cancellation)))

    def test_halo_cfar_bitexact(self):
        """The ppermute halo-exchange CFAR (in place of a full-plane
        all_gather) must reproduce the single-device detector
        BIT-EXACTLY on a fixed power plane: interior shards read true
        neighbor training columns; mesh-edge shards read ppermute's zero
        fill, which is exactly ca_cfar's zero padding."""
        from functools import partial

        from jax.sharding import Mesh, PartitionSpec as P

        rng = np.random.default_rng(7)
        for n_az, n_rg, n_seq in ((64, 256, 4), (32, 1024, 8)):
            pw = (rng.standard_normal((n_az, n_rg)).astype(np.float32) ** 2
                  * 10.0 ** rng.uniform(-4, 4, (n_az, n_rg)
                                        ).astype(np.float32))
            devs = np.array(jax.devices()[:n_seq]).reshape(1, n_seq)
            mesh = Mesh(devs, ("chan", "seq"))
            cp = cfar.CfarParams()
            body = partial(distributed._cfar_snr_halo, cfar_params=cp,
                           n_seq=n_seq, ns_global=n_rg)
            f = jax.jit(jax.shard_map(body, mesh=mesh,
                                      in_specs=P(None, "seq"),
                                      out_specs=P(None, "seq"),
                                      check_vma=False))
            got = np.asarray(f(jnp.asarray(pw)))
            want = np.asarray(cfar.ca_cfar(jnp.asarray(pw), cp).snr)
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("guard,train", [(0, 4), (0, 1), (0, 8)])
    def test_halo_cfar_zero_half_window(self, guard, train):
        """A zero inner half-window (guard=0) must exchange an EMPTY
        halo for it — a negative-zero slice would ship the whole shard —
        and still match the single-device detector bit-exactly."""
        from functools import partial

        from jax.sharding import Mesh, PartitionSpec as P

        rng = np.random.default_rng(5)
        n_az, n_rg, n_seq = 32, 256, 4
        pw = (rng.standard_normal((n_az, n_rg)) ** 2).astype(np.float32)
        mesh = Mesh(np.array(jax.devices()[:n_seq]).reshape(1, n_seq),
                    ("chan", "seq"))
        cp = cfar.CfarParams(guard=guard, train=train)
        body = partial(distributed._cfar_snr_halo, cfar_params=cp,
                       n_seq=n_seq, ns_global=n_rg)
        f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(None, "seq"),
                                  out_specs=P(None, "seq"), check_vma=False))
        got = np.asarray(f(jnp.asarray(pw)))
        want = np.asarray(cfar.ca_cfar(jnp.asarray(pw), cp).snr)
        np.testing.assert_array_equal(got, want)

    def test_halo_cfar_too_narrow_raises(self):
        from functools import partial

        from jax.sharding import Mesh, PartitionSpec as P

        devs = np.array(jax.devices()[:8]).reshape(1, 8)
        mesh = Mesh(devs, ("chan", "seq"))
        cp = cfar.CfarParams()       # h_o = 10 > 64/8 columns per shard
        body = partial(distributed._cfar_snr_halo, cfar_params=cp,
                       n_seq=8, ns_global=64)
        f = jax.shard_map(body, mesh=mesh, in_specs=P(None, "seq"),
                          out_specs=P(None, "seq"), check_vma=False)
        with pytest.raises(ValueError, match="narrower than the CFAR"):
            f(jnp.ones((16, 64), jnp.float32))

    def test_dpca_shift_applied(self):
        """With shift_pulses=1 the step must cancel a DPCA-coherent pair:
        build channels where ch1[k+1] == ch2[k]; after the shift the
        difference is ~0 while the unshifted difference is large."""
        n_az, n_rg, n_f = 33, 64, 2   # 33 pulses -> 32 after shift (div by 2)
        p = _params(n_az - 1, n_rg)
        key = jax.random.PRNGKey(9)
        base = jax.lax.complex(
            jax.random.normal(key, (n_f, n_az, n_rg), jnp.float32),
            jax.random.normal(jax.random.fold_in(key, 1),
                              (n_f, n_az, n_rg), jnp.float32))
        ch1 = base
        ch2 = jnp.roll(base, -1, axis=1)  # ch2[k] == ch1[k+1] -> ch1[1:] == ch2[:-1]
        raw = jnp.stack([ch1, ch2], axis=1)
        mesh = mesh_mod.make_mesh((2, 2, 2))
        step = distributed.make_gmti_step(mesh, p, shift_pulses=1)
        # pre-shift P=33 is not seq-divisible; jit inserts the reshard after
        # the in-step co-registration slice
        out = step(raw)
        dpca = cplx.to_host(out.dpca_mag)
        s_ref = np.abs(cplx.to_host(csa_ops.apply_csa(
            base[:, 1:], csa_ops.csa_phases(p))))
        # cancellation deep: DPCA residual tiny relative to the SLC field
        assert dpca.max() < 1e-3 * s_ref.max()

    def test_videosar_step(self):
        n_az, n_rg, n_f = 32, 64, 8
        p = _params(n_az, n_rg)
        key = jax.random.PRNGKey(3)
        raw = jax.lax.complex(
            jax.random.normal(key, (n_f, n_az, n_rg), jnp.float32),
            jax.random.normal(jax.random.fold_in(key, 2),
                              (n_f, n_az, n_rg), jnp.float32))
        mesh = mesh_mod.make_mesh((4, 1, 2))
        step = distributed.make_videosar_step(mesh, p)
        got = cplx.to_host(step(raw))
        want = cplx.to_host(csa_ops.apply_csa(raw, csa_ops.csa_phases(p)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-4 * np.abs(want).max())


@needs_8
class TestShardedBp:
    def test_frame_sharded_bp_equals_local(self):
        """Backprojection frames sharded over 'data' equal the local run."""
        import dataclasses
        from nis_sar_amtigmti_video_tpu.geometry import orbit
        from nis_sar_amtigmti_video_tpu.models.videosar import (
            form_frames_bp, bp_params_for, spotlight_echo_opts,
            antenna_length_for_swath)
        from nis_sar_amtigmti_video_tpu.ops.echo import (phase_history,
                                                         window_start_time)
        from nis_sar_amtigmti_video_tpu.scene import targets as T

        sc = cfg.videosar().replace(
            radar=dataclasses.replace(cfg.videosar().radar,
                                      bandwidth_hz=120e6, pulse_width_s=2e-6,
                                      fs_hz=150e6, prf_hz=1000.0),
            collect=dataclasses.replace(cfg.videosar().collect,
                                        window_length_s=256 / 150e6),
            processing=dataclasses.replace(cfg.videosar().processing,
                                           bp_grid=24, bp_scene_size_m=300.0))
        g = sc.geometry
        opts = spotlight_echo_opts(sc, antenna_length_for_swath(sc, 300.0))
        t0 = __import__("nis_sar_amtigmti_video_tpu.ops.echo",
                        fromlist=["window_start_time"]).window_start_time(
            g.slant_range_m, opts, sc.collect.window_length_s, "centered")
        p_bp = bp_params_for(sc, opts, "f32")
        traj = orbit.make_trajectory(g, np.linspace(-0.2, 0.2, 64))
        frames, poss, vels, ts = [], [], [], []
        for f in range(8):
            sl = traj.slice(f * 8, f * 8 + 16) if f < 6 else traj.slice(0, 16)
            raw = phase_history(sl, T.point_target((0, 0, 0), 10.0), opts,
                                t_start=t0)
            frames.append(raw); poss.append(sl.positions)
            vels.append(sl.velocities); ts.append(sl.times)
        raw_b = jnp.stack(frames)
        pos_b = jnp.asarray(np.stack(poss))
        vel_b = jnp.asarray(np.stack(vels))
        t_b = jnp.asarray(np.stack(ts))
        vf = jnp.zeros(3)
        want = cplx.to_host(form_frames_bp(raw_b, pos_b, vel_b, t_b, vf,
                                           jnp.float64(t0), p_bp))

        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = mesh_mod.make_mesh((8, 1, 1))
        sh4 = NamedSharding(mesh, P("data", None, None))
        got = cplx.to_host(form_frames_bp(
            jax.device_put(raw_b, sh4),
            jax.device_put(pos_b, NamedSharding(mesh, P("data", None, None))),
            jax.device_put(vel_b, NamedSharding(mesh, P("data", None, None))),
            jax.device_put(t_b, NamedSharding(mesh, P("data", None))),
            vf, jnp.float64(t0), p_bp))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
