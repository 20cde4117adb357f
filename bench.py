"""Benchmark: GMTI-inclusive VideoSAR throughput at 4096x4096 on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/sec", "vs_baseline": N, ...}

value        — frames/sec of the COMPLETE per-CPI GMTI pipeline: two-channel
               4096^2 CSA formation (ops/csa.py::apply_csa_fused) with
               channel balance + ATI phase + DPCA magnitude + CA-CFAR
               (gmti/fused.py::gmti_product_step), every product plane
               consumed, timed warm with ``jax.block_until_ready``.
vs_baseline  — speedup over the NumPy reference doing the same GMTI step
               (2x oracle CSA + numpy products on this host).

Every metric key in the JSON either has a value or a reason. The
per-section `sections` map records {status, elapsed_s, path} for ALL
sections — "ok", "skipped: <why>" (budget arithmetic spelled out, or the
BENCH_SKIP_* env var), or "error: <repr>"; any error makes the exit code 1.
The output names the device it ran on (platform, device_kind, count, and
the card's name and power limit). A bench run needs a GPU: on any other
platform it exits non-zero with no metric, unless BENCH_SMOKE=1 asks for a
control-flow smoke run, which runs the sections and reports no timing.

Extra keys: csa_formation_fps (single-channel formation-only stream),
bp_frame_ms (gather-free fast BP at the reference 512^2 x 2,500-pulse
VideoSAR scale), bp_stream_frame_ms, sim_pass_s, e2e_fullscale_s,
hrws_recon_ms, numpy_gmti_fps.
"""

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Pin the BLAS/FFT thread pool BEFORE numpy loads so the NumPy-baseline
# denominator is reproducible across hosts/runs. A fixed count, capped by
# the machine.
_NP_THREADS = str(min(8, os.cpu_count() or 8))
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
           "NUMEXPR_NUM_THREADS", "VECLIB_MAXIMUM_THREADS"):
    os.environ.setdefault(_v, _NP_THREADS)

import numpy as np


def _rnd(x, nd):
    """Round-for-JSON that treats 0.0 as a real measurement (`is not None`,
    not truthiness — an exact-zero reading must not report as null)."""
    return None if x is None else round(x, nd)


def main():
    t_proc0 = time.perf_counter()
    budget_s = float(os.environ.get("BENCH_TIME_BUDGET", "1800"))
    # seconds held back for the NumPy-denominator section: without the
    # denominator `vs_baseline` is null, so every earlier section's budget
    # check subtracts this reservation before deciding it can run.
    np_reserve = float(os.environ.get("BENCH_NUMPY_RESERVE", "300"))
    if os.environ.get("BENCH_SKIP_NUMPY", "0") == "1":
        np_reserve = 0.0

    sections = {}
    m = {}                      # metric name -> value (None until measured)

    def section(name, est_s, fn, *, reserve=True, skip_env=None):
        """Run one bench section with explicit status accounting.

        est_s is the section's worst-case cost estimate (compile +
        measurement); the section is skipped — with the
        arithmetic recorded — when the remaining budget minus the NumPy
        reservation cannot cover it. Exceptions are caught ONCE here and
        recorded as `error: <repr>`; nothing is silently swallowed."""
        t0 = time.perf_counter()
        if skip_env is not None and os.environ.get(skip_env, "0") == "1":
            sections[name] = {"status": f"skipped: {skip_env}=1",
                              "elapsed_s": 0.0}
            return False
        remaining = budget_s - (t0 - t_proc0)
        held = np_reserve if reserve else 0.0
        if remaining - held < est_s:
            sections[name] = {
                "status": (f"skipped: budget (remaining {remaining:.0f}s"
                           f" - reserved {held:.0f}s < est {est_s:.0f}s)"),
                "elapsed_s": 0.0}
            return False
        print(f"[bench] {name}: start (t={t0 - t_proc0:.0f}s)",
              file=sys.stderr, flush=True)
        try:
            fn()
            status = "ok"
        except Exception as e:  # noqa: BLE001 — recorded, never swallowed
            status = f"error: {e!r}"[:300]
        el = round(time.perf_counter() - t0, 1)
        sections[name] = {"status": status, "elapsed_s": el}
        print(f"[bench] {name}: {status} ({el}s)", file=sys.stderr,
              flush=True)
        return status == "ok"

    import jax

    import jax.numpy as jnp

    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.gmti import cfar
    from nis_sar_amtigmti_video_tpu.gmti.fused import gmti_product_step
    from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
    from nis_sar_amtigmti_video_tpu.ops.echo import window_start_time
    from nis_sar_amtigmti_video_tpu.utils import runtime

    runtime.enable_compile_cache()
    device = runtime.device_record()
    smoke = os.environ.get("BENCH_SMOKE", "0") == "1"
    if device["platform"] != "gpu" and not smoke:
        print(json.dumps({
            "metric": "videosar_gmti_stream", "value": None,
            "unit": "frames/sec", "device": device,
            "error": f"no GPU: JAX runs on {device['platform']!r}; a bench "
                     "run measures the card only (BENCH_SMOKE=1 runs the "
                     "sections without timing)"}))
        sys.exit(1)
    size = int(os.environ.get("BENCH_SIZE", "4096"))
    ncpi = int(os.environ.get("BENCH_NCPI", "2"))
    iters = int(os.environ.get("BENCH_ITERS", "8"))
    fft_impl = "xla"
    paths = {}

    sc = cfg.videosar()
    g, r = sc.geometry, sc.radar
    t0 = window_start_time(g.slant_range_m, None, sc.collect.window_length_s,
                           "centered")
    p = csa_ops.CsaParams(
        wavelength_m=r.wavelength_m, chirp_rate=r.chirp_rate, fs_hz=r.fs_hz,
        prf_hz=r.prf_hz, velocity_mps=g.effective_velocity_mps,
        range_ref_m=g.slant_range_m, t_start_fast=t0,
        num_pulses=size, num_samples=size)
    f = csa_ops.csa_factors(p)
    cfar_p = cfar.CfarParams(guard=2, train=8)

    # Each timed loop chains device-resident state and waits ONCE at the end
    # (jax.block_until_ready), so host dispatch overlaps device work.
    sync = jax.block_until_ready

    @jax.jit
    def mk(key):
        return (jax.random.normal(key, (ncpi, 2, size, size), jnp.float32),
                jax.random.normal(jax.random.fold_in(key, 1),
                                  (ncpi, 2, size, size), jnp.float32))

    def form(xr, xi):
        slc = csa_ops.apply_csa_fused(
            jax.lax.complex(xr, xi).reshape(-1, size, size), f, fft_impl)
        return (jnp.real(slc).reshape(ncpi, 2, size, size),
                jnp.imag(slc).reshape(ncpi, 2, size, size))

    # ---- 1. headline: two-channel GMTI stream ----
    def sec_gmti():
        def gmti_batch(xr, xi):
            sr, si = form(xr, xi)
            slc = jax.lax.complex(sr, si)

            def prods(s):
                _, phase, dmag, det = gmti_product_step(
                    s[0], s[1], cfar_params=cfar_p)
                return phase, dmag, det.snr

            ph, dm, snr = jax.vmap(prods)(slc)
            return sr, si, jnp.sum(ph) + jnp.sum(dm) + jnp.sum(snr)

        gmti_fn = jax.jit(gmti_batch, donate_argnums=(0, 1))
        xr, xi = mk(jax.random.PRNGKey(0))
        xr, xi, s = sync(gmti_fn(xr, xi))              # compile + first run
        t1 = time.perf_counter()
        for _i in range(iters):
            xr, xi, s = gmti_fn(xr, xi)
        sync(s)
        m["gmti_ms"] = (1000.0 * (time.perf_counter() - t1)
                        / (iters * ncpi))
        paths["gmti"] = f"composed (apply_csa_fused fft_impl={fft_impl})"

    section("gmti", 420, sec_gmti, skip_env="BENCH_SKIP_GMTI")

    # ---- 2. full-scale END-TO-END GMTI + the per-channel sim pass ----
    # scene -> batched two-channel echo -> DPCA coregister -> dual CSA ->
    # balance/ATI/DPCA products at the reference 7,200 x 13,200 shape
    # (sar_ati_dcpa_sim_csa.py's complete pipeline, timed warm as one
    # chain). The sim pass metric is derived from the SAME compiled
    # two-channel program (warm batched synthesis / 2): the batched path
    # IS the production per-channel cost.
    def sec_e2e():
        import dataclasses

        from nis_sar_amtigmti_video_tpu.geometry import orbit
        from nis_sar_amtigmti_video_tpu.models import gmti as gmti_model
        from nis_sar_amtigmti_video_tpu.models.stripmap import echo_opts_for
        from nis_sar_amtigmti_video_tpu.ops.echo import (
            multi_channel_phase_history)
        from nis_sar_amtigmti_video_tpu.scene import targets as T_
        from nis_sar_amtigmti_video_tpu.scene.clutter import (
            ocean_clutter_field)

        sc_s = cfg.ati_dpca()
        rs, gs, cs = sc_s.radar, sc_s.geometry, sc_s.collect
        sim_win = os.environ.get("BENCH_SIM_WIN")
        sim_grp = os.environ.get("BENCH_SIM_GRP")
        opts_s = dataclasses.replace(
            echo_opts_for(sc_s), backend="freq", endpoint_grid=False,
            freq_spreader=os.environ.get("BENCH_SIM_SPREADER", "auto"),
            freq_spread_win=int(sim_win) if sim_win else None,
            freq_spread_grp=int(sim_grp) if sim_grp else None)
        t0s = window_start_time(gs.slant_range_m, opts_s,
                                cs.window_length_s, "centered")
        ship = T_.destroyer().rotate_z(90.0)
        clut = ocean_clutter_field(np.random.default_rng(0))
        scene = T_.PointTargets.concatenate([ship, clut])
        n_ps = cs.num_pulses(rs.prf_hz)
        traj_e = orbit.make_trajectory(
            gs, orbit.slow_time_grid(cs.integration_time_s, n_ps))
        offs = sc_s.channels.rx_offsets()

        def sim2ch():
            raw2 = multi_channel_phase_history(
                traj_e, scene, opts_s, t_start=t0s, rx_offsets=offs)
            return raw2

        def e2e_once():
            raw2 = sim2ch()
            sync(gmti_model.focus_and_products(raw2, sc_s, float(t0s)))

        e2e_once()                         # compile + first run (all stages)
        t1 = time.perf_counter()
        e2e_once()
        m["e2e_fullscale_s"] = time.perf_counter() - t1
        # warm batched 2-channel synthesis alone (program already compiled)
        sync(sim2ch())
        t1 = time.perf_counter()
        sync(sim2ch())
        m["sim_pass_s"] = (time.perf_counter() - t1) / 2.0
        m["sim_pass_protocol"] = "batched2ch/2"
        paths["e2e_fullscale"] = (
            f"echo freq spreader={opts_s.freq_spreader}, composed GMTI")

    section("e2e_fullscale", 420, sec_e2e, skip_env="BENCH_SKIP_E2E")

    # ---- 3. gather-free fast BP at reference VideoSAR scale ----
    bp_state = {}

    def sec_bp():
        from nis_sar_amtigmti_video_tpu.geometry import orbit
        from nis_sar_amtigmti_video_tpu.models import videosar
        from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops
        from nis_sar_amtigmti_video_tpu.ops import bp_fast

        scv = cfg.videosar()
        rv, gv = scv.radar, scv.geometry
        sched_pulses = 2500
        l_ant = videosar.antenna_length_for_swath(
            scv, scv.processing.bp_scene_size_m)
        opts = videosar.spotlight_echo_opts(scv, l_ant)
        t0b = window_start_time(gv.slant_range_m, opts,
                                scv.collect.window_length_s, "centered")
        p_bp = videosar.bp_params_for(scv, opts, "f32")
        d_ps = bp_ops.presum_factor(p_bp, rv.prf_hz, rv.wavelength_m,
                                    gv.slant_range_m,
                                    gv.effective_velocity_mps)
        tb = np.linspace(-sched_pulses / rv.prf_hz / 2,
                         sched_pulses / rv.prf_hz / 2, sched_pulses)
        trajb = orbit.make_trajectory(gv, tb)
        # the factorized plan and the accumulate the model picks for it
        # (models/videosar.py 'fast_factor'), measured as a chained stream
        plan_bp = bp_fast.make_plan(p_bp, np.asarray(trajb.positions),
                                    np.asarray(trajb.times), float(t0b),
                                    factorize=True)
        bp_acc = (os.environ.get("BENCH_BP_ACC", "")
                  or bp_fast.pick_accumulate(plan_bp))
        if bp_acc not in bp_fast.ACCUMULATES:
            raise ValueError(f"BENCH_BP_ACC={bp_acc!r}: pick one of "
                             f"{', '.join(bp_fast.ACCUMULATES)}")

        @jax.jit
        def mk_bp(key):
            return jax.lax.complex(
                jax.random.normal(key, (sched_pulses, opts.num_samples),
                                  jnp.float32),
                jax.random.normal(jax.random.fold_in(key, 1),
                                  (sched_pulses, opts.num_samples),
                                  jnp.float32))

        raw_bp = mk_bp(jax.random.PRNGKey(1))
        chain = 3

        @jax.jit
        def bp_stream(x):
            img = None
            for _c in range(chain):
                img = bp_fast.focus_bp_fast(
                    x, trajb.positions, trajb.velocities, trajb.times,
                    np.zeros(3), float(t0b), p_bp, presum=d_ps,
                    plan=plan_bp, accumulate=bp_acc, fit_stride=16,
                    math_mode=os.environ.get("BENCH_BP_MATH", "exact"))
                x = x + (jnp.sum(img[:1, :1]) * 0).astype(x.dtype)
            return x, img

        x, o = sync(bp_stream(raw_bp))
        lat = []
        for _i in range(3):
            t1 = time.perf_counter()
            x, o = sync(bp_stream(x))
            lat.append((time.perf_counter() - t1) / chain)
        m["bp_ms"] = 1000.0 * float(np.median(lat))
        paths["bp_frame"] = f"fast BP accumulate={bp_acc}"
        bp_state.update(p_bp=p_bp, plan_bp=plan_bp, trajb=trajb, t0b=t0b,
                        d_ps=d_ps, bp_acc=bp_acc, raw_bp=raw_bp,
                        sched_pulses=sched_pulses, chain=chain)

    section("bp_frame", 300, sec_bp, skip_env="BENCH_SKIP_BP")

    # ---- 4. streaming VideoSAR BP: amortized per-frame cost at the
    # product's 80% CPI overlap — forward spectra cached per pulse (computed
    # once, shared by ~5 frames), only recentre/fit/accumulate/finalize per
    # frame ----
    def sec_bp_stream():
        from nis_sar_amtigmti_video_tpu.ops import bp_fast

        if not bp_state:
            raise RuntimeError("bp_frame section did not run")
        p_bp, plan_bp = bp_state["p_bp"], bp_state["plan_bp"]
        trajb, t0b = bp_state["trajb"], bp_state["t0b"]
        d_ps, bp_acc = bp_state["d_ps"], bp_state["bp_acc"]
        raw_bp, chain = bp_state["raw_bp"], bp_state["chain"]
        sched_pulses = bp_state["sched_pulses"]
        step_p = 500                     # 10 fps at PRF 5 kHz
        bp_math = os.environ.get("BENCH_BP_MATH", "exact")

        @jax.jit
        def stream_step(spec_buf, wp, new_raw):
            # ring buffer: advance the cached-spectra window with ONE
            # dynamic_update_slice (one step's spectra written) instead of
            # re-concatenating the whole window every frame; ring_offset
            # rolls only the per-pulse scalars + the small presummed rows.
            # The chain frames ride inside one jit like bp_stream above
            # (one dispatch per chain).
            img = None
            for _c in range(chain):
                new_spec = bp_fast.forward_spectra(new_raw, p_bp)
                zero = jnp.zeros((), wp.dtype)
                spec_buf = jax.lax.dynamic_update_slice(
                    spec_buf, new_spec, (wp, zero))
                wp = (wp + step_p) % sched_pulses
                img = bp_fast.focus_bp_fast(
                    None, trajb.positions, trajb.velocities,
                    trajb.times, np.zeros(3), float(t0b), p_bp,
                    presum=d_ps, plan=plan_bp, accumulate=bp_acc,
                    fit_stride=16, math_mode=bp_math,
                    raw_spectra=spec_buf, ring_offset=wp)
                new_raw = new_raw + (jnp.sum(img[:1, :1])
                                     * 0).astype(new_raw.dtype)
            return spec_buf, wp, img

        spec0 = bp_fast.forward_spectra(raw_bp, p_bp)
        wp0 = jnp.int32(0)
        new0 = raw_bp[:step_p]
        spec0, wp0, img0 = sync(stream_step(spec0, wp0, new0))
        lat = []
        for _i in range(3):
            t1 = time.perf_counter()
            spec0, wp0, img0 = sync(stream_step(spec0, wp0, new0))
            lat.append((time.perf_counter() - t1) / chain)
        m["bp_stream_ms"] = 1000.0 * float(np.median(lat))
        paths["bp_stream"] = (f"ring-buffered cached spectra (XLA recentre), "
                              f"accumulate={bp_acc}")

    section("bp_stream", 180, sec_bp_stream, skip_env="BENCH_SKIP_BP_STREAM")

    # ---- 5. single-channel formation-only stream ----
    def sec_form():
        xr, xi = mk(jax.random.PRNGKey(0))

        def form_only(xr_, xi_):
            sr, si = form(xr_, xi_)
            return sr, si, jnp.sum(jnp.abs(sr[:, :, :1, :1]))

        form_fn = jax.jit(form_only, donate_argnums=(0, 1))
        xr, xi, s = sync(form_fn(xr, xi))
        t1 = time.perf_counter()
        for _i in range(iters):
            xr, xi, s = form_fn(xr, xi)
        sync(s)
        m["form_fps"] = (2 * ncpi * iters) / (time.perf_counter() - t1)
        paths["csa_formation"] = f"apply_csa_fused fft_impl={fft_impl}"

    section("csa_formation", 150, sec_form,
            skip_env="BENCH_SKIP_FORM")

    # ---- 6. HRWS multichannel reconstruction (K=4, production 4096^2:
    # (4, 1024, 4096) sub-Nyquist channels -> (4096, 4096) unfolded
    # slow-time; doppler ambiguity.html:556-570's processing chain) ----
    def sec_hrws():
        from nis_sar_amtigmti_video_tpu.models import hrws
        from nis_sar_amtigmti_video_tpu.utils import cplx as _cplx

        k_ch, m_b = 4, 4
        p_az, n_rg = size // m_b, size
        prf_h, v_h = 6000.0, 7612.0      # ati_dpca-class system PRF
        # uniform effective sampling: spacing*PRF/(2V) = 1/K
        ph = hrws.HrwsParams(num_channels=k_ch,
                             spacing_m=2.0 * v_h / (k_ch * prf_h),
                             prf_hz=prf_h, velocity_mps=v_h)
        # multi-tone scene: one in-band + one aliasing tone per extra
        # band, constant over range (the solve/FFT work is
        # data-independent; tones give the ghost metric physical meaning).
        # Tone frequencies are BIN-CENTERED on the single-channel p_az
        # grid — the reconstructed m_b*p_az grid at m_b*prf has the SAME
        # bin spacing prf/p_az, so both spectra read the tones leak-free
        # (a non-centered tone's rectangular-window leakage would floor
        # the measurable suppression). Channel k samples slow time
        # advanced by x_k/(2V).
        t_h = np.arange(p_az) / prf_h
        df = prf_h / p_az                  # bin spacing on BOTH grids
        tones = [(round(0.17 * p_az) * df, 1.0),
                 (round(1.31 * p_az) * df, 1.0),
                 (round(-1.62 * p_az) * df, 0.7)]
        f_ghost = tones[1][0]              # the 1.31*PRF-class alias tone
        offs_h = ph.rx_offsets()
        ch_np = np.zeros((k_ch, p_az, 1), np.complex64)
        for kk, x_off in enumerate(offs_h):
            tk = t_h + x_off / (2.0 * v_h)
            sig = np.zeros(p_az, np.complex128)
            for f0_h, a_h in tones:
                sig += a_h * np.exp(2j * np.pi * f0_h * tk)
            ch_np[kk] = sig[:, None].astype(np.complex64)
        chans = jnp.broadcast_to(_cplx.to_device(ch_np),
                                 (k_ch, p_az, n_rg))

        # chained protocol like every other section (one sync per timed
        # dispatch of `chain` recons)
        chain = 4

        @jax.jit
        def hrws_chain(c):
            rec = None
            for _c in range(chain):
                rec = hrws.reconstruct(c, ph)
                c = c + (jnp.sum(jnp.abs(rec[:1, :1])) * 0).astype(c.dtype)
            return c, rec

        chans, rec = sync(hrws_chain(chans))       # compile + first
        t1 = time.perf_counter()
        for _i in range(3):
            chans, rec = hrws_chain(chans)
        sync(rec)
        m["hrws_recon_ms"] = (time.perf_counter() - t1) / (3 * chain) * 1e3
        paths["hrws"] = "hrws.reconstruct (K=4, per-bin Gram solve)"

        # ghost suppression: the ~1.31*PRF tone aliases to ~0.31*PRF in any
        # single channel; after unfolding it sits at its true bin and the
        # aliased bin drops. The metric is SYMMETRIC: in each spectrum the
        # alias-bin level is normalized by that spectrum's level at the
        # tone's energy bin (single channel: the alias bin ITSELF holds all
        # the tone's energy, so its ratio is exactly 1 == 0 dB; the
        # reconstruction's ratio is alias-bin / true-bin). dB < 0 means the
        # unfolding moved the energy home.
        spec_r = np.abs(np.fft.fft(_cplx.to_host(rec[:, 0])))
        fr = np.fft.fftfreq(m_b * p_az, 1.0 / (m_b * prf_h))
        f_alias = f_ghost - prf_h          # in-band alias position
        br = int(np.argmin(np.abs(fr - f_alias)))
        b_true = int(np.argmin(np.abs(fr - f_ghost)))
        m["hrws_ghost_db"] = 20.0 * math.log10(
            max(spec_r[br] / spec_r[b_true], 1e-12))

    section("hrws", 150, sec_hrws, skip_env="BENCH_SKIP_HRWS")

    # ---- 8. NumPy reference baseline: the same 2-channel GMTI step ----
    def sec_numpy():
        import oracle
        rng = np.random.default_rng(0)
        nsz = min(size, 4096)
        # PINNED PROTOCOL: fixed BLAS threads (set at module top), the
        # first `n_cold` passes are DISCARDED (page-faulting the FFT
        # workspace + BLAS warm-up), then the MEDIAN of
        # `n_passes` warm passes over the same two raw buffers. All raw
        # per-pass seconds (cold included) land in the JSON, plus the warm
        # spread; the warm window is split in two halves whose medians
        # must agree within +-20% or the section reports
        # numpy_stable=false (the multiplier is then decoration, loudly).
        n_cold = int(os.environ.get("BENCH_NUMPY_COLD", "2"))
        n_passes = max(4, int(os.environ.get("BENCH_NUMPY_PASSES", "6")))
        raws = [(rng.standard_normal((nsz, nsz))
                 + 1j * rng.standard_normal((nsz, nsz)))
                for _ in range(2)]
        s_pair = [None, None]
        ch_dt = []
        for k in range(n_cold + n_passes):
            tc = time.perf_counter()
            s_pair[k % 2] = oracle.focus_csa(
                raws[k % 2], p.wavelength_m, p.chirp_rate, p.fs_hz, p.prf_hz,
                p.velocity_mps, p.range_ref_m, p.t_start_fast)[0].T
            ch_dt.append(time.perf_counter() - tc)
        s1o, s2o = s_pair
        t3 = time.perf_counter()
        cal = np.angle(np.mean(s1o * np.conj(s2o)))
        s2o = s2o * np.exp(1j * cal)
        interf = s1o * np.conj(s2o)
        phase = np.angle(interf)
        mag = np.abs(s1o)
        phase = np.where(mag > 0.05 * mag.max(), phase, 0.0)
        dmag = np.abs(s1o - s2o)
        _ = phase.sum() + dmag.sum()           # products (CFAR omitted:
        prod_dt = time.perf_counter() - t3     # favours the baseline)
        warm = ch_dt[n_cold:]
        med = float(np.median(warm))
        half_a = float(np.median(warm[:len(warm) // 2]))
        half_b = float(np.median(warm[len(warm) // 2:]))
        stable = abs(half_a - half_b) <= 0.2 * max(half_a, half_b)
        numpy_dt = 2.0 * med + prod_dt
        m["numpy_raw_s"] = [round(d, 3) for d in ch_dt] + [round(prod_dt, 3)]
        m["numpy_cold_discarded"] = n_cold
        m["numpy_warm_spread"] = round(
            (max(warm) - min(warm)) / med, 3)
        m["numpy_stable"] = stable
        work = (size * size * np.log2(size)) / (nsz * nsz * np.log2(nsz))
        m["numpy_gmti_fps"] = (1.0 / numpy_dt) / work

    section("numpy_baseline", np_reserve or 300, sec_numpy, reserve=False,
            skip_env="BENCH_SKIP_NUMPY")

    if smoke:
        # a control-flow run: no number it took is a device measurement
        for k in ("gmti_ms", "e2e_fullscale_s", "sim_pass_s", "bp_ms",
                  "bp_stream_ms", "form_fps", "hrws_recon_ms"):
            m[k] = None
    gmti_ms = m.get("gmti_ms")
    gmti_fps = 1000.0 / gmti_ms if gmti_ms else None
    numpy_fps = m.get("numpy_gmti_fps")
    for name, path in paths.items():
        sections[name]["path"] = path
    result = {
        "metric": f"videosar_gmti_{size}x{size}_stream",
        "value": _rnd(gmti_fps, 2),
        "unit": "frames/sec",
        "vs_baseline": (round(gmti_fps / numpy_fps, 1)
                        if gmti_fps and numpy_fps else None),
        "gmti_latency_ms": _rnd(gmti_ms, 2),
        "csa_formation_fps": _rnd(m.get("form_fps"), 2),
        "bp_frame_ms": _rnd(m.get("bp_ms"), 1),
        "bp_stream_frame_ms": _rnd(m.get("bp_stream_ms"), 1),
        "sim_pass_s": _rnd(m.get("sim_pass_s"), 2),
        "sim_pass_protocol": m.get("sim_pass_protocol"),
        "hrws_recon_ms": _rnd(m.get("hrws_recon_ms"), 1),
        "hrws_ghost_db": _rnd(m.get("hrws_ghost_db"), 1),
        "e2e_fullscale_s": _rnd(m.get("e2e_fullscale_s"), 2),
        "numpy_gmti_fps": _rnd(numpy_fps, 5),
        "numpy_gmti_s_raw": m.get("numpy_raw_s"),
        "numpy_cold_discarded": m.get("numpy_cold_discarded"),
        "numpy_warm_spread": m.get("numpy_warm_spread"),
        "numpy_stable": m.get("numpy_stable"),
        "timing": ("not measured (BENCH_SMOKE=1 control-flow run on "
                   f"{device['platform']})" if smoke else "measured"),
        "fft_impl": fft_impl,
        "device": device,
        "card": runtime.card_info() if device["platform"] == "gpu" else None,
        "ncpi": ncpi,
        "iters": iters,
        "total_elapsed_s": round(time.perf_counter() - t_proc0, 1),
        "sections": sections,
    }
    print(json.dumps(result))
    if any(v["status"].startswith("error") for v in sections.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
