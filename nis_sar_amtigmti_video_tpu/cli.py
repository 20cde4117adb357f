"""Command-line interface: one runner for every reference script's workflow.

The reference is driven by executing individual scripts (sar_satellite_sim.py,
sar_vehicle_sim.py, sar_ati_dcpa_sim_csa.py, sar_satellite_moving_sim.py,
sar_batch_sim.py, view_targets.py); this CLI reproduces each as a subcommand
writing the same product files, plus the mission-analysis tools:

    python -m nis_sar_amtigmti_video_tpu stripmap   [--small] [--out DIR]
    python -m nis_sar_amtigmti_video_tpu vehicle    [--small]
    python -m nis_sar_amtigmti_video_tpu moving     [--small]
    python -m nis_sar_amtigmti_video_tpu ati-dpca   [--small] [--clutter N]
    python -m nis_sar_amtigmti_video_tpu videosar   [--small] [--algo mbp|stdbp|csa]
    python -m nis_sar_amtigmti_video_tpu targets
    python -m nis_sar_amtigmti_video_tpu coverage   [--sats N] [--mode spotlight|hrws]
    python -m nis_sar_amtigmti_video_tpu timing     [--prf-min ..] [--prf-max ..]
    python -m nis_sar_amtigmti_video_tpu budget     [--preset NAME]

``--small`` shrinks waveform/aperture for quick checks on any host; full-size
runs match the reference's exact constants.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _small_radar(sc, n_pulses=256, n_samples=768):
    # BW must stay below fs (physical waveform; the reference uses fs=1.2*BW)
    return sc.replace(
        radar=dataclasses.replace(sc.radar, bandwidth_hz=120e6,
                                  pulse_width_s=2e-6, fs_hz=150e6),
        collect=dataclasses.replace(sc.collect,
                                    integration_time_s=n_pulses / sc.radar.prf_hz,
                                    window_length_s=n_samples / 150e6))


def cmd_stripmap(args):
    import jax
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.io import products
    from nis_sar_amtigmti_video_tpu.models import stripmap
    from nis_sar_amtigmti_video_tpu.scene import targets as T
    from nis_sar_amtigmti_video_tpu.viz import render

    sc = cfg.satellite_stripmap()
    if args.small:
        sc = _small_radar(sc)
    sc = _apply_fast_sim(sc)
    tgt = T.destroyer().rotate_z(90.0)
    key = jax.random.PRNGKey(args.seed) if not args.no_noise else None
    t0 = time.time()
    prod = stripmap.run(sc, tgt, key=key, avg_rcs=50000.0)
    out = os.path.join(args.out, "sar_satellite_data.npz")
    products.write_satellite_products(out, prod, sc)
    png = render.save_pipeline_steps(
        os.path.join(args.out, "satellite_pipeline.png"), prod, sc)
    print(f"stripmap: {prod.raw.shape} raw -> image in {time.time()-t0:.1f}s")
    print(f"  wrote {out}\n  wrote {png}")


def cmd_vehicle(args):
    import jax
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.io import products
    from nis_sar_amtigmti_video_tpu.models import stripmap
    from nis_sar_amtigmti_video_tpu.scene import targets as T
    from nis_sar_amtigmti_video_tpu.viz import render

    sc = cfg.airborne_vehicle()
    if args.small:
        sc = sc.replace(collect=dataclasses.replace(
            sc.collect, integration_time_s=2048 / sc.radar.prf_hz))
    key = jax.random.PRNGKey(args.seed) if not args.no_noise else None
    prod = stripmap.run(sc, T.destroyer(), key=key, avg_rcs=50000.0)
    out = os.path.join(args.out, "sar_simulation_data.npz")
    products.write_vehicle_products(out, prod, sc)
    render.save_pipeline_steps(
        os.path.join(args.out, "vehicle_pipeline.png"), prod, sc)
    print(f"vehicle: image {prod.image.shape}; wrote {out}")


def cmd_moving(args):
    import jax
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.io import products
    from nis_sar_amtigmti_video_tpu.models import stripmap
    from nis_sar_amtigmti_video_tpu.scene import targets as T

    sc = cfg.satellite_moving()
    if args.small:
        sc = _small_radar(sc)
    sc = _apply_fast_sim(sc)
    base = T.destroyer()
    speed = 15.0
    scenarios = [("stationary", 0.0, 0.0), ("moving_0deg", 0.0, speed),
                 ("moving_45deg", 45.0, speed), ("moving_90deg", 90.0, speed),
                 ("moving_135deg", 135.0, speed)]
    for name, ang, spd in scenarios:
        tgt = base.rotate_z(ang)
        phi = np.radians(ang)
        vel = (spd * np.cos(phi), spd * np.sin(phi), 0.0)
        key = jax.random.PRNGKey(args.seed) if not args.no_noise else None
        prod = stripmap.run(sc, tgt, target_velocity=vel, key=key,
                            avg_rcs=50000.0)
        out = os.path.join(args.out, f"sar_satellite_moving_scen_{name}.npz")
        products.write_moving_scenario(out, prod, sc, scen_name=name,
                                       ship_speed=spd, ship_heading=ang,
                                       ship_vel=vel)
        print(f"moving[{name}]: wrote {out}")


def cmd_ati_dpca(args):
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.io import products
    from nis_sar_amtigmti_video_tpu.models import gmti as gmti_model
    from nis_sar_amtigmti_video_tpu.scene import targets as T
    from nis_sar_amtigmti_video_tpu.scene.clutter import ocean_clutter_field
    from nis_sar_amtigmti_video_tpu.viz import render

    sc = cfg.ati_dpca()
    if args.small:
        sc = _small_radar(sc)
    sc = _apply_fast_sim(sc)
    rng = np.random.default_rng(args.seed)
    ship = T.destroyer()
    clut = (ocean_clutter_field(rng, num_points=args.clutter)
            if args.clutter > 0 else None)
    t0 = time.time()
    prod = gmti_model.run(sc, ship, (15.0, 0.0, 0.0), clut)
    if _RUNLOG is not None:
        _RUNLOG.params(sc)
    out = os.path.join(args.out, "sar_ati_dpca_data_csa.npz")
    products.write_ati_dpca_products(out, prod)
    png = render.save_gmti_panel(os.path.join(args.out, "gmti_panel.png"),
                                 prod)
    # the reference's three standalone plots, same filenames/colormaps
    # (sar_ati_dcpa_sim_csa.py:446-451)
    from nis_sar_amtigmti_video_tpu.utils import cplx as _cplx
    s1 = _cplx.to_host(prod.slc1)
    render.save_image(os.path.join(args.out, "csa_sar_ati_ch1_mag.png"),
                      np.abs(s1), title="CSA Channel 1 Magnitude", cmap="bone")
    render.save_image(os.path.join(args.out, "csa_sar_ati_phase.png"),
                      _cplx.to_host(prod.ati_phase), title="CSA ATI Phase",
                      is_phase=True)
    render.save_image(os.path.join(args.out, "csa_sar_dpca_diff.png"),
                      _cplx.to_host(prod.dpca_mag),
                      title="CSA DPCA Difference", cmap="magma")
    from nis_sar_amtigmti_video_tpu.utils import cplx
    ratio = float(np.asarray(cplx.to_host(prod.cancellation_ratio)))
    _log_event("gmti_products", cancellation_db=20*np.log10(ratio+1e-30),
               v_amb_mps=prod.v_amb, seconds=time.time()-t0)
    print(f"ati-dpca: {time.time()-t0:.1f}s, cancellation "
          f"{20*np.log10(ratio+1e-30):.1f} dB, v_amb {prod.v_amb:.2f} m/s")
    print(f"  wrote {out}\n  wrote {png}")


def cmd_videosar(args):
    import jax
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.io import products
    from nis_sar_amtigmti_video_tpu.models import videosar
    from nis_sar_amtigmti_video_tpu.scene import targets as T
    from nis_sar_amtigmti_video_tpu.viz import render

    sc = cfg.videosar()
    if args.small:
        sc = sc.replace(
            radar=dataclasses.replace(sc.radar, bandwidth_hz=300e6,
                                      pulse_width_s=2e-6, fs_hz=150e6,
                                      prf_hz=1000.0),
            collect=dataclasses.replace(sc.collect,
                                        window_length_s=512 / 150e6),
            processing=dataclasses.replace(sc.processing, bp_grid=128,
                                           bp_scene_size_m=500.0),
            video=cfg.VideoConfig(duration_s=2.0, fps=5.0, cpi_s=0.4))
    sc = _apply_fast_sim(sc)
    key = jax.random.PRNGKey(args.seed) if not args.no_noise else None
    t0 = time.time()
    stream = getattr(args, "stream", False)
    out = videosar.run(sc, T.destroyer(), heading_deg=args.heading,
                       speed_mps=args.speed, algorithm=args.algo,
                       frames_per_batch=args.frames_per_batch, key=key,
                       avg_rcs=5000.0, num_frames=args.frames or None,
                       bp_backend=args.bp_backend,
                       noise_mode="per_segment" if stream else "per_frame",
                       stream_spectra=stream)
    n = out.images.shape[0]
    run_id = f"Destroyer_{int(args.speed)}_{int(args.heading)}_{args.algo}"
    frame_dir = os.path.join(args.out, f"frames_{run_id}")
    products.write_video_frames(frame_dir, out.images)
    gif = render.save_gif(os.path.join(args.out, f"{run_id}.gif"), out.images,
                          fps=sc.video.fps)
    dt = time.time() - t0
    _log_event("videosar_frames", frames=n, wall_s=dt, fps=n/dt,
               algorithm=args.algo)
    print(f"videosar: {n} frames in {dt:.1f}s ({n/dt:.2f} fps end-to-end)")
    print(f"  wrote {frame_dir}/ and {gif}")


def cmd_videosar_batch(args):
    """The reference's batch matrix (sar_batch_sim.py:266-295): vehicles x
    headings x algorithms, one GIF + resumable frame stack per combination."""
    import jax
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.io import products
    from nis_sar_amtigmti_video_tpu.models import videosar
    from nis_sar_amtigmti_video_tpu.scene import targets as T
    from nis_sar_amtigmti_video_tpu.viz import render

    sc = cfg.videosar()
    if args.small:
        sc = sc.replace(
            radar=dataclasses.replace(sc.radar, bandwidth_hz=300e6,
                                      pulse_width_s=2e-6, fs_hz=150e6,
                                      prf_hz=1000.0),
            collect=dataclasses.replace(sc.collect,
                                        window_length_s=512 / 150e6),
            processing=dataclasses.replace(sc.processing, bp_grid=96),
            video=cfg.VideoConfig(duration_s=1.2, fps=5.0, cpi_s=0.4))
    sc = _apply_fast_sim(sc)

    # vehicle matrix entries mirror sar_batch_sim.py:267-288 (incl. the
    # commented-out aircraft rows, available here)
    matrix = {
        "Destroyer": (T.destroyer, 15.0, 500.0, 5000.0),
        "PlaneCrus": (T.fighter_jet, 250.0, 2000.0, 5.0),
        "Stealth": (T.f35, 515.0, 2000.0, 1.0),
    }
    vehicles = args.vehicles.split(",") if args.vehicles else ["Destroyer"]
    headings = [float(h) for h in args.headings.split(",")]
    algos = args.algos.split(",")

    for vname in vehicles:
        gen, speed, swath, rcs = matrix[vname]
        sc_v = sc.replace(processing=dataclasses.replace(
            sc.processing, bp_scene_size_m=swath))
        for heading in headings:
            for algo in algos:
                run_id = f"{vname}_{int(speed)}_{int(heading)}_{algo}"
                key = (None if args.no_noise
                       else jax.random.PRNGKey(args.seed))
                t0 = time.time()
                out = videosar.run(sc_v, gen(), heading_deg=heading,
                                   speed_mps=speed, algorithm=algo,
                                   frames_per_batch=args.frames_per_batch,
                                   key=key, avg_rcs=rcs,
                                   num_frames=args.frames or None)
                products.write_video_frames(
                    os.path.join(args.out, f"frames_{run_id}"), out.images,
                    async_spill=True)
                render.save_gif(os.path.join(args.out, f"{run_id}.gif"),
                                out.images, fps=sc.video.fps)
                print(f"videosar-batch[{run_id}]: {out.images.shape[0]} "
                      f"frames in {time.time()-t0:.1f}s")


def cmd_targets(args):
    from nis_sar_amtigmti_video_tpu.viz import render
    png = render.save_targets_preview(
        os.path.join(args.out, "targets_preview.png"))
    print(f"targets: wrote {png}")


def cmd_coverage(args):
    from nis_sar_amtigmti_video_tpu.mission import coverage
    cfg_ = coverage.ConstellationConfig(num_sats=args.sats,
                                        altitude_m=args.alt_km * 1e3)
    stats = coverage.analyze(cfg_, duration_s=args.duration,
                             dt_s=args.dt, mode=args.mode)
    print(json.dumps({
        "num_sats": args.sats, "mode": args.mode,
        "coverage_pct": round(100 * stats.coverage_fraction, 1),
        "mean_revisit_min": round(stats.mean_revisit_s / 60, 1),
        "max_revisit_min": round(stats.max_revisit_s / 60, 1),
        "mean_access_s": round(stats.mean_access_s, 1),
        "num_accesses": stats.num_accesses}))


def cmd_timing(args):
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.mission import timing
    geom = cfg.satellite_stripmap().geometry
    sw = timing.swath_from_geometry(geom, args.beamwidth)
    prfs, clear = timing.valid_prfs(sw, args.pulse_us * 1e-6, args.prf_min,
                                    args.prf_max, altitude_m=geom.altitude_m)
    # report clear PRF bands
    bands = []
    in_band = None
    for p, c in zip(prfs, clear):
        if c and in_band is None:
            in_band = p
        elif not c and in_band is not None:
            bands.append((in_band, p))
            in_band = None
    if in_band is not None:
        bands.append((in_band, prfs[-1]))
    print(json.dumps({
        "swath_near_km": round(sw.r_near_m / 1e3, 1),
        "swath_far_km": round(sw.r_far_m / 1e3, 1),
        "clear_fraction": round(float(clear.mean()), 3),
        "clear_prf_bands_hz": [[round(a), round(b)] for a, b in bands[:12]]}))


def cmd_view(args):
    """Headless viewer: auto-detect a product file's schema and render it —
    the CLI replacement for the reference's interactive matplotlib viewers."""
    import math

    from nis_sar_amtigmti_video_tpu.viz import render

    src = args.file
    stem = os.path.splitext(os.path.basename(src))[0]
    outbase = os.path.join(args.out, stem)

    if getattr(args, "interactive", False):
        from nis_sar_amtigmti_video_tpu.viz import interactive
        if os.path.isdir(src):
            interactive.MovingScenarioViewer(src).show()
            return
        z = np.load(src)
        if {"slc1", "slc2"} <= set(z.keys()):
            interactive.AtiDpcaViewer(src).show()
        else:
            interactive.PipelineViewer(src).show()
        return

    if os.path.isdir(src):
        from nis_sar_amtigmti_video_tpu.viz.interactive import (
            MovingScenarioViewer)
        if MovingScenarioViewer.scenario_paths(src):
            # moving-scenario set -> shared-zoom comparative sheet
            png = render.save_moving_scenarios(
                os.path.join(args.out, "moving_scenarios.png"), src)
            print(f"view: moving-scenario sheet -> {png}")
            return
        from nis_sar_amtigmti_video_tpu.io.products import read_video_frames
        idx, frames = read_video_frames(src)  # frame directory -> GIF
        if frames.shape[0] == 0:
            print(f"view: no frames in {src}")
            return
        gif = render.save_gif(outbase + ".gif", frames)
        print(f"view: {frames.shape[0]} frames -> {gif}")
        return

    z = np.load(src)
    keys = set(z.keys())
    if {"slc1", "slc2"} <= keys:  # ATI/DPCA SLC pair (reference stores (rg, az))
        slc1, slc2 = z["slc1"].T, z["slc2"].T
        render.save_image(outbase + "_ch1_mag.png", np.abs(slc1),
                          title="Channel 1 magnitude", cmap="bone")
        phase = render.masked_phase_display(slc1, slc2)
        render.save_image(outbase + "_ati_phase.png", phase,
                          title="ATI phase", is_phase=True)
        render.save_image(outbase + "_dpca.png", np.abs(slc1 - slc2),
                          title="DPCA difference", cmap="magma")
        stats = render.region_stats(slc1, slc1 - slc2)
        print(f"view: ATI/DPCA pair; cancellation "
              f"{stats['cancellation_db']:.1f} dB; wrote 3 panels to {args.out}")
        return
    if "final_image" in keys:
        img = z["final_image"]
        panels = [("final_image", img, False)]
        for k in ("raw_phist", "range_comp", "rd_map", "rd_rcmc", "rd_az_comp"):
            if k in keys and z[k] is not None and z[k].ndim == 2:
                panels.append((k, z[k], True))
        for name, data, db in panels:
            render.save_image(f"{outbase}_{name}.png", np.abs(data),
                              title=name, db=True)
        print(f"view: wrote {len(panels)} panels to {args.out}")
        return
    print(f"view: unrecognized schema (keys: {sorted(keys)})")


def cmd_world(args):
    """3-D world: build the demo (or fetched) scene, export OBJ + preview,
    and fly it first-person — live with ``--interactive`` (GUI backend) or
    as a scripted headless fly-through GIF otherwise. CLI counterpart of
    the reference's sar_simulator_ursina.py."""
    from nis_sar_amtigmti_video_tpu.viz import world, world_runtime

    w = world_runtime.demo_world(seed=getattr(args, "seed", 0) or 0)
    if args.interactive:
        w.run(max_seconds=args.seconds if args.seconds > 0 else None)
        return
    obj = world.export_obj(os.path.join(args.out, "world.obj"), w.meshes)
    png = world.render_preview(os.path.join(args.out, "world_preview.png"),
                               w.meshes)
    script = [("w", 0.6)] * 6 + [("w+left", 0.5)] * 6 + [("w+q", 0.5)] * 4 \
        + [("down", 0.4)] * 3 + [("w", 0.6)] * 5
    gif = os.path.join(args.out, "world_flythrough.gif")
    frames = world_runtime.fly_sequence(w, script, path=gif)
    print(f"world: {len(w.meshes)} meshes -> {obj}, {png}; "
          f"{frames.shape[0]}-frame fly-through -> {gif}")


def cmd_geometry(args):
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.viz.geometry_view import save_geometry_view
    sc = getattr(cfg, args.preset)()
    png = save_geometry_view(os.path.join(args.out, f"geometry_{sc.name}.png"),
                             sc)
    print(f"geometry: wrote {png}")


def cmd_budget(args):
    from nis_sar_amtigmti_video_tpu import config as cfg
    from nis_sar_amtigmti_video_tpu.utils import metrics
    preset = getattr(cfg, args.preset)()
    print(json.dumps(metrics.radar_budget_report(preset), indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nis_sar_amtigmti_video_tpu",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true",
                    help="reduced waveform/aperture for quick runs")
    ap.add_argument("--no-noise", action="store_true")
    ap.add_argument("--fast-sim", action="store_true",
                    help="use the approximate NUFFT echo backend (~50x "
                         "faster for clutter-heavy scenes; uniform-grid "
                         "window modes only)")
    ap.add_argument("--log", default="",
                    help="append structured JSONL run events to this file")
    sub = ap.add_subparsers(dest="cmd", required=True)

    # global flags are also accepted *after* the subcommand (the natural
    # place to type them); SUPPRESS defaults keep the subparser from
    # overwriting values parsed before the subcommand
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--out", default=argparse.SUPPRESS)
    common.add_argument("--seed", type=int, default=argparse.SUPPRESS)
    common.add_argument("--small", action="store_true",
                        default=argparse.SUPPRESS)
    common.add_argument("--no-noise", action="store_true",
                        default=argparse.SUPPRESS)
    common.add_argument("--fast-sim", action="store_true",
                        default=argparse.SUPPRESS)
    common.add_argument("--log", default=argparse.SUPPRESS)

    def add_cmd(name):
        return sub.add_parser(name, parents=[common])

    add_cmd("stripmap").set_defaults(fn=cmd_stripmap)
    add_cmd("vehicle").set_defaults(fn=cmd_vehicle)
    add_cmd("moving").set_defaults(fn=cmd_moving)

    p = add_cmd("ati-dpca")
    p.add_argument("--clutter", type=int, default=500)
    p.set_defaults(fn=cmd_ati_dpca)

    p = add_cmd("videosar")
    p.add_argument("--algo", default="mbp", choices=["mbp", "stdbp", "csa"])
    p.add_argument("--bp-backend", default="fast",
                   choices=["fast", "fast_factor", "exact"])
    p.add_argument("--heading", type=float, default=0.0)
    p.add_argument("--speed", type=float, default=15.0)
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--frames-per-batch", type=int, default=4)
    p.add_argument("--stream", nargs="?", const=True, default=False,
                   metavar="{concat,ring}",
                   help="cache per-pulse forward spectra across the "
                        "overlapped CPIs (implies per-segment noise; "
                        "needs a fast BP backend and a long window); "
                        "'ring' keeps the window as a device ring buffer "
                        "(the sequential streaming-product path)")
    p.set_defaults(fn=cmd_videosar)

    p = add_cmd("videosar-batch")
    p.add_argument("--vehicles", default="Destroyer",
                   help="comma list: Destroyer,PlaneCrus,Stealth")
    p.add_argument("--headings", default="0,90,45,135")
    p.add_argument("--algos", default="mbp,stdbp")
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--frames-per-batch", type=int, default=4)
    p.set_defaults(fn=cmd_videosar_batch)

    add_cmd("targets").set_defaults(fn=cmd_targets)

    p = add_cmd("coverage")
    p.add_argument("--sats", type=int, default=24)
    p.add_argument("--alt-km", type=float, default=500.0)
    p.add_argument("--duration", type=float, default=6000.0)
    p.add_argument("--dt", type=float, default=10.0)
    p.add_argument("--mode", default="spotlight", choices=["spotlight", "hrws"])
    p.set_defaults(fn=cmd_coverage)

    p = add_cmd("timing")
    p.add_argument("--beamwidth", type=float, default=2.0)
    p.add_argument("--pulse-us", type=float, default=20.0)
    p.add_argument("--prf-min", type=float, default=1000.0)
    p.add_argument("--prf-max", type=float, default=8000.0)
    p.set_defaults(fn=cmd_timing)

    p = add_cmd("view")
    p.add_argument("file", help=".npz product file or frame directory")
    p.add_argument("--interactive", action="store_true",
                   help="open the widget viewer instead of writing PNGs")
    p.set_defaults(fn=cmd_view)

    p = add_cmd("world")
    p.add_argument("--interactive", action="store_true",
                   help="open the live first-person window (GUI backend)")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="auto-quit the live window after this many seconds")
    p.set_defaults(fn=cmd_world)

    p = add_cmd("geometry")
    p.add_argument("--preset", default="satellite_stripmap",
                   choices=["satellite_stripmap", "satellite_moving",
                            "ati_dpca", "airborne_vehicle", "videosar"])
    p.set_defaults(fn=cmd_geometry)

    p = add_cmd("budget")
    p.add_argument("--preset", default="satellite_stripmap",
                   choices=["satellite_stripmap", "satellite_moving",
                            "ati_dpca", "airborne_vehicle", "videosar"])
    p.set_defaults(fn=cmd_budget)

    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    from nis_sar_amtigmti_video_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    if args.fast_sim:
        global _FAST_SIM
        _FAST_SIM = True
    try:
        if args.log:
            from nis_sar_amtigmti_video_tpu.utils.runlog import RunLogger
            with RunLogger(args.log, run_id=args.cmd) as rl:
                global _RUNLOG
                _RUNLOG = rl
                rl.event("start", argv=argv or sys.argv[1:])
                t0 = time.time()
                args.fn(args)
                rl.event("done", wall_s=round(time.time() - t0, 2))
                _RUNLOG = None
        else:
            args.fn(args)
    except ModuleNotFoundError as e:
        if e.name not in _RENDER_DEPS:
            raise
        sys.exit(f"error: '{args.cmd}' renders its products with "
                 f"{_RENDER_DEPS[e.name]}, which is not installed")


# optional packages only the render step imports -> their distribution names
_RENDER_DEPS = {"matplotlib": "matplotlib", "PIL": "Pillow"}


_RUNLOG = None


def _log_event(kind, **fields):
    if _RUNLOG is not None:
        _RUNLOG.event(kind, **fields)


_FAST_SIM = False


def _apply_fast_sim(sc):
    """Switch a scenario to the NUFFT echo backend (uniform window grids)."""
    if not _FAST_SIM:
        return sc
    return sc.replace(collect=dataclasses.replace(
        sc.collect, window_start_mode="centered", echo_backend="freq"))


if __name__ == "__main__":
    main()
