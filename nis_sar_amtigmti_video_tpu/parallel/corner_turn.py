"""Corner turns and the sequence-parallel (distributed) CSA.

SAR processing alternates between two natural layouts of a (pulses, samples)
matrix: pulse-sharded (echo synthesis, range ops) and range-sharded (azimuth
FFTs). The *corner turn* — an ``all_to_all`` over the mesh 'seq' axis — swaps
them, exactly the Ulysses-style axis swap for sequence parallelism
(SURVEY.md §5 long-context row). Azimuth FFTs then run locally on whole
columns; no distributed FFT needed.

Distributed CSA layout walk (3 corner turns):

    pulses-sharded (P/n, Ns)
      -> turn -> range-sharded (P, Ns/n):  az FFT, *Phi1 (cols sliced)
      -> turn -> pulse-sharded (P/n, Ns):  rg FFT, *Phi2, rg IFFT, *Phi3 (rows sliced)
      -> turn -> range-sharded (P, Ns/n):  az IFFT  -> SLC range-sharded
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nis_sar_amtigmti_video_tpu.ops.csa import CsaPhases


def corner_turn_local(x, axis_name: str, *, to_range_sharded: bool):
    """Inside shard_map: swap which of the last two dims is sharded.

    to_range_sharded=True : local (P/n, Ns)  -> local (P, Ns/n)
    to_range_sharded=False: local (P, Ns/n)  -> local (P/n, Ns)
    Batch dims (leading) pass through.
    """
    nd = x.ndim
    if to_range_sharded:
        split, concat = nd - 1, nd - 2
    else:
        split, concat = nd - 2, nd - 1
    return jax.lax.all_to_all(x, axis_name, split_axis=split,
                              concat_axis=concat, tiled=True)


def csa_local(phist_local, phi1_cols, phi2_rows, phi3_rows, axis_name: str,
              fft_impl: str = "xla", input_layout: str = "pulse"):
    """Per-device body of the distributed CSA (see module docstring).

    phist_local: (..., P/n, Ns) — pulse-sharded raw data (input_layout=
                 'pulse'), or (..., P, Ns/n) already range-sharded
                 (input_layout='range': the HRWS reconstruction's output
                 layout — the first corner turn is skipped)
    phi1_cols:   (P, Ns/n)      — Phi1 sliced along range
    phi2_rows, phi3_rows: (P/n, Ns) — Phi2/Phi3 sliced along azimuth
    fft_impl: 'xla' | 'mxu' | 'hybrid' (ops/fft.py) — the azimuth passes
    are exactly the axis=-2 case the matmul DFT handles.
    Returns (..., P, Ns/n) — range-sharded SLC.
    """
    from nis_sar_amtigmti_video_tpu.ops.fft import get_impl
    fft, ifft = get_impl(fft_impl)
    s = phist_local
    if input_layout == "pulse":
        s = corner_turn_local(s, axis_name, to_range_sharded=True)
    s = fft(s, axis=-2) * phi1_cols
    s = corner_turn_local(s, axis_name, to_range_sharded=False)
    s = fft(s, axis=-1) * phi2_rows
    s = ifft(s, axis=-1) * phi3_rows
    s = corner_turn_local(s, axis_name, to_range_sharded=True)
    return ifft(s, axis=-2)


def csa_sharded(phist, phases: CsaPhases, mesh: Mesh, axis: str = "seq",
                fft_impl: str = "xla", input_layout: str = "pulse"):
    """Sequence-parallel CSA: raw (..., P, Ns) sharded on the pulse axis over
    ``axis`` (or on the range axis with input_layout='range', skipping the
    first corner turn — the layout HRWS reconstruction hands over); returns
    SLC (..., P, Ns) sharded on the range axis.

    P and Ns must both divide by the axis size. Phases are sliced to each
    device by shard_map's in_specs — no replication of the phase grids.
    """
    nbatch = phist.ndim - 2
    lead = [None] * nbatch
    body = partial(csa_local, axis_name=axis, fft_impl=fft_impl,
                   input_layout=input_layout)
    spec_pulse = P(*lead, axis, None)
    spec_range = P(*lead, None, axis)
    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec_range if input_layout == "range" else spec_pulse,
                  P(None, axis), P(axis, None), P(axis, None)),
        out_specs=spec_range)
    return f(phist, phases.phi1, phases.phi2, phases.phi3)


def bp_sharded(rc, sat_pos, sat_vel, t_slow, vel_focus, t_start, p,
               mesh, axis: str = "seq"):
    """Pulse-sharded backprojection: each device backprojects its slow-time
    shard onto the full pixel grid, then the partial images psum over
    ``axis`` — a ring-reduce over aperture segments
    (SURVEY §5 "BP accumulation over pulse shards = psum"; the reference
    runs the pulse loop serially, sar_batch_sim.py:207-235).

    rc: (P, Ns) range-compressed pulses with P divisible by the axis size.
    Returns the (ny, nx) complex image, replicated across the mesh.
    """
    import jax
    from jax.sharding import PartitionSpec as P_

    from nis_sar_amtigmti_video_tpu.ops import bp as bp_ops

    n_shards = mesh.shape[axis]

    def body(rc_l, pos_l, vel_l, ts_l, vf_l, t0_l):
        # global CPI mid-time: each shard must reference the same moving grid
        t_mean = (jax.lax.psum(jnp.sum(ts_l), axis)
                  / (ts_l.shape[0] * n_shards))
        img = bp_ops.backproject(rc_l, pos_l, vel_l, ts_l, vf_l[0],
                                 t0_l[0], p, t_mean=t_mean)
        return jax.lax.psum(img, axis)[None]

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P_(axis, None), P_(axis, None), P_(axis, None), P_(axis),
                  P_(None, None), P_(None)),
        out_specs=P_(None, None, None),
        check_vma=False)
    out = fn(rc, sat_pos, sat_vel, t_slow, vel_focus[None, :],
             t_start[None])
    return out[0]


def bp_fast_sharded(raw, sat_pos, sat_vel, t_slow, vel_focus, t_start,
                    p, plan, mesh, axis: str = "seq", presum: int = 1,
                    accumulate: str = "xla", fit_stride: int = 0,
                    raw_spectra=None):
    """Pulse-sharded *fast* backprojection: each device runs the fused
    compress+recentre+presum and iso-range accumulation on its slow-time
    shard, partial internal images psum over ``axis``, and the (cheap)
    carrier demodulation + chirp-Z output resample run replicated — the
    fast-path analog of :func:`bp_sharded` (SURVEY §5 "BP accumulation over
    pulse shards = psum"; reference pulse loop: sar_batch_sim.py:207-235).

    raw: (P, Ns) *uncompressed* pulses; P must split evenly into shards and
    each shard into whole presum groups, so sharded group boundaries match
    the single-device ones. Returns the (ny, nx) image, replicated (matches
    ops/bp_fast.py::backproject_fast(compress=True) to f32 reduction
    order).

    ``accumulate`` selects the per-shard accumulation exactly as in
    :func:`ops.bp_fast.backproject_fast`: 'xla' (scan) or 'factor' /
    'factor2' (the sub-aperture factorization; needs a factorize=True
    plan). Sub-aperture anchors are then per-shard, which changes only the
    band-limited merge's ~-100 dB interpolation error, not the exact phase
    totals. ``raw_spectra`` (P, nfft, from ops/bp_fast.forward_spectra)
    feeds cached forward spectra instead of raw pulses — the
    streaming-VideoSAR path sharded over pulses; ``raw`` is then ignored.
    """
    from jax.sharding import PartitionSpec as P_

    from nis_sar_amtigmti_video_tpu.ops import bp_fast as bf

    if accumulate not in bf.ACCUMULATES:
        raise ValueError(f"unknown BP accumulate {accumulate!r}; options: "
                         f"{', '.join(bf.ACCUMULATES)}")
    if raw_spectra is not None and raw_spectra.shape[1] != plan.nfft:
        raise ValueError(
            f"raw_spectra length ({raw_spectra.shape[1]}) does not match "
            f"plan.nfft={plan.nfft}")
    d = max(1, presum)
    n_sh = mesh.shape[axis]
    num_p = (raw_spectra if raw_spectra is not None else raw).shape[0]
    if num_p % n_sh or (num_p // n_sh) % d:
        raise ValueError(
            f"bp_fast_sharded needs pulses ({num_p}) divisible into "
            f"{n_sh} shards of whole presum-{d} groups")

    pos = jnp.asarray(sat_pos, jnp.float64)
    vel = jnp.asarray(sat_vel, jnp.float64)
    ts = jnp.asarray(t_slow, jnp.float64)
    vf = jnp.asarray(vel_focus, jnp.float64)
    t_mean = jnp.mean(ts)

    # global presummed trajectory + coefficients (light; replicated)
    ci = jnp.arange(num_p // d) * d + d // 2
    pos2, vel2, t2 = pos[ci], vel[ci], ts[ci]
    rdir, cdir, dy_m = bf._frame_geometry(pos2[pos2.shape[0] // 2], p, plan)
    coeffs = bf._fit_coeffs(pos2, vel2, t2, vf, p, plan, t_mean, rdir, cdir,
                            dy_m, fit_stride=fit_stride)
    ref_conj = bf.matched_filter_spectrum(p, plan.nfft)

    def body(raw_l, pos_l, vel_l, ts_l, *coeffs_l):
        if raw_spectra is not None:
            rc2, _, _, _ = bf.recentre_from_spectra(
                raw_l, pos_l, vel_l, ts_l, vf, p, d, plan.t_ref,
                t_mean=t_mean)
        else:
            rc2, _, _, _ = bf.recenter_presum(raw_l, pos_l, vel_l, ts_l, vf,
                                              p, d, plan.t_ref,
                                              ref_conj=ref_conj,
                                              t_mean=t_mean)
        img = bf.accumulate_image(rc2, coeffs_l, plan, accumulate, d)
        return jax.lax.psum(img, axis)[None]

    lead = raw_spectra if raw_spectra is not None else raw
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P_(axis, None), P_(axis, None), P_(axis, None), P_(axis),
                  P_(axis, None), P_(axis, None), P_(axis, None),
                  P_(axis, None), P_(axis), P_(axis)),
        out_specs=P_(None, None, None),
        check_vma=False)
    img_i = fn(lead, pos, vel, ts, *coeffs)[0]
    return bf._finalize(img_i, coeffs[1:4], pos2, vel2, t2, vf, t_mean,
                        p, plan, rdir, cdir, dy_m)
