"""Multi-chip GMTI / VideoSAR pipeline over a ('data','chan','seq') mesh.

Packages the framework's full sharded processing step for production use:
frame batches shard over 'data', receive channels over 'chan', and the
pulse/range axis over 'seq' with corner-turned CSA
(parallel/corner_turn.py). Cross-channel products use one all_gather over
'chan'; scalar metrics psum over the whole mesh.

Numerics are identical to the single-device pipeline (asserted on the
8-virtual-device CPU mesh in tests/test_distributed.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nis_sar_amtigmti_video_tpu.gmti import cfar as cfar_mod
from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu.parallel import corner_turn


class ShardedGmtiOutputs(NamedTuple):
    dpca_mag: jax.Array       # (F, P, Ns) range-sharded over 'seq'
    ati_phase: jax.Array      # (F, P, Ns)
    cfar_snr: jax.Array       # (F, P, Ns)
    cancellation: jax.Array   # () replicated


def raw_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the (F, C, P, Ns) raw input batch."""
    return NamedSharding(mesh, P("data", "chan", "seq", None))


def product_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of the (F, P, Ns) product maps."""
    return NamedSharding(mesh, P("data", None, "seq"))


def _axis_box_sum(x, half: int, axis: int, valid: bool = False):
    """(2*half+1)-tap sliding sum along one axis (zero-padded unless
    ``valid``) — the 1-D factor of cfar._box_sum, shard_map-local."""
    k = 2 * half + 1
    win = [1] * x.ndim
    win[axis] = k
    pad = [(0, 0)] * x.ndim
    if not valid:
        pad[axis] = (half, half)
    return jax.lax.reduce_window(x, jnp.zeros((), x.dtype), jax.lax.add,
                                 tuple(win), (1,) * x.ndim, pad)


def _cfar_snr_halo(power_l, cfar_params: cfar_mod.CfarParams, *,
                   n_seq: int, ns_global: int):
    """CA-CFAR SNR on a range-sharded (..., P, ns_local) power plane via a
    ppermute halo exchange over 'seq'.

    Window-identical to ``cfar_mod.ca_cfar`` on the gathered plane: the
    azimuth box sums are shard-local (azimuth is unsharded), and the range
    box sums read guard+train (=h_o) true neighbor columns exchanged with
    two ppermutes — ~3 orders of magnitude less traffic than the
    full-plane all_gather it replaces. Training-cell counts use the
    GLOBAL column positions (exact rank-1 form, cfar._box_count), so edge
    normalization matches the single-device detector everywhere.

    Requires ns_local >= h_o (one-neighbor halos); the production shapes
    satisfy it by 100x (1024-column shards vs h_o = 10) and the caller's
    mesh construction guards smaller CPIs.
    """
    g, t = cfar_params.guard, cfar_params.train
    h_o, h_i = g + t, g
    ns_local = power_l.shape[-1]
    if ns_local < h_o:
        raise ValueError(
            f"range shard of {ns_local} columns is narrower than the CFAR "
            f"outer half-window {h_o}: halos would need multi-hop "
            f"exchange — use fewer 'seq' shards for this CPI")
    # azimuth (unsharded axis) box sums: fully local
    y_o = _axis_box_sum(power_l, h_o, axis=-2)
    y_i = _axis_box_sum(power_l, h_i, axis=-2)
    # one packed halo per direction serves both windows (h_i <= h_o)
    fwd = [(i, i + 1) for i in range(n_seq - 1)]
    bwd = [(i + 1, i) for i in range(n_seq - 1)]
    # explicit start indices: a zero half-window (guard=0) must slice an
    # EMPTY halo — x[..., -0:] would be the whole shard
    pack_tail = jnp.concatenate([y_o[..., ns_local - h_o:],
                                 y_i[..., ns_local - h_i:]], axis=-1)
    pack_head = jnp.concatenate([y_o[..., :h_o], y_i[..., :h_i]], axis=-1)
    from_left = jax.lax.ppermute(pack_tail, "seq", fwd)   # edge shards: 0
    from_right = jax.lax.ppermute(pack_head, "seq", bwd)
    ext_o = jnp.concatenate([from_left[..., :h_o], y_o,
                             from_right[..., :h_o]], axis=-1)
    ext_i = jnp.concatenate([from_left[..., h_o:], y_i,
                             from_right[..., h_o:]], axis=-1)
    outer = _axis_box_sum(ext_o, h_o, axis=-1, valid=True)
    inner = _axis_box_sum(ext_i, h_i, axis=-1, valid=True)
    # exact global training-cell counts at this shard's column positions
    n_az = power_l.shape[-2]
    start = jax.lax.axis_index("seq") * ns_local
    cw_o = jax.lax.dynamic_slice_in_dim(
        cfar_mod._count_1d(ns_global, h_o), start, ns_local)
    cw_i = jax.lax.dynamic_slice_in_dim(
        cfar_mod._count_1d(ns_global, h_i), start, ns_local)
    n_outer = cfar_mod._count_1d(n_az, h_o)[:, None] * cw_o[None, :]
    n_inner = cfar_mod._count_1d(n_az, h_i)[:, None] * cw_i[None, :]
    n_train = jnp.maximum(n_outer - n_inner, 1.0)
    noise = (outer - inner) / n_train
    return power_l / jnp.maximum(noise, 1e-30)


def make_gmti_step(mesh: Mesh, p: csa_ops.CsaParams,
                   cfar_params: cfar_mod.CfarParams = cfar_mod.CfarParams(),
                   mask_threshold: float = 0.05, fft_impl: str = "xla",
                   shift_pulses: int = 1):
    """Jitted sharded step: (F, C=2, P, Ns) complex64 raw -> products.

    The DPCA one-pulse-shift co-registration (gmti/dpca.py) is applied
    first, exactly as the single-device pipeline does, so ``p.num_pulses``
    must equal P - shift_pulses, and both (P - shift_pulses) and Ns must
    divide by the 'seq' axis size. Pass shift_pulses=0 for pre-coregistered
    input. The caller shards the input with :func:`raw_sharding` (or lets
    jit insert the transfer).
    """
    phases = csa_ops.csa_phases(p)

    def body(raw_l, phi1_l, phi2_l, phi3_l):
        slc = corner_turn.csa_local(raw_l, phi1_l, phi2_l, phi3_l, "seq",
                                    fft_impl=fft_impl)
        ch = jax.lax.all_gather(slc, "chan", axis=1, tiled=True)
        s1, s2 = ch[:, 0], ch[:, 1]
        # channel balance from the global mean interferogram
        ifg = s1 * jnp.conj(s2)
        num = jax.lax.psum(jnp.sum(ifg), ("data", "chan", "seq"))
        cal = num / jnp.abs(num)
        s2 = s2 * cal
        ifg = ifg * jnp.conj(cal)

        # magnitude-masked phase: mask on the global channel-1 peak
        mag1 = jnp.abs(s1)
        peak = jax.lax.pmax(jnp.max(mag1), ("data", "chan", "seq"))
        phase = jnp.where(mag1 > mask_threshold * peak, jnp.angle(ifg), 0.0)

        diff = s1 - s2
        # CFAR training windows cross range-shard boundaries by only
        # guard+train (=h_o) columns, so exchange JUST those boundary
        # columns with the 'seq' neighbors (two ppermutes of the
        # azimuth-summed halos, ~2*h_o columns per shard) instead of
        # all_gathering the whole (P, Ns) power plane — 134 MB -> ~0.5 MB
        # per CPI at the 4096^2 shape, by count. Identical
        # windows to the single-device detector: interior shards see their
        # neighbors' true training columns; the mesh-edge shards receive
        # ppermute's zero fill, which IS ca_cfar's zero padding.
        snr_local = _cfar_snr_halo(jnp.abs(diff) ** 2, cfar_params,
                                   n_seq=mesh.shape["seq"],
                                   ns_global=p.num_samples)
        c_num = jax.lax.psum(jnp.sum(mag1), ("data", "chan", "seq"))
        c_den = jax.lax.psum(jnp.sum(jnp.abs(diff)), ("data", "chan", "seq"))
        cancel = (c_num / (c_den + 1e-30)) * jnp.ones((), jnp.float32)
        return (jnp.abs(diff), phase.astype(jnp.float32),
                snr_local.astype(jnp.float32), cancel)

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("data", "chan", "seq", None),
                  P(None, "seq"), P("seq", None), P("seq", None)),
        out_specs=(P("data", None, "seq"), P("data", None, "seq"),
                   P("data", None, "seq"), P()),
        check_vma=False)

    @jax.jit
    def step(raw):
        if shift_pulses:
            s = shift_pulses
            raw = jnp.stack([raw[:, 0, s:, :], raw[:, 1, :-s, :]], axis=1)
        return ShardedGmtiOutputs(*sharded(raw, phases.phi1, phases.phi2,
                                           phases.phi3))

    return step


def make_videosar_step(mesh: Mesh, p: csa_ops.CsaParams,
                       fft_impl: str = "xla"):
    """Jitted sharded single-channel VideoSAR formation:
    (F, P, Ns) raw frames -> (F, P, Ns) SLC frames, 'data' x 'seq' sharded."""
    phases = csa_ops.csa_phases(p)

    def body(raw_l, phi1_l, phi2_l, phi3_l):
        return corner_turn.csa_local(raw_l, phi1_l, phi2_l, phi3_l, "seq",
                                     fft_impl=fft_impl)

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("data", "seq", None),
                  P(None, "seq"), P("seq", None), P("seq", None)),
        out_specs=P("data", None, "seq"))

    @jax.jit
    def step(raw):
        return sharded(raw, phases.phi1, phases.phi2, phases.phi3)

    return step
