"""HRWS multichannel azimuth-ambiguity (Doppler) reconstruction.

The reference encodes HRWS as a *system design space* — the butterfly-swath
constellation designer (``HRWS constellation.html:257-350``) and the
single-channel azimuth-ambiguity demo that shows ghost targets at low PRF
(``doppler ambiguity.html:181-198,556-570``) motivating multichannel
reconstruction. This module implements the actual signal processing those
demos point at (Krieger/Gebert-style multichannel reconstruction):

K along-track receive channels at offsets x_k sample the azimuth (Doppler)
spectrum K times per PRI. A channel at offset x_k has its two-way phase
center x_k/2 along track, so it sees the monostatic signal advanced by
x_k/(2V): s_k(t) = s0(t + x_k/(2V)) (matching the bistatic echo engine's
geometry), giving in Doppler

    Y_k(f) = sum_m U(f + m*PRF) * exp(+j*pi*x_k*(f + m*PRF)/V)

with m running over the M aliased Doppler bands. Per base Doppler bin this is
a K x M linear system; solving it for all (bin, range) pairs is one batched
``jnp.linalg.solve`` — batched small solves, sharded over range bins on the mesh
'seq' axis if desired. The unfolded spectrum spans M*PRF: an effective PRF
multiplication that removes azimuth ghosts (tested in tests/test_hrws.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nis_sar_amtigmti_video_tpu.utils.cplx import expj


@dataclass(frozen=True)
class HrwsParams:
    num_channels: int        # K receive channels
    spacing_m: float         # along-track offset spacing between channels
    prf_hz: float
    velocity_mps: float      # platform (phase-center progression) velocity
    num_bands: int = 0       # M aliased bands to unfold; 0 -> K

    @property
    def bands(self) -> int:
        return self.num_bands or self.num_channels

    def rx_offsets(self) -> np.ndarray:
        """Channel offsets centered on the transmitter."""
        k = self.num_channels
        return (np.arange(k) - (k - 1) / 2.0) * self.spacing_m

    @property
    def effective_prf(self) -> float:
        return self.bands * self.prf_hz


def steering_matrix(p: HrwsParams, f_ext):
    """A[..., k, m] = exp(+j*pi*x_k*f_ext[..., m]/V) for extended (unfolded)
    Doppler frequencies f_ext (..., M)."""
    offs = jnp.asarray(p.rx_offsets())                       # (K,)
    phase = ((math.pi / p.velocity_mps)
             * offs[:, None] * jnp.asarray(f_ext)[..., None, :])
    return expj(phase.astype(jnp.float32))                   # (..., K, M)


def _band_layout(p: HrwsParams, n_az: int):
    """For each (base bin b, band m): the unfolded array position in natural
    fft order of length M*n_az, and the *wrapped* continuous frequency it
    represents on the extended +/- M*PRF/2 grid (which band covers a base bin
    depends on the bin's sign — candidates are the extended-grid frequencies
    congruent to f_base mod PRF)."""
    m = p.bands
    freq_num = np.fft.fftfreq(n_az, 1.0 / n_az).astype(np.int64)  # b or b-P
    m_off = np.arange(m) - m // 2
    idx = (freq_num[:, None] + m_off[None, :] * n_az) % (m * n_az)
    f_ext = np.fft.fftfreq(m * n_az, 1.0 / (m * p.prf_hz))[idx]
    return idx, f_ext  # both (n_az, M)


@partial(jax.jit, static_argnames=("p",))
def reconstruct(raw_channels, p: HrwsParams):
    """Unfold the aliased azimuth spectrum of a K-channel collection.

    raw_channels: (K, P, Ns) complex64 — per-channel raw (or range-compressed)
    data at the *system* PRF — or a tuple/list of K (P, Ns) arrays (the
    echo engine's backend='freq' return form; stacked here).
    Returns (M*P, Ns) complex64 — the reconstructed single-channel-equivalent
    slow-time signal at PRF_eff = M*PRF (uniform grid, natural fft order in
    azimuth restored by the inverse FFT).
    """
    if isinstance(raw_channels, (tuple, list)):
        raw_channels = jnp.stack(raw_channels, axis=0)
    k, n_az, n_rg = raw_channels.shape
    m = p.bands
    if k < m:
        raise ValueError(f"need >= {m} channels to unfold {m} bands, got {k}")

    # per-channel azimuth spectra at the base PRF: (K, P, Ns)
    spec = jnp.fft.fft(raw_channels, axis=1)

    idx_np, f_ext = _band_layout(p, n_az)
    a = steering_matrix(p, jnp.asarray(f_ext))                   # (P, K, M)

    # batched per-bin solve: y (P, K, Ns) -> u (P, M, Ns), via diagonally
    # loaded normal equations: near the degenerate spacing (spacing*PRF/(2V)
    # integer — channels sampling coincident effective positions) the plain
    # solve blows up to NaN; Tikhonov loading keeps it finite (noise
    # amplification is then the caller's diagnostic via condition_numbers).
    # HIGHEST: a TF32 Gram product cannot hold the ghost-suppression budget
    y = jnp.transpose(spec, (1, 0, 2))
    ah = jnp.conj(jnp.swapaxes(a, -1, -2))
    hi = jax.lax.Precision.HIGHEST
    gram = jnp.matmul(ah, a, precision=hi)
    eps = 1e-6 * jnp.mean(jnp.abs(jnp.diagonal(gram, axis1=-2, axis2=-1)))
    gram = gram + eps * jnp.eye(m, dtype=gram.dtype)
    u = jnp.linalg.solve(gram, jnp.matmul(ah, y, precision=hi))

    # scatter bands into the extended spectrum (a pure permutation)
    idx = jnp.asarray(idx_np)                                    # (P, M)
    ext = jnp.zeros((m * n_az, n_rg), jnp.complex64)
    ext = ext.at[idx.reshape(-1)].set(u.reshape(m * n_az, n_rg))
    # factor 1/M keeps amplitude consistent with a true PRF_eff sampling
    return jnp.fft.ifft(ext, axis=0) * m


def reconstruct_sharded(raw_channels, p: HrwsParams, mesh, axis: str = "seq"):
    """Range-bin-sharded HRWS reconstruction (the SURVEY §2.10 commitment:
    "per-Doppler-bin solve sharded over range bins").

    Every step of :func:`reconstruct` — azimuth FFT (along pulses), the
    per-Doppler-bin Tikhonov-loaded solve, the band scatter and the inverse
    FFT — is independent per range bin, so the shard_map body IS
    ``reconstruct`` on the local (K, P, Ns/n) slab: zero collectives beyond
    the input reshard, and the M x M Gram solves replicate only the (tiny)
    steering matrices. Input sharded (or resharded) on the trailing range
    axis over mesh ``axis``; output (M*P, Ns) stays range-sharded for the
    focusing stage that follows (ops/csa.py on the same layout).
    """
    import jax
    from jax.sharding import PartitionSpec as P_

    if isinstance(raw_channels, (tuple, list)):
        raw_channels = jnp.stack(raw_channels, axis=0)
    f = jax.shard_map(
        lambda rc_l: reconstruct(rc_l, p), mesh=mesh,
        in_specs=P_(None, None, axis), out_specs=P_(None, axis),
        check_vma=False)
    return f(raw_channels)


def collect_reconstruct_focus(trajectory, targets, echo_opts, p: HrwsParams,
                              csa_params, *, t_start: float, mesh=None,
                              axis: str = "seq",
                              target_velocity=(0.0, 0.0, 0.0)):
    """End-to-end HRWS pipeline: K-channel collection at the (deliberately
    sub-Nyquist) system PRF -> azimuth-spectrum unfolding -> CSA focusing
    at PRF_eff = M*PRF. This is the processing chain the reference's
    'doppler ambiguity' demo motivates (ghosts at low PRF,
    ``doppler ambiguity.html:556-570``) and the HRWS constellation is built
    to feed (``HRWS constellation.html``).

    ``csa_params.num_pulses`` must equal M*P (the reconstructed slow-time
    length) and ``csa_params.prf_hz`` the effective PRF. With ``mesh``,
    reconstruction runs range-sharded (:func:`reconstruct_sharded`) and the
    CSA runs on the same sharded layout via the sequence-parallel path.
    Returns (reconstructed slow-time signal, focused SLC).
    """
    from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
    from nis_sar_amtigmti_video_tpu.ops.echo import (
        multi_channel_phase_history)

    raw = multi_channel_phase_history(
        trajectory, targets, echo_opts, t_start=t_start,
        rx_offsets=p.rx_offsets(), target_velocity=target_velocity)
    if mesh is not None:
        from nis_sar_amtigmti_video_tpu.parallel import corner_turn
        rec = reconstruct_sharded(raw, p, mesh, axis)
        slc = corner_turn.csa_sharded(rec, csa_ops.csa_phases(csa_params),
                                      mesh, axis=axis,
                                      input_layout="range")
    else:
        rec = reconstruct(raw, p)
        slc = csa_ops.focus_csa(rec, csa_params)
    return rec, slc


def ghost_free_prf(doppler_bandwidth_hz: float, num_channels: int) -> float:
    """Minimum system PRF for K channels to cover a Doppler bandwidth."""
    return doppler_bandwidth_hz / num_channels


def uniform_sampling_prf(v_platform: float, spacing_m: float,
                         num_channels: int) -> float:
    """PRF at which the K channels' effective phase centers sample slow time
    uniformly at K*PRF (best-conditioned reconstruction):
    spacing/(2V) = 1/(K*PRF)  =>  PRF = 2V/(K*spacing)."""
    return 2.0 * v_platform / (num_channels * spacing_m)


def uniform_sampling_spacing(v_platform: float, prf_hz: float,
                             num_channels: int) -> float:
    """Channel spacing for uniform effective sampling at this PRF."""
    return 2.0 * v_platform / (num_channels * prf_hz)


def dpca_condition_prf(v_platform: float, spacing_m: float) -> float:
    """PRF at which adjacent channels' effective phase centers *coincide*
    after one PRI (spacing = 2V/PRF) — ideal for DPCA clutter cancellation
    but DEGENERATE for HRWS reconstruction (singular steering matrix): keep
    the operating PRF away from this point when unfolding."""
    return 2.0 * v_platform / spacing_m


def condition_numbers(p: HrwsParams, n_az: int):
    """Per-Doppler-bin condition number of the steering matrix — the noise
    amplification diagnostic of the non-uniform-sampling tradeoff."""
    import numpy as np
    _, f_ext = _band_layout(p, n_az)
    from nis_sar_amtigmti_video_tpu.utils import cplx
    a = cplx.to_host(steering_matrix(p, jnp.asarray(f_ext)))
    return np.linalg.cond(a)
