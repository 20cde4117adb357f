"""Chirp-Z evaluation of trigonometric interpolants (Bluestein, FFT-only).

Rationale: arbitrary-position resampling normally needs gathers; when the evaluation positions form an
*arithmetic progression* ``start + step*k`` the periodic sinc interpolant can
be evaluated exactly with three FFTs (Bluestein's chirp factorization
nk = (n^2 + k^2 - (k-n)^2) / 2) — no gathers, no interpolation-kernel design
error (exact for the sampled band, including content at the Nyquist edge
that windowed-sinc kernels droop).

Uses: fast-BP output-grid resampling (ops/bp_fast.py), chirp-Z RCMC
(squinted range-cell migration without per-bin gathers — the reference's
interp1d loop is sar_satellite_sim.py:417-427).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from nis_sar_amtigmti_video_tpu.utils.cplx import expj

_TWO_PI = 2.0 * math.pi


def _wrap32(phase64):
    ph = phase64 - _TWO_PI * jnp.round(phase64 / _TWO_PI)
    return ph.astype(jnp.float32)


@partial(jax.jit, static_argnames=("n_out", "axis"))
def czt_eval(x, n_out: int, step, start, axis: int = -1):
    """Evaluate the periodic trig interpolant of ``x`` at ``start + step*k``.

    x: (..., N, ...) complex samples on the integer grid 0..N-1 along
    ``axis``; positions are in sample units. Returns (..., n_out, ...) with

        out[k] = (1/N) sum_m X[m] exp(j 2 pi f_m (start + step k))

    where X = DFT(x) and f_m are the *signed* bin frequencies (fftfreq) —
    i.e. exact band-limited interpolation, identical to FFT-upsample +
    pick, for any real step/start. At step=1, start=0 it returns x.

    ``start`` may be an ARRAY broadcasting against x's non-``axis`` dims
    (shaped like x with ``axis`` moved last and dropped): the start offset
    enters only the pre-convolution phase, so a per-slice start comes free
    — callers that would otherwise FFT-shear then czt (the fast-BP output
    resample) fold the shear's whole FFT round trip into this one.
    """
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    # signed spectrum: m' = -N//2 .. N//2-1
    xs = jnp.fft.fftshift(jnp.fft.fft(x, axis=-1), axes=-1) / n
    m = jnp.arange(n, dtype=jnp.float64) - n // 2

    theta = _TWO_PI * jnp.asarray(step, jnp.float64) / n      # rad per (m*k)
    phi = (_TWO_PI / n) * (jnp.asarray(start, jnp.float64)[..., None]
                           * m)                               # rad per m

    # out[k] = sum_j y[j] e^{j theta (j - c) k},  y = xs * e^{j phi},
    # with j the array position and c = n//2 the signed-bin offset.
    # Bluestein on the j-indexed sum: jk = (j^2 + k^2 - (k-j)^2)/2.
    j = jnp.arange(n, dtype=jnp.float64)
    a = xs * expj(_wrap32(phi + 0.5 * theta * j * j))
    k = jnp.arange(n_out, dtype=jnp.float64)
    out_chirp = expj(_wrap32(0.5 * theta * k * k - theta * (n // 2) * k))

    # linear convolution a (len n) with the even chirp b(d)=e^{-j theta d^2/2}
    # over lags d = k - j in [-(n-1), n_out-1]. Asymmetric circular fill:
    # buffer slots [0, n_out) hold the positive lags and the top n-1 slots
    # the negative ones, so nfft >= n + n_out - 1 suffices (the symmetric
    # nfft/2 split needed 2*max(n, n_out) — one pow2 size larger at the
    # fast-BP output-resample shapes, e.g. 4096 vs 2048 for 1536 -> 512).
    # Slots in between are hit only by discarded outputs k >= n_out.
    nfft = 1 << (n + n_out - 2).bit_length()
    d = jnp.arange(nfft, dtype=jnp.float64)
    d = jnp.where(d >= n_out, d - nfft, d)                    # circular lag
    b = expj(_wrap32(-0.5 * theta * d * d))
    shape_b = (1,) * (a.ndim - 1) + (nfft,)
    conv = jnp.fft.ifft(
        jnp.fft.fft(a, n=nfft, axis=-1) * jnp.fft.fft(b).reshape(shape_b),
        axis=-1)
    out = conv[..., :n_out] * out_chirp
    return jnp.moveaxis(out.astype(x.dtype), -1, axis)
