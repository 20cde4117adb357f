"""Matmul FFTs: four-step Cooley-Tukey as dense complex DFT matmuls.

This module factors an N-point FFT (N = n1*n2) into

    reshape (n1, n2) -> D_{n1} @ x -> twiddle W_N^{k1 b}
    -> x @ D_{n2} -> transpose(k1,k2) -> flatten

so the work is dense complex matmuls. It is one of the FFT implementations
:func:`get_impl` offers beside the stock ``jnp.fft`` (cuFFT on the GPU).

Exactness: this is the exact DFT (dense DFT matrices in f64, cast c64), not
an approximation. Every product runs at ``Precision.HIGHEST``: a float32
matmul on the GPU otherwise runs in TF32 (~3 decimal digits), far outside
the focusing fidelity budgets. Agreement with jnp.fft is at f32 rounding
level.
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST

# preferred factorizations (n1, n2) per size
_FACTORS = {
    256: (16, 16),
    512: (32, 16),
    1024: (32, 32),
    2048: (64, 32),
    4096: (64, 64),
    8192: (128, 64),
    16384: (128, 128),
}

# The four-step identity X[k1 + n1*k2] = D2_{k2 b} (W_N^{k1 b} (D1_{k1 a}
# c[a, b])) holds for ANY n = n1*n2 — nothing in _fft_last/_fft_middle
# assumes powers of two. Composite sizes off the preferred table get the
# most balanced divisor pair, bounded so the dense DFT matrices stay a few
# MB: the reference's full-scale apertures (7,199 = 23*313 azimuth after
# the DPCA pulse shift, 13,200 = 120*110 range samples,
# sar_ati_dcpa_sim_csa.py:46-47,398-404).
_MAX_FACTOR = 512


@lru_cache(maxsize=None)
def _factor_pair(n: int):
    """Balanced (n1, n2) with n = n1*n2, n2 <= n1 <= _MAX_FACTOR; None if no
    such pair exists (n prime or with a huge prime factor)."""
    if n in _FACTORS:
        return _FACTORS[n]
    if n < 4:
        return None
    a = int(math.isqrt(n))
    while a >= 2:
        if n % a == 0:
            n1 = n // a           # the most balanced split: n1 grows as a
            return (n1, a) if n1 <= _MAX_FACTOR else None  # shrinks further
        a -= 1
    return None


def supported(n: int) -> bool:
    return _factor_pair(n) is not None


@lru_cache(maxsize=None)
def _consts(n: int, inverse: bool):
    """(D1 (n1,n1), D2 (n2,n2), twiddle (n1,n2)) complex64 numpy consts."""
    n1, n2 = _factor_pair(n)
    sign = 2.0j * math.pi / n if inverse else -2.0j * math.pi / n
    a1 = np.arange(n1)
    a2 = np.arange(n2)
    d1 = np.exp((sign * n2) * np.outer(a1, a1))          # W_{n1}
    d2 = np.exp((sign * n1) * np.outer(a2, a2))          # W_{n2}
    tw = np.exp(sign * np.outer(a1, a2))                 # W_N^{k1 b}
    return (d1.astype(np.complex64), d2.astype(np.complex64),
            tw.astype(np.complex64))


def _dev_consts(n: int, inverse: bool):
    """The DFT/twiddle tables as on-device complex64 arrays."""
    return tuple(jnp.asarray(c) for c in _consts(n, inverse))


def _fft_last(x, n: int, inverse: bool):
    """Exact (i)DFT along the last axis via the four-step factorization."""
    n1, n2 = _factor_pair(n)
    d1, d2, tw = _dev_consts(n, inverse)

    lead = x.shape[:-1]
    c = x.reshape(lead + (n1, n2))
    # stage 1: DFT over the a (length-n1) axis: D1[k1,a] @ C[a,b]
    y = jnp.einsum("ka,...ab->...kb", d1, c, precision=_HIGHEST,
                   preferred_element_type=jnp.complex64)
    y = y * tw
    # stage 3: DFT over b: Y[k1,b] @ D2[b,k2]
    y = jnp.einsum("...kb,bj->...kj", y, d2, precision=_HIGHEST,
                   preferred_element_type=jnp.complex64)
    # output index is k1 + n1*k2 -> transpose then flatten
    y = jnp.swapaxes(y, -1, -2).reshape(lead + (n,))
    if inverse:
        y = y * jnp.float32(1.0 / n)
    return y


def _fft_middle(x, n: int, inverse: bool):
    """Exact (i)DFT along axis=-2, minor (last) axis untouched.

    Every einsum keeps the original last axis minor, so the pulse axis is
    contracted in place with no data transposes."""
    n1, n2 = _factor_pair(n)
    d1, d2, tw = _dev_consts(n, inverse)

    lead = x.shape[:-2]
    r = x.shape[-1]
    c = x.reshape(lead + (n1, n2, r))
    # stage 1: contract the a axis: D1[k,a] x C[...,a,b,r]
    y = jnp.einsum("ka,...abr->...kbr", d1, c, precision=_HIGHEST,
                   preferred_element_type=jnp.complex64)
    y = y * tw[:, :, None]
    # stage 3: contract the b axis: Y[...,k,b,r] x D2[b,j]
    y = jnp.einsum("bj,...kbr->...kjr", d2, y, precision=_HIGHEST,
                   preferred_element_type=jnp.complex64)
    # output index k + n1*j along the pulse axis -> swap the two small axes
    y = jnp.swapaxes(y, -2, -3).reshape(lead + (n, r))
    if inverse:
        y = y * jnp.float32(1.0 / n)
    return y


def fft(x, axis: int = -1):
    """Matmul FFT along ``axis``; falls back to jnp.fft.fft for unsupported
    sizes/axes."""
    n = x.shape[axis]
    if not supported(n):
        return jnp.fft.fft(x, axis=axis)
    if axis in (-1, x.ndim - 1):
        return _fft_last(x, n, inverse=False)
    if axis in (-2, x.ndim - 2):
        return _fft_middle(x, n, inverse=False)
    return jnp.fft.fft(x, axis=axis)


def ifft(x, axis: int = -1):
    n = x.shape[axis]
    if not supported(n):
        return jnp.fft.ifft(x, axis=axis)
    if axis in (-1, x.ndim - 1):
        return _fft_last(x, n, inverse=True)
    if axis in (-2, x.ndim - 2):
        return _fft_middle(x, n, inverse=True)
    return jnp.fft.ifft(x, axis=axis)


def _fft_hybrid(x, axis=-1):
    """einsum for the middle (azimuth) axis, stock XLA FFT for the minor."""
    n = x.shape[axis]
    if axis in (-2, x.ndim - 2) and supported(n):
        return _fft_middle(x, n, inverse=False)
    return jnp.fft.fft(x, axis=axis)


def _ifft_hybrid(x, axis=-1):
    n = x.shape[axis]
    if axis in (-2, x.ndim - 2) and supported(n):
        return _fft_middle(x, n, inverse=True)
    return jnp.fft.ifft(x, axis=axis)


FFT_IMPLS = ("auto", "xla", "mxu", "hybrid")


def get_impl(name: str):
    """('auto' | 'xla' | 'mxu' | 'hybrid') -> (fft, ifft) pair.

    'xla' is the stock ``jnp.fft`` (cuFFT on the GPU) and what 'auto'
    resolves to. 'mxu' runs every supported axis as the four-step matmul
    DFT (each call checks ``supported(n)`` and falls back to jnp.fft for
    prime-class lengths); 'hybrid' runs only azimuth (middle-axis)
    transforms that way and range (minor-axis) transforms on jnp.fft."""
    if name in ("auto", "xla"):
        return jnp.fft.fft, jnp.fft.ifft
    if name == "mxu":
        return fft, ifft
    if name == "hybrid":
        return _fft_hybrid, _ifft_hybrid
    raise ValueError(
        f"unknown fft impl {name!r}; options: {', '.join(FFT_IMPLS)}")
