"""Gather-based linear interpolation primitives.

JAX has no ``grid_sample`` / ``interp1d``; everything is expressed as
vectorized index arithmetic + gathers, replacing the reference's per-bin
``scipy.interp1d`` loop (sar_satellite_sim.py:417-427) and
``torch.nn.functional.grid_sample`` (sar_batch_sim.py:229).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def interp_uniform(sig, u, *, fill_zero: bool = True):
    """Sample complex/real ``sig`` (..., N) at fractional positions ``u``
    (..., M) on its own uniform index grid; linear, zero outside [0, N-1].

    Matches torch grid_sample(align_corners=False) semantics when the caller
    passes u = index - 0.5 (sar_batch_sim.py:225-230 uses normalized coords
    that reduce to exactly that).
    """
    n = sig.shape[-1]
    i0 = jnp.floor(u)
    w = (u - i0).astype(jnp.float32)
    i0 = i0.astype(jnp.int32)

    def take(idx):
        v = jnp.take_along_axis(sig, jnp.clip(idx, 0, n - 1), axis=-1)
        if fill_zero:
            ok = (idx >= 0) & (idx <= n - 1)
            v = jnp.where(ok, v, jnp.zeros((), sig.dtype))
        return v

    return take(i0) * (1.0 - w) + take(i0 + 1) * w


def interp_nonuniform_src(x_src, y_src, x_out, *, fill_zero: bool = True):
    """Linear interpolation from a *non-uniform ascending* source grid.

    Equivalent to scipy ``interp1d(x_src, y_src, kind='linear',
    fill_value=0, bounds_error=False)`` evaluated at ``x_out``
    (the reference RCMC resampler, sar_satellite_sim.py:422-424).

    x_src: (N,) ascending; y_src: (N,) values; x_out: (M,).
    """
    n = x_src.shape[0]
    # index of the interval: largest i with x_src[i] <= x_out
    idx = jnp.searchsorted(x_src, x_out, side="right") - 1
    i0 = jnp.clip(idx, 0, n - 2)
    x0 = x_src[i0]
    x1 = x_src[i0 + 1]
    w = ((x_out - x0) / (x1 - x0)).astype(jnp.float32)
    out = y_src[i0] * (1.0 - w) + y_src[i0 + 1] * w
    if fill_zero:
        ok = (x_out >= x_src[0]) & (x_out <= x_src[-1])
        out = jnp.where(ok, out, jnp.zeros((), y_src.dtype))
    return out
