"""Dual-baseline velocity-ambiguity resolution (CRT solver).

Behavior of ``CRT Solver.html:30-51``: two along-track baselines R1 < R2 give
two wrapped ATI phase measurements; each hypothesis (k1, k2) of wrap counts
yields candidate velocities v_i = C_i*(phi_i + 2*pi*k_i) with
C_i = lambda*v_amb/(4*pi*R_i); candidates are ranked by |v_1 - v_2| and the
best consistent pair's mean is the unwrapped radial velocity.

This version evaluates the whole (2K+1)^2 hypothesis grid as one
vectorized outer sum and also vmaps over batched phase pairs, so dense
per-pixel unwrapping of an ATI velocity map is a single device kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp


class CrtSolution(NamedTuple):
    velocity: jax.Array      # consistent velocity estimate (mean of pair)
    residual: jax.Array      # |v1 - v2| of the winning hypothesis
    k1: jax.Array            # winning wrap counts
    k2: jax.Array
    diff_grid: jax.Array     # (2K+1, 2K+1) |v1-v2| hypothesis surface


def solve(phase1, phase2, wavelength_m: float, v_amb: float,
          baseline1_m: float, baseline2_m: float, k_range: int = 20):
    """Resolve the velocity ambiguity for one phase pair.

    Constants C_i = lambda*v_amb/(4*pi*R_i) follow the reference demo
    exactly (CRT Solver.html:37-38).
    """
    c1 = wavelength_m * v_amb / (4.0 * math.pi * baseline1_m)
    c2 = wavelength_m * v_amb / (4.0 * math.pi * baseline2_m)
    ks = jnp.arange(-k_range, k_range + 1, dtype=jnp.float64)
    v1 = c1 * (phase1 + 2.0 * math.pi * ks)          # (K,)
    v2 = c2 * (phase2 + 2.0 * math.pi * ks)          # (K,)
    diff = jnp.abs(v1[:, None] - v2[None, :])        # (K, K) over (k1, k2)
    flat = jnp.argmin(diff)
    i1, i2 = jnp.unravel_index(flat, diff.shape)
    vel = 0.5 * (v1[i1] + v2[i2])
    return CrtSolution(velocity=vel, residual=diff[i1, i2],
                       k1=ks[i1].astype(jnp.int32), k2=ks[i2].astype(jnp.int32),
                       diff_grid=diff)


def top_candidates(sol: CrtSolution, phase1, phase2, wavelength_m, v_amb,
                   baseline1_m, baseline2_m, n: int = 10):
    """(velocity, residual, k1, k2) of the n best hypotheses, ranked —
    the reference demo's candidate table (CRT Solver.html:219-243)."""
    k = (sol.diff_grid.shape[0] - 1) // 2
    c1 = wavelength_m * v_amb / (4.0 * math.pi * baseline1_m)
    c2 = wavelength_m * v_amb / (4.0 * math.pi * baseline2_m)
    ks = jnp.arange(-k, k + 1, dtype=jnp.float64)
    flat = sol.diff_grid.ravel()
    order = jnp.argsort(flat)[:n]
    i1, i2 = jnp.unravel_index(order, sol.diff_grid.shape)
    v1 = c1 * (phase1 + 2.0 * math.pi * ks[i1])
    v2 = c2 * (phase2 + 2.0 * math.pi * ks[i2])
    return (0.5 * (v1 + v2), flat[order], ks[i1].astype(jnp.int32),
            ks[i2].astype(jnp.int32))


def solve_map(phase1_map, phase2_map, wavelength_m, v_amb,
              baseline1_m, baseline2_m, k_range: int = 20):
    """Dense unwrapping: vmapped solve over arbitrarily-shaped phase maps.
    Returns (velocity_map, residual_map)."""
    shape = phase1_map.shape
    f = jax.vmap(lambda a, b: solve(a, b, wavelength_m, v_amb,
                                    baseline1_m, baseline2_m, k_range)[:2])
    vel, res = f(phase1_map.ravel(), phase2_map.ravel())
    return vel.reshape(shape), res.reshape(shape)
