"""Fused GMTI product step — the streaming hot path.

The composed ops (ati.channel_balance_phase -> ati.apply_balance ->
ati.masked_phase -> dpca.dpca_difference -> cfar.ca_cfar) are individually
correct but materialize the balanced channel and make several full passes
over the 4096^2 SLC pair. This step computes identical products with:

  pass A  one fused reduction (balance sum + peak magnitude together)
  pass B  one fused elementwise map: the balance rotation is folded
          analytically into the interferogram (x e^{-j cal}) and the
          difference (s1 - s2 e^{+j cal}) — the balanced channel is never
          written to device memory
  pass C  CFAR box sums on |diff|^2 (cfar.ca_cfar, separable reduce_window)

Products match the composed path exactly (same formulas, same rounding
class); tests/test_gmti.py::TestFusedStep asserts equality.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nis_sar_amtigmti_video_tpu.gmti import cfar as cfar_mod


def gmti_product_step(s1, s2, *, balance: bool = True,
                      mask_threshold: float = 0.05,
                      cfar_params: cfar_mod.CfarParams | None = None):
    """(s1, s2) SLCs -> (cal_phase, ati_phase, dpca_mag, cfar_detection).

    cal_phase is the applied balance rotation (0 when balance=False);
    ati_phase is magnitude-masked like ati.masked_phase (0 outside);
    dpca_mag = |s1 - s2 e^{j cal}|.
    """
    # ---- pass A: both reductions fused ----
    prod = s1 * jnp.conj(s2)
    xsum = jnp.sum(prod)
    peak2 = jnp.max(jnp.real(s1) ** 2 + jnp.imag(s1) ** 2)
    cal = jnp.angle(xsum) if balance else jnp.zeros((), jnp.float32)

    # ---- pass B: products without materializing the balanced channel ----
    rot = jax.lax.complex(jnp.cos(cal), jnp.sin(cal)).astype(s1.dtype)
    interf = prod * jnp.conj(rot)            # s1 conj(s2 e^{j cal})
    phase = jnp.angle(interf).astype(jnp.float32)
    mag1_2 = jnp.real(s1) ** 2 + jnp.imag(s1) ** 2
    mask = mag1_2 > (mask_threshold ** 2) * peak2
    phase = jnp.where(mask, phase, 0.0)
    diff = s1 - s2 * rot
    power = jnp.real(diff) ** 2 + jnp.imag(diff) ** 2
    dmag = jnp.sqrt(power)

    det = cfar_mod.ca_cfar(power, cfar_params or cfar_mod.CfarParams())
    return cal, phase, dmag, det
