"""SAR / AMTI-GMTI / VideoSAR framework in JAX.

A JAX/XLA re-design of the capabilities of the
``NIS-SAR-AMTIGMTI-Video`` reference toolkit (see SURVEY.md): vmapped point-target
raw-echo simulation, on-device image formation (CSA / RDA / backprojection),
multichannel GMTI (ATI, DPCA, CRT, CFAR), VideoSAR frame pipelines, HRWS
multichannel azimuth-ambiguity reconstruction, and constellation/mission design
math — sharded over a device mesh with JAX collectives.

Precision policy
----------------
x64 is enabled at import. Geometry (trajectories, slant ranges, delays) is
computed in float64 — at ~507 km slant range the two-way carrier phase needs
sub-mm range accuracy, which float32 cannot represent (reference relies on
numpy float64 / torch complex128 for the same reason, e.g.
``sar_ati_dcpa_sim_csa.py:118``). All *large* tensors (phase histories, images)
are explicitly complex64/float32: phases are wrapped mod 2π in f64 *before*
being cast down, so the hot compute path is pure f32/c64 work. Every f32/c64
matmul and einsum on the main path states its ``precision``: on the GPU an
unstated float32 matmul runs in TF32, outside the focusing fidelity budgets.

Host transfer policy
--------------------
:mod:`nis_sar_amtigmti_video_tpu.utils.cplx` (``to_host`` / ``to_device``)
moves arrays, complex included, across the host<->device boundary in one
direct transfer each.
"""

import os as _os

import jax as _jax

# Must happen before any array is created anywhere in the package. Host
# applications embedding this library next to other JAX code can opt out of
# the process-global x64 switch with NIS_SAR_NO_X64=1 (geometry helpers then
# upcast explicitly where f64 is required; focusing accuracy contracts are
# only guaranteed with x64 on).
if _os.environ.get("NIS_SAR_NO_X64", "0") != "1":
    _jax.config.update("jax_enable_x64", True)

from nis_sar_amtigmti_video_tpu import constants  # noqa: E402
from nis_sar_amtigmti_video_tpu import config  # noqa: E402

__version__ = "0.1.0"

__all__ = ["constants", "config", "__version__"]
