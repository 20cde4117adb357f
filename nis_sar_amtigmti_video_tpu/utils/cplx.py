"""Complex host<->device transfer helpers.

``to_host`` / ``to_device`` are the package's one boundary for moving
arrays between NumPy and the device; each is a single direct transfer,
complex dtypes included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def to_host(x) -> np.ndarray:
    """Fetch a (possibly complex) device array to a host numpy array."""
    return np.asarray(x)


def to_device(x: np.ndarray, dtype=jnp.complex64, device=None):
    """Put a host array on device; complex arrays are cast to ``dtype``."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        x = x.astype(dtype)
    return jax.device_put(x, device)


def expj(phase):
    """exp(1j*phase) for real ``phase`` without materializing a complex phase
    grid first — cos/sin fuse into the consumer."""
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
