"""Test harness: CPU with 8 virtual devices unless JAX_PLATFORMS says otherwise.

Multi-device tests run on a virtual 8-device CPU mesh
(--xla_force_host_platform_device_count) so sharding logic is exercised on
any host; numerical goldens also run on CPU for speed and determinism. An
explicit ``JAX_PLATFORMS`` (e.g. ``cuda``) is honoured, which is how the
``gpu``-marked comparisons run on the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The GPU a ``gpu``-marked test compares on; skips without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform}); run "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return dev
