"""Process set-up shared by the entry points: compile cache and device.

The persistent compilation cache is only found again at the same path, so
its directory is fixed: ``JAX_COMPILATION_CACHE_DIR`` when the environment
sets it (JAX reads that variable itself, and nothing else is set),
otherwise ``.jax_cache/`` at the root of the checkout.
"""

from __future__ import annotations

import os
import subprocess

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def card_info() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reports them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    if res.returncode != 0:
        return f"unavailable (nvidia-smi rc={res.returncode})"
    return res.stdout.strip()


def device_record() -> dict:
    """The device the process computes on, as JAX reports it."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
