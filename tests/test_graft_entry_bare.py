"""Driver-contract test: dryrun_multichip must work in a BARE process.

__graft_entry__ must not rely on the test conftest to provide 8 virtual CPU
devices. This test reproduces a bare invocation: a fresh python subprocess
with NO XLA_FLAGS / JAX_PLATFORMS hints, calling ``dryrun_multichip(8)``
(on a host whose only platform is the CPU, the dryrun builds its virtual
devices itself).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bare_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")}
    return env


def test_dryrun_multichip_bare_subprocess():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import __graft_entry__\n"
        "__graft_entry__.dryrun_multichip(8)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], env=_bare_env(),
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    assert "dryrun_multichip ok" in res.stdout, res.stdout


def test_dryrun_multichip_after_jax_initialized():
    """If JAX's CPU backend is already up with too few devices, the
    CPU-pinned subprocess fallback must kick in."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "assert len(jax.devices()) == 1\n"   # bare CPU: one device
        "import __graft_entry__\n"
        "__graft_entry__.dryrun_multichip(8)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], env=_bare_env(),
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    assert "dryrun_multichip ok" in res.stdout, res.stdout
