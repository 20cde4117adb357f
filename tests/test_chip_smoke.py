"""chip_smoke.py: the no-GPU contract, and every phase at a tiny size on
the CPU (the same functions run at the reference sizes on the card)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [[], ["--four"]], ids=["one", "four"])
def test_no_gpu_fails_without_result(args):
    res = _run(args, REPO)
    assert res.returncode == 2
    assert res.stdout == ""                  # no phase line, no JSON
    assert "needs" in res.stderr and "GPU" in res.stderr


def test_alone_without_the_repo_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run([], str(tmp_path))
    assert res.returncode == 2
    assert res.stdout == ""
    assert "cannot import the package" in res.stderr


def test_options_are_exclusive():
    res = _run(["--four", "--fullscale-oracle"], REPO)
    assert res.returncode == 2 and res.stdout == ""


def test_run_phase_reports_failure(capsys):
    def boom(_):
        raise AssertionError("bad image")
    assert chip_smoke.run_phase("x", boom, chip_smoke.TINY) is False
    assert "x: FAILED" in capsys.readouterr().out
    assert chip_smoke.run_phase("y", lambda _: (1.0, 0.5, "d"),
                                chip_smoke.TINY)
    line = capsys.readouterr().out
    assert "y: ok compile_s=1.00 warm_s=0.5000" in line and "| d" in line


@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.PHASES])
def test_phase_tiny_on_cpu(name):
    fn = dict(chip_smoke.PHASES)[name]
    kw = {"workers": 2} if name == "gmti_oracle" else {}
    first, warm, detail = fn(chip_smoke.TINY, **kw)
    assert first >= 0.0 and warm > 0.0 and detail


def test_phase_four_tiny_on_virtual_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    first, warm, detail = chip_smoke.phase_four(chip_smoke.TINY,
                                                jax.devices())
    assert detail.count("e-") + detail.count("e+") == 5


@pytest.mark.gpu
@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.PHASES])
def test_phase_reference_size_on_gpu(gpu, name):
    """The same phase at the reference sizes, on the card."""
    dict(chip_smoke.PHASES)[name](chip_smoke.FULL)

