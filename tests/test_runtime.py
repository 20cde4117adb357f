"""Process set-up helpers, the device fence, and the precision every
f32/c64 matmul on the main path states (a float32 matmul with no stated
precision runs in TF32 on the GPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore

import nis_sar_amtigmti_video_tpu as nst  # noqa: F401  (x64 on)
from nis_sar_amtigmti_video_tpu.utils import cplx, profiling, runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore(self):
        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_env_dir_wins_and_nothing_else_is_set(self, monkeypatch,
                                                   tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", None)
        assert runtime.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the helper sets no other path
        assert jax.config.jax_compilation_cache_dir is None

    def test_unset_uses_fixed_dir_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = runtime.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        # the same path every call: no temporary name, PID or time in it
        assert runtime.enable_compile_cache() == got
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestDevice:
    def test_device_record_names_the_platform(self):
        rec = runtime.device_record()
        assert rec == {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())}

    def test_card_info_without_nvidia_smi(self, monkeypatch):
        monkeypatch.setenv("PATH", "")
        assert runtime.card_info().startswith("unavailable")


class TestSync:
    def test_sync_waits_on_every_leaf(self):
        tree = {"a": jnp.arange(4.0) * 2, "b": (jnp.ones(3, jnp.complex64),
                                                 np.zeros(2), 1.5)}
        assert profiling.sync(tree) is None
        assert all(x.is_ready() for x in (tree["a"], tree["b"][0]))

    def test_stage_timer_counts_and_syncs(self):
        t = profiling.StageTimer()
        out = t.timed("double", lambda x: 2 * x, jnp.ones(5))
        assert out.is_ready() and t.counts["double"] == 1
        assert t.report()["double"]["count"] == 1


class TestTransfers:
    def test_complex_round_trip_is_exact(self):
        x = (np.arange(12.0).reshape(3, 4)
             + 1j * np.arange(12.0, 24.0).reshape(3, 4)).astype(np.complex64)
        d = cplx.to_device(x)
        assert d.dtype == jnp.complex64
        np.testing.assert_array_equal(cplx.to_host(d), x)

    def test_to_device_casts_complex128(self):
        d = cplx.to_device(np.ones(3, np.complex128) * (1 + 2j))
        assert d.dtype == jnp.complex64
        d = cplx.to_device(np.ones(3, np.float32))
        assert d.dtype == jnp.float32


def _dots(jaxpr, out):
    """(operand dtype, precision) of every dot_general, sub-jaxprs too."""
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            out.append((e.invars[0].aval.dtype, e.params["precision"]))
        for v in e.params.values():
            for w in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(w, jcore.ClosedJaxpr):
                    _dots(w.jaxpr, out)
                elif isinstance(w, jcore.Jaxpr):
                    _dots(w, out)
    return out


def _csa_case(fft_impl):
    from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
    p = csa_ops.CsaParams(wavelength_m=0.031, chirp_rate=1e13, fs_hz=60e6,
                          prf_hz=1000.0, velocity_mps=7000.0,
                          range_ref_m=5e5, t_start_fast=3.3e-3,
                          num_pulses=64, num_samples=256)
    f = csa_ops.csa_factors(p)
    return (lambda x: csa_ops.apply_csa_fused(x, f, fft_impl),
            (jnp.zeros((64, 256), jnp.complex64),))


def _hrws_case():
    from nis_sar_amtigmti_video_tpu.models import hrws
    p = hrws.HrwsParams(num_channels=4, spacing_m=0.6, prf_hz=6000.0,
                        velocity_mps=7612.0)
    return (lambda x: hrws.reconstruct(x, p),
            (jnp.zeros((4, 16, 8), jnp.complex64),))


def _bp_case(accumulate, math_mode):
    from nis_sar_amtigmti_video_tpu.ops import bp_fast
    plan = bp_fast.FastBpPlan(ny_i=16, nx_i=128, w_win=32, stride=1,
                              band_start=4, nfft=128, dx_m=1.0, t_ref=1e-3,
                              n_org=60.0, sub_raw=4, nx_c=32, sub_raw1=2,
                              nx_c1=16, grp=2)
    n_p = 8
    prec = "default" if math_mode == "fast" else "highest"
    args = (jnp.zeros((n_p, 128), jnp.complex64),
            tuple(jnp.zeros((n_p, 16), jnp.float32) for _ in range(4))
            + tuple(jnp.zeros((n_p,), jnp.float32) for _ in range(2)))
    return (lambda rc2, co: bp_fast.accumulate_image(
        rc2, co, plan, accumulate, einsum_prec=prec), args)


CASES = {
    "fft_mxu": lambda: (lambda x: __import__(
        "nis_sar_amtigmti_video_tpu.ops.fft", fromlist=["fft"]).fft(
        x, axis=-2), (jnp.zeros((64, 256), jnp.complex64),)),
    "csa_mxu": lambda: _csa_case("mxu"),
    "csa_hybrid": lambda: _csa_case("hybrid"),
    "hrws_reconstruct": _hrws_case,
    "bp_xla": lambda: _bp_case("xla", "exact"),
    "bp_factor": lambda: _bp_case("factor", "exact"),
    "bp_factor2": lambda: _bp_case("factor2", "exact"),
    "bp_factor2_fast": lambda: _bp_case("factor2", "fast"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_main_path_matmuls_state_precision(case):
    fn, args = CASES[case]()
    dots = _dots(jax.make_jaxpr(fn)(*args).jaxpr, [])
    assert dots, "expected matmuls on this path"
    loose = [(d, p) for d, p in dots
             if d in (jnp.float32, jnp.complex64) and p is None]
    assert not loose, f"f32/c64 dot_general with no stated precision: {loose}"
