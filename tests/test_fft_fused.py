"""Four-step matmul FFT and the fused (grid-free) CSA path."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import nis_sar_amtigmti_video_tpu as nst
from nis_sar_amtigmti_video_tpu import config as cfg
from nis_sar_amtigmti_video_tpu.ops import csa as csa_ops
from nis_sar_amtigmti_video_tpu.ops import fft as mfft
from nis_sar_amtigmti_video_tpu.utils import cplx


def _rand_c64(key, shape):
    return jax.lax.complex(
        jax.random.normal(key, shape, jnp.float32),
        jax.random.normal(jax.random.fold_in(key, 1), shape, jnp.float32))


class TestMxuFft:
    @pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
    def test_forward_matches_numpy(self, n):
        x = _rand_c64(jax.random.PRNGKey(n), (3, n))
        got = cplx.to_host(mfft.fft(x))
        want = np.fft.fft(cplx.to_host(x), axis=-1)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    @pytest.mark.parametrize("n", [256, 1024])
    def test_inverse_roundtrip(self, n):
        x = _rand_c64(jax.random.PRNGKey(n + 7), (2, n))
        back = cplx.to_host(mfft.ifft(mfft.fft(x)))
        np.testing.assert_allclose(back, cplx.to_host(x), atol=2e-5)

    def test_axis_minus_two(self):
        x = _rand_c64(jax.random.PRNGKey(2), (256, 5))
        got = cplx.to_host(mfft.fft(x, axis=-2))
        want = np.fft.fft(cplx.to_host(x), axis=-2)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    def test_unsupported_size_falls_back(self):
        x = _rand_c64(jax.random.PRNGKey(3), (4, 100))
        got = cplx.to_host(mfft.fft(x))
        want = np.fft.fft(cplx.to_host(x), axis=-1)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    # the four-step factorization is exact for ANY composite n = n1*n2 —
    # including the reference full-scale lengths (7,199 = 23*313 azimuth
    # after the DPCA shift, 13,200 = 120*110 range)
    @pytest.mark.parametrize("n", [360, 437, 1320, 7199, 13200])
    def test_composite_forward_matches_numpy(self, n):
        assert mfft.supported(n)
        x = _rand_c64(jax.random.PRNGKey(n), (3, n))
        got = cplx.to_host(mfft.fft(x))
        want = np.fft.fft(cplx.to_host(x), axis=-1)
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-5

    @pytest.mark.parametrize("n", [360, 437])
    def test_composite_middle_axis(self, n):
        x = _rand_c64(jax.random.PRNGKey(n + 1), (n, 5))
        got = cplx.to_host(mfft.ifft(x, axis=-2))
        want = np.fft.ifft(cplx.to_host(x), axis=-2)
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-5

    def test_prime_sizes_unsupported(self):
        # primes (and sizes whose every split has a >_MAX_FACTOR side)
        # must keep the jnp.fft fallback
        assert not mfft.supported(7207)          # prime
        assert not mfft.supported(2 * 7207)      # 2 x prime > _MAX_FACTOR
        x = _rand_c64(jax.random.PRNGKey(5), (2, 127))
        got = cplx.to_host(mfft.fft(x))
        want = np.fft.fft(cplx.to_host(x), axis=-1)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


class TestFusedCsa:
    def _params(self, n_az=128, n_rg=256):
        g = cfg.ati_dpca().geometry
        return csa_ops.CsaParams(
            wavelength_m=cfg.ati_dpca().radar.wavelength_m,
            chirp_rate=150e6 / 2e-6, fs_hz=150e6, prf_hz=6000.0,
            velocity_mps=g.effective_velocity_mps,
            range_ref_m=g.slant_range_m,
            t_start_fast=2 * g.slant_range_m / 299792458.0 - 2e-6,
            num_pulses=n_az, num_samples=n_rg)

    @pytest.mark.parametrize("fft_impl", ["xla", "mxu"])
    def test_fused_matches_grid(self, fft_impl):
        p = self._params(256, 256)
        raw = _rand_c64(jax.random.PRNGKey(0), (256, 256))
        a = cplx.to_host(csa_ops.apply_csa(raw, csa_ops.csa_phases(p)))
        b = cplx.to_host(csa_ops.apply_csa_fused(raw, csa_ops.csa_factors(p),
                                                 fft_impl))
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-4
        strong = np.abs(a) > 0.2 * np.abs(a).max()
        assert np.abs(np.angle(a[strong] * np.conj(b[strong]))).max() < 5e-4

    def test_fused_batched(self):
        p = self._params(128, 256)
        raw = _rand_c64(jax.random.PRNGKey(1), (3, 128, 256))
        a = cplx.to_host(csa_ops.apply_csa(raw, csa_ops.csa_phases(p)))
        b = cplx.to_host(csa_ops.apply_csa_fused(raw, csa_ops.csa_factors(p)))
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-4


class TestFftImplRegressions:
    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match="unknown fft impl"):
            mfft.get_impl("hybird")

    def test_known_impls(self):
        for name in ("xla", "mxu", "hybrid"):
            f, fi = mfft.get_impl(name)
            assert callable(f) and callable(fi)

    def test_auto_impl_resolves_by_backend(self):
        # 'auto' is the stock jnp.fft (cuFFT on the GPU) on every backend
        f, fi = mfft.get_impl("auto")
        assert (f, fi) == (jnp.fft.fft, jnp.fft.ifft)

    def test_removed_pallas_impl_rejected(self):
        """fft_impl='pallas' (the removed CSA megakernel) raises, naming
        the valid choices, from both get_impl and the fused CSA."""
        with pytest.raises(ValueError, match="auto, xla, mxu, hybrid"):
            mfft.get_impl("pallas")
        p = csa_ops.CsaParams(wavelength_m=0.031, chirp_rate=1e13,
                              fs_hz=60e6, prf_hz=1000.0, velocity_mps=7000.0,
                              range_ref_m=5e5, t_start_fast=3.3e-3,
                              num_pulses=16, num_samples=32)
        with pytest.raises(ValueError, match="auto, xla, mxu, hybrid"):
            csa_ops.apply_csa_fused(jnp.zeros((16, 32), jnp.complex64),
                                    csa_ops.csa_factors(p), "pallas")
