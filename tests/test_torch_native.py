"""The port's host C++ audio library (audioldm2_torch/utils/native.py over
csrc/host/audio_kernels.cpp, built here with g++ into audioldm2_torch/
_build/): its five entry points against the numpy path, scipy and the JAX
package's binding of the same source; the build's place and its failure
path; audio_io's use of it (resample, as JAX's audio_io; normalize_wav
stays numpy, as JAX's does); and get_duration / get_bit_depth against JAX.

Tolerances: the resamplers accumulate in double and -march=native lets
the compiler contract into FMAs, so they equal the numpy phase-bank
matmul (f32) to 1e-6, as the JAX package's tests/test_resample.py states
(measured here at most 4.8e-7), and scipy's resample_poly to 2e-6
(measured 7.2e-7); normalize_wav equals numpy's to 1e-7 (measured 3.0e-8:
the mean in double against numpy's f32 pairwise sum). Against the JAX
package's binding, which builds the same source with the same flags, all
are equal bit for bit."""

import warnings
from fractions import Fraction

import numpy as np
import pytest
from scipy.io import wavfile
from scipy.signal import resample_poly

from audioldm2_tpu.utils import audio_io as jaudio
from audioldm2_tpu.utils import native as jnative
from audioldm2_torch.utils import audio_io, native

RATES = [(16000, 48000), (48000, 16000), (16000, 8000), (44100, 48000)]


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.fail(f"the host library did not build: {native.build_error()}")
    return native


def _x(seed=0, shape=(2, 9601)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_builds_into_the_port_build_dir(lib):
    path = native.library_path()
    assert path.exists() and path.parent == native.PKG_DIR / "_build"
    assert path.name.startswith("libaudio_kernels_") and native.build_error() is None
    assert native.SOURCE.parent == native.PKG_DIR / "csrc" / "host"
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
    assert sorted(native.SIGNATURES) == sorted(
        ["resample_poly_f32", "resample_sinc_f32", "normalize_wav_f32", "int16_to_f32",
         "f32_to_int16"])


@pytest.mark.parametrize("a,b", RATES)
def test_resample_sinc_matches_numpy_and_jax(lib, a, b):
    x = _x()
    kernel, orig, new, width = audio_io.sinc_interp_hann_kernel(a, b)
    got = native.resample_sinc(x, kernel, orig, new, width)
    want = audio_io._resample_sinc_np(x, kernel, orig, new, width)
    assert got.shape == want.shape == (2, -(-9601 * b // a))
    np.testing.assert_allclose(got, want, atol=1e-6)
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.resample_sinc(x, kernel, orig, new, width))
    one = native.resample_sinc(x[0], kernel, orig, new, width)  # 1-D in, 1-D out
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("a,b", RATES)
def test_resample_poly_matches_scipy_and_jax(lib, a, b):
    x = _x(1)
    got = native.resample_poly(x, a, b)
    f = Fraction(b, a)
    np.testing.assert_allclose(got, resample_poly(x, f.numerator, f.denominator, axis=-1),
                               atol=2e-6)
    np.testing.assert_array_equal(got, jnative.resample(x, a, b))
    np.testing.assert_array_equal(native.resample_poly(x, a, a), x)


def test_normalize_and_pcm_conversions(lib):
    x = (0.3 * _x(2, (160000,)) + 0.01).astype(np.float32)
    got = native.normalize_wav(x)
    want = x - np.mean(x)
    want = (0.5 * want / (np.max(np.abs(want)) + 1e-8)).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert got is not x and not np.shares_memory(got, x)
    np.testing.assert_array_equal(got, jnative.normalize_wav(x))
    pcm = np.random.default_rng(3).integers(-32768, 32768, 1000).astype(np.int16)
    np.testing.assert_array_equal(native.int16_to_f32(pcm), pcm.astype(np.float32) / 32768.0)
    f = np.array([-2.0, -1.0, -0.5, 0.0, 1e-5, 0.25, 0.99999, 1.0, 3.0], np.float32)
    np.testing.assert_array_equal(native.f32_to_int16(f),
                                  np.rint(np.clip(f, -1, 1) * 32767).astype(np.int16))


def test_audio_io_resamples_on_the_native_path(lib, monkeypatch):
    """resample goes native, as JAX's does; normalize_wav stays numpy, as
    JAX's does, bitwise equal to it."""
    calls = []
    real_sinc, real_norm = native.resample_sinc, native.normalize_wav
    monkeypatch.setattr(native, "resample_sinc", lambda *a: calls.append("r") or real_sinc(*a))
    monkeypatch.setattr(native, "normalize_wav", lambda x: calls.append("n") or real_norm(x))
    x = _x(4, (4800,))
    y = audio_io.resample(x, 48000, 16000)
    z = audio_io.normalize_wav(y)
    assert calls == ["r"] and y.shape == (1600,)
    np.testing.assert_allclose(y, jaudio.resample(x, 48000, 16000), atol=1e-6)
    np.testing.assert_array_equal(z, jaudio.normalize_wav(y))


def test_read_wav_file_matches_jax(lib, tmp_path):
    path = str(tmp_path / "in.wav")
    t = np.arange(48000) / 48000.0
    wavfile.write(path, 48000, (0.4 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16))
    got = audio_io.read_wav_file(path, 20000, target_sr=16000)
    want = jaudio.read_wav_file(path, 20000, target_sr=16000)
    assert got.shape == want.shape == (1, 20000)
    if jnative.available():  # both resample natively: the same bits
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_a_failed_build_says_why(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.warns(UserWarning, match="did not build"):
        assert native.available() is False
    assert "no-such-compiler" in native.build_error()
    with pytest.raises(RuntimeError, match="not available"):
        native.normalize_wav(np.ones(4, np.float32))
    x = _x(5, (4800,))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = audio_io.resample(x, 48000, 16000)  # the numpy path, no second warning
    kernel, orig, new, width = audio_io.sinc_interp_hann_kernel(48000, 16000)
    np.testing.assert_array_equal(got, audio_io._resample_sinc_np(x, kernel, orig, new, width))


def test_a_failing_compiler_says_why(monkeypatch, tmp_path):
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho 'error: broken toolchain' >&2\nexit 3\n")
    script.chmod(0o755)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(script))
    with pytest.warns(UserWarning):
        assert not native.available()
    assert "broken toolchain" in native.build_error() and "(3)" in native.build_error()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("dtype,bits", [(np.int16, 16), (np.int32, 32), (np.float32, 32)])
def test_duration_and_bit_depth_match_jax(tmp_path, dtype, bits):
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 16000, np.zeros(24000, dtype))
    assert audio_io.get_duration(path) == jaudio.get_duration(path) == 1.5
    assert audio_io.get_bit_depth(path) == jaudio.get_bit_depth(path) == bits
