"""ctypes binding of the host C++ audio library (``csrc/host/audio_kernels.cpp``).

The port's counterpart of ``audioldm2_tpu/utils/native.py``, over the
port's own copy of the source. On first use it is compiled with the JAX
package's flags (``native/Makefile``: ``g++ -O3 -march=native -fPIC -shared
-std=c++17``) into ``audioldm2_torch/_build/libaudio_kernels_<hash>.so``,
keyed by a hash of the source, the flags and the CPU, and loaded with its five
entry points. A build or load failure is not silent: it warns once,
:func:`available` is False and :func:`build_error` says why; the wrappers
then raise, and ``utils.audio_io`` takes its numpy path.

``-march=native`` lets the compiler contract products and sums into FMAs,
so the resamplers (double accumulators) equal the numpy path only to a
tolerance, as the JAX package's tests/test_resample.py states (1e-6).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import warnings
from fractions import Fraction
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "host" / "audio_kernels.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_F32P = ctypes.POINTER(ctypes.c_float)
_I16P = ctypes.POINTER(ctypes.c_int16)
_I64 = ctypes.c_int64
# the five extern "C" entry points and their C signatures
SIGNATURES = {
    "resample_poly_f32": [_F32P, _I64, ctypes.c_int, ctypes.c_int, _F32P, _I64, _F32P, _I64],
    "resample_sinc_f32": [_F32P, _I64, ctypes.c_int, ctypes.c_int, _F32P, _I64, _I64, _F32P,
                          _I64],
    "normalize_wav_f32": [_F32P, _I64],
    "int16_to_f32": [_I16P, _I64, _F32P],
    "f32_to_int16": [_F32P, _I64, _I16P],
}

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None
_TRIED = False


def _cpu_identity() -> bytes:
    """The CPU's model and feature flags: ``-march=native`` code built on one
    CPU may not run on another, so a build directory copied between
    machines must not be reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(sorted(set(keep)))


def library_path() -> Path:
    """Where the build for this source, these flags and this CPU lands."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_identity())
    return BUILD_DIR / f"libaudio_kernels_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".tmp_{os.getpid()}_{path.name}"
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({out.returncode}): {out.stderr.strip()[-2000:]}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _ERROR, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _LIB = lib
    except (OSError, RuntimeError, AttributeError, subprocess.SubprocessError) as e:
        _ERROR = f"{type(e).__name__}: {e}"
        warnings.warn(f"the host audio library did not build or load ({_ERROR}); "
                      "utils.audio_io takes its numpy path", stacklevel=3)
    return _LIB


def available() -> bool:
    """Whether the library is built and loaded (building it on first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None when it is, or before the
    first attempt)."""
    _load()
    return _ERROR


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the host audio library is not available: {_ERROR}")
    return lib


def _ptr(a: np.ndarray, ctype=_F32P):
    return a.ctypes.data_as(ctype)


def _rows(x: np.ndarray):
    """(x's C-contiguous float32 rows [R, N], x as C-contiguous float32)."""
    x = np.ascontiguousarray(x, np.float32)
    return (x[None] if x.ndim == 1 else x.reshape(-1, x.shape[-1])), x


def resample_sinc(x: np.ndarray, kernel: np.ndarray, orig: int, n_phase: int,
                  width: int) -> np.ndarray:
    """The windowed-sinc phase-bank resample along the last axis:
    ``out[j * n_phase + p] = sum_k x[j * orig + k - width] * kernel[p, k]``
    (taps from ``audio_io.sinc_interp_hann_kernel``), ceil(N * n_phase /
    orig) samples, accumulated in double."""
    lib = _lib()
    rows, x = _rows(x)
    kernel = np.ascontiguousarray(kernel, np.float32)
    if kernel.ndim != 2 or kernel.shape[0] != n_phase:
        raise ValueError(f"kernel {kernel.shape} is not [n_phase={n_phase}, K]")
    n_out = -(-x.shape[-1] * n_phase // orig)
    out = np.empty((rows.shape[0], n_out), np.float32)
    for row_in, row_out in zip(rows, out):
        lib.resample_sinc_f32(_ptr(row_in), row_in.shape[0], orig, n_phase, _ptr(kernel),
                              kernel.shape[1], width, _ptr(row_out), n_out)
    return out.reshape(x.shape[:-1] + (n_out,))


def _fir_lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass (scipy resample_poly's default design)."""
    from scipy.signal import firwin

    return firwin(num_taps, cutoff, window=("kaiser", 5.0)).astype(np.float32)


def resample_poly(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Rational polyphase resample along the last axis with scipy
    resample_poly's filter design (the JAX binding's ``resample``)."""
    if orig_sr == target_sr:
        return np.asarray(x, np.float32)
    lib = _lib()
    frac = Fraction(int(target_sr), int(orig_sr))
    up, down = frac.numerator, frac.denominator
    rows, x = _rows(x)
    max_rate = max(up, down)
    filt = _fir_lowpass(2 * 10 * max_rate + 1, 1.0 / max_rate)
    n_out = int(np.ceil(x.shape[-1] * up / down))
    out = np.empty((rows.shape[0], n_out), np.float32)
    for row_in, row_out in zip(rows, out):
        lib.resample_poly_f32(_ptr(row_in), row_in.shape[0], up, down, _ptr(filt),
                              filt.shape[0], _ptr(row_out), n_out)
    return out.reshape(x.shape[:-1] + (n_out,))


def normalize_wav(x: np.ndarray) -> np.ndarray:
    """Mean-subtract, scale to 0.5 peak, over the whole array (a float32
    copy; the mean accumulated in double)."""
    lib = _lib()
    x = np.array(x, np.float32, order="C", copy=True)
    lib.normalize_wav_f32(_ptr(x), x.size)
    return x


def int16_to_f32(x: np.ndarray) -> np.ndarray:
    """int16 PCM -> float32 in [-1, 1) (x / 32768)."""
    lib = _lib()
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.shape, np.float32)
    lib.int16_to_f32(_ptr(x, _I16P), x.size, _ptr(out))
    return out


def f32_to_int16(x: np.ndarray) -> np.ndarray:
    """float32 -> int16 PCM: clipped to [-1, 1], times 32767, rounded to
    the nearest (ties to even)."""
    lib = _lib()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int16)
    lib.f32_to_int16(_ptr(x), x.size, _ptr(out, _I16P))
    return out
