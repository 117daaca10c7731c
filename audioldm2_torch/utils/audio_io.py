"""Host-side wav IO and resampling (scipy-based; no torchaudio/librosa/soundfile).

The port's own copy of ``audioldm2_tpu/utils/audio_io.py``: the resampler
runs in the host C++ library (``utils.native``) where it is built, as the
JAX package's does, and in numpy otherwise. Reproduces the reference's wav loading semantics (reference
``utilities/audio/tools.py:9-40``): load, mono, resample to the target rate,
mean-subtract, peak-normalize to 0.5, pad/cut to the segment length.
``sinc_interp_hann_kernel`` also feeds the CLAP rerank's device resample.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
from scipy.io import wavfile


def _to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def sinc_interp_hann_kernel(
    orig_sr: int,
    target_sr: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
):
    """Phase-bank taps of the reference resampler.

    The reference resamples with ``torchaudio.functional.resample`` defaults
    (sinc interpolation under a squared-cosine/Hann window, width 6,
    rolloff 0.99) for both file reading (tools.py:31) and CLAP audio prep
    (modules.py:700-703). torchaudio is absent in this image, so the
    documented kernel is built here from its published formula.

    Returns ``(kernel [n_phase, K] float32, orig, n_phase, width)`` with the
    gcd-reduced rates: ``out[j*n_phase+p] = sum_k x[j*orig+k-width]*kernel[p,k]``
    and output length ``ceil(n_in * n_phase / orig)``.
    """
    import math

    g = math.gcd(int(orig_sr), int(target_sr))
    orig, new = int(orig_sr) // g, int(target_sr) // g
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    tpi = t * np.pi
    kernel = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0, tpi))
    kernel *= window * (base_freq / orig)
    return kernel.astype(np.float32), orig, new, width


def _resample_sinc_np(x: np.ndarray, kernel: np.ndarray, orig: int, new: int,
                      width: int) -> np.ndarray:
    """The phase-bank resampler in numpy: ``out[j*new+p] =
    sum_k x[j*orig+k-width] * kernel[p, k]``."""
    from numpy.lib.stride_tricks import sliding_window_view

    K = kernel.shape[1]
    n_in = x.shape[-1]
    n_out = -(-n_in * new // orig)
    n_frames = -(-n_out // new)
    # pad so every frame window exists: last frame starts at (n_frames-1)*orig
    need = (n_frames - 1) * orig + K
    xpad = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(width, max(0, need - n_in - width))])
    frames = sliding_window_view(xpad, K, axis=-1)[..., ::orig, :][..., :n_frames, :]
    out = np.einsum("...tk,pk->...tp", frames, kernel)
    return out.reshape(x.shape[:-1] + (-1,))[..., :n_out].astype(np.float32)


def resample(waveform: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Reference-matching resample (torchaudio sinc_interp_hann defaults):
    the native phase-bank resampler when the host library is built, the
    numpy phase-bank matmul otherwise."""
    if orig_sr == target_sr:
        return waveform
    from audioldm2_torch.utils import native

    kernel, orig, new, width = sinc_interp_hann_kernel(orig_sr, target_sr)
    if native.available():
        return native.resample_sinc(waveform, kernel, orig, new, width)
    return _resample_sinc_np(np.asarray(waveform, np.float32), kernel, orig, new, width)


def normalize_wav(waveform: np.ndarray) -> np.ndarray:
    """Mean-subtract then scale to 0.5 peak (reference tools.py:22-25), in
    numpy as the JAX package's: ``native.normalize_wav`` (its mean in
    double) differs in the last bit, and the data pipeline's batches are
    held bitwise to JAX's."""
    waveform = waveform - np.mean(waveform)
    waveform = waveform / (np.max(np.abs(waveform)) + 1e-8)
    return (waveform * 0.5).astype(np.float32)


def pad_wav(waveform: np.ndarray, segment_length: Optional[int]) -> np.ndarray:
    """Cut or zero-pad [N] waveform to segment_length (reference tools.py:9-19)."""
    n = waveform.shape[-1]
    if segment_length is None or n == segment_length:
        return waveform
    if n > segment_length:
        return waveform[..., :segment_length]
    out = np.zeros(waveform.shape[:-1] + (segment_length,), dtype=waveform.dtype)
    out[..., :n] = waveform
    return out


def read_wav_file(
    filename: str, segment_length: Optional[int], target_sr: int = 16000
) -> np.ndarray:
    """Load a wav as [1, N] float32, resampled + double-normalized to 0.5 peak
    (the reference normalizes twice, tools.py:28-40)."""
    sr, data = wavfile.read(filename)
    data = _to_float(np.asarray(data))
    if data.ndim > 1:
        data = data.mean(axis=-1)
    data = resample(data, sr, target_sr)
    data = normalize_wav(data)
    data = pad_wav(data[None, :], segment_length)
    peak = np.max(np.abs(data))
    if peak > 0:
        data = data / peak
    return (0.5 * data).astype(np.float32)


def save_wave(
    waveform: np.ndarray,
    savepath: str,
    name: Union[str, Sequence[str]] = "outwav",
    samplerate: int = 16000,
) -> List[str]:
    """Write [B, 1, N] (or [B, N]) float waveforms with the reference's file
    naming rules (reference utils.py:53-75). Returns written paths."""
    waveform = np.asarray(waveform)
    if waveform.ndim == 2:
        waveform = waveform[:, None, :]
    if not isinstance(name, (list, tuple)):
        name = [name] * waveform.shape[0]

    os.makedirs(savepath, exist_ok=True)
    paths = []
    for i in range(waveform.shape[0]):
        base = os.path.basename(name[i])
        stem = base.split(".")[0] if ".wav" in base else base
        if waveform.shape[0] > 1:
            fname = "%s_%s.wav" % (stem, i)
        else:
            fname = "%s.wav" % stem
            if len(fname) > 255:
                fname = f"{hex(hash(fname))}.wav"
        path = os.path.join(savepath, fname)
        data = np.clip(waveform[i, 0], -1.0, 1.0)
        wavfile.write(path, samplerate, (data * 32767.0).astype(np.int16))
        paths.append(path)
    return paths


def text_to_filename(text: str) -> str:
    return text.replace(" ", "_").replace("'", "_").replace('"', "_")



def get_duration(fname: str) -> float:
    """Clip duration in seconds (reference utils.py:21-25)."""
    sr, data = wavfile.read(fname)
    return data.shape[0] / float(sr)


def get_bit_depth(fname: str) -> int:
    """Sample bit depth (reference utils.py:28-31)."""
    _, data = wavfile.read(fname)
    return data.dtype.itemsize * 8
