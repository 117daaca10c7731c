"""Audio frontend of the sr/inpainting path: STFT magnitude, the Slaney mel
filterbank and the log-mel fbank, in PyTorch.

Port of ``audioldm2_tpu/ops/stft.py:30-199`` (which imports jax, so the
port has its own copy of the numpy bases; a test holds them equal). The
bases are built once on the host in float64 and stored as float32. The
STFT reflect-pads by filter_length // 2 on each side, frames the signal at
stride ``hop`` and multiplies the frames by the windowed real-DFT basis;
the mel projection is a second matmul and the log clamps at 1e-5. Both
matmuls run in full f32 (no TF32): the log of small magnitudes amplifies
any truncation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audioldm2_torch.ops.nn import full_f32


def hann_window_periodic(win_length: int) -> np.ndarray:
    """scipy.signal.get_window("hann", n, fftbins=True), float64."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def stft_basis(filter_length: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT analysis basis [filter_length, 2 * nfreq]: the real
    parts (cos) then the imaginary parts (sin) of exp(-2i pi k n / N), each
    windowed by the periodic hann window centre-padded to filter_length."""
    cutoff = filter_length // 2 + 1
    n = np.arange(filter_length, dtype=np.float64)
    k = np.arange(cutoff, dtype=np.float64)[:, None]
    angle = -2.0 * np.pi * k * n / filter_length
    basis = np.concatenate([np.cos(angle), np.sin(angle)], axis=0)  # [2c, N]
    pad = (filter_length - win_length) // 2
    window = np.zeros(filter_length, dtype=np.float64)
    window[pad:pad + win_length] = hann_window_periodic(win_length)
    return (basis * window[None, :]).T.astype(np.float32)


_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_branch = _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log_branch, f / _F_SP)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


def librosa_mel_filters(sr: int, n_fft: int, n_mels: int, fmin: float,
                        fmax: float) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) with htk=False and
    norm="slaney": [n_mels, 1 + n_fft // 2] float32."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                                          n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def stft_magnitude(wav: torch.Tensor, basis: torch.Tensor, filter_length: int,
                   hop: int) -> torch.Tensor:
    """wav: [B, N] f32; basis: [filter_length, 2 * nfreq] from stft_basis.
    Returns the magnitude [B, nfreq, T] (reflect padding of filter_length //
    2 on each side, magnitude floored at sqrt(1e-12))."""
    pad = filter_length // 2
    wav = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = wav.unfold(-1, filter_length, hop)  # [B, T, N]
    with full_f32():
        spec = torch.matmul(frames, basis)  # [B, T, 2 * nfreq]
    nfreq = basis.shape[1] // 2
    real, imag = spec[..., :nfreq], spec[..., nfreq:]
    mag = torch.sqrt(torch.clamp(real * real + imag * imag, min=1e-12))
    return mag.transpose(1, 2)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, min=clip_val))."""
    return torch.log(torch.clamp(x, min=clip_val))


class MelSpectrogram:
    """The TacotronSTFT-equivalent log-mel of the JAX package, with its bases
    on ``device``: :meth:`mel` gives [B, n_mels, T], :meth:`fbank` the
    model-facing [B, T, n_mels] padded or cut to a target length."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 160, win_length: int = 1024,
                 n_mel_channels: int = 64, sampling_rate: int = 16000, mel_fmin: float = 0.0,
                 mel_fmax: float = 8000.0, device="cpu"):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.device = torch.device(device)
        self.basis = torch.from_numpy(stft_basis(filter_length, win_length)).to(self.device)
        self.mel_basis = torch.from_numpy(librosa_mel_filters(
            sampling_rate, filter_length, n_mel_channels, mel_fmin, mel_fmax)).to(self.device)

    def mel(self, wav) -> torch.Tensor:
        """[B, N] waveform in [-1, 1] (numpy or tensor) -> [B, n_mels, T] log-mel."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        mag = stft_magnitude(wav, self.basis, self.filter_length, self.hop_length)
        with full_f32():
            melspec = torch.matmul(self.mel_basis, mag)
        return dynamic_range_compression(melspec)

    def fbank(self, wav, target_length: int = 1024) -> torch.Tensor:
        """[B, N] -> [B, target_length, n_mels] (zero-padded or cut in time)."""
        m = self.mel(wav).transpose(1, 2)
        t = m.shape[1]
        if t < target_length:
            return F.pad(m, (0, 0, 0, target_length - t))
        return m[:, :target_length].contiguous()


# ---------------------------------------------------------------------------
# Kaldi-compatible fbank (the AudioMAE frontend; the training data's
# ``ta_kaldi_fbank``)
# ---------------------------------------------------------------------------


def _kaldi_mel_banks(num_bins: int, window_length_padded: int, sample_freq: float,
                     low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi-style mel filterbank [num_bins, window_length_padded // 2]
    (HTK mel scale 1127 ln(1 + f / 700), no nyquist bin), as
    torchaudio.compliance.kaldi.get_mel_banks builds it; float64 maths,
    float32 out (JAX ``stft.py:207-236``)."""
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq

    fft_bin_width = sample_freq / window_length_padded

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    mel_low = mel(low_freq)
    mel_delta = (mel(high_freq) - mel_low) / (num_bins + 1)
    bins = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bins * mel_delta
    center_mel = mel_low + (bins + 1.0) * mel_delta
    right_mel = mel_low + (bins + 2.0) * mel_delta
    mels = mel(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)[None, :])
    up_slope = (mels - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mels) / (right_mel - center_mel)
    return np.maximum(0.0, np.minimum(up_slope, down_slope)).astype(np.float32)


def stft_basis_nowin(filter_length: int) -> np.ndarray:
    """Unwindowed real-DFT basis [filter_length, 2 * (filter_length // 2 + 1)]."""
    cutoff = filter_length // 2 + 1
    n = np.arange(filter_length, dtype=np.float64)
    k = np.arange(cutoff, dtype=np.float64)[:, None]
    angle = -2.0 * np.pi * k * n / filter_length
    return np.concatenate([np.cos(angle), np.sin(angle)], axis=0).T.astype(np.float32)


class KaldiFbank:
    """torchaudio.compliance.kaldi.fbank-compatible log-mel fbank, fixed to
    the AudioMAE frontend's settings (JAX ``stft.py:239-310``, reference
    pipeline.py:44-80): 16 kHz, 25 ms frames every 10 ms with snip_edges,
    per-frame DC removal, preemphasis 0.97, the symmetric hann window,
    zero-padding to 512, 128 mel bins, no dither, no energy. The matmuls
    run in full f32."""

    NORM_MEAN = -4.2677393  # reference pipeline.py:45
    NORM_STD = 4.5689974

    def __init__(self, sample_rate: int = 16000, num_mel_bins: int = 128, device="cpu"):
        self.sample_rate = sample_rate
        self.frame_length = int(sample_rate * 0.025)
        self.frame_shift = int(sample_rate * 0.010)
        self.padded_length = 1 << (self.frame_length - 1).bit_length()
        self.device = torch.device(device)
        n = np.arange(self.frame_length, dtype=np.float64)
        window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (self.frame_length - 1))
        self.window = torch.from_numpy(window.astype(np.float32)).to(self.device)
        self.mel_banks = torch.from_numpy(_kaldi_mel_banks(
            num_mel_bins, self.padded_length, float(sample_rate))).to(self.device)
        self.basis = torch.from_numpy(stft_basis_nowin(self.padded_length)).to(self.device)

    def __call__(self, wav) -> torch.Tensor:
        """[B, N] waveform (numpy or tensor) -> [B, T, num_mel_bins] kaldi
        log-fbank, T = 1 + (N - 400) // 160 at 16 kHz."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        frames = wav.unfold(-1, self.frame_length, self.frame_shift)
        frames = frames - frames.mean(dim=-1, keepdim=True)
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = (frames - 0.97 * prev) * self.window
        frames = F.pad(frames, (0, self.padded_length - self.frame_length))
        nfreq = self.basis.shape[1] // 2
        with full_f32():
            spec = torch.matmul(frames, self.basis)
            real, imag = spec[..., :nfreq], spec[..., nfreq:]
            power = real * real + imag * imag
            mel = torch.matmul(power[..., :self.padded_length // 2], self.mel_banks.t())
        return torch.log(torch.clamp(mel, min=torch.finfo(torch.float32).eps))

    def normalized(self, wav, target_length: int = 1024) -> torch.Tensor:
        """The AudioMAE-normalized fbank [B, target_length, num_mel_bins],
        zero-padded or cut in time (reference pipeline.py:44-80)."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        fb = self(wav - wav.mean(dim=-1, keepdim=True))
        t = fb.shape[1]
        if t < target_length:
            fb = F.pad(fb, (0, 0, 0, target_length - t))
        else:
            fb = fb[:, :target_length]
        return (fb - self.NORM_MEAN) / (self.NORM_STD * 2.0)
