"""The CLAP rerank of the reference: HTSAT's audio embedding, the text
embedding and their cosine similarity.

A frozen copy of ``audioldm2_torch/models/htsat.py``, the STFT and mel
bases of ``ops/stft.py``, the sinc resampler of ``utils/audio_io.py`` and
the audio half of ``models/clap.py``, in float32: the mel frontend
(power spectrogram, Slaney mel, dB, bn0, the align-corners bicubic time
resize, the fold onto the frequency axis), the Swin blocks with the
relative-position bias and the shifted-window mask, patch merging, the
pooled embedding and CLAP's projection.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from a2bench.reference import nn
from a2bench.reference.conditioning import clap_text, normalize, project
from a2bench.reference.config import CLAPConfig, HTSATConfig, audio_tower


def stft_basis(n_fft: int) -> np.ndarray:
    """Hann-windowed real-DFT basis [n_fft, 2 * (n_fft // 2 + 1)]: cos then sin."""
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[:, None]
    angle = -2.0 * np.pi * k * n / n_fft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)
    basis = np.concatenate([np.cos(angle), np.sin(angle)], axis=0) * window[None, :]
    return basis.T.astype(np.float32)


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_branch = 15.0 + np.log(f / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log_branch, f * 3.0 / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    200.0 / 3.0 * m)


def mel_filters(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa's Slaney-normalized mel filterbank [n_mels, n_fft // 2 + 1]."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    return (weights * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]).astype(np.float32)


def bicubic_matrix(t_in: int, t_out: int) -> np.ndarray:
    """F.interpolate(mode="bicubic", align_corners=True) along one axis, as a
    [t_out, t_in] matrix (a = -0.75)."""
    a = -0.75

    def kernel(t):
        t = abs(t)
        if t <= 1:
            return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        if t < 2:
            return a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
        return 0.0

    w = np.zeros((t_out, t_in), np.float64)
    scale = (t_in - 1) / (t_out - 1) if t_out > 1 else 0.0
    for i in range(t_out):
        src = i * scale
        j0 = int(np.floor(src))
        for dj in (-1, 0, 1, 2):
            j = j0 + dj
            w[i, np.clip(j, 0, t_in - 1)] += kernel(src - j)
    return w.astype(np.float32)


def _swin_mask(res: int, window: int, shift: int) -> np.ndarray:
    img = np.zeros((res, res), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    nh = res // window
    wins = img.reshape(nh, window, nh, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    return np.where(wins[:, None, :] - wins[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


def _rel_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _windows(x, w):
    b, h, wid, c = x.shape
    x = x.reshape(b, h // w, w, wid // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _unwindow(wins, w, h, wid):
    b = wins.shape[0] // ((h // w) * (wid // w))
    x = wins.reshape(b, h // w, wid // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wid, -1)


def _swin_block(p, x, res, heads, window, shift, mask, rel_idx):
    b, length, c = x.shape
    h = nn.layer_norm(p["norm1"], x).reshape(b, res, res, c)
    if shift > 0:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    wins = _windows(h, window)
    q, k, v = (nn.split_heads(t, heads)
               for t in torch.chunk(nn.linear(p["attn"]["qkv"], wins), 3, dim=-1))
    bias = p["attn"]["rel_bias"].float()[rel_idx].permute(2, 0, 1)[None]
    if mask is not None:
        bias = bias + mask[:, None].repeat(b, 1, 1, 1)
    wins = nn.linear(p["attn"]["proj"], nn.merge_heads(nn.attention(q, k, v, bias=bias)))
    h = _unwindow(wins, window, res, res)
    if shift > 0:
        h = torch.roll(h, (shift, shift), dims=(1, 2))
    x = x + h.reshape(b, length, c)
    h = nn.layer_norm(p["norm2"], x)
    return x + nn.linear(p["mlp"]["fc2"], nn.gelu(nn.linear(p["mlp"]["fc1"], h)))


def htsat_embedding(params, cfg: HTSATConfig, wav: torch.Tensor) -> torch.Tensor:
    """waveform [B, N] at 48 kHz -> HTSAT's pooled embedding [B, num_features]."""
    dev = wav.device
    pad = cfg.n_fft // 2
    frames = F.pad(wav.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = frames.unfold(-1, cfg.n_fft, cfg.hop_size)
    spec = frames @ torch.from_numpy(stft_basis(cfg.n_fft)).to(dev)
    nf = cfg.n_fft // 2 + 1
    power = torch.clamp(spec[..., :nf].square() + spec[..., nf:].square(), min=1e-12)
    fb = torch.from_numpy(mel_filters(cfg.sample_rate, cfg.n_fft, cfg.mel_bins, cfg.fmin,
                                      cfg.fmax)).to(dev)
    mel = torch.einsum("mf,btf->btm", fb, power)
    bn = params["bn0"]
    logmel = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    logmel = ((logmel - bn["mean"].float()) * torch.rsqrt(bn["var"].float() + 1e-5)
              * bn["scale"].float() + bn["bias"].float())
    interp = torch.from_numpy(bicubic_matrix(logmel.shape[1],
                                             cfg.spec_size * cfg.freq_ratio)).to(dev)
    x = torch.einsum("ot,btm->bom", interp, logmel)
    b, t, f = x.shape
    x = x.transpose(1, 2).reshape(b, f, cfg.freq_ratio, t // cfg.freq_ratio)
    img = x.permute(0, 2, 1, 3).reshape(b, cfg.freq_ratio * f, t // cfg.freq_ratio)[..., None]

    x = nn.conv2d(params["patch_embed"]["proj"], img,
                  stride=(cfg.patch_stride, cfg.patch_stride), padding="VALID")
    b, gh, gw, c = x.shape
    x = nn.layer_norm(params["patch_embed"]["norm"], x.reshape(b, gh * gw, c))
    res = cfg.grid
    for i_layer, layer in enumerate(params["layers"]):
        heads = cfg.num_heads[i_layer]
        window = min(cfg.window_size, res)
        shift_base = window // 2 if res > cfg.window_size else 0
        rel_idx = torch.from_numpy(_rel_index(window)).to(dev)
        mask = (torch.from_numpy(_swin_mask(res, window, shift_base)).to(dev)
                if shift_base > 0 else None)
        for j, blk in enumerate(layer["blocks"]):
            shift = 0 if j % 2 == 0 else shift_base
            x = _swin_block(blk, x, res, heads, window, shift, mask if shift > 0 else None,
                            rel_idx)
        if "downsample" in layer:
            d = layer["downsample"]
            bb, _, cc = x.shape
            x = x.reshape(bb, res, res, cc)
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                           x[:, 1::2, 1::2]], dim=-1).reshape(bb, -1, 4 * cc)
            x = nn.linear(d["reduction"], nn.layer_norm(d["norm"], x))
            res //= 2
    x = nn.layer_norm(params["norm"], x)
    return x.reshape(b, -1, cfg.num_features).mean(dim=1)


def resample(wav: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """torchaudio's default sinc resample (Hann window, width 6, rolloff
    0.99) as one strided conv over the phase bank; [B, N] -> [B, ceil(N * new
    / orig)]."""
    if orig_sr == target_sr:
        return wav
    g = math.gcd(int(orig_sr), int(target_sr))
    orig, new = int(orig_sr) // g, int(target_sr) // g
    base_freq = min(orig, new) * 0.99
    width = int(math.ceil(6 * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx) * base_freq
    t = np.clip(t, -6, 6)
    window = np.cos(t * np.pi / 12) ** 2
    tpi = t * np.pi
    kernel = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0, tpi))
    kernel = (kernel * window * (base_freq / orig)).astype(np.float32)
    n_in = wav.shape[-1]
    n_out = -(-n_in * new // orig)
    n_frames = -(-n_out // new)
    pad_r = (n_frames - 1) * orig + kernel.shape[1] - width - n_in
    x = F.pad(wav.float()[:, None, :], (width, max(0, pad_r)))
    out = F.conv1d(x, torch.from_numpy(kernel).to(wav.device)[:, None, :], stride=orig)
    return out.transpose(1, 2).reshape(wav.shape[0], -1)[:, :n_out]


def fit_clip(wav: torch.Tensor, clip: int) -> torch.Tensor:
    """Repeat a short clip as many whole times as fit and zero-pad; cut a long one."""
    n = wav.shape[-1]
    if n < clip:
        wav = wav.repeat(1, max(1, clip // n))
        return F.pad(wav, (0, clip - wav.shape[-1]))
    return wav[:, :clip]


def similarities(params, cfg: CLAPConfig, orig_sr: int, wav: torch.Tensor,
                 ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Cosine similarity [B] of each waveform [B, N] at ``orig_sr`` with the
    CLAP text embedding of its tokens."""
    acfg, _ = audio_tower(cfg)
    clip = fit_clip(resample(wav.float(), orig_sr, cfg.sampling_rate), cfg.clip_samples)
    a = normalize(project(params["audio_projection"],
                          htsat_embedding(params["audio_branch"], acfg, clip)))
    t = clap_text(params, cfg, ids, mask)
    return (normalize(a) * normalize(t)).sum(dim=-1)
