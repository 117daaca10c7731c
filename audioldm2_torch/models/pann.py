"""PANN CNN14 and CNN10, CLAP's alternative audio towers, in PyTorch.

Port of ``audioldm2_tpu/models/pann.py``: the log-mel front end (48 kHz,
n_fft 1024, hop 480, 64 mels, 50-14000 Hz, power -> dB) through the port's
``ops/stft.py``, a per-mel-bin BatchNorm, VGG-style stages of two bias-free
3x3 convs, each followed by BatchNorm and ReLU, with a 2x2 average pool
after each stage (CNN14 leaves its last stage unpooled), then the mean over
mel bins, max + mean over time, ``fc1`` and ReLU. Every BatchNorm runs on
its stored statistics. The convs run channels-first on the HWIO weights
of the JAX tree; the front end's matmuls in full f32 (no TF32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from audioldm2_torch.ops import nn
from audioldm2_torch.ops import stft as stft_ops
from audioldm2_torch.ops.nn import full_f32
from audioldm2_torch.params import Init

CHANNELS = (64, 128, 256, 512, 1024, 2048)


@dataclass(frozen=True)
class PANNConfig:
    """The JAX package's ``PANNConfig`` (CNN14 defaults)."""

    sample_rate: int = 48000
    window_size: int = 1024
    hop_size: int = 480
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    embed_dim: int = 2048
    num_classes: int = 527
    variant: str = "cnn14"  # "cnn14" | "cnn10"
    channels_override: Optional[Tuple[int, ...]] = None  # stage widths; None: the variant's

    @property
    def channels(self) -> Tuple[int, ...]:
        if self.channels_override is not None:
            return tuple(self.channels_override)
        return (64, 128, 256, 512, 1024) if self.variant == "cnn10" else CHANNELS

    @property
    def pools(self) -> Tuple[int, ...]:
        n = len(self.channels)
        return tuple(2 if (self.variant == "cnn10" or i < n - 1) else 1 for i in range(n))


def _bn_init(ini: Init, c: int):
    return {"scale": torch.ones((c,), device=ini.device), "bias": ini.zeros((c,)),
            "mean": ini.zeros((c,)), "var": torch.ones((c,), device=ini.device)}


def _bn(p, x: torch.Tensor, shape=(-1,), eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm on stored statistics over the axis ``shape`` puts -1 on."""
    def v(k):
        return p[k].reshape(shape)
    return (x - v("mean")) * torch.rsqrt(v("var") + eps) * v("scale") + v("bias")


def init_pann(ini: Init, cfg: PANNConfig = PANNConfig()):
    blocks, cin = [], 1
    for cout in cfg.channels:
        blocks.append({"conv1": ini.conv(3, 3, cin, cout, bias=False), "bn1": _bn_init(ini, cout),
                       "conv2": ini.conv(3, 3, cout, cout, bias=False),
                       "bn2": _bn_init(ini, cout)})
        cin = cout
    return {
        "bn0": _bn_init(ini, cfg.mel_bins),
        "blocks": blocks,
        "fc1": ini.linear(cfg.channels[-1], cfg.embed_dim),
        "fc_audioset": ini.linear(cfg.embed_dim, cfg.num_classes),
    }


def _conv_block(p, x: torch.Tensor, pool: int) -> torch.Tensor:
    """x: [B, C, T, M] -> [B, C', T / pool, M / pool]."""
    for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
        x = F.conv2d(x, p[conv]["w"].permute(3, 2, 0, 1), padding=1)
        x = torch.relu(_bn(p[bn], x, (-1, 1, 1)))
    return F.avg_pool2d(x, pool) if pool > 1 else x


def log_mel(params, wav: torch.Tensor, cfg: PANNConfig = PANNConfig()) -> torch.Tensor:
    """waveform [B, N] -> the bn0-normalized log-mel [B, T, mel_bins]."""
    dev = wav.device
    basis = torch.from_numpy(stft_ops.stft_basis(cfg.window_size, cfg.window_size)).to(dev)
    power = stft_ops.stft_magnitude(wav.float(), basis, cfg.window_size, cfg.hop_size).square()
    mel_fb = torch.from_numpy(stft_ops.librosa_mel_filters(
        cfg.sample_rate, cfg.window_size, cfg.mel_bins, cfg.fmin, cfg.fmax)).to(dev)
    with full_f32():
        mel = torch.einsum("mf,bft->btm", mel_fb, power)
    return _bn(params["bn0"], 10.0 * torch.log10(torch.clamp(mel, min=1e-10)))


def encode(params, wav: torch.Tensor, cfg: PANNConfig = PANNConfig()):
    """waveform [B, N] -> {"embedding": [B, embed_dim], "clipwise_output":
    [B, num_classes]}."""
    x = log_mel(params, wav, cfg)[:, None]  # [B, 1, T, M]
    for blk, pool in zip(params["blocks"], cfg.pools):
        x = _conv_block(blk, x, pool)
    x = x.mean(dim=3)  # over mel bins: [B, C, T']
    emb = torch.relu(nn.linear(params["fc1"], x.amax(dim=2) + x.mean(dim=2)))
    return {"embedding": emb,
            "clipwise_output": torch.sigmoid(nn.linear(params["fc_audioset"], emb))}
