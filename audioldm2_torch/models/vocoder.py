"""HiFi-GAN vocoder generator, in PyTorch.

Port of the unfolded path of ``audioldm2_tpu/models/vocoder.py``
(``apply_vocoder`` with ``folded=None``): conv_pre -> [leaky_relu ->
ConvTranspose1d upsample -> multi-receptive-field ResBlock fusion] per
stage -> leaky_relu -> conv_post -> tanh, with resblock "1" (dual conv)
and "2" (single conv). The time-folded MRF is a TPU lane-occupancy trick
that is off by default in the JAX package and is not ported.
Activations are [B, T, C]; the mel input is [B, T_mel, num_mels].
"""

from __future__ import annotations

import torch

from audioldm2_torch.config import VocoderConfig
from audioldm2_torch.ops import nn
from audioldm2_torch.params import Init

LRELU_SLOPE = 0.1


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def init_vocoder(ini: Init, cfg: VocoderConfig):
    ch0 = cfg.upsample_initial_channel
    p = {"conv_pre": ini.conv1d(7, cfg.num_mels, ch0)}
    ups, resblocks = [], []
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cin = ch0 // (2 ** i)
        cout = ch0 // (2 ** (i + 1))
        ups.append({"w": ini.randn((k, cout, cin), std=0.01), "b": ini.zeros((cout,))})
        for ks, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            if cfg.resblock == "1":
                resblocks.append({"convs1": [ini.conv1d(ks, cout, cout) for _ in dils],
                                  "convs2": [ini.conv1d(ks, cout, cout) for _ in dils]})
            else:
                resblocks.append({"convs": [ini.conv1d(ks, cout, cout) for _ in dils]})
    p["ups"] = ups
    p["resblocks"] = resblocks
    p["conv_post"] = ini.conv1d(7, ch0 // (2 ** len(ups)), 1)
    return p


def _resblock(p, x, kernel_size: int, dilations):
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        xt = nn.leaky_relu(x, LRELU_SLOPE)
        xt = nn.conv1d(c1, xt, padding=_get_padding(kernel_size, d), dilation=d)
        xt = nn.leaky_relu(xt, LRELU_SLOPE)
        xt = nn.conv1d(c2, xt, padding=_get_padding(kernel_size, 1))
        x = xt + x
    return x


def _resblock2(p, x, kernel_size: int, dilations):
    for c, d in zip(p["convs"], dilations):
        xt = nn.leaky_relu(x, LRELU_SLOPE)
        xt = nn.conv1d(c, xt, padding=_get_padding(kernel_size, d), dilation=d)
        x = xt + x
    return x


def apply_vocoder(p, cfg: VocoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, T_mel, num_mels] -> waveform [B, T_mel * prod(rates)]."""
    x = nn.conv1d(p["conv_pre"], mel, padding=3)
    nk = len(cfg.resblock_kernel_sizes)
    rb_fn = _resblock if cfg.resblock == "1" else _resblock2
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = nn.leaky_relu(x, LRELU_SLOPE)
        x = nn.conv_transpose1d(p["ups"][i], x, stride=u, padding=(k - u) // 2)
        acc = None
        for j, (ks, dils) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
            y = rb_fn(p["resblocks"][i * nk + j], x, ks, dils)
            acc = y if acc is None else acc + y
        x = acc / nk
    x = nn.leaky_relu(x, 0.01)
    x = nn.conv1d(p["conv_post"], x, padding=3)
    return torch.tanh(x)[..., 0]
