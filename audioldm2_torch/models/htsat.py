"""HTSAT, the CLAP audio tower (hierarchical token-semantic audio Swin
transformer), in PyTorch.

Port of ``audioldm2_tpu/models/htsat.py`` (HTSAT-base: embed 128, depths
[2, 2, 12, 2], heads [4, 8, 16, 32], window 8, spec_size 256): the mel
frontend (48 kHz, n_fft 1024, hop 480, 64 mels, 50-14000 Hz, power
spectrogram -> dB) as framed matmuls, the align-corners bicubic time
resize as a precomputed matrix, the Swin blocks with the relative-position
bias and the shifted-window mask added to the logits (an additive bias, so
``nn.attention`` takes its plain path), patch merging, and the pooled
embedding ``encode`` feeds to CLAP's audio projection. Same parameter tree
as the JAX ``init_htsat``. The STFT, mel and resize matmuls run in full f32
(no TF32): the log of small powers amplifies any truncation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from audioldm2_torch.ops import nn
from audioldm2_torch.ops import stft as stft_ops
from audioldm2_torch.ops.nn import full_f32
from audioldm2_torch.params import Init


@dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 12, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    num_classes: int = 527
    mel_bins: int = 64
    sample_rate: int = 48000
    n_fft: int = 1024
    hop_size: int = 480
    fmin: float = 50.0
    fmax: float = 14000.0

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @property
    def grid(self) -> int:
        return self.spec_size // self.patch_stride


BASE = HTSATConfig()


# ---------------------------------------------------------------------------
# Host-side constants (copied from the JAX module; numpy)
# ---------------------------------------------------------------------------


def bicubic_matrix(t_in: int, t_out: int) -> np.ndarray:
    """torch F.interpolate(mode="bicubic", align_corners=True) as a matrix
    [t_out, t_in] (cubic convolution kernel, a = -0.75)."""
    a = -0.75

    def kernel(t):
        t = abs(t)
        if t <= 1:
            return (a + 2) * t**3 - (a + 3) * t**2 + 1
        if t < 2:
            return a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a
        return 0.0

    W = np.zeros((t_out, t_in), np.float64)
    scale = (t_in - 1) / (t_out - 1) if t_out > 1 else 0.0
    for i in range(t_out):
        src = i * scale
        j0 = int(np.floor(src))
        for dj in (-1, 0, 1, 2):
            j = j0 + dj
            w = kernel(src - j)
            W[i, np.clip(j, 0, t_in - 1)] += w
    return W.astype(np.float32)


def _swin_attn_mask(res: int, window: int, shift: int) -> np.ndarray:
    """Additive mask [nW, w*w, w*w] for shifted windows."""
    img = np.zeros((res, res), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    nh = res // window
    wins = img.reshape(nh, window, nh, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _rel_pos_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)  # [w*w, w*w]


# ---------------------------------------------------------------------------
# Init (the JAX tree key for key and shape for shape)
# ---------------------------------------------------------------------------


def init_htsat(ini: Init, cfg: HTSATConfig = BASE):
    layers = []
    for i_layer, depth in enumerate(cfg.depths):
        dim = cfg.embed_dim * 2**i_layer
        heads = cfg.num_heads[i_layer]
        hidden = int(dim * cfg.mlp_ratio)
        blocks = [
            {
                "norm1": ini.norm(dim),
                "attn": {
                    "qkv": ini.linear(dim, 3 * dim),
                    "proj": ini.linear(dim, dim),
                    "rel_bias": ini.randn(((2 * cfg.window_size - 1) ** 2, heads), std=0.02),
                },
                "norm2": ini.norm(dim),
                "mlp": {"fc1": ini.linear(dim, hidden), "fc2": ini.linear(hidden, dim)},
            }
            for _ in range(depth)
        ]
        layer = {"blocks": blocks}
        if i_layer < len(cfg.depths) - 1:
            layer["downsample"] = {"norm": ini.norm(4 * dim),
                                   "reduction": ini.linear(4 * dim, 2 * dim, bias=False)}
        layers.append(layer)
    sf = cfg.spec_size // (2 ** (len(cfg.depths) - 1)) // cfg.patch_stride // cfg.freq_ratio
    ones = torch.ones((cfg.mel_bins,), device=ini.device)
    return {
        "bn0": {"scale": ones, "bias": ini.zeros((cfg.mel_bins,)),
                "mean": ini.zeros((cfg.mel_bins,)), "var": ones.clone()},
        "patch_embed": {"proj": ini.conv(cfg.patch_size, cfg.patch_size, 1, cfg.embed_dim),
                        "norm": ini.norm(cfg.embed_dim)},
        "layers": layers,
        "norm": ini.norm(cfg.num_features),
        "tscam_conv": ini.conv(sf, 3, cfg.num_features, cfg.num_classes),
        "head": ini.linear(cfg.num_classes, cfg.num_classes),
    }


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _window_partition(x, w):
    b, h, wid, c = x.shape
    x = x.reshape(b, h // w, w, wid // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(wins, w, h, wid):
    b = wins.shape[0] // ((h // w) * (wid // w))
    x = wins.reshape(b, h // w, wid // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wid, -1)


def _swin_block(p, x, res, heads, window, shift, attn_mask, rel_idx):
    b, length, c = x.shape
    shortcut = x
    x = nn.layer_norm(p["norm1"], x).reshape(b, res, res, c)
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    wins = _window_partition(x, window)  # [B*nW, w*w, C]
    q, k, v = (nn.split_heads(t, heads)
               for t in torch.chunk(nn.linear(p["attn"]["qkv"], wins), 3, dim=-1))
    bias = p["attn"]["rel_bias"][rel_idx].permute(2, 0, 1)[None]  # [1, H, w*w, w*w]
    if attn_mask is not None:  # [nW, w*w, w*w], repeated per batch
        bias = bias + attn_mask[:, None].repeat(b, 1, 1, 1)
    out = nn.attention(q, k, v, bias=bias)
    wins = nn.linear(p["attn"]["proj"], nn.merge_heads(out))
    x = _window_reverse(wins, window, res, res)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x.reshape(b, length, c)
    h = nn.layer_norm(p["norm2"], x)
    return x + nn.linear(p["mlp"]["fc2"], nn.gelu(nn.linear(p["mlp"]["fc1"], h)))


def _patch_merge(p, x, res):
    b, _, c = x.shape
    x = x.reshape(b, res, res, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1).reshape(b, -1, 4 * c)
    return nn.linear(p["reduction"], nn.layer_norm(p["norm"], x))


def forward_features(params, cfg: HTSATConfig, img):
    """img: [B, spec_size, spec_size, 1] (the folded mel "image"). Returns
    'embedding' [B, num_features], 'clipwise_output' and 'latent_logits'
    [B, num_classes]."""
    dev = img.device
    x = nn.conv2d(params["patch_embed"]["proj"], img,
                  stride=(cfg.patch_stride, cfg.patch_stride), padding="VALID")
    b, gh, gw, c = x.shape
    x = nn.layer_norm(params["patch_embed"]["norm"], x.reshape(b, gh * gw, c))

    res = cfg.grid
    for i_layer, layer in enumerate(params["layers"]):
        heads = cfg.num_heads[i_layer]
        window = min(cfg.window_size, res)
        shift_base = window // 2 if res > cfg.window_size else 0
        rel_idx = torch.from_numpy(_rel_pos_index(window)).to(dev)
        mask = (torch.from_numpy(_swin_attn_mask(res, window, shift_base)).to(dev)
                if shift_base > 0 else None)
        for j, blk in enumerate(layer["blocks"]):
            shift = 0 if j % 2 == 0 else shift_base
            x = _swin_block(blk, x, res, heads, window, shift, mask if shift > 0 else None,
                            rel_idx)
        if "downsample" in layer:
            x = _patch_merge(layer["downsample"], x, res)
            res //= 2

    x = nn.layer_norm(params["norm"], x)
    C = cfg.num_features
    x = x.reshape(b, res, res, C)
    # group 2D: fold freq_ratio out of the freq axis into time
    c_freq_bin = res // cfg.freq_ratio
    x = x.reshape(b, cfg.freq_ratio, c_freq_bin, res, C)
    x = x.permute(0, 2, 1, 3, 4).reshape(b, c_freq_bin, cfg.freq_ratio * res, C)
    embedding = x.reshape(b, -1, C).mean(dim=1)
    logits = nn.conv2d(params["tscam_conv"], x, padding=[(0, 0), (1, 1)])
    logits = logits.reshape(b, -1, cfg.num_classes).mean(dim=1)
    return {"embedding": embedding, "clipwise_output": torch.sigmoid(logits),
            "latent_logits": logits}


def mel_image(params, cfg: HTSATConfig, wav, interp_matrix):
    """waveform [B, N] at 48 kHz -> the folded [B, spec_size, spec_size, 1]
    image: power spectrogram -> mel -> dB -> bn0 -> bicubic time resize ->
    fold of freq_ratio time segments onto the frequency axis."""
    dev = wav.device
    basis = torch.from_numpy(stft_ops.stft_basis(cfg.n_fft, cfg.n_fft)).to(dev)
    power = stft_ops.stft_magnitude(wav.float(), basis, cfg.n_fft, cfg.hop_size).square()
    mel_fb = torch.from_numpy(stft_ops.librosa_mel_filters(
        cfg.sample_rate, cfg.n_fft, cfg.mel_bins, cfg.fmin, cfg.fmax)).to(dev)
    interp = torch.as_tensor(interp_matrix, dtype=torch.float32, device=dev)
    bn = params["bn0"]
    with full_f32():
        mel = torch.einsum("mf,bft->btm", mel_fb, power)
        logmel = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))  # power_to_db, no top_db
        logmel = (logmel - bn["mean"]) * torch.rsqrt(bn["var"] + 1e-5) * bn["scale"] + bn["bias"]
        x = torch.einsum("ot,btm->bom", interp, logmel)
    b, t, f = x.shape
    xt = x.transpose(1, 2).reshape(b, f, cfg.freq_ratio, t // cfg.freq_ratio)
    xt = xt.permute(0, 2, 1, 3).reshape(b, cfg.freq_ratio * f, t // cfg.freq_ratio)
    return xt[..., None]


def encode(params, wav, cfg: HTSATConfig = BASE):
    """waveform [B, N] at 48 kHz -> latent embedding [B, num_features]."""
    t_frames = wav.shape[-1] // cfg.hop_size + 1
    interp = bicubic_matrix(t_frames, cfg.spec_size * cfg.freq_ratio)
    return forward_features(params, cfg, mel_image(params, cfg, wav, interp))["embedding"]
