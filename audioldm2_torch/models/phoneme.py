"""VITS-style phoneme TextEncoder, in PyTorch.

Port of ``audioldm2_tpu/models/phoneme.py``: the embedding scaled by
sqrt(h), post-LN blocks of windowed relative-position attention (window
``window_size``, one key and one value table shared by the heads) and conv
FFNs (kernel ``kernel_size``, padding ((k - 1) // 2, k // 2)), the prefix
mask from the lengths, then the learnable positional embedding added to the
output. The relative terms are the JAX package's direct gather: logits[i, j]
+= q_i . E_k[j - i + w] for |j - i| <= w, zero outside the window. Masked
logits are filled with -1e4, as the reference's attentions.py does (not
with the -finfo.max of ``nn.attention_plain``). The encoder runs in f32 with
TF32 off and launches no hand-written kernel: the JAX package computes it
outside Pallas.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from audioldm2_torch.config import PhonemeEncoderConfig
from audioldm2_torch.ops import nn
from audioldm2_torch.ops.nn import full_f32
from audioldm2_torch.params import Init

MASK_FILL = -1e4


def init_phoneme_encoder(ini: Init, cfg: PhonemeEncoderConfig):
    """The JAX ``init_phoneme_encoder`` tree: per layer the q/k/v/o 1x1
    convs and the two relative tables [1, 2w + 1, h / heads], two
    LayerNorms and the FFN convs; the embedding, the unused m/logs head
    ``proj`` and the positional embedding (zeros, as in the reference)."""
    h = cfg.hidden_channels
    d = h // cfg.n_heads
    rel = (1, 2 * cfg.window_size + 1, d)
    layers = [
        {
            "attn": {
                "q": ini.conv1d(1, h, h), "k": ini.conv1d(1, h, h),
                "v": ini.conv1d(1, h, h), "o": ini.conv1d(1, h, h),
                "emb_rel_k": ini.randn(rel, std=d ** -0.5),
                "emb_rel_v": ini.randn(rel, std=d ** -0.5),
            },
            "ln1": ini.norm(h),
            "ffn": {"conv1": ini.conv1d(cfg.kernel_size, h, cfg.filter_channels),
                    "conv2": ini.conv1d(cfg.kernel_size, cfg.filter_channels, h)},
            "ln2": ini.norm(h),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "emb": ini.randn((cfg.vocab_size, h), std=h ** -0.5),
        "layers": layers,
        "proj": ini.conv1d(1, h, 2 * h),
        "pos_emb": ini.zeros((1, cfg.pad_length, h)),
    }


def _rel_table(emb_rel: torch.Tensor, window: int, length: int) -> torch.Tensor:
    """[L, L, d]: E[j - i + w] where |j - i| <= w, else zero."""
    pos = torch.arange(length, device=emb_rel.device)
    rel = pos[None, :] - pos[:, None]
    inside = (rel.abs() <= window)[..., None]
    table = emb_rel[0][(rel + window).clamp(0, 2 * window)]
    return torch.where(inside, table, torch.zeros_like(table))


def _rel_attention(p, x: torch.Tensor, keep: torch.Tensor, cfg: PhonemeEncoderConfig):
    """x: [B, L, h]; keep: [B, 1, L, L] boolean."""
    heads = cfg.n_heads
    scale = 1.0 / math.sqrt(cfg.hidden_channels // heads)
    q, k, v = (nn.split_heads(nn.conv1d(p[n], x, padding=0), heads) for n in "qkv")
    length = x.shape[1]
    table_k = _rel_table(p["emb_rel_k"], cfg.window_size, length)
    table_v = _rel_table(p["emb_rel_v"], cfg.window_size, length)
    scores = torch.einsum("bihd,bjhd->bhij", q, k) * scale
    scores = scores + torch.einsum("bihd,ijd->bhij", q, table_k) * scale
    weights = torch.softmax(torch.where(keep, scores, torch.full_like(scores, MASK_FILL)), dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", weights, v)
    out = out + torch.einsum("bhij,ijd->bihd", weights, table_v)
    return nn.conv1d(p["o"], nn.merge_heads(out), padding=0)


def _ffn(p, x: torch.Tensor, x_mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    pad = (0, 0, (kernel_size - 1) // 2, kernel_size // 2)  # on the time axis of [B, L, C]
    h = torch.relu(nn.conv1d(p["conv1"], F.pad(x * x_mask, pad), padding=0))
    h = nn.conv1d(p["conv2"], F.pad(h * x_mask, pad), padding=0)
    return h * x_mask


def apply_phoneme_encoder(params, cfg: PhonemeEncoderConfig, phoneme_idx: torch.Tensor):
    """phoneme_idx: [B, pad_length] integer ids -> (emb [B, pad_length, h],
    mask [B, pad_length] float, 1 on the first ``length`` positions, where
    ``length`` counts the ids other than ``pad_token_id``)."""
    with full_f32():
        lengths = (phoneme_idx != cfg.pad_token_id).sum(dim=-1)
        length = phoneme_idx.shape[1]
        pos = torch.arange(length, device=phoneme_idx.device)
        x_mask = (pos[None, :] < lengths[:, None]).float()
        m = x_mask[..., None]
        x = params["emb"][phoneme_idx.long()] * math.sqrt(cfg.hidden_channels) * m
        keep = (x_mask[:, None, :, None] * x_mask[:, None, None, :]) > 0
        for layer in params["layers"]:
            x = nn.layer_norm(layer["ln1"], x + _rel_attention(layer["attn"], x, keep, cfg))
            x = nn.layer_norm(layer["ln2"], x + _ffn(layer["ffn"], x, m, cfg.kernel_size))
        return x * m + params["pos_emb"], x_mask
