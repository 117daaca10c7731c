"""AudioMAE, the ViT-B/16 audio encoder of the AudioMAE conditioner, in PyTorch.

Port of ``audioldm2_tpu/models/audiomae.py``: a [B, 1024, 128] kaldi fbank
is cut into 16x16 patches by a stride-16 conv (a 64 x 8 grid of 512
tokens, plus CLS), runs through twelve pre-norm ViT blocks (LayerNorm eps
1e-6, exact-erf GELU), and the contextual embedding is the mean of the
LayerNorm'd outputs of the blocks after ``contextual_depth``. The
conditioner's (avg + max) / 2 pooling on that 64 x 8 grid (fixed, as in
JAX) and its optional L2 normalization are here too.

The attention is the plain non-causal softmax the JAX package leaves to
XLA (no Pallas function computes it); ``scaled_dot_product_attention``
serves it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audioldm2_torch.config import AudioMAEConfig
from audioldm2_torch.ops import nn
from audioldm2_torch.params import Init

LN_EPS = 1e-6
GRID = (64, 8)  # the patch grid of a 1024 x 128 fbank, hard-coded in the reference's pooling


def init_audiomae(ini: Init, cfg: AudioMAEConfig):
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)
    n_patches = (cfg.img_size[0] // cfg.patch_size) * (cfg.img_size[1] // cfg.patch_size)
    blocks = [
        {
            "norm1": ini.norm(d),
            "attn": {"qkv": ini.linear(d, 3 * d), "proj": ini.linear(d, d)},
            "norm2": ini.norm(d),
            "mlp": {"fc1": ini.linear(d, hidden), "fc2": ini.linear(hidden, d)},
        }
        for _ in range(cfg.depth)
    ]
    return {
        "patch_embed": ini.conv(cfg.patch_size, cfg.patch_size, 1, d),
        "cls_token": ini.zeros((1, 1, d)),
        "pos_embed": ini.randn((1, n_patches + 1, d), std=0.02),
        "blocks": blocks,
        "norm": ini.norm(d),
    }


def _self_attention(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, 3C] packed q, k, v -> [B, T, C]."""
    b, t, c3 = x.shape
    q, k, v = x.reshape(b, t, 3, num_heads, c3 // (3 * num_heads)).permute(2, 0, 3, 1, 4)
    return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, t, c3 // 3)


def _vit_block(p, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    h = nn.layer_norm(p["norm1"], x, LN_EPS)
    x = x + nn.linear(p["attn"]["proj"], _self_attention(nn.linear(p["attn"]["qkv"], h),
                                                         num_heads))
    h = nn.layer_norm(p["norm2"], x, LN_EPS)
    return x + nn.linear(p["mlp"]["fc2"], nn.gelu(nn.linear(p["mlp"]["fc1"], h)))


def encode_no_mask(params, cfg: AudioMAEConfig, fbank: torch.Tensor) -> torch.Tensor:
    """fbank [B, 1024, 128] -> the contextual embedding [B, 513, embed_dim]
    (CLS first, then the patches in row-major order over the grid)."""
    ps = cfg.patch_size
    patches = nn.conv2d(params["patch_embed"], fbank[..., None], stride=(ps, ps),
                        padding="VALID")
    b, gt, gf, d = patches.shape
    tokens = patches.reshape(b, gt * gf, d) + params["pos_embed"][:, 1:]
    cls = (params["cls_token"] + params["pos_embed"][:, :1]).expand(b, 1, d)
    x = torch.cat([cls, tokens], dim=1)
    contextual = []
    for n, blk in enumerate(params["blocks"]):
        x = _vit_block(blk, x, cfg.num_heads)
        if n > cfg.contextual_depth:
            contextual.append(nn.layer_norm(params["norm"], x, LN_EPS))
    return torch.stack(contextual).mean(dim=0)


def avg_max_pool_factors(representation: torch.Tensor, time_pool: int,
                         freq_pool: int) -> torch.Tensor:
    """(avg + max) / 2 over (time_pool, freq_pool) windows of the 512 patch
    tokens on the 64 x 8 grid; [B, 513, D] -> [B, 512 / (tp * fp), D]."""
    tp, fp = min(int(time_pool), GRID[0]), min(int(freq_pool), GRID[1])
    b, _, d = representation.shape
    grid = representation[:, 1:].reshape(b, *GRID, d).permute(0, 3, 1, 2)
    pooled = (F.avg_pool2d(grid, (tp, fp)) + F.max_pool2d(grid, (tp, fp))) / 2.0
    return pooled.permute(0, 2, 3, 1).reshape(b, -1, d)


def avg_max_pool(representation: torch.Tensor, cfg: AudioMAEConfig) -> torch.Tensor:
    """The pooling at the config's evaluation factors."""
    return avg_max_pool_factors(representation, cfg.eval_time_pooling, cfg.eval_freq_pooling)


def sample_pooling_factors(rng, cfg: AudioMAEConfig):
    """Training-time pooling factors from a numpy Generator: time_pool from
    ``time_pooling_factors``; freq_pool drawn apart from
    ``freq_pooling_factors`` when ``tf_separated``, else min(8, time_pool)."""
    tp = int(min(GRID[0], rng.choice(list(cfg.time_pooling_factors))))
    if cfg.tf_separated:
        return tp, int(min(GRID[1], rng.choice(list(cfg.freq_pooling_factors))))
    return tp, min(GRID[1], tp)


def l2_regularize(pooled: torch.Tensor) -> torch.Tensor:
    """Each pooled token divided by its L2 norm (floored at 1e-12)."""
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp(min=1e-12)
