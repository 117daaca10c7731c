"""GPT-2 over continuous embeddings with a KV cache, in PyTorch.

Port of ``audioldm2_tpu/models/gpt2.py``: ``prefill`` runs the prefix in
one pass and fills the first L slots of a fixed-size cache; ``step`` runs
one token against the cache. Position ids come from the cumulative
attention mask, so pads do not take positions. Pre-LN blocks with the
tanh-approximate GELU; Conv1D weights stay [in, out]. The attention is
masked (causal and cache masks), so it takes the plain path on every
device. Unlike the JAX functions, ``step`` writes the cache in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from audioldm2_torch.config import GPT2Config
from audioldm2_torch.ops import nn
from audioldm2_torch.params import Init


def init_gpt2(ini: Init, cfg: GPT2Config):
    d = cfg.n_embd
    blocks = [
        {
            "ln_1": ini.norm(d),
            "attn": {"c_attn": ini.linear(d, 3 * d), "c_proj": ini.linear(d, d)},
            "ln_2": ini.norm(d),
            "mlp": {"c_fc": ini.linear(d, 4 * d), "c_proj": ini.linear(4 * d, d)},
        }
        for _ in range(cfg.n_layer)
    ]
    return {"wpe": ini.randn((cfg.n_positions, d), std=0.01), "blocks": blocks,
            "ln_f": ini.norm(d)}


class KVCache(NamedTuple):
    k: torch.Tensor  # [n_layer, B, L_max, H, D]
    v: torch.Tensor


def _attn(p, q, k_all, v_all, keep):
    """q: [B, Tq, H, Dh]; k_all, v_all: [B, Tk, H, Dh]; keep: bool mask
    broadcastable to [B, H, Tq, Tk]."""
    return nn.linear(p["c_proj"], nn.merge_heads(nn.attention(q, k_all, v_all, mask=keep)))


def _mlp(p, x):
    return nn.linear(p["c_proj"], nn.gelu_tanh(nn.linear(p["c_fc"], x)))


def _qkv(p, x, cfg: GPT2Config):
    q, k, v = torch.chunk(nn.linear(p["c_attn"], x), 3, dim=-1)
    return tuple(nn.split_heads(t, cfg.n_head) for t in (q, k, v))


def prefill(params, cfg: GPT2Config, embeds: torch.Tensor, mask: torch.Tensor, cache_len: int):
    """embeds: [B, L, D]; mask: [B, L] (1 = valid; pads may sit
    mid-sequence); cache_len: prefix + generation steps. Returns (hidden
    [B, L, D], KVCache with the first L slots filled)."""
    b, length, d = embeds.shape
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0).long()
    x = embeds + params["wpe"][positions]
    causal = torch.tril(torch.ones((length, length), dtype=torch.bool, device=x.device))
    keep = causal[None, None] & mask.bool()[:, None, None, :]
    shape = (cfg.n_layer, b, cache_len, cfg.n_head, d // cfg.n_head)
    ks = torch.zeros(shape, dtype=embeds.dtype, device=x.device)
    vs = torch.zeros_like(ks)
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(blk["attn"], nn.layer_norm(blk["ln_1"], x, cfg.layer_norm_epsilon), cfg)
        ks[i, :, :length] = k
        vs[i, :, :length] = v
        x = x + _attn(blk["attn"], q, k, v, keep)
        x = x + _mlp(blk["mlp"], nn.layer_norm(blk["ln_2"], x, cfg.layer_norm_epsilon))
    return nn.layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon), KVCache(ks, vs)


def step(params, cfg: GPT2Config, emb: torch.Tensor, cache: KVCache, cache_mask: torch.Tensor,
         index: int, position: torch.Tensor):
    """One decode step. emb: [B, D]; cache_mask: [B, L_max] validity of the
    cache slots; index: the slot this token writes; position: [B] position
    ids. Returns (hidden [B, D], the cache, updated in place)."""
    x = (emb + params["wpe"][position.long()])[:, None, :]
    keep = cache_mask.bool().clone()
    keep[:, index] = True
    keep = keep[:, None, None, :]
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(blk["attn"], nn.layer_norm(blk["ln_1"], x, cfg.layer_norm_epsilon), cfg)
        cache.k[i, :, index] = k[:, 0]
        cache.v[i, :, index] = v[:, 0]
        x = x + _attn(blk["attn"], q, cache.k[i], cache.v[i], keep)
        x = x + _mlp(blk["mlp"], nn.layer_norm(blk["ln_2"], x, cfg.layer_norm_epsilon))
    return nn.layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon)[:, 0], cache


def forward_full(params, cfg: GPT2Config, embeds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The cache-free forward over the whole sequence (the reference's GPT-2
    call): prefill with a cache of exactly the sequence's length; returns
    the hidden states [B, L, D]. The oracle of the KV-cached generator."""
    return prefill(params, cfg, embeds, mask, cache_len=embeds.shape[1])[0]
