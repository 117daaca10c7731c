"""FLAN-T5 text encoder, in PyTorch.

Port of ``audioldm2_tpu/models/t5.py``: pre-norm RMSNorm blocks (eps from
the config, 1e-6), unscaled attention (scale 1.0) with the bucketed
relative-position bias held by block 0 and shared by every block, and the
gated-gelu feed-forward with the tanh-approximate gelu (not the exact-erf
gelu of the UNet's GEGLU). Attention carries a mask and a bias, so it
takes the plain path on every device, as XLA does in the JAX package.
An encoder whose leaves are tp-split (``parallel.mesh.shard_params``)
computes on the rank's heads and d_ff columns, with Megatron's collectives
(``parallel.collectives``); one nested in another conditioner stays whole.
"""

from __future__ import annotations

import numpy as np
import torch

from audioldm2_torch.config import FlanT5Config
from audioldm2_torch.ops import nn
from audioldm2_torch.parallel import collectives as tp
from audioldm2_torch.params import Init


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket function (host side; positions are static)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int32) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


def position_bias_table_index(q_len: int, k_len: int, cfg: FlanT5Config) -> np.ndarray:
    """[q_len, k_len] bucket indices."""
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    return relative_position_bucket(
        mem - ctx,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance,
    )


def init_t5_encoder(ini: Init, cfg: FlanT5Config):
    inner = cfg.num_heads * cfg.d_kv
    ones = lambda: {"scale": torch.ones((cfg.d_model,), device=ini.device)}  # noqa: E731
    blocks = []
    for i in range(cfg.num_layers):
        blk = {
            "ln1": ones(),
            "attn": {
                "q": ini.linear(cfg.d_model, inner, bias=False),
                "k": ini.linear(cfg.d_model, inner, bias=False),
                "v": ini.linear(cfg.d_model, inner, bias=False),
                "o": ini.linear(inner, cfg.d_model, bias=False),
            },
            "ln2": ones(),
            "ff": {
                "wi_0": ini.linear(cfg.d_model, cfg.d_ff, bias=False),
                "wi_1": ini.linear(cfg.d_model, cfg.d_ff, bias=False),
                "wo": ini.linear(cfg.d_ff, cfg.d_model, bias=False),
            },
        }
        if i == 0:
            blk["rel_bias"] = ini.randn((cfg.relative_attention_num_buckets, cfg.num_heads), std=0.1)
        blocks.append(blk)
    return {
        "token_embed": ini.randn((cfg.vocab_size, cfg.d_model)),
        "blocks": blocks,
        "final_ln": ones(),
    }


def _local_heads(params, cfg: FlanT5Config) -> int:
    """The heads this rank holds: all of them, or, with the encoder's
    leaves tp-split (``parallel.mesh.shard_params``; a T5 nested in another
    conditioner stays whole and computes replicated), num_heads / tp."""
    return params["blocks"][0]["attn"]["q"]["w"].shape[1] // cfg.d_kv


def _t5_attention(p, x, position_bias, mask, cfg: FlanT5Config, heads: int):
    """Under tp: q/k/v split by column (this rank's heads), o by row."""
    x = tp.copy_to_tp(x) if heads < cfg.num_heads else x
    q = nn.split_heads(nn.linear(p["q"], x), heads)
    k = nn.split_heads(nn.linear(p["k"], x), heads)
    v = nn.split_heads(nn.linear(p["v"], x), heads)
    out = nn.attention(q, k, v, mask=mask, bias=position_bias, scale=1.0)
    o = tp.row_parallel_linear if heads < cfg.num_heads else nn.linear
    return o(p["o"], nn.merge_heads(out))


def _t5_ff(p, h, cfg: FlanT5Config, split: bool):
    """Under tp: wi_0/wi_1 split by column, wo by row."""
    h = tp.copy_to_tp(h) if split else h
    if cfg.gated_act:
        u = nn.gelu_tanh(nn.linear(p["wi_0"], h)) * nn.linear(p["wi_1"], h)
    else:
        u = torch.relu(nn.linear(p["wi_0"], h))
    return (tp.row_parallel_linear if split else nn.linear)(p["wo"], u)


def apply_t5_encoder(params, cfg: FlanT5Config, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor) -> torch.Tensor:
    """input_ids: [B, L] int; attention_mask: [B, L] (1 = token).
    Returns [B, L, d_model] final hidden states (after the final RMSNorm)."""
    x = params["token_embed"][input_ids.long()]
    L = input_ids.shape[1]
    buckets = torch.as_tensor(position_bias_table_index(L, L, cfg), device=x.device).long()
    table = params["blocks"][0]["rel_bias"]  # [num_buckets, H], whole on every rank
    heads = _local_heads(params, cfg)
    if heads < cfg.num_heads:  # this rank's heads' columns
        table = tp.copy_to_tp(table)[:, tp.tp_rank() * heads:(tp.tp_rank() + 1) * heads]
    position_bias = table[buckets].permute(2, 0, 1)[None]  # [1, H, L, L]
    for blk in params["blocks"]:
        h = nn.rms_norm(blk["ln1"], x, cfg.layer_norm_epsilon)
        x = x + _t5_attention(blk["attn"], h, position_bias, attention_mask, cfg, heads)
        h = nn.rms_norm(blk["ln2"], x, cfg.layer_norm_epsilon)
        x = x + _t5_ff(blk["ff"], h, cfg, blk["ff"]["wo"]["w"].shape[0] < cfg.d_ff)
    return nn.rms_norm(params["final_ln"], x, cfg.layer_norm_epsilon)
