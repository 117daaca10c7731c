"""Latent UNet with per-block spatial-transformer ladders, in PyTorch.

Port of ``audioldm2_tpu/models/unet.py`` (apply path plus init): the same
parameter tree (nested dicts of tensors), channels-last activations
[B, T, F, C], a context-free self-attention SpatialTransformer first at
every attention level, then one cross-attention SpatialTransformer per
context slot. The ResBlock bodies, the LN-fused projections, the GEGLU
output and the self-attention go through the dispatch points of
``ops.nn``, which launch the Hopper kernels on CUDA tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from audioldm2_tpu.config import UNetConfig
from audioldm2_torch.ops import nn
from audioldm2_torch.params import Init

GN_EPS_RES = 1e-5
GN_EPS_ST = 1e-6
LN_EPS = 1e-5


# ---------------------------------------------------------------------------
# Init (mirrors the JAX tree key for key and shape for shape)
# ---------------------------------------------------------------------------


def _resblock_init(ini: Init, cin, cout, emb_dim):
    p = {
        "in_norm": ini.norm(cin),
        "in_conv": ini.conv(3, 3, cin, cout),
        "emb": ini.linear(emb_dim, cout),
        "out_norm": ini.norm(cout),
        "out_conv": ini.conv(3, 3, cout, cout, zero=True),
    }
    if cin != cout:
        p["skip"] = ini.conv(1, 1, cin, cout)
    return p


def _attn_init(ini: Init, query_dim, context_dim, inner_dim):
    ctx = context_dim if context_dim is not None else query_dim
    return {
        "to_q": ini.linear(query_dim, inner_dim, bias=False),
        "to_k": ini.linear(ctx, inner_dim, bias=False),
        "to_v": ini.linear(ctx, inner_dim, bias=False),
        "to_out": ini.linear(inner_dim, query_dim),
    }


def _st_init(ini: Init, channels, depth, context_dim):
    return {
        "norm": ini.norm(channels),
        "proj_in": ini.conv(1, 1, channels, channels),
        "blocks": [
            {
                "norm1": ini.norm(channels),
                "attn1": _attn_init(ini, channels, None, channels),
                "norm2": ini.norm(channels),
                "attn2": _attn_init(ini, channels, context_dim, channels),
                "norm3": ini.norm(channels),
                "ff": {
                    "proj_in": ini.linear(channels, channels * 8),  # GEGLU
                    "proj_out": ini.linear(channels * 4, channels),
                },
            }
            for _ in range(depth)
        ],
        "proj_out": ini.conv(1, 1, channels, channels, zero=True),
    }


def _sts_init(ini: Init, ch, cfg: UNetConfig):
    return {
        "self_st": _st_init(ini, ch, cfg.transformer_depth, None),
        "cross_sts": [_st_init(ini, ch, cfg.transformer_depth, cd) for cd in cfg.context_dims],
    }


def init_unet(ini: Init, cfg: UNetConfig):
    mc = cfg.model_channels
    emb_dim = cfg.emb_dim
    p = {
        "time_embed": {
            "lin1": ini.linear(mc, cfg.time_embed_dim),
            "lin2": ini.linear(cfg.time_embed_dim, cfg.time_embed_dim),
        }
    }
    if cfg.extra_film_condition_dim is not None:
        p["film_emb"] = ini.linear(cfg.extra_film_condition_dim, cfg.time_embed_dim)
    input_blocks = [{"conv": ini.conv(3, 3, cfg.in_channels, mc)}]
    ch, ds, chans = mc, 1, [mc]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _resblock_init(ini, ch, mult * mc, emb_dim)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk.update(_sts_init(ini, ch, cfg))
            input_blocks.append(blk)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append({"downsample": ini.conv(3, 3, ch, ch)})
            chans.append(ch)
            ds *= 2
    p["input_blocks"] = input_blocks
    mid = {"res1": _resblock_init(ini, ch, ch, emb_dim)}
    mid.update(_sts_init(ini, ch, cfg))
    mid["res2"] = _resblock_init(ini, ch, ch, emb_dim)
    p["middle_block"] = mid
    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            blk = {"res": _resblock_init(ini, ch + ich, mult * mc, emb_dim)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk.update(_sts_init(ini, ch, cfg))
            if level and i == cfg.num_res_blocks:
                blk["upsample"] = ini.conv(3, 3, ch, ch)
                ds //= 2
            output_blocks.append(blk)
    p["output_blocks"] = output_blocks
    p["out_norm"] = ini.norm(ch)
    p["out_conv"] = ini.conv(3, 3, mc, cfg.out_channels, zero=True)
    return p


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _resblock(p, x, emb):
    """x: [B, T, F, C], or the decoder's (h, skip) tuple, which goes to the
    concat-free kernel paths."""
    if isinstance(x, tuple):
        x1, x2 = x
        h = nn.gn_silu_conv_cat(p["in_norm"], p["in_conv"], x1, x2, eps=GN_EPS_RES)
        skip = nn.conv1x1_cat(p["skip"], x1, x2) if "skip" in p else torch.cat([x1, x2], -1)
    else:
        h = nn.gn_silu_conv(p["in_norm"], p["in_conv"], x, eps=GN_EPS_RES)
        skip = nn.conv2d(p["skip"], x) if "skip" in p else x
    emb_out = nn.linear(p["emb"], nn.silu(emb))
    h = h + emb_out[:, None, None, :]
    h = nn.gn_silu_conv(p["out_norm"], p["out_conv"], h, eps=GN_EPS_RES)
    return skip + h


def _cross_attention(p, p_norm, x, context, mask, num_heads, kv=None):
    if kv is None and context is None and "to_qkv" in p:
        q, k, v = torch.chunk(nn.ln_linear(p_norm, p["to_qkv"], x, LN_EPS), 3, dim=-1)
        q, k, v = (nn.split_heads(t, num_heads) for t in (q, k, v))
    elif kv is not None or context is not None:
        q = nn.split_heads(nn.ln_linear(p_norm, p["to_q"], x, LN_EPS), num_heads)
        if kv is not None:
            k, v = kv
        else:
            k = nn.split_heads(nn.linear(p["to_k"], context), num_heads)
            v = nn.split_heads(nn.linear(p["to_v"], context), num_heads)
    else:
        xn = nn.layer_norm(p_norm, x, LN_EPS)
        q = nn.split_heads(nn.linear(p["to_q"], xn), num_heads)
        k = nn.split_heads(nn.linear(p["to_k"], xn), num_heads)
        v = nn.split_heads(nn.linear(p["to_v"], xn), num_heads)
    cross = context is not None or kv is not None
    out = nn.attention(q, k, v, mask=mask if cross else None)
    return nn.linear(p["to_out"], nn.merge_heads(out))


def _st_block(p, x, context, mask, num_heads, kv=None):
    x = x + _cross_attention(p["attn1"], p["norm1"], x, None, None, num_heads)
    x = x + _cross_attention(p["attn2"], p["norm2"], x, context, mask, num_heads, kv=kv)
    h = nn.ln_linear(p["norm3"], p["ff"]["proj_in"], x, LN_EPS)
    return nn.geglu_ff_out(p["ff"]["proj_out"], h, x)


def _spatial_transformer(p, x, context, mask, num_heads, kvs=None):
    b, t, f, c = x.shape
    h = nn.group_norm(p["norm"], x, eps=GN_EPS_ST)
    h = nn.conv2d(p["proj_in"], h).reshape(b, t * f, c)
    for d, blk in enumerate(p["blocks"]):
        kv = kvs[d] if kvs is not None else None
        h = _st_block(blk, h, context, mask, num_heads, kv=kv)
    h = nn.conv2d(p["proj_out"], h.reshape(b, t, f, c))
    return x + h


def _run_sts(blk, h, contexts, masks, cfg: UNetConfig, kv_iter=None):
    num_heads = h.shape[-1] // cfg.num_head_channels
    h = _spatial_transformer(blk["self_st"], h, None, None, num_heads)
    for i, st in enumerate(blk["cross_sts"]):
        ctx = contexts[i] if i < len(contexts) else None
        msk = masks[i] if i < len(masks) else None
        kvs = next(kv_iter) if kv_iter is not None else None
        if kvs is not None and ctx is None:
            kvs = None
        h = _spatial_transformer(st, h, ctx, msk, num_heads, kvs=kvs)
    return h


def _fuse_attn(attn):
    if "to_qkv" in attn:
        return attn
    out = dict(attn)
    out["to_qkv"] = {
        "w": torch.cat([attn["to_q"]["w"], attn["to_k"]["w"], attn["to_v"]["w"]], dim=1)
    }
    return out


def fuse_self_qkv(params):
    """Fuse the q/k/v projections of every self-attention (attn1 of all
    blocks, plus attn2 of the context-free self-ST) into one [C, 3C]
    weight. Done once per generate call, outside the step loop."""

    def fuse_st(st):
        st = dict(st)
        st["blocks"] = [dict(b) for b in st["blocks"]]
        for b in st["blocks"]:
            b["attn1"] = _fuse_attn(b["attn1"])
        return st

    def fuse_sts(blk):
        blk = dict(blk)
        st = fuse_st(blk["self_st"])
        for b in st["blocks"]:
            b["attn2"] = _fuse_attn(b["attn2"])
        blk["self_st"] = st
        blk["cross_sts"] = [fuse_st(s) for s in blk["cross_sts"]]
        return blk

    p = dict(params)
    p["input_blocks"] = [fuse_sts(b) if "self_st" in b else b for b in params["input_blocks"]]
    p["middle_block"] = fuse_sts(params["middle_block"])
    p["output_blocks"] = [fuse_sts(b) if "self_st" in b else b for b in params["output_blocks"]]
    return p


def precompute_cross_kv(params, cfg: UNetConfig, context_list):
    """Cross-attention K/V per cross-ST instance (walk order) and depth,
    computed once from the loop-invariant contexts; None for context-free
    slots."""
    out = []

    def add(blk):
        for i, st in enumerate(blk["cross_sts"]):
            ctx = context_list[i] if i < len(context_list) else None
            if ctx is None:
                out.append(None)
                continue
            per_depth = []
            for sub in st["blocks"]:
                heads = sub["attn2"]["to_k"]["w"].shape[1] // cfg.num_head_channels
                k = nn.split_heads(nn.linear(sub["attn2"]["to_k"], ctx), heads)
                v = nn.split_heads(nn.linear(sub["attn2"]["to_v"], ctx), heads)
                per_depth.append((k, v))
            out.append(per_depth)

    for blk in params["input_blocks"]:
        if "self_st" in blk:
            add(blk)
    add(params["middle_block"])
    for blk in params["output_blocks"]:
        if "self_st" in blk:
            add(blk)
    return out


def apply_unet(params, cfg: UNetConfig, x: torch.Tensor, timesteps: torch.Tensor,
               context_list: Sequence[Optional[torch.Tensor]] = (),
               context_mask_list: Sequence[Optional[torch.Tensor]] = (),
               y: Optional[torch.Tensor] = None, cross_kv=None) -> torch.Tensor:
    """x: [B, T, F, C]; timesteps: [B]; context_list[i]: [B, L_i, D_i];
    context_mask_list[i]: [B, L_i] (1 = attend); y: [B, film_dim]."""
    t_emb = nn.timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = nn.linear(params["time_embed"]["lin1"], t_emb)
    emb = nn.linear(params["time_embed"]["lin2"], nn.silu(emb))
    if cfg.extra_film_condition_dim is not None:
        if y is None:
            raise ValueError("film-conditioned UNet requires y")
        emb = torch.cat([emb, nn.linear(params["film_emb"], y)], dim=-1)

    kv_iter = iter(cross_kv) if cross_kv is not None else None
    hs = []
    h = x
    for blk in params["input_blocks"]:
        if "conv" in blk:
            h = nn.conv2d(blk["conv"], h)
        elif "downsample" in blk:
            h = nn.conv2d(blk["downsample"], h, stride=(2, 2), padding=1)
        else:
            h = _resblock(blk["res"], h, emb)
            if "self_st" in blk:
                h = _run_sts(blk, h, context_list, context_mask_list, cfg, kv_iter)
        hs.append(h)

    mid = params["middle_block"]
    h = _resblock(mid["res1"], h, emb)
    h = _run_sts(mid, h, context_list, context_mask_list, cfg, kv_iter)
    h = _resblock(mid["res2"], h, emb)

    for blk in params["output_blocks"]:
        h = _resblock(blk["res"], (h, hs.pop()), emb)
        if "self_st" in blk:
            h = _run_sts(blk, h, context_list, context_mask_list, cfg, kv_iter)
        if "upsample" in blk:
            h = nn.conv2d(blk["upsample"], nn.nearest_upsample_2d(h))

    h = nn.group_norm_silu(params["out_norm"], h, eps=GN_EPS_RES)
    return nn.conv2d(params["out_conv"], h)


def kernel_launches_per_forward(cfg: UNetConfig) -> dict:
    """Kernel launches of one apply_unet call with a context in every
    cross slot: two K1 per ResBlock; per transformer block three K3 (the
    self-attention's fused QKV, attn2's q or fused QKV, the GEGLU proj_in)
    and one K4; K2 for every self-attention whose head_dim the kernel
    takes (attn1 everywhere, attn2 in the self-ST)."""
    n_levels = len(cfg.channel_mult)
    n_res = n_levels * cfg.num_res_blocks + 2 + n_levels * (cfg.num_res_blocks + 1)
    att_levels = [lvl for lvl in range(n_levels) if 2 ** lvl in cfg.attention_resolutions]
    n_ladders = (len(att_levels) * (2 * cfg.num_res_blocks + 1)) + 1
    sts_per_ladder = 1 + len(cfg.context_dims)
    blocks = n_ladders * sts_per_ladder * cfg.transformer_depth
    kernel_heads = cfg.num_head_channels in (32, 64, 128)
    self_attn = n_ladders * cfg.transformer_depth * (2 + len(cfg.context_dims))
    return {
        "gn_silu_conv3x3": 2 * n_res,
        "flash_self_attention": self_attn if kernel_heads else 0,
        "ln_matmul": 3 * blocks,
        "geglu_matmul": blocks,
    }
