"""Latent UNet with per-block spatial-transformer ladders, in PyTorch.

Port of ``audioldm2_tpu/models/unet.py`` (apply path plus init): the same
parameter tree (nested dicts of tensors), channels-last activations
[B, T, F, C], a context-free self-attention SpatialTransformer first at
every attention level, then one cross-attention SpatialTransformer per
context slot. The ResBlock bodies, the LN-fused projections, the GEGLU
output, the self-attention and the plain convs (the stem, skips, the
transformers' GroupNorm + proj_in and proj_out, down- and upsamples, the
out_conv) go through the dispatch points of ``ops.nn``, which launch the
Hopper kernels on CUDA tensors.

The legacy QKV attention block and the EncoderUNet half-UNet classifier
(JAX ``unet.py:448-558``; no shipped config instantiates either) reuse the
ResBlock (K1); the block's self-attention goes through ``nn.attention``
(K2) and the classifier's out_norm + SiLU through K6.

The int8 serving mode (``quantize_st_linears``, ``quantize_resblock_convs``,
JAX ``unet.py:294-349``) swaps weights for int8 ones with the same
predicates; the dispatch points then launch the int8 kernels.

Under a dp x tp mesh (``parallel.collectives.tensor_parallel``, with the
rank's slices from ``parallel.mesh.shard_params``) the spatial
transformers split Megatron-style: q/k/v and the GEGLU projection by
column, to_out and the FF's output by row, summed over tp in f32 and
rounded once; the rest computes replicated. In the int8 serving mode each
rank quantizes its slices as the whole weight's quantization would cut
them (``quantize_st_linears``): int8 columns with their scales for a
column split, int8 rows with the whole weight's scales for a row split;
the ResBlock convs are whole on every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from audioldm2_torch.config import UNetConfig
from audioldm2_torch.ops import KERNEL_NAMES, nn, quant
from audioldm2_torch.parallel import collectives as tp
from audioldm2_torch.parallel.mesh import split_axis
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


def _ln_linear(p_norm, p_lin, x):
    """A column-parallel LN-fused projection: under tp, x and the LN
    parameters (whole on every rank) pass Megatron's "f", so that their
    gradients sum over the tp ranks' column slices."""
    if tp.tp_size() > 1:
        p_norm = {k: tp.copy_to_tp(v) for k, v in p_norm.items()}
        x = tp.copy_to_tp(x)
    return nn.ln_linear(p_norm, p_lin, x, LN_EPS)


def _cross_attention(p, p_norm, x, context, mask, num_heads, kv=None):
    """Under tp (``parallel.collectives``) ``p`` holds this rank's heads:
    to_q/to_k/to_v (or the fused to_qkv) by column, to_out by row, and
    ``num_heads`` counts this rank's."""
    if kv is None and context is None and "to_qkv" in p:
        q, k, v = torch.chunk(_ln_linear(p_norm, p["to_qkv"], x), 3, dim=-1)
        q, k, v = (nn.split_heads(t, num_heads) for t in (q, k, v))
    elif kv is not None or context is not None:
        q = nn.split_heads(_ln_linear(p_norm, p["to_q"], x), num_heads)
        if kv is not None:
            k, v = kv
        else:
            context = tp.copy_to_tp(context)
            k = nn.split_heads(nn.linear(p["to_k"], context), num_heads)
            v = nn.split_heads(nn.linear(p["to_v"], context), num_heads)
    else:
        xn = tp.copy_to_tp(nn.layer_norm(p_norm, x, LN_EPS))
        q = nn.split_heads(nn.linear(p["to_q"], xn), num_heads)
        k = nn.split_heads(nn.linear(p["to_k"], xn), num_heads)
        v = nn.split_heads(nn.linear(p["to_v"], xn), num_heads)
    cross = context is not None or kv is not None
    out = nn.attention(q, k, v, mask=mask if cross else None)
    return tp.row_parallel_linear(p["to_out"], nn.merge_heads(out))


def _st_block(p, x, context, mask, num_heads, kv=None):
    x = x + _cross_attention(p["attn1"], p["norm1"], x, None, None, num_heads)
    x = x + _cross_attention(p["attn2"], p["norm2"], x, context, mask, num_heads, kv=kv)
    h = _ln_linear(p["norm3"], p["ff"]["proj_in"], x)  # [a_r | gate_r] under tp
    return tp.row_parallel_geglu(p["ff"]["proj_out"], h, x)


def _spatial_transformer(p, x, context, mask, num_heads, kvs=None):
    b, t, f, c = x.shape
    h = nn.gn_conv2d(p["norm"], p["proj_in"], x, eps=GN_EPS_ST).reshape(b, t * f, c)
    for d, blk in enumerate(p["blocks"]):
        kv = kvs[d] if kvs is not None else None
        h = _st_block(blk, h, context, mask, num_heads, kv=kv)
    h = nn.conv2d(p["proj_out"], h.reshape(b, t, f, c))
    return x + h


def _run_sts(blk, h, contexts, masks, cfg: UNetConfig, kv_iter=None):
    num_heads = h.shape[-1] // cfg.num_head_channels // tp.tp_size()
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
            h = nn.upsample_conv2d(blk["upsample"], h)

    h = nn.group_norm_silu(params["out_norm"], h, eps=GN_EPS_RES)
    return nn.conv2d(params["out_conv"], h)


# ---------------------------------------------------------------------------
# Legacy QKV attention block (the reference's AttentionBlock with
# QKVAttention / QKVAttentionLegacy) and the EncoderUNet classifier
# ---------------------------------------------------------------------------


def init_legacy_attention_block(ini: Init, channels: int, num_heads: int = 1,
                                num_head_channels: int = -1):
    """``num_heads`` is a non-array leaf of the tree, where JAX puts it."""
    if num_head_channels != -1:
        num_heads = channels // num_head_channels
    return {
        "num_heads": num_heads,
        "norm": ini.norm(channels),
        "qkv": ini.conv1d(1, channels, channels * 3),
        "proj_out": ini.conv1d(1, channels, channels, zero=True),
    }


def apply_legacy_attention_block(p, x: torch.Tensor, new_order: bool = False) -> torch.Tensor:
    """x: [B, T, F, C] (or [B, S, C]) -> x + attention over all positions.
    ``new_order`` splits the qkv channels into thirds first, then heads
    (QKVAttention); otherwise heads first, then thirds of each head's 3d
    channels (QKVAttentionLegacy). Unmasked self-attention: K2 on CUDA."""
    b, c = x.shape[0], x.shape[-1]
    xs = x.reshape(b, -1, c)
    heads = p["num_heads"]
    d = c // heads
    qkv = nn.conv1d(p["qkv"], nn.group_norm(p["norm"], xs), padding=0)  # [B, S, 3C]
    if new_order:
        q, k, v = (nn.split_heads(t, heads) for t in torch.chunk(qkv, 3, dim=-1))
    else:
        q, k, v = torch.split(qkv.reshape(b, -1, heads, 3 * d), d, dim=-1)
    out = nn.conv1d(p["proj_out"], nn.merge_heads(nn.attention(q, k, v)), padding=0)
    return (xs + out).reshape(x.shape)


def init_encoder_unet(ini: Init, cfg: UNetConfig, pool: str = "adaptive"):
    """The EncoderUNet tree, JAX's keys and shapes (``pool`` a string leaf).
    Only the adaptive pooling head exists, as in JAX."""
    if pool != "adaptive":
        raise ValueError(f"EncoderUNet pool {pool!r}: only 'adaptive' is implemented")
    mc = cfg.model_channels
    emb_dim = cfg.time_embed_dim
    p = {
        "pool": pool,
        "time_embed": {
            "lin1": ini.linear(mc, emb_dim),
            "lin2": ini.linear(emb_dim, emb_dim),
        },
    }
    blocks = [{"conv": ini.conv(3, 3, cfg.in_channels, mc)}]
    ch, ds = mc, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _resblock_init(ini, ch, mult * mc, emb_dim)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk["attn"] = init_legacy_attention_block(
                    ini, ch, num_head_channels=cfg.num_head_channels)
            blocks.append(blk)
        if level != len(cfg.channel_mult) - 1:
            blocks.append({"downsample": ini.conv(3, 3, ch, ch)})
            ds *= 2
    p["input_blocks"] = blocks
    p["middle_block"] = {
        "res1": _resblock_init(ini, ch, ch, emb_dim),
        "attn": init_legacy_attention_block(ini, ch, num_head_channels=cfg.num_head_channels),
        "res2": _resblock_init(ini, ch, ch, emb_dim),
    }
    p["out_norm"] = ini.norm(ch)
    p["out_conv"] = ini.conv(1, 1, ch, cfg.out_channels, zero=True)
    return p


def apply_encoder_unet(params, cfg: UNetConfig, x: torch.Tensor,
                       timesteps: torch.Tensor) -> torch.Tensor:
    """x: [B, T, F, C]; timesteps: [B] -> logits [B, out_channels]
    (GroupNorm + SiLU, the mean over all positions, a 1x1 conv)."""
    t_emb = nn.timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = nn.linear(params["time_embed"]["lin1"], t_emb)
    emb = nn.linear(params["time_embed"]["lin2"], nn.silu(emb))
    h = x
    for blk in params["input_blocks"]:
        if "conv" in blk:
            h = nn.conv2d(blk["conv"], h)
        elif "downsample" in blk:
            h = nn.conv2d(blk["downsample"], h, stride=(2, 2), padding=1)
        else:
            h = _resblock(blk["res"], h, emb)
            if "attn" in blk:
                h = apply_legacy_attention_block(blk["attn"], h)
    mid = params["middle_block"]
    h = _resblock(mid["res1"], h, emb)
    h = apply_legacy_attention_block(mid["attn"], h)
    h = _resblock(mid["res2"], h, emb)
    h = nn.group_norm_silu(params["out_norm"], h, eps=GN_EPS_RES)
    h = h.mean(dim=(1, 2), keepdim=True)  # AdaptiveAvgPool2d((1, 1))
    return nn.conv2d(params["out_conv"], h)[:, 0, 0, :]


def kernel_launches_per_encoder_forward(cfg: UNetConfig, compute_dtype: str = "bfloat16") -> dict:
    """Kernel launches of one apply_encoder_unet call: two K1 per ResBlock,
    one K2 per legacy attention block whose head_dim the kernel takes, one
    K6 (out_norm); in bf16 the plain conv for the stem, downsample, skip and
    out_conv convs that ``nn.conv2d_uses_kernel`` takes."""
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    res = len(cfg.channel_mult) * cfg.num_res_blocks + 2
    attn, ds = 1, 1  # the middle block's
    for level in range(len(cfg.channel_mult)):
        if ds in cfg.attention_resolutions:
            attn += cfg.num_res_blocks
        if level != len(cfg.channel_mult) - 1:
            ds *= 2
    counts["gn_silu_conv3x3"] = 2 * res
    counts["flash_self_attention"] = attn if cfg.num_head_channels in (32, 64, 128) else 0
    counts["group_norm_silu"] = 1
    if compute_dtype == "bfloat16":
        counts["conv2d"] = sum(_conv_takes(*cv[:6]) for cv in _plain_convs(cfg, encoder=True))
    return counts


_QUANT_KEYS = ("to_qkv", "to_q", "to_out", "proj_in", "proj_out")


def _st_linear_quantizable(k: int, n: int) -> bool:
    return k % 128 == 0 and n % 128 == 0


def _conv_quantizable(cin: int, cout: int) -> bool:
    return cin % 128 == 0 and cout % 128 == 0


def _whole_shape(path, w, tp_size: int):
    """(K, N) of the whole weight of which ``w`` is a tp rank's slice."""
    shape = list(w.shape)
    axis = split_axis(("unet",) + path + ("w",), w)
    if axis is not None:
        shape[axis] *= tp_size
    return shape


def quantize_st_linears(params):
    """int8-quantize the spatial-transformer matmul weights read every
    step (``_QUANT_KEYS`` under attn1, attn2 or ff, K and N multiples of
    128). to_k/to_v stay: the cross K/V are precomputed once per call.
    Apply after fuse_self_qkv and precompute_cross_kv, once per call.

    Under tp (``parallel.collectives.tensor_parallel``) ``params`` holds
    the rank's slices and every rank quantizes its own, as the whole tree's
    quantization would cut them: the predicate takes the whole weight's
    shape (N x tp for a column-split leaf, K x tp for a row-split one), so
    the same leaves go int8 at every tp; a column split (the fused QKV,
    to_q, the GEGLU proj_in) holds whole columns, whose scales are already
    the whole weight's; a row split (to_out, the FF's proj_out) takes each
    column's absmax as the max over the tp ranks' rows, all of the call's
    row-split leaves in one all-reduce of their concatenation. The int8
    values and scales then equal the whole quantization's slices bit for
    bit."""
    tp_size = tp.tp_size()

    def pred(path, p):
        if not path or path[-1] not in _QUANT_KEYS:
            return False
        if not any(seg in ("attn1", "attn2", "ff") for seg in path):
            return False
        return _st_linear_quantizable(*_whole_shape(path, p["w"], tp_size))

    def whole_absmax(linears):
        rows = {path: p["w"] for path, p in linears.items()
                if split_axis(("unet",) + path + ("w",), p["w"]) == 0}
        if not rows:
            return {}
        flat = tp.max_over_tp(torch.cat([w.float().abs().amax(0) for w in rows.values()]))
        return dict(zip(rows, torch.split(flat, [w.shape[1] for w in rows.values()])))

    return quant.quantize_tree(params, pred, whole_absmax if tp_size > 1 else None)


def quantize_resblock_convs(params):
    """int8-quantize the ResBlock 3x3 convs (``in_conv``/``out_conv``) whose
    Cin and Cout are multiples of 128; the rest keep their weights."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                w = v.get("w") if isinstance(v, dict) else None
                if (k in ("in_conv", "out_conv") and isinstance(w, torch.Tensor)
                        and w.dim() == 4 and w.shape[0] == 3
                        and _conv_quantizable(w.shape[2], w.shape[3])):
                    out[k] = quant.quantize_conv3x3_dict(v)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def _layout(cfg: UNetConfig):
    """(ResBlocks as (C1, C2, Cout, downsampling factor), C2 the skip
    channels of a decoder block's virtual concat or 0; transformer-ladder
    widths; each ladder's downsampling factor) of one forward, in the order
    init_unet builds them."""
    mc = cfg.model_channels
    res, ladders, ladder_ds = [], [], []
    ch, ds, chans = mc, 1, [mc]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            res.append((ch, 0, mult * mc, ds))
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                ladders.append(ch)
                ladder_ds.append(ds)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            chans.append(ch)
            ds *= 2
    res += [(ch, 0, ch, ds), (ch, 0, ch, ds)]
    ladders.append(ch)
    ladder_ds.append(ds)
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            res.append((ch, chans.pop(), mult * mc, ds))
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                ladders.append(ch)
                ladder_ds.append(ds)
            if level and i == cfg.num_res_blocks:
                ds //= 2
    return res, ladders, ladder_ds


def _ladder_slots(cfg: UNetConfig, c: int):
    """Per transformer block of each slot of a ladder of width c: (attn2's
    LN-fused projection width or None, self-attentions that reach K2). The
    self-ST's attn2 is a fused QKV; a cross slot's is its q; a None slot's
    attn2 is self-attention without the fused projection."""
    return [(3 * c, 2)] + [(c, 1) if cd is not None else (None, 2) for cd in cfg.context_dims]


def ln_matmul_shapes(cfg: UNetConfig, batch: int, latent_t: int, latent_f: int,
                     weight_quant: Optional[str] = None, tp: int = 1) -> dict:
    """{(M, C, N): calls} of the K3 launches of one unquantized apply_unet
    call on a [batch, latent_t, latent_f] latent: per transformer block the
    fused QKV (N = 3C), attn2's LN-fused projection and the GEGLU proj_in
    (N = 8C), with M = batch x the ladder's tokens. The calls sum to
    kernel_launches_per_forward(cfg)["ln_matmul"]. With weight_quant
    "int8": those of the K3q launches of a quantized forward, which sum to
    kernel_launches_per_forward(cfg, "int8")["ln_matmul_q"]. With ``tp``:
    one tp rank's, N / tp (the projections split by column; the
    quantization predicate takes the whole N)."""
    q = weight_quant == "int8"
    shapes: dict = {}
    _, ladders, ladder_ds = _layout(cfg)
    for c, ds in zip(ladders, ladder_ds):
        m = batch * (latent_t // ds) * (latent_f // ds)
        for attn2_n, _ in _ladder_slots(cfg, c):
            for n in (3 * c, attn2_n, 8 * c):
                if n is not None and (not q or _st_linear_quantizable(c, n)):
                    key = (m, c, n // tp)
                    shapes[key] = shapes.get(key, 0) + cfg.transformer_depth
    return shapes


def conv_shapes(cfg: UNetConfig, batch: int, latent_t: int, latent_f: int,
                weight_quant: Optional[str] = None) -> dict:
    """{(B, T, F, C1, C2, Cout): calls} of the K1 launches of one
    unquantized apply_unet call on a [batch, latent_t, latent_f] latent:
    per ResBlock the in_conv over [x1 ; x2] (C2 > 0 in the decoder, whose
    skip tensor is the second part) and the out_conv, at the block's level
    (a stride-2 SAME downsample gives ceil(n / 2)). The calls sum to
    kernel_launches_per_forward(cfg)["gn_silu_conv3x3"]. With weight_quant
    "int8": those of the K1q launches of a quantized forward, which sum to
    kernel_launches_per_forward(cfg, "int8")["gn_silu_conv3x3_q"]."""
    q = weight_quant == "int8"
    shapes: dict = {}
    res, _, _ = _layout(cfg)
    for c1, c2, cout, ds in res:
        t, f = -(-latent_t // ds), -(-latent_f // ds)
        for key in ((batch, t, f, c1, c2, cout), (batch, t, f, cout, 0, cout)):
            if not q or _conv_quantizable(key[3] + key[4], cout):
                shapes[key] = shapes.get(key, 0) + 1
    return shapes


def geglu_matmul_shapes(cfg: UNetConfig, batch: int, latent_t: int, latent_f: int,
                        weight_quant: Optional[str] = None, tp: int = 1) -> dict:
    """{(M, F, N): calls} of the K4 launches of one unquantized apply_unet
    call: per transformer block the GEGLU proj_out, h [M, 2F] with F = 4C,
    onto N = C, M = batch x the ladder's tokens. The calls sum to
    kernel_launches_per_forward(cfg)["geglu_matmul"]. With weight_quant
    "int8": those of the K4q launches of a quantized forward, which sum to
    kernel_launches_per_forward(cfg, "int8")["geglu_matmul_q"]. With ``tp``:
    one tp rank's, F / tp (the proj_out split by row, in the f32-residual
    mode; the quantization predicate takes the whole F)."""
    q = weight_quant == "int8"
    shapes: dict = {}
    _, ladders, ladder_ds = _layout(cfg)
    for c, ds in zip(ladders, ladder_ds):
        if q and not _st_linear_quantizable(4 * c, c):
            continue
        key = (batch * (latent_t // ds) * (latent_f // ds), 4 * c // tp, c)
        calls = len(_ladder_slots(cfg, c)) * cfg.transformer_depth
        shapes[key] = shapes.get(key, 0) + calls
    return shapes


def int8_matmul_shapes(cfg: UNetConfig, batch: int, latent_t: int, latent_f: int,
                       tp: int = 1) -> dict:
    """{(M, K, N): calls} of the K5 launches of one quantized apply_unet
    call (weight_quant "int8"): per transformer block the attn1 and attn2
    to_out projections, and a None slot's to_q, all [M, C] onto C where the
    quantization predicate takes C, M = batch x the ladder's tokens. The
    calls sum to kernel_launches_per_forward(cfg, "int8")["int8_matmul"].
    With ``tp``: one tp rank's, to_out at K = C / tp (split by row, in the
    f32-output mode) and the None slot's to_q at N = C / tp (by column)."""
    shapes: dict = {}
    _, ladders, ladder_ds = _layout(cfg)
    for c, ds in zip(ladders, ladder_ds):
        if not _st_linear_quantizable(c, c):
            continue
        m = batch * (latent_t // ds) * (latent_f // ds)
        for attn2_n, _ in _ladder_slots(cfg, c):
            for key, calls in (((m, c // tp, c), 2), ((m, c, c // tp), attn2_n is None)):
                if calls:
                    shapes[key] = shapes.get(key, 0) + calls * cfg.transformer_depth
    return shapes


def _plain_convs(cfg: UNetConfig, encoder: bool = False):
    """(C1, C2, Cout, taps, stride, up, GroupNorm prologue, downsampling
    factor of the input) of every conv of one forward that goes to the plain
    conv's dispatch points (``nn.conv2d``, ``gn_conv2d``, ``upsample_conv2d``,
    ``conv1x1_cat``), in the order apply_unet runs them: the stem, the
    ResBlocks' 1x1 skips (C2 > 0: the decoder's concat), each spatial
    transformer's GroupNorm + proj_in and its proj_out, the stride-2
    downsamples, the upsamples (read through the nearest 2x), the out_conv.
    ``encoder``: apply_encoder_unet's (no transformers; a 1x1 out_conv on the
    pooled [B, 1, 1, C], its factor None)."""
    mc = cfg.model_channels
    convs = [(cfg.in_channels, 0, mc, 3, 1, 1, False, 1)]
    sts = 1 + len(cfg.context_dims)
    res, ladders, ladder_ds = _layout(cfg)

    def ladder(i):
        c, ds = ladders[i], ladder_ds[i]
        return [(c, 0, c, 1, 1, 1, True, ds), (c, 0, c, 1, 1, 1, False, ds)] * sts

    li = ri = 0  # the ladders and ResBlocks walked
    for level in range(len(cfg.channel_mult)):
        for _ in range(cfg.num_res_blocks):
            c1, _, cout, ds = res[ri]
            ri += 1
            if c1 != cout:
                convs.append((c1, 0, cout, 1, 1, 1, False, ds))
            if ds in cfg.attention_resolutions:
                if not encoder:
                    convs += ladder(li)
                li += 1
        if level != len(cfg.channel_mult) - 1:
            convs.append((cout, 0, cout, 3, 2, 1, False, ds))
    ri += 2  # the middle block's ResBlocks keep their width
    if encoder:
        return convs + [(cout, 0, cfg.out_channels, 1, 1, 1, False, None)]
    convs += ladder(li)
    li += 1
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            c1, c2, cout, ds = res[ri]
            ri += 1
            if c1 + c2 != cout:
                convs.append((c1, c2, cout, 1, 1, 1, False, ds))
            if ds in cfg.attention_resolutions:
                convs += ladder(li)
                li += 1
            if level and i == cfg.num_res_blocks:
                convs.append((cout, 0, cout, 3, 1, 2, False, ds))
    return convs + [(mc, 0, cfg.out_channels, 3, 1, 1, False, 1)]


def _conv_takes(c1, c2, cout, taps, stride, up) -> bool:
    return nn.conv2d_uses_kernel((taps, taps, c1 + c2, cout), (stride, stride),
                                 ((0, 0), (0, 0)), (c1, c2) if c2 else (c1,))


def plain_conv_shapes(cfg: UNetConfig, batch: int, latent_t: int, latent_f: int) -> dict:
    """{(B, Ti, Fi, C1, C2, Cout, taps, stride, up, gn): calls} of the plain
    conv's launches in one bf16 apply_unet call on a [batch, latent_t,
    latent_f] latent, (Ti, Fi) the input's extent as stored (before the
    nearest 2x where up is 2; a stride-2 SAME conv gives ceil(n / 2)), gn
    whether the GroupNorm is folded in: every conv of ``_plain_convs`` that
    ``nn.conv2d_uses_kernel`` takes. The calls sum to
    kernel_launches_per_forward(cfg)["conv2d"]."""
    shapes: dict = {}
    for c1, c2, cout, taps, stride, up, gn, ds in _plain_convs(cfg):
        if _conv_takes(c1, c2, cout, taps, stride, up):
            key = (batch, -(-latent_t // ds), -(-latent_f // ds), c1, c2, cout, taps, stride, up,
                   gn)
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def self_attention_shapes(cfg: UNetConfig, batch: int, latent_t: int, latent_f: int) -> dict:
    """{(B, T, H, D): (calls on the chunks of a fused QKV projection, calls
    on three separate projections)} of the K2 launches of one apply_unet
    call on a [batch, latent_t, latent_f] latent. Only a None slot's attn2
    projects q, k and v separately. The calls sum to
    kernel_launches_per_forward(cfg)["flash_self_attention"]."""
    shapes: dict = {}
    d = cfg.num_head_channels
    if d not in (32, 64, 128):
        return shapes
    _, ladders, ladder_ds = _layout(cfg)
    for c, ds in zip(ladders, ladder_ds):
        key = (batch, (latent_t // ds) * (latent_f // ds), c // d, d)
        fused, separate = shapes.get(key, (0, 0))
        for attn2_n, self_attns in _ladder_slots(cfg, c):
            own = 1 if attn2_n is None else 0
            fused += (self_attns - own) * cfg.transformer_depth
            separate += own * cfg.transformer_depth
        shapes[key] = (fused, separate)
    return shapes


def kernel_launches_per_forward(cfg: UNetConfig, weight_quant: Optional[str] = None,
                                compute_dtype: str = "bfloat16") -> dict:
    """Kernel launches of one apply_unet call with a context in every
    cross slot whose ``context_dims`` entry is set, from the config and,
    for ``weight_quant="int8"``, the quantization predicates. Per ResBlock
    two convs: K1, or K1q where the conv is quantized. Per transformer
    block: the LN-fused projections (the self-attention's fused QKV; attn2's
    q in a cross slot, its fused QKV in the self-ST; the GEGLU proj_in) run
    K3 or K3q, the GEGLU proj_out K4 or K4q, the two to_out projections K5
    when quantized (else a plain matmul), and every self-attention whose
    head_dim the kernel takes runs K2 (attn1 everywhere, attn2 in the
    self-ST). A ``None`` slot's attn2 is self-attention without the fused
    projection, as in JAX: a plain LayerNorm, to_q (K5 when quantized),
    plain to_k and to_v, and K2. K6 for the final GroupNorm+SiLU.

    In bf16 (``compute_dtype``), int8 mode or not, the plain conv for every
    conv of ``plain_conv_shapes``; an f32 forward leaves those convs to
    cuDNN.

    A tp rank launches the same: every call at its narrower slice (the
    shape functions' ``tp``), the int8 predicates on the whole weights'
    shapes, the convs whole."""
    q = weight_quant == "int8"
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    counts["group_norm_silu"] = 1  # out_norm
    if compute_dtype == "bfloat16":
        counts["conv2d"] = sum(plain_conv_shapes(cfg, 1, 1, 1).values())
    res, ladders, _ = _layout(cfg)
    for c1, c2, cout, _ in res:
        for a, b in ((c1 + c2, cout), (cout, cout)):
            counts["gn_silu_conv3x3_q" if q and _conv_quantizable(a, b) else "gn_silu_conv3x3"] += 1
    kernel_heads = cfg.num_head_channels in (32, 64, 128)
    depth = cfg.transformer_depth

    def add(name, k, n, blocks):
        if q and _st_linear_quantizable(k, n):
            counts[name + "_q" if name != "linear" else "int8_matmul"] += blocks
        elif name != "linear":
            counts[name] += blocks

    for c in ladders:
        for attn2_n, self_attns in _ladder_slots(cfg, c):
            add("ln_matmul", c, 3 * c, depth)  # attn1's fused QKV
            if attn2_n is None:
                add("linear", c, c, depth)  # the None slot's to_q
            else:
                add("ln_matmul", c, attn2_n, depth)
            add("ln_matmul", c, 8 * c, depth)  # GEGLU proj_in
            add("geglu_matmul", 4 * c, c, depth)
            add("linear", c, c, 2 * depth)  # attn1 and attn2 to_out
            if kernel_heads:
                counts["flash_self_attention"] += self_attns * depth
    return counts
