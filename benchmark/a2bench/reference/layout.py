"""The parameter tree's layout: every leaf's path and shape.

A frozen copy of the init functions of ``audioldm2_torch`` (``params.py``
and the ``init_*`` of each model module), which give the JAX package's
keys and layouts, the format the program reads its weights in. Here each
leaf is an empty tensor on the ``"meta"`` device: only its shape matters,
the values come from :mod:`a2bench.weights`.
"""

from __future__ import annotations

from typing import Dict

import torch

from a2bench.reference.config import (AudioMAEConfig, CLAPConfig, ConditionerSpec,
                                      FlanT5Config, GPT2Config, HTSATConfig, ModelConfig,
                                      PhonemeEncoderConfig, RobertaConfig, UNetConfig,
                                      VAEConfig, VocoderConfig, audio_tower, text_tower)


def _leaf(*shape) -> torch.Tensor:
    return torch.empty(shape, device="meta")


def conv(kh, kw, cin, cout, bias: bool = True) -> Dict:
    p = {"w": _leaf(kh, kw, cin, cout)}
    if bias:
        p["b"] = _leaf(cout)
    return p


def conv1d(k, cin, cout) -> Dict:
    return {"w": _leaf(k, cin, cout), "b": _leaf(cout)}


def linear(cin, cout, bias: bool = True) -> Dict:
    p = {"w": _leaf(cin, cout)}
    if bias:
        p["b"] = _leaf(cout)
    return p


def norm(c) -> Dict:
    return {"scale": _leaf(c), "bias": _leaf(c)}


# --- UNet --------------------------------------------------------------------


def _resblock(cin, cout, emb_dim):
    p = {"in_norm": norm(cin), "in_conv": conv(3, 3, cin, cout), "emb": linear(emb_dim, cout),
         "out_norm": norm(cout), "out_conv": conv(3, 3, cout, cout)}
    if cin != cout:
        p["skip"] = conv(1, 1, cin, cout)
    return p


def _attn(query_dim, context_dim, inner_dim):
    ctx = context_dim if context_dim is not None else query_dim
    return {"to_q": linear(query_dim, inner_dim, bias=False),
            "to_k": linear(ctx, inner_dim, bias=False),
            "to_v": linear(ctx, inner_dim, bias=False),
            "to_out": linear(inner_dim, query_dim)}


def _st(channels, depth, context_dim):
    return {
        "norm": norm(channels),
        "proj_in": conv(1, 1, channels, channels),
        "blocks": [{"norm1": norm(channels), "attn1": _attn(channels, None, channels),
                    "norm2": norm(channels), "attn2": _attn(channels, context_dim, channels),
                    "norm3": norm(channels),
                    "ff": {"proj_in": linear(channels, channels * 8),
                           "proj_out": linear(channels * 4, channels)}}
                   for _ in range(depth)],
        "proj_out": conv(1, 1, channels, channels),
    }


def _sts(ch, cfg: UNetConfig):
    return {"self_st": _st(ch, cfg.transformer_depth, None),
            "cross_sts": [_st(ch, cfg.transformer_depth, cd) for cd in cfg.context_dims]}


def unet(cfg: UNetConfig):
    mc = cfg.model_channels
    emb_dim = cfg.emb_dim
    p = {"time_embed": {"lin1": linear(mc, cfg.time_embed_dim),
                        "lin2": linear(cfg.time_embed_dim, cfg.time_embed_dim)}}
    if cfg.extra_film_condition_dim is not None:
        p["film_emb"] = linear(cfg.extra_film_condition_dim, cfg.time_embed_dim)
    input_blocks = [{"conv": conv(3, 3, cfg.in_channels, mc)}]
    ch, ds, chans = mc, 1, [mc]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _resblock(ch, mult * mc, emb_dim)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk.update(_sts(ch, cfg))
            input_blocks.append(blk)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append({"downsample": conv(3, 3, ch, ch)})
            chans.append(ch)
            ds *= 2
    p["input_blocks"] = input_blocks
    mid = {"res1": _resblock(ch, ch, emb_dim)}
    mid.update(_sts(ch, cfg))
    mid["res2"] = _resblock(ch, ch, emb_dim)
    p["middle_block"] = mid
    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            blk = {"res": _resblock(ch + ich, mult * mc, emb_dim)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk.update(_sts(ch, cfg))
            if level and i == cfg.num_res_blocks:
                blk["upsample"] = conv(3, 3, ch, ch)
                ds //= 2
            output_blocks.append(blk)
    p["output_blocks"] = output_blocks
    p["out_norm"] = norm(ch)
    p["out_conv"] = conv(3, 3, mc, cfg.out_channels)
    return p


# --- VAE and vocoder ---------------------------------------------------------


def _vae_resblock(cin, cout):
    p = {"norm1": norm(cin), "conv1": conv(3, 3, cin, cout), "norm2": norm(cout),
         "conv2": conv(3, 3, cout, cout)}
    if cin != cout:
        p["nin_shortcut"] = conv(1, 1, cin, cout)
    return p


def _vae_attnblock(c):
    return {"norm": norm(c), "q": conv(1, 1, c, c), "k": conv(1, 1, c, c), "v": conv(1, 1, c, c),
            "proj_out": conv(1, 1, c, c)}


def _vae_mid(c):
    return {"block_1": _vae_resblock(c, c), "attn_1": _vae_attnblock(c),
            "block_2": _vae_resblock(c, c)}


def vae(cfg: VAEConfig):
    ch, mults = cfg.ch, cfg.ch_mult
    enc = {"conv_in": conv(3, 3, cfg.in_channels, ch)}
    in_mults = (1,) + tuple(mults)
    down = []
    block_in = ch
    for i, mult in enumerate(mults):
        block_in = ch * in_mults[i]
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blocks.append(_vae_resblock(block_in, ch * mult))
            block_in = ch * mult
        level = {"block": blocks}
        if i != len(mults) - 1:
            key = "downsample_ts4" if i in cfg.downsample_time_stride4_levels else "downsample"
            k = 5 if key == "downsample_ts4" else 3
            level[key] = conv(k, k, block_in, block_in)
        down.append(level)
    enc["down"] = down
    enc["mid"] = _vae_mid(block_in)
    enc["norm_out"] = norm(block_in)
    enc["conv_out"] = conv(3, 3, block_in, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)

    block_in = ch * mults[-1]
    dec = {"conv_in": conv(3, 3, cfg.z_channels, block_in), "mid": _vae_mid(block_in)}
    up = [None] * len(mults)
    for i in reversed(range(len(mults))):
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_vae_resblock(block_in, ch * mults[i]))
            block_in = ch * mults[i]
        level = {"block": blocks}
        if i != 0:
            key = "upsample_ts4" if (i - 1) in cfg.downsample_time_stride4_levels else "upsample"
            k = 5 if key == "upsample_ts4" else 3
            level[key] = conv(k, k, block_in, block_in)
        up[i] = level
    dec["up"] = up
    dec["norm_out"] = norm(block_in)
    dec["conv_out"] = conv(3, 3, block_in, cfg.out_ch)
    z2 = 2 * cfg.z_channels
    return {"encoder": enc, "decoder": dec, "quant_conv": conv(1, 1, z2, 2 * cfg.embed_dim),
            "post_quant_conv": conv(1, 1, cfg.embed_dim, cfg.z_channels)}


def vocoder(cfg: VocoderConfig):
    ch0 = cfg.upsample_initial_channel
    ups, resblocks = [], []
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cin, cout = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
        ups.append({"w": _leaf(k, cout, cin), "b": _leaf(cout)})
        for ks, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            if cfg.resblock == "1":
                resblocks.append({"convs1": [conv1d(ks, cout, cout) for _ in dils],
                                  "convs2": [conv1d(ks, cout, cout) for _ in dils]})
            else:
                resblocks.append({"convs": [conv1d(ks, cout, cout) for _ in dils]})
    return {"conv_pre": conv1d(7, cfg.num_mels, ch0), "ups": ups, "resblocks": resblocks,
            "conv_post": conv1d(7, ch0 // (2 ** len(ups)), 1)}


# --- conditioners ------------------------------------------------------------


def t5(cfg: FlanT5Config):
    inner = cfg.num_heads * cfg.d_kv
    blocks = []
    for i in range(cfg.num_layers):
        blk = {"ln1": {"scale": _leaf(cfg.d_model)},
               "attn": {n: linear(cfg.d_model if n != "o" else inner,
                                  inner if n != "o" else cfg.d_model, bias=False)
                        for n in ("q", "k", "v", "o")},
               "ln2": {"scale": _leaf(cfg.d_model)},
               "ff": {"wi_0": linear(cfg.d_model, cfg.d_ff, bias=False),
                      "wi_1": linear(cfg.d_model, cfg.d_ff, bias=False),
                      "wo": linear(cfg.d_ff, cfg.d_model, bias=False)}}
        if i == 0:
            blk["rel_bias"] = _leaf(cfg.relative_attention_num_buckets, cfg.num_heads)
        blocks.append(blk)
    return {"token_embed": _leaf(cfg.vocab_size, cfg.d_model), "blocks": blocks,
            "final_ln": {"scale": _leaf(cfg.d_model)}}


def gpt2(cfg: GPT2Config):
    d = cfg.n_embd
    blocks = [{"ln_1": norm(d), "attn": {"c_attn": linear(d, 3 * d), "c_proj": linear(d, d)},
               "ln_2": norm(d), "mlp": {"c_fc": linear(d, 4 * d), "c_proj": linear(4 * d, d)}}
              for _ in range(cfg.n_layer)]
    return {"wpe": _leaf(cfg.n_positions, d), "blocks": blocks, "ln_f": norm(d)}


def roberta(cfg: RobertaConfig):
    d = cfg.hidden_size
    layers = [{"attn": {"q": linear(d, d), "k": linear(d, d), "v": linear(d, d),
                        "out": linear(d, d), "ln": norm(d)},
               "ff": {"intermediate": linear(d, cfg.intermediate_size),
                      "output": linear(cfg.intermediate_size, d), "ln": norm(d)}}
              for _ in range(cfg.num_layers)]
    return {"word_embeddings": _leaf(cfg.vocab_size, d),
            "position_embeddings": _leaf(cfg.max_position_embeddings, d),
            "token_type_embeddings": _leaf(cfg.type_vocab_size, d), "emb_ln": norm(d),
            "layers": layers, "pooler": linear(d, d)}


def htsat(cfg: HTSATConfig):
    layers = []
    for i_layer, depth in enumerate(cfg.depths):
        dim = cfg.embed_dim * 2 ** i_layer
        heads = cfg.num_heads[i_layer]
        hidden = int(dim * cfg.mlp_ratio)
        blocks = [{"norm1": norm(dim),
                   "attn": {"qkv": linear(dim, 3 * dim), "proj": linear(dim, dim),
                            "rel_bias": _leaf((2 * cfg.window_size - 1) ** 2, heads)},
                   "norm2": norm(dim),
                   "mlp": {"fc1": linear(dim, hidden), "fc2": linear(hidden, dim)}}
                  for _ in range(depth)]
        layer = {"blocks": blocks}
        if i_layer < len(cfg.depths) - 1:
            layer["downsample"] = {"norm": norm(4 * dim),
                                   "reduction": linear(4 * dim, 2 * dim, bias=False)}
        layers.append(layer)
    sf = cfg.spec_size // (2 ** (len(cfg.depths) - 1)) // cfg.patch_stride // cfg.freq_ratio
    m = cfg.mel_bins
    return {"bn0": {"scale": _leaf(m), "bias": _leaf(m), "mean": _leaf(m), "var": _leaf(m)},
            "patch_embed": {"proj": conv(cfg.patch_size, cfg.patch_size, 1, cfg.embed_dim),
                            "norm": norm(cfg.embed_dim)},
            "layers": layers, "norm": norm(cfg.num_features),
            "tscam_conv": conv(sf, 3, cfg.num_features, cfg.num_classes),
            "head": linear(cfg.num_classes, cfg.num_classes)}


def clap(cfg: CLAPConfig):
    tcfg, twidth = text_tower(cfg)
    acfg, awidth = audio_tower(cfg)
    d = cfg.embed_dim
    return {"text_branch": roberta(tcfg),
            "text_projection": {"lin1": linear(twidth, d), "lin2": linear(d, d)},
            "text_transform": {"lin1": linear(d, d), "lin2": linear(d, d)},
            "audio_transform": {"lin1": linear(d, d), "lin2": linear(d, d)},
            "logit_scale_a": _leaf(), "logit_scale_t": _leaf(),
            "audio_projection": {"lin1": linear(awidth, d), "lin2": linear(d, d)},
            "audio_branch": htsat(acfg)}


def audiomae(cfg: AudioMAEConfig):
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)
    n_patches = (cfg.img_size[0] // cfg.patch_size) * (cfg.img_size[1] // cfg.patch_size)
    blocks = [{"norm1": norm(d), "attn": {"qkv": linear(d, 3 * d), "proj": linear(d, d)},
               "norm2": norm(d), "mlp": {"fc1": linear(d, hidden), "fc2": linear(hidden, d)}}
              for _ in range(cfg.depth)]
    return {"patch_embed": conv(cfg.patch_size, cfg.patch_size, 1, d),
            "cls_token": _leaf(1, 1, d), "pos_embed": _leaf(1, n_patches + 1, d),
            "blocks": blocks, "norm": norm(d)}


def phoneme(cfg: PhonemeEncoderConfig):
    """The VITS text encoder: per layer the q/k/v/o 1x1 convs and the
    relative key and value tables [1, 2w + 1, h / heads], two LayerNorms and
    the FFN's convs; the embedding, the m/logs head ``proj`` (drawn, never
    read) and the positional embedding."""
    h = cfg.hidden_channels
    rel = (1, 2 * cfg.window_size + 1, h // cfg.n_heads)
    layers = [{"attn": {"q": conv1d(1, h, h), "k": conv1d(1, h, h), "v": conv1d(1, h, h),
                        "o": conv1d(1, h, h), "emb_rel_k": _leaf(*rel),
                        "emb_rel_v": _leaf(*rel)},
               "ln1": norm(h),
               "ffn": {"conv1": conv1d(cfg.kernel_size, h, cfg.filter_channels),
                       "conv2": conv1d(cfg.kernel_size, cfg.filter_channels, h)},
               "ln2": norm(h)}
              for _ in range(cfg.n_layers)]
    return {"emb": _leaf(cfg.vocab_size, h), "layers": layers, "proj": conv1d(1, h, 2 * h),
            "pos_emb": _leaf(1, cfg.pad_length, h)}


def conditioner(spec: ConditionerSpec):
    if spec.kind == "flan_t5":
        return {"t5": t5(spec.flan_t5)}
    if spec.kind == "clap":
        return {"clap": clap(spec.clap)}
    if spec.kind == "audiomae_pooled":
        return {"audiomae": audiomae(spec.audiomae)}
    if spec.kind == "phoneme":
        return phoneme(spec.phoneme)
    if spec.kind == "sequence_gen":
        sg = spec.sequence_gen
        return {"sos": _leaf(32, 768), "eos": _leaf(32, 768), "gpt2": gpt2(sg.gpt2),
                "input_linears": [linear(dim, 768) for dim in sg.sequence_input_embed_dims],
                "cond": {ns.name: conditioner(ns) for ns in spec.nested}}
    raise ValueError(f"conditioner kind {spec.kind!r} is not in the reference")


def model(cfg: ModelConfig):
    """The whole tree of ``cfg``: UNet, VAE, vocoder, every conditioner
    (nested ones included), ``scale_factor`` and the reranker CLAP."""
    tree = {"unet": unet(cfg.unet), "vae": vae(cfg.vae), "vocoder": vocoder(cfg.vocoder),
            "cond": {spec.name: conditioner(spec) for spec in cfg.conditioners},
            "scale_factor": _leaf()}
    if cfg.reranker_clap is not None:
        tree["reranker_clap"] = clap(cfg.reranker_clap)
    return tree
