"""A parameter tree -> a state dict in the reference checkpoint's key layout.

The inverse of the converters (``convert.py``, ``convert_cond.py``,
``convert_htsat.py``): each function here undoes its converter's
transposes and names, so that ``convert_state_dict(reference_state_dict(
tree, cfg), cfg)`` gives ``tree`` back. It writes checkpoint files for the
tests and for ``chip_smoke.py`` (no real checkpoint is at hand, and none may
be fetched); no entry point of the port calls it.

The tree's leaves may be numpy arrays or torch tensors (on any device): the
state dict holds views of them (transposed, not copied), plus numpy arrays
for what the tool makes itself. :func:`save_pth` writes it as ``torch.save``
would write a reference checkpoint, each tensor contiguous.

    tree = complete(tree, cfg)                    # draw what the port leaves out
    sd = reference_state_dict(tree, cfg)          # the reference's keys
    save_pth(path, sd)                            # {"state_dict": sd}

Options of :func:`reference_state_dict`: the vocoder's convs as ``.weight``
(what the reference's ``state_dict()`` holds after its weight-norm removal)
or as ``weight_g``/``weight_v``; LitEma's ``model_ema.*`` shadows; a few
keys of each class the converters skip (schedule buffers,
``*.position_ids``, ``num_batches_tracked``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from audioldm2_torch.config import AudioMAEConfig, ConditionerSpec, ModelConfig


def _t(x, *axes):
    """Transpose a numpy array or a torch tensor (a view either way)."""
    return x.permute(*axes) if isinstance(x, torch.Tensor) else x.transpose(*axes)


# ---------------------------------------------------------------------------
# Primitives: the inverses of convert.conv2d_p, linear_p, norm_p, ...
# ---------------------------------------------------------------------------


def _conv2d(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["w"], 3, 2, 0, 1)  # [kh, kw, I, O] -> [O, I, kh, kw]
    sd[prefix + ".bias"] = p["b"]


def _conv1d(sd, prefix, p):  # also ConvTranspose1d: [k, O, I] -> [I, O, k]
    sd[prefix + ".weight"] = _t(p["w"], 2, 1, 0)
    sd[prefix + ".bias"] = p["b"]


def _linear(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["w"], 1, 0)
    if "b" in p:
        sd[prefix + ".bias"] = p["b"]


def _norm(sd, prefix, p):
    sd[prefix + ".weight"] = p["scale"]
    sd[prefix + ".bias"] = p["bias"]


def _wn_conv1d(sd, prefix, p, weight_norm: bool):
    w = _t(p["w"], 2, 1, 0)
    if weight_norm:
        # torch's weight_norm(dim=0): g is ||w|| over every dim but 0, shaped
        # [O, 1, 1]; v = w, so that g * v / ||v|| folds back to w
        g = (w.reshape(w.shape[0], -1) ** 2).sum(1) ** 0.5
        sd[prefix + ".weight_g"] = g.reshape((-1,) + (1,) * (w.ndim - 1))
        sd[prefix + ".weight_v"] = w
    else:
        sd[prefix + ".weight"] = w
    sd[prefix + ".bias"] = p["b"]


# ---------------------------------------------------------------------------
# VAE, vocoder, UNet
# ---------------------------------------------------------------------------


def _vae_resblock(sd, prefix, p):
    _norm(sd, prefix + ".norm1", p["norm1"])
    _conv2d(sd, prefix + ".conv1", p["conv1"])
    _norm(sd, prefix + ".norm2", p["norm2"])
    _conv2d(sd, prefix + ".conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv2d(sd, prefix + ".nin_shortcut", p["nin_shortcut"])


def _vae_attn(sd, prefix, p):
    _norm(sd, prefix + ".norm", p["norm"])
    for name in ("q", "k", "v", "proj_out"):
        _conv2d(sd, f"{prefix}.{name}", p[name])


def _vae_mid(sd, prefix, p):
    _vae_resblock(sd, prefix + ".block_1", p["block_1"])
    _vae_attn(sd, prefix + ".attn_1", p["attn_1"])
    _vae_resblock(sd, prefix + ".block_2", p["block_2"])


def vae(sd, p, prefix: str = "first_stage_model.") -> None:
    enc, dec = p["encoder"], p["decoder"]
    _conv2d(sd, prefix + "encoder.conv_in", enc["conv_in"])
    for i, level in enumerate(enc["down"]):
        for j, blk in enumerate(level["block"]):
            _vae_resblock(sd, f"{prefix}encoder.down.{i}.block.{j}", blk)
        for kind in ("downsample", "downsample_ts4"):
            if kind in level:
                _conv2d(sd, f"{prefix}encoder.down.{i}.downsample.conv", level[kind])
    _vae_mid(sd, prefix + "encoder.mid", enc["mid"])
    _norm(sd, prefix + "encoder.norm_out", enc["norm_out"])
    _conv2d(sd, prefix + "encoder.conv_out", enc["conv_out"])
    _conv2d(sd, prefix + "decoder.conv_in", dec["conv_in"])
    _vae_mid(sd, prefix + "decoder.mid", dec["mid"])
    for i, level in enumerate(dec["up"]):
        for j, blk in enumerate(level["block"]):
            _vae_resblock(sd, f"{prefix}decoder.up.{i}.block.{j}", blk)
        for kind in ("upsample", "upsample_ts4"):
            if kind in level:
                _conv2d(sd, f"{prefix}decoder.up.{i}.upsample.conv", level[kind])
    _norm(sd, prefix + "decoder.norm_out", dec["norm_out"])
    _conv2d(sd, prefix + "decoder.conv_out", dec["conv_out"])
    _conv2d(sd, prefix + "quant_conv", p["quant_conv"])
    _conv2d(sd, prefix + "post_quant_conv", p["post_quant_conv"])


def vocoder(sd, p, weight_norm: bool = False,
            prefix: str = "first_stage_model.vocoder.") -> None:
    _wn_conv1d(sd, prefix + "conv_pre", p["conv_pre"], weight_norm)
    for i, up in enumerate(p["ups"]):
        _wn_conv1d(sd, f"{prefix}ups.{i}", up, weight_norm)
    for idx, rb in enumerate(p["resblocks"]):
        for name in ("convs1", "convs2", "convs"):
            for m, conv in enumerate(rb.get(name, ())):
                _wn_conv1d(sd, f"{prefix}resblocks.{idx}.{name}.{m}", conv, weight_norm)
    _wn_conv1d(sd, prefix + "conv_post", p["conv_post"], weight_norm)


def _st_block(sd, prefix, p):
    _norm(sd, prefix + ".norm1", p["norm1"])
    _norm(sd, prefix + ".norm2", p["norm2"])
    _norm(sd, prefix + ".norm3", p["norm3"])
    for attn in ("attn1", "attn2"):
        for name in ("to_q", "to_k", "to_v"):
            _linear(sd, f"{prefix}.{attn}.{name}", p[attn][name])
        _linear(sd, f"{prefix}.{attn}.to_out.0", p[attn]["to_out"])
    _linear(sd, prefix + ".ff.net.0.proj", p["ff"]["proj_in"])
    _linear(sd, prefix + ".ff.net.2", p["ff"]["proj_out"])


def _spatial_transformer(sd, prefix, p):
    _norm(sd, prefix + ".norm", p["norm"])
    _conv2d(sd, prefix + ".proj_in", p["proj_in"])
    for d, blk in enumerate(p["blocks"]):
        _st_block(sd, f"{prefix}.transformer_blocks.{d}", blk)
    _conv2d(sd, prefix + ".proj_out", p["proj_out"])


def _unet_resblock(sd, prefix, p):
    _norm(sd, prefix + ".in_layers.0", p["in_norm"])
    _conv2d(sd, prefix + ".in_layers.2", p["in_conv"])
    _linear(sd, prefix + ".emb_layers.1", p["emb"])
    _norm(sd, prefix + ".out_layers.0", p["out_norm"])
    _conv2d(sd, prefix + ".out_layers.3", p["out_conv"])
    if "skip" in p:
        _conv2d(sd, prefix + ".skip_connection", p["skip"])


def _sts(sd, block_prefix, blk) -> int:
    """The self-ST and the cross-STs at consecutive layer indices from 1;
    returns the next free index."""
    if "self_st" not in blk:
        return 1
    _spatial_transformer(sd, f"{block_prefix}.1", blk["self_st"])
    for i, st in enumerate(blk["cross_sts"]):
        _spatial_transformer(sd, f"{block_prefix}.{2 + i}", st)
    return 2 + len(blk["cross_sts"])


def unet(sd, p, prefix: str = "model.diffusion_model.") -> None:
    """The reference UNetModel's construction order (openaimodel.py:476-819),
    as ``convert.convert_unet`` walks it."""
    _linear(sd, prefix + "time_embed.0", p["time_embed"]["lin1"])
    _linear(sd, prefix + "time_embed.2", p["time_embed"]["lin2"])
    if "film_emb" in p:
        _linear(sd, prefix + "film_emb", p["film_emb"])
    for idx, blk in enumerate(p["input_blocks"]):
        bp = f"{prefix}input_blocks.{idx}"
        if "conv" in blk:
            _conv2d(sd, bp + ".0", blk["conv"])
        elif "downsample" in blk:
            _conv2d(sd, bp + ".0.op", blk["downsample"])
        else:
            _unet_resblock(sd, bp + ".0", blk["res"])
            _sts(sd, bp, blk)
    mid = p["middle_block"]
    _unet_resblock(sd, prefix + "middle_block.0", mid["res1"])
    nxt = _sts(sd, prefix + "middle_block", mid)
    _unet_resblock(sd, f"{prefix}middle_block.{nxt}", mid["res2"])
    for idx, blk in enumerate(p["output_blocks"]):
        bp = f"{prefix}output_blocks.{idx}"
        _unet_resblock(sd, bp + ".0", blk["res"])
        nxt = _sts(sd, bp, blk)
        if "upsample" in blk:
            _conv2d(sd, f"{bp}.{nxt}.conv", blk["upsample"])
    _norm(sd, prefix + "out.0", p["out_norm"])
    _conv2d(sd, prefix + "out.2", p["out_conv"])


# ---------------------------------------------------------------------------
# Text towers, CLAP, HTSAT
# ---------------------------------------------------------------------------


def t5_encoder(sd, p, prefix: str) -> None:
    """HF T5EncoderModel: ``shared`` and the tied ``encoder.embed_tokens``,
    both stored, as its ``state_dict()`` has them."""
    sd[prefix + "shared.weight"] = p["token_embed"]
    sd[prefix + "encoder.embed_tokens.weight"] = p["token_embed"]
    for i, blk in enumerate(p["blocks"]):
        bp = f"{prefix}encoder.block.{i}.layer"
        sd[f"{bp}.0.layer_norm.weight"] = blk["ln1"]["scale"]
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{bp}.0.SelfAttention.{name}", blk["attn"][name])
        if "rel_bias" in blk:
            sd[f"{bp}.0.SelfAttention.relative_attention_bias.weight"] = blk["rel_bias"]
        sd[f"{bp}.1.layer_norm.weight"] = blk["ln2"]["scale"]
        for name in ("wi_0", "wi_1", "wo"):
            _linear(sd, f"{bp}.1.DenseReluDense.{name}", blk["ff"][name])
    sd[prefix + "encoder.final_layer_norm.weight"] = p["final_ln"]["scale"]


def gpt2(sd, p, prefix: str) -> None:
    """HF GPT2Model: Conv1D weights are stored [in, out], as the tree has them."""
    def conv1d(name, q):
        sd[name + ".weight"], sd[name + ".bias"] = q["w"], q["b"]

    for i, blk in enumerate(p["blocks"]):
        bp = f"{prefix}h.{i}"
        _norm(sd, bp + ".ln_1", blk["ln_1"])
        conv1d(bp + ".attn.c_attn", blk["attn"]["c_attn"])
        conv1d(bp + ".attn.c_proj", blk["attn"]["c_proj"])
        _norm(sd, bp + ".ln_2", blk["ln_2"])
        conv1d(bp + ".mlp.c_fc", blk["mlp"]["c_fc"])
        conv1d(bp + ".mlp.c_proj", blk["mlp"]["c_proj"])
    sd[prefix + "wpe.weight"] = p["wpe"]
    _norm(sd, prefix + "ln_f", p["ln_f"])


def roberta(sd, p, prefix: str) -> None:
    for i, layer in enumerate(p["layers"]):
        lp = f"{prefix}encoder.layer.{i}"
        a, f = layer["attn"], layer["ff"]
        _linear(sd, lp + ".attention.self.query", a["q"])
        _linear(sd, lp + ".attention.self.key", a["k"])
        _linear(sd, lp + ".attention.self.value", a["v"])
        _linear(sd, lp + ".attention.output.dense", a["out"])
        _norm(sd, lp + ".attention.output.LayerNorm", a["ln"])
        _linear(sd, lp + ".intermediate.dense", f["intermediate"])
        _linear(sd, lp + ".output.dense", f["output"])
        _norm(sd, lp + ".output.LayerNorm", f["ln"])
    sd[prefix + "embeddings.word_embeddings.weight"] = p["word_embeddings"]
    sd[prefix + "embeddings.position_embeddings.weight"] = p["position_embeddings"]
    sd[prefix + "embeddings.token_type_embeddings.weight"] = p["token_type_embeddings"]
    _norm(sd, prefix + "embeddings.LayerNorm", p["emb_ln"])
    _linear(sd, prefix + "pooler.dense", p["pooler"])


def htsat(sd, p, prefix: str) -> None:
    for i, layer in enumerate(p["layers"]):
        lp = f"{prefix}layers.{i}"
        for j, blk in enumerate(layer["blocks"]):
            bp = f"{lp}.blocks.{j}"
            _norm(sd, bp + ".norm1", blk["norm1"])
            _linear(sd, bp + ".attn.qkv", blk["attn"]["qkv"])
            _linear(sd, bp + ".attn.proj", blk["attn"]["proj"])
            sd[bp + ".attn.relative_position_bias_table"] = blk["attn"]["rel_bias"]
            _norm(sd, bp + ".norm2", blk["norm2"])
            _linear(sd, bp + ".mlp.fc1", blk["mlp"]["fc1"])
            _linear(sd, bp + ".mlp.fc2", blk["mlp"]["fc2"])
        if "downsample" in layer:
            _norm(sd, f"{lp}.downsample.norm", layer["downsample"]["norm"])
            _linear(sd, f"{lp}.downsample.reduction", layer["downsample"]["reduction"])
    bn = p["bn0"]
    sd[prefix + "bn0.weight"], sd[prefix + "bn0.bias"] = bn["scale"], bn["bias"]
    sd[prefix + "bn0.running_mean"], sd[prefix + "bn0.running_var"] = bn["mean"], bn["var"]
    _conv2d(sd, prefix + "patch_embed.proj", p["patch_embed"]["proj"])
    _norm(sd, prefix + "patch_embed.norm", p["patch_embed"]["norm"])
    _norm(sd, prefix + "norm", p["norm"])
    _conv2d(sd, prefix + "tscam_conv", p["tscam_conv"])
    _linear(sd, prefix + "head", p["head"])


def clap(sd, p, prefix: str) -> None:
    roberta(sd, p["text_branch"], prefix + "text_branch.")
    for head, (a, b) in (("text_projection", (0, 2)), ("audio_projection", (0, 2)),
                         ("text_transform", (0, 3)), ("audio_transform", (0, 3))):
        seq = ".sequential" if head.endswith("transform") else ""
        _linear(sd, f"{prefix}{head}{seq}.{a}", p[head]["lin1"])
        _linear(sd, f"{prefix}{head}{seq}.{b}", p[head]["lin2"])
    sd[prefix + "logit_scale_a"] = p["logit_scale_a"]
    sd[prefix + "logit_scale_t"] = p["logit_scale_t"]
    htsat(sd, p["audio_branch"], prefix + "audio_branch.")


# ---------------------------------------------------------------------------
# Conditioners
# ---------------------------------------------------------------------------


def phoneme(sd, p, prefix: str) -> None:
    te = prefix + "text_encoder."
    for i, layer in enumerate(p["layers"]):
        ap = f"{te}encoder.attn_layers.{i}"
        for name in ("q", "k", "v", "o"):
            _conv1d(sd, f"{ap}.conv_{name}", layer["attn"][name])
        sd[ap + ".emb_rel_k"] = layer["attn"]["emb_rel_k"]
        sd[ap + ".emb_rel_v"] = layer["attn"]["emb_rel_v"]
        for n, ln in ((1, "ln1"), (2, "ln2")):
            sd[f"{te}encoder.norm_layers_{n}.{i}.gamma"] = layer[ln]["scale"]
            sd[f"{te}encoder.norm_layers_{n}.{i}.beta"] = layer[ln]["bias"]
        _conv1d(sd, f"{te}encoder.ffn_layers.{i}.conv_1", layer["ffn"]["conv1"])
        _conv1d(sd, f"{te}encoder.ffn_layers.{i}.conv_2", layer["ffn"]["conv2"])
    sd[te + "emb.weight"] = p["emb"]
    _conv1d(sd, te + "proj", p["proj"])
    sd[prefix + "learnable_positional_embedding"] = _t(p["pos_emb"], 0, 2, 1)


def audiomae(sd, p, prefix: str) -> None:
    mp = prefix + "audiomae.model."
    enc = p["audiomae"]
    for i, blk in enumerate(enc["blocks"]):
        bp = f"{mp}blocks.{i}"
        _norm(sd, bp + ".norm1", blk["norm1"])
        _linear(sd, bp + ".attn.qkv", blk["attn"]["qkv"])
        _linear(sd, bp + ".attn.proj", blk["attn"]["proj"])
        _norm(sd, bp + ".norm2", blk["norm2"])
        _linear(sd, bp + ".mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, bp + ".mlp.fc2", blk["mlp"]["fc2"])
    _conv2d(sd, mp + "patch_embed.proj", enc["patch_embed"])
    sd[mp + "cls_token"] = enc["cls_token"]
    sd[mp + "pos_embed"] = enc["pos_embed"]
    _norm(sd, mp + "norm", enc["norm"])


def sequence_gen(sd, p, spec: ConditionerSpec, prefix: str) -> None:
    sd[prefix + "start_of_sequence_tokens.weight"] = p["sos"]
    sd[prefix + "end_of_sequence_tokens.weight"] = p["eos"]
    gpt2(sd, p["gpt2"], prefix + "model.")
    for i, lin in enumerate(p["input_linears"]):
        _linear(sd, f"{prefix}input_sequence_embed_linear.{i}", lin)
    for j, ns in enumerate(spec.nested):
        conditioner(sd, p["cond"][ns.name], ns, f"{prefix}cond_stage_models.{j}.")


def conditioner(sd, p, spec: ConditionerSpec, prefix: str) -> None:
    if spec.kind == "flan_t5":
        t5_encoder(sd, p["t5"], prefix + "model.")
    elif spec.kind == "clap":
        clap(sd, p["clap"], prefix + "model.")
    elif spec.kind == "phoneme":
        phoneme(sd, p, prefix)
    elif spec.kind == "audiomae_pooled":
        audiomae(sd, p, prefix)
    elif spec.kind == "sequence_gen":
        sequence_gen(sd, p, spec, prefix)
    else:
        raise ValueError(f"unknown conditioner kind {spec.kind!r}")


# ---------------------------------------------------------------------------
# The whole checkpoint
# ---------------------------------------------------------------------------


def audiomae_tree(cfg: AudioMAEConfig, rng: np.random.Generator) -> Dict:
    """An AudioMAE encoder tree at ``cfg``'s shapes, every leaf drawn from
    N(0, 0.02) in float32 (the JAX package's ``init_audiomae`` layout)."""
    d, hidden = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    n_patches = (cfg.img_size[0] // cfg.patch_size) * (cfg.img_size[1] // cfg.patch_size)

    def draw(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def lin(cin, cout):
        return {"w": draw(cin, cout), "b": draw(cout)}

    def norm():
        return {"scale": draw(d), "bias": draw(d)}

    return {"audiomae": {
        "patch_embed": {"w": draw(cfg.patch_size, cfg.patch_size, 1, d), "b": draw(d)},
        "cls_token": draw(1, 1, d),
        "pos_embed": draw(1, n_patches + 1, d),
        "blocks": [{"norm1": norm(), "attn": {"qkv": lin(d, 3 * d), "proj": lin(d, d)},
                    "norm2": norm(), "mlp": {"fc1": lin(d, hidden), "fc2": lin(hidden, d)}}
                   for _ in range(cfg.depth)],
        "norm": norm(),
    }}


def complete(tree: Dict, cfg: ModelConfig, seed: int = 0) -> Dict:
    """``tree`` with the subtrees that a real checkpoint has and the port's
    ``init_params`` does not draw: the nested AudioMAE encoder of a sequence
    generator (no ported path encodes it), drawn by :func:`audiomae_tree`
    from ``seed``. The rest is shared with ``tree``, not copied."""
    rng = np.random.default_rng(seed)

    def fill(p, spec: ConditionerSpec):
        if spec.kind != "sequence_gen":
            return p
        cond = dict(p["cond"])
        for ns in spec.nested:
            if ns.name not in cond and ns.kind == "audiomae_pooled":
                cond[ns.name] = audiomae_tree(ns.audiomae, rng)
            elif ns.name in cond:
                cond[ns.name] = fill(cond[ns.name], ns)
        return {**p, "cond": cond}

    return {**tree, "cond": {s.name: fill(tree["cond"][s.name], s) for s in cfg.conditioners}}


def reference_state_dict(tree: Dict, cfg: ModelConfig, *, weight_norm: bool = False,
                         ema: bool = False, skip_keys: bool = False) -> Dict:
    """The reference ``LatentDiffusion.state_dict()`` layout of ``tree``
    (which must hold every subtree the converters read: see
    :func:`complete`).

    ``weight_norm``: the vocoder's convs as ``weight_g``/``weight_v``
    (folding them back is exact to rounding only) instead of ``.weight``.
    ``ema``: LitEma's shadows of the UNet, ``model_ema.<name without
    dots>`` (from ``tree["unet_ema"]`` when present, else the UNet's own
    values), with its ``decay`` and ``num_updates``. ``skip_keys``: a few
    keys of each class the converters ignore."""
    sd: Dict = {}
    unet(sd, tree["unet"])
    vae(sd, tree["vae"])
    vocoder(sd, tree["vocoder"], weight_norm)
    sd["scale_factor"] = tree["scale_factor"]
    for idx, spec in enumerate(cfg.conditioners):
        conditioner(sd, tree["cond"][spec.name], spec, f"cond_stage_models.{idx}.")
    if tree.get("reranker_clap") is not None:
        clap(sd, tree["reranker_clap"], "clap.model.")
    if ema:
        shadow: Dict = {}
        unet(shadow, tree.get("unet_ema", tree["unet"]))
        for k, v in shadow.items():  # "model.diffusion_model.x.0.w" -> "diffusion_modelx0w"
            sd["model_ema." + k[len("model."):].replace(".", "")] = v
        sd["model_ema.decay"] = np.asarray(0.9999, np.float32)
        sd["model_ema.num_updates"] = np.asarray(1150000, np.int64)
    if skip_keys:
        _add_skip_keys(sd, cfg)
    return sd


def _add_skip_keys(sd: Dict, cfg: ModelConfig) -> None:
    """Schedule buffers, RoBERTa's ``position_ids`` and HTSAT's BatchNorm
    ``num_batches_tracked`` under every CLAP prefix present."""
    n = cfg.diffusion.timesteps
    betas = np.linspace(cfg.diffusion.linear_start, cfg.diffusion.linear_end, n, dtype=np.float32)
    sd["betas"] = betas
    sd["alphas_cumprod"] = np.cumprod(1.0 - betas).astype(np.float32)
    sd["logvar"] = np.zeros((n,), np.float32)
    for k in [k for k in sd if k.endswith("text_branch.embeddings.word_embeddings.weight")]:
        clap_prefix = k[: -len("text_branch.embeddings.word_embeddings.weight")]
        n_pos = sd[clap_prefix + "text_branch.embeddings.position_embeddings.weight"].shape[0]
        sd[clap_prefix + "text_branch.embeddings.position_ids"] = np.arange(
            n_pos, dtype=np.int64)[None]
        sd[clap_prefix + "audio_branch.bn0.num_batches_tracked"] = np.asarray(0, np.int64)


def save_pth(path: str, sd: Dict, wrapped: bool = True) -> None:
    """``torch.save`` the state dict, as ``{"state_dict": sd}`` when
    ``wrapped`` (a Lightning checkpoint's form), every value a contiguous
    tensor (a tensor on the card is written from it, storage by storage)."""
    made: Dict[int, torch.Tensor] = {}  # one tensor per array: the tied T5 embedding

    def tensor(v):
        if id(v) not in made:
            made[id(v)] = (v.contiguous() if isinstance(v, torch.Tensor)
                           else torch.from_numpy(np.array(v, order="C")))
        return made[id(v)]

    tensors = {k: tensor(v) for k, v in sd.items()}
    torch.save({"state_dict": tensors} if wrapped else tensors, path)

