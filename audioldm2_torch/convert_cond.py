"""Checkpoint conversion for the conditioning stack.

The port's copy of ``audioldm2_tpu/convert_cond.py`` (a test holds the two
equal on the same state dicts). Maps the reference's
``cond_stage_models.<i>.`` namespaces (and the nested
``cond_stage_models.<i>.cond_stage_models.<j>.`` of SequenceGenAudioMAECond)
onto the conditioner trees of :mod:`audioldm2_torch.models.conditioners`,
the nested AudioMAE encoder included, which no ported path reads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from audioldm2_torch import convert
from audioldm2_torch.config import ConditionerSpec


def convert_phoneme(sd: Dict[str, np.ndarray], spec: ConditionerSpec, prefix: str) -> dict:
    """PhonemeEncoder (reference encoders/modules.py:30-110 +
    phoneme_encoder/{encoder,attentions}.py)."""
    cfg = spec.phoneme
    te = prefix + "text_encoder."
    layers = []
    for i in range(cfg.n_layers):
        ap = f"{te}encoder.attn_layers.{i}"
        layers.append(
            {
                "attn": {
                    "q": convert.conv1d_p(sd, ap + ".conv_q"),
                    "k": convert.conv1d_p(sd, ap + ".conv_k"),
                    "v": convert.conv1d_p(sd, ap + ".conv_v"),
                    "o": convert.conv1d_p(sd, ap + ".conv_o"),
                    "emb_rel_k": sd[ap + ".emb_rel_k"],
                    "emb_rel_v": sd[ap + ".emb_rel_v"],
                },
                "ln1": {
                    "scale": sd[f"{te}encoder.norm_layers_1.{i}.gamma"],
                    "bias": sd[f"{te}encoder.norm_layers_1.{i}.beta"],
                },
                "ffn": {
                    "conv1": convert.conv1d_p(sd, f"{te}encoder.ffn_layers.{i}.conv_1"),
                    "conv2": convert.conv1d_p(sd, f"{te}encoder.ffn_layers.{i}.conv_2"),
                },
                "ln2": {
                    "scale": sd[f"{te}encoder.norm_layers_2.{i}.gamma"],
                    "bias": sd[f"{te}encoder.norm_layers_2.{i}.beta"],
                },
            }
        )
    return {
        "emb": sd[te + "emb.weight"],
        "layers": layers,
        "proj": convert.conv1d_p(sd, te + "proj"),
        # [1, 192, pad_length] -> [1, pad_length, 192]
        "pos_emb": sd[prefix + "learnable_positional_embedding"].transpose(0, 2, 1),
    }


def convert_audiomae(sd: Dict[str, np.ndarray], spec: ConditionerSpec, prefix: str) -> dict:
    """Vanilla_AudioMAE encoder (reference modules/audiomae/models_mae.py).
    Decoder weights in the checkpoint are ignored (inference never uses
    them, AudioMAE.py:120-138)."""
    cfg = spec.audiomae
    mp = prefix + "audiomae.model."
    blocks = []
    for i in range(cfg.depth):
        bp = f"{mp}blocks.{i}"
        blocks.append(
            {
                "norm1": convert.norm_p(sd, bp + ".norm1"),
                "attn": {
                    "qkv": convert.linear_p(sd, bp + ".attn.qkv"),
                    "proj": convert.linear_p(sd, bp + ".attn.proj"),
                },
                "norm2": convert.norm_p(sd, bp + ".norm2"),
                "mlp": {
                    "fc1": convert.linear_p(sd, bp + ".mlp.fc1"),
                    "fc2": convert.linear_p(sd, bp + ".mlp.fc2"),
                },
            }
        )
    return {
        "audiomae": {
            "patch_embed": convert.conv2d_p(sd, mp + "patch_embed.proj"),
            "cls_token": sd[mp + "cls_token"],
            "pos_embed": sd[mp + "pos_embed"],
            "blocks": blocks,
            "norm": convert.norm_p(sd, mp + "norm"),
        }
    }


def convert_sequence_gen(sd: Dict[str, np.ndarray], spec: ConditionerSpec, prefix: str) -> dict:
    """SequenceGenAudioMAECond (reference audiomae_gen/sequence_input.py)."""
    sg = spec.sequence_gen
    params = {
        "sos": sd[prefix + "start_of_sequence_tokens.weight"],
        "eos": sd[prefix + "end_of_sequence_tokens.weight"],
        "gpt2": convert.convert_gpt2(sd, n_layer=sg.gpt2.n_layer, prefix=prefix + "model."),
        "input_linears": [
            convert.linear_p(sd, f"{prefix}input_sequence_embed_linear.{i}")
            for i in range(len(sg.sequence_input_embed_dims))
        ],
        "cond": {},
    }
    for j, ns in enumerate(spec.nested):
        nested_prefix = f"{prefix}cond_stage_models.{j}."
        params["cond"][ns.name] = convert_conditioner(sd, ns, nested_prefix)
    return params


def convert_conditioner(sd: Dict[str, np.ndarray], spec: ConditionerSpec, prefix: str) -> dict:
    if spec.kind == "flan_t5":
        return {"t5": convert.convert_t5_encoder(sd, spec.flan_t5, prefix + "model.")}
    if spec.kind == "clap":
        return {"clap": convert.convert_clap(sd, prefix + "model.")}
    if spec.kind == "phoneme":
        return convert_phoneme(sd, spec, prefix)
    if spec.kind == "audiomae_pooled":
        return convert_audiomae(sd, spec, prefix)
    if spec.kind == "sequence_gen":
        return convert_sequence_gen(sd, spec, prefix)
    raise ValueError(f"unknown conditioner kind {spec.kind!r}")
