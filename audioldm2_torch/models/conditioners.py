"""Conditioning stack of the port: the ``flan_t5``, ``clap`` (text mode),
``phoneme`` and ``sequence_gen`` kinds.

Port of ``audioldm2_tpu/models/conditioners.py``. Each conditioner returns
``("crossattn", (ctx [B, L, D], mask [B, L]))`` or ``("film", emb)`` and
has an unconditional variant for classifier-free guidance. The AudioMAE
kind and CLAP's audio mode wait for their ROADMAP items and raise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from audioldm2_torch.config import ConditionerSpec
from audioldm2_torch.models import clap as clap_model
from audioldm2_torch.models import phoneme as ph_model
from audioldm2_torch.models import sequence_gen as sg_model
from audioldm2_torch.models import t5 as t5_model
from audioldm2_torch.params import Init

_NOT_PORTED = {"audiomae_pooled": "ROADMAP queue 1 item 10 (AudioMAE)"}


def check_kind(spec: ConditionerSpec) -> None:
    """Raise for a kind (or a nested input of a sequence generator) that is
    not ported."""
    if spec.kind == "clap":
        if spec.clap.embed_mode != "text":
            raise NotImplementedError(
                "CLAP audio embedding mode is not ported to audioldm2_torch yet "
                "(ROADMAP queue 1 item 9: HTSAT)"
            )
        clap_model.text_tower(spec.clap)
    elif spec.kind == "sequence_gen":
        for ns in sg_model.input_specs(spec):
            check_kind(ns)
    elif spec.kind not in ("flan_t5", "phoneme"):
        where = _NOT_PORTED.get(spec.kind, "no ROADMAP item")
        raise NotImplementedError(
            f"conditioner kind {spec.kind!r} is not ported to audioldm2_torch yet ({where})"
        )


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x] * n, dim=0) if n > 1 else x


def init_conditioner(ini: Init, spec: ConditionerSpec):
    check_kind(spec)
    if spec.kind == "clap":
        return {"clap": clap_model.init_clap(ini, spec.clap)}
    if spec.kind == "sequence_gen":
        return sg_model.init_sequence_gen(ini, spec)
    if spec.kind == "phoneme":
        return ph_model.init_phoneme_encoder(ini, spec.phoneme)
    return {"t5": t5_model.init_t5_encoder(ini, spec.flan_t5)}


def encode(params, spec: ConditionerSpec, batch) -> Tuple[str, object]:
    check_kind(spec)
    if spec.kind == "clap":
        return "film", clap_model.text_embedding(params["clap"], spec.clap, batch["clap_ids"],
                                                 batch["clap_mask"])
    if spec.kind == "sequence_gen":
        tokens = sg_model.generate(params, spec, batch)
        return "crossattn", (tokens, torch.ones(tokens.shape[:2], device=tokens.device))
    if spec.kind == "phoneme":
        return "crossattn", ph_model.apply_phoneme_encoder(params, spec.phoneme,
                                                           batch["phoneme_idx"])
    ctx = t5_model.apply_t5_encoder(params["t5"], spec.flan_t5, batch["t5_ids"], batch["t5_mask"])
    return "crossattn", (ctx, batch["t5_mask"].float())


def unconditional(params, spec: ConditionerSpec, batch, batchsize: int) -> Tuple[str, object]:
    check_kind(spec)
    if spec.kind == "clap":
        emb = clap_model.text_embedding(params["clap"], spec.clap, batch["clap_uncond_ids"],
                                        batch["clap_uncond_mask"])
        return "film", _tile(emb, batchsize)
    if spec.kind == "sequence_gen":
        # zeros of the generated length with an all-ones mask
        n = spec.sequence_gen.sequence_gen_length
        dev = batch["clap_ids"].device
        return "crossattn", (torch.zeros((batchsize, n, 768), device=dev),
                             torch.ones((batchsize, n), device=dev))
    if spec.kind == "phoneme":  # the encoding of an all-pad input
        ph = spec.phoneme
        pad = torch.full((batchsize, ph.pad_length), ph.pad_token_id, dtype=torch.int32,
                         device=batch["phoneme_idx"].device)
        return "crossattn", ph_model.apply_phoneme_encoder(params, ph, pad)
    ctx = t5_model.apply_t5_encoder(
        params["t5"], spec.flan_t5, batch["t5_uncond_ids"], batch["t5_uncond_mask"]
    )
    return "crossattn", (_tile(ctx, batchsize), _tile(batch["t5_uncond_mask"].float(), batchsize))
