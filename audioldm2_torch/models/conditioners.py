"""Conditioning stack of the port: the ``flan_t5``, ``audiomae_pooled``,
``clap`` (text and audio embedding modes), ``phoneme`` and
``sequence_gen`` kinds.

Port of ``audioldm2_tpu/models/conditioners.py``. Each conditioner returns
``("crossattn", (ctx [B, L, D], mask [B, L]))`` or ``("film", emb)`` and
has an unconditional variant for classifier-free guidance. Batch keys (made
by ``AudioLDM2.make_batch``): ``t5_*`` and ``clap_*`` token ids and masks
(``*_uncond_*`` of ""), ``phoneme_idx``, ``ta_kaldi_fbank`` [B, 1024, 128]
(AudioMAE's input) and, for a CLAP in audio mode, ``clap_waveform_48k``
[B, clip_samples].
"""

from __future__ import annotations

from typing import Tuple

import torch

from audioldm2_torch.config import ConditionerSpec
from audioldm2_torch.models import audiomae as mae_model
from audioldm2_torch.models import clap as clap_model
from audioldm2_torch.models import phoneme as ph_model
from audioldm2_torch.models import sequence_gen as sg_model
from audioldm2_torch.models import t5 as t5_model
from audioldm2_torch.params import Init


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x] * n, dim=0) if n > 1 else x


def _ones_mask(ctx: torch.Tensor) -> torch.Tensor:
    return torch.ones(ctx.shape[:2], device=ctx.device)


# FLAN-T5


def _t5_init(ini, spec):
    return {"t5": t5_model.init_t5_encoder(ini, spec.flan_t5)}


def _t5_encode(params, spec, batch):
    ctx = t5_model.apply_t5_encoder(params["t5"], spec.flan_t5, batch["t5_ids"], batch["t5_mask"])
    return "crossattn", (ctx, batch["t5_mask"].float())


def _t5_uncond(params, spec, batch, batchsize):
    ctx = t5_model.apply_t5_encoder(
        params["t5"], spec.flan_t5, batch["t5_uncond_ids"], batch["t5_uncond_mask"])
    return "crossattn", (_tile(ctx, batchsize), _tile(batch["t5_uncond_mask"].float(), batchsize))


# AudioMAE, pooled


def audiomae_token_num(spec: ConditionerSpec) -> int:
    """Tokens of the pooled AudioMAE output: 512 / (time_pool * freq_pool)."""
    tp = min(spec.audiomae.eval_time_pooling, mae_model.GRID[0])
    fp = min(spec.audiomae.eval_freq_pooling, mae_model.GRID[1])
    return int(512 / (tp * fp))


def _audiomae_init(ini, spec):
    return {"audiomae": mae_model.init_audiomae(ini, spec.audiomae)}


def _audiomae_encode(params, spec, batch):
    tokens = mae_model.encode_no_mask(params["audiomae"], spec.audiomae,
                                      batch["ta_kaldi_fbank"].float())
    pooled = mae_model.avg_max_pool(tokens, spec.audiomae)
    if spec.audiomae.regularization:
        pooled = mae_model.l2_regularize(pooled)
    return "crossattn", (pooled, _ones_mask(pooled))


def _audiomae_uncond(params, spec, batch, batchsize):
    zeros = torch.zeros((batchsize, audiomae_token_num(spec), 768),
                        device=batch["ta_kaldi_fbank"].device)
    return "crossattn", (zeros, _ones_mask(zeros))


# CLAP: the text embedding, or in audio mode the embedding of the
# conditioning clip; the unconditional branch is the "" text embedding in both


def _clap_init(ini, spec):
    return {"clap": clap_model.init_clap(ini, spec.clap)}


def _clap_encode(params, spec, batch):
    if spec.clap.embed_mode == "audio":
        return "film", clap_model.audio_embedding(params["clap"], spec.clap,
                                                  batch["clap_waveform_48k"])
    return "film", clap_model.text_embedding(params["clap"], spec.clap, batch["clap_ids"],
                                             batch["clap_mask"])


def _clap_uncond(params, spec, batch, batchsize):
    emb = clap_model.text_embedding(params["clap"], spec.clap, batch["clap_uncond_ids"],
                                    batch["clap_uncond_mask"])
    return "film", _tile(emb, batchsize)


# VITS phoneme encoder


def _phoneme_init(ini, spec):
    return ph_model.init_phoneme_encoder(ini, spec.phoneme)


def _phoneme_encode(params, spec, batch):
    return "crossattn", ph_model.apply_phoneme_encoder(params, spec.phoneme, batch["phoneme_idx"])


def _phoneme_uncond(params, spec, batch, batchsize):  # the encoding of an all-pad input
    ph = spec.phoneme
    pad = torch.full((batchsize, ph.pad_length), ph.pad_token_id, dtype=torch.int32,
                     device=batch["phoneme_idx"].device)
    return "crossattn", ph_model.apply_phoneme_encoder(params, ph, pad)


# GPT-2 sequence generator


def _seqgen_encode(params, spec, batch):
    tokens = sg_model.generate(params, spec, batch)
    return "crossattn", (tokens, _ones_mask(tokens))


def _seqgen_uncond(params, spec, batch, batchsize):  # zeros of the generated length
    zeros = torch.zeros((batchsize, spec.sequence_gen.sequence_gen_length, 768),
                        device=batch["clap_ids"].device)
    return "crossattn", (zeros, _ones_mask(zeros))


REGISTRY = {
    "flan_t5": (_t5_init, _t5_encode, _t5_uncond),
    "audiomae_pooled": (_audiomae_init, _audiomae_encode, _audiomae_uncond),
    "clap": (_clap_init, _clap_encode, _clap_uncond),
    "phoneme": (_phoneme_init, _phoneme_encode, _phoneme_uncond),
    "sequence_gen": (sg_model.init_sequence_gen, _seqgen_encode, _seqgen_uncond),
}


def check_kind(spec: ConditionerSpec) -> None:
    """Raise for a conditioner kind, or a CLAP tower, that the port does not
    know (nested specs included)."""
    if spec.kind not in REGISTRY:
        raise ValueError(f"unknown conditioner kind {spec.kind!r} (known: {sorted(REGISTRY)})")
    if spec.kind == "clap":
        for name, towers in ((spec.clap.tmodel, clap_model.TEXT_TOWERS),
                             (spec.clap.amodel, clap_model.AUDIO_TOWERS)):
            if name not in towers:
                raise ValueError(f"unknown CLAP tower {name!r} (known: {sorted(towers)})")
    for ns in spec.nested:
        check_kind(ns)


def init_conditioner(ini: Init, spec: ConditionerSpec):
    return REGISTRY[spec.kind][0](ini, spec)


def encode(params, spec: ConditionerSpec, batch) -> Tuple[str, object]:
    return REGISTRY[spec.kind][1](params, spec, batch)


def unconditional(params, spec: ConditionerSpec, batch, batchsize: int) -> Tuple[str, object]:
    return REGISTRY[spec.kind][2](params, spec, batch, batchsize)
