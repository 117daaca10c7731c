"""Conditioning stack of the port: the ``flan_t5`` kind only.

Port of ``audioldm2_tpu/models/conditioners.py:44-65``. Each conditioner
returns ``("crossattn", (ctx [B, L, D], mask [B, L]))`` and has an
unconditional variant for classifier-free guidance. The other kinds wait
for their ROADMAP items and raise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from audioldm2_tpu.config import ConditionerSpec
from audioldm2_torch.models import t5 as t5_model
from audioldm2_torch.params import Init

_NOT_PORTED = {
    "clap": "ROADMAP queue 1 item 9 (CLAP)",
    "audiomae_pooled": "ROADMAP queue 1 item 10 (audioldm2-full: AudioMAE)",
    "sequence_gen": "ROADMAP queue 1 item 10 (audioldm2-full: GPT-2 sequence generator)",
    "phoneme": "ROADMAP queue 1 item 12 (TTS)",
}


def check_kind(spec: ConditionerSpec) -> None:
    if spec.kind != "flan_t5":
        where = _NOT_PORTED.get(spec.kind, "no ROADMAP item")
        raise NotImplementedError(
            f"conditioner kind {spec.kind!r} is not ported to audioldm2_torch yet ({where})"
        )


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x] * n, dim=0) if n > 1 else x


def init_conditioner(ini: Init, spec: ConditionerSpec):
    check_kind(spec)
    return {"t5": t5_model.init_t5_encoder(ini, spec.flan_t5)}


def encode(params, spec: ConditionerSpec, batch) -> Tuple[str, object]:
    check_kind(spec)
    ctx = t5_model.apply_t5_encoder(params["t5"], spec.flan_t5, batch["t5_ids"], batch["t5_mask"])
    return "crossattn", (ctx, batch["t5_mask"].float())


def unconditional(params, spec: ConditionerSpec, batch, batchsize: int) -> Tuple[str, object]:
    check_kind(spec)
    ctx = t5_model.apply_t5_encoder(
        params["t5"], spec.flan_t5, batch["t5_uncond_ids"], batch["t5_uncond_mask"]
    )
    return "crossattn", (_tile(ctx, batchsize), _tile(batch["t5_uncond_mask"].float(), batchsize))
