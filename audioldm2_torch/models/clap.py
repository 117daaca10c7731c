"""CLAP text embedding, in PyTorch.

Port of the text side of ``audioldm2_tpu/models/clap.py``: the RoBERTa text
tower, the two-layer ``text_projection`` MLP (``_project``) and the L2
normalization, giving [B, 1, 512] unit-norm embeddings (``text_embedding``).
The audio tower (HTSAT/PANN), the audio projection and the contrastive
heads are not ported: ``init_clap`` does not draw them, and a tree from
the JAX package keeps them untouched.

Text towers are looked up by ``CLAPConfig.tmodel`` in :data:`TEXT_TOWERS`
(the JAX registry's roberta entry); ``register_text_tower`` adds a RoBERTa
variant, as the JAX registry's does. The bert, bart and transformer towers
raise.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from audioldm2_tpu.config import CLAPConfig
from audioldm2_torch.models import roberta
from audioldm2_torch.ops import nn
from audioldm2_torch.params import Init

# name: (RobertaConfig factory, width feeding text_projection)
TEXT_TOWERS: Dict[str, Tuple[Callable[[], roberta.RobertaConfig], int]] = {
    "roberta": (roberta.RobertaConfig, 768),
}

_NOT_PORTED = ("bert", "bart", "transformer")


def register_text_tower(name: str, cfg_factory, width: int) -> None:
    TEXT_TOWERS[name] = (cfg_factory, width)


def text_tower(cfg: CLAPConfig):
    if cfg.tmodel in _NOT_PORTED or cfg.tmodel not in TEXT_TOWERS:
        raise NotImplementedError(
            f"CLAP text tower {cfg.tmodel!r} is not ported to audioldm2_torch "
            f"(ported: {sorted(TEXT_TOWERS)})"
        )
    factory, width = TEXT_TOWERS[cfg.tmodel]
    return factory(), width


def init_clap(ini: Init, cfg: CLAPConfig):
    """The text branch and text_projection of the JAX ``init_clap`` tree."""
    tcfg, width = text_tower(cfg)
    return {
        "text_branch": roberta.init_roberta(ini, tcfg),
        "text_projection": {
            "lin1": ini.linear(width, cfg.embed_dim),
            "lin2": ini.linear(cfg.embed_dim, cfg.embed_dim),
        },
    }


def _project(p, x):
    return nn.linear(p["lin2"], torch.relu(nn.linear(p["lin1"], x)))


def _normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def text_embedding(params, cfg: CLAPConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor) -> torch.Tensor:
    """RoBERTa pooler output -> MLP projection -> L2 norm; [B, 1, embed_dim]."""
    tcfg, _ = text_tower(cfg)
    _, pooled = roberta.apply_roberta(params["text_branch"], tcfg, input_ids, attention_mask)
    return _normalize(_project(params["text_projection"], pooled))[:, None, :]
