"""RoBERTa-base text encoder (the CLAP text tower) and its BERT and BART
variants, in PyTorch.

Port of ``audioldm2_tpu/models/roberta.py``: post-LN blocks, the exact
(erf) GELU, a tanh pooler over the first token, and RoBERTa position ids
``cumsum(mask) * mask + padding_idx``; ``bert_style=True`` takes plain
``arange`` positions and token-type ids (CLAP's "bert" tower);
``apply_bart_encoder`` the BART encoder's learned positions at offset 2
and no pooler (CLAP's "bart" tower). The attention is masked, so it takes
the plain path on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from audioldm2_torch.ops import nn
from audioldm2_torch.params import Init


@dataclass(frozen=True)
class RobertaConfig:
    """The JAX package's ``RobertaConfig`` (roberta-base defaults)."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5


def init_roberta(ini: Init, cfg: RobertaConfig):
    d = cfg.hidden_size
    layers = [
        {
            "attn": {
                "q": ini.linear(d, d),
                "k": ini.linear(d, d),
                "v": ini.linear(d, d),
                "out": ini.linear(d, d),
                "ln": ini.norm(d),
            },
            "ff": {
                "intermediate": ini.linear(d, cfg.intermediate_size),
                "output": ini.linear(cfg.intermediate_size, d),
                "ln": ini.norm(d),
            },
        }
        for _ in range(cfg.num_layers)
    ]
    return {
        "word_embeddings": ini.randn((cfg.vocab_size, d), std=0.02),
        "position_embeddings": ini.randn((cfg.max_position_embeddings, d), std=0.02),
        "token_type_embeddings": ini.randn((cfg.type_vocab_size, d), std=0.02),
        "emb_ln": ini.norm(d),
        "layers": layers,
        "pooler": ini.linear(d, d),
    }


def _encoder_stack(params, cfg: RobertaConfig, x, attention_mask):
    for layer in params["layers"]:
        a = layer["attn"]
        q, k, v = (nn.split_heads(nn.linear(a[n], x), cfg.num_heads) for n in ("q", "k", "v"))
        att = nn.linear(a["out"], nn.merge_heads(nn.attention(q, k, v, mask=attention_mask)))
        x = nn.layer_norm(a["ln"], x + att, cfg.layer_norm_eps)
        f = layer["ff"]
        h = nn.linear(f["output"], nn.gelu(nn.linear(f["intermediate"], x)))
        x = nn.layer_norm(f["ln"], x + h, cfg.layer_norm_eps)
    return x


def apply_bart_encoder(params, cfg: RobertaConfig, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor) -> torch.Tensor:
    """The BART encoder's last hidden state [B, L, D]: learned positions at
    BART's offset of 2, the embedding LayerNorm, the shared post-LN blocks."""
    ids = input_ids.long()
    position_ids = torch.arange(ids.shape[1], device=ids.device) + 2
    x = params["word_embeddings"][ids] + params["position_embeddings"][position_ids]
    x = nn.layer_norm(params["emb_ln"], x, cfg.layer_norm_eps)
    return _encoder_stack(params, cfg, x, attention_mask)


def apply_roberta(params, cfg: RobertaConfig, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor, bert_style: bool = False,
                  token_type_ids: Optional[torch.Tensor] = None):
    """input_ids, attention_mask: [B, L]. Returns (sequence_output
    [B, L, D], pooler_output [B, D]). ``bert_style``: BERT's positions
    ``0..L-1`` instead of RoBERTa's; ``token_type_ids`` [B, L] index the
    token-type embeddings (None: type 0 everywhere)."""
    ids = input_ids.long()
    if bert_style:
        position_ids = torch.arange(ids.shape[1], device=ids.device)
    else:
        mask = attention_mask.long()
        position_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
    type_emb = (params["token_type_embeddings"][0] if token_type_ids is None
                else params["token_type_embeddings"][token_type_ids.long()])
    x = params["word_embeddings"][ids] + params["position_embeddings"][position_ids] + type_emb
    x = nn.layer_norm(params["emb_ln"], x, cfg.layer_norm_eps)
    x = _encoder_stack(params, cfg, x, attention_mask)
    pooled = torch.tanh(nn.linear(params["pooler"], x[:, 0]))
    return x, pooled
