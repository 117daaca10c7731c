"""The CLIP-style causal text transformer, CLAP's "transformer" text tower,
in PyTorch.

Port of ``audioldm2_tpu/models/clip_text.py``: token and learned position
embeddings, pre-LN residual blocks with a causal mask (masked, so
``nn.attention`` takes its plain path), a final LayerNorm, and the
features at the EOT position (the argmax token id, as CLIP's BPE puts the
largest id there). ``convert_clip_text`` maps the reference's keys.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from audioldm2_torch.ops import nn
from audioldm2_torch.params import Init


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    context_length: int = 77


def init_clip_text(ini: Init, cfg: CLIPTextConfig = CLIPTextConfig()):
    d = cfg.width
    blocks = [
        {
            "ln_1": ini.norm(d),
            "attn": {"in_proj": ini.linear(d, 3 * d), "out_proj": ini.linear(d, d)},
            "ln_2": ini.norm(d),
            "mlp": {"c_fc": ini.linear(d, 4 * d), "c_proj": ini.linear(4 * d, d)},
        }
        for _ in range(cfg.layers)
    ]
    return {
        "token_embedding": ini.randn((cfg.vocab_size, d), std=0.02),
        "positional_embedding": ini.randn((cfg.context_length, d), std=0.01),
        "blocks": blocks,
        "ln_final": ini.norm(d),
    }


def apply_clip_text(params, cfg: CLIPTextConfig, token_ids: torch.Tensor) -> torch.Tensor:
    """token_ids [B, context_length] -> features [B, width] at the EOT
    position, after the final LayerNorm."""
    ids = token_ids.long()
    x = params["token_embedding"][ids] + params["positional_embedding"]
    n = ids.shape[1]
    causal = torch.ones((n, n), dtype=torch.bool, device=ids.device).tril()[None, None]
    for blk in params["blocks"]:
        h = nn.layer_norm(blk["ln_1"], x)
        q, k, v = (nn.split_heads(t, cfg.heads)
                   for t in nn.linear(blk["attn"]["in_proj"], h).chunk(3, dim=-1))
        att = nn.attention(q, k, v, mask=causal)
        x = x + nn.linear(blk["attn"]["out_proj"], nn.merge_heads(att))
        h = nn.layer_norm(blk["ln_2"], x)
        x = x + nn.linear(blk["mlp"]["c_proj"], nn.gelu(nn.linear(blk["mlp"]["c_fc"], h)))
    x = nn.layer_norm(params["ln_final"], x)
    return x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]


def convert_clip_text(sd, cfg: CLIPTextConfig = CLIPTextConfig(), prefix: str = ""):
    """The reference's keys (``token_embedding``, ``positional_embedding``,
    ``text_branch.resblocks.<i>``, ``ln_final``; numpy values) -> the tree
    of :func:`init_clip_text`."""
    from audioldm2_torch import convert

    blocks = []
    for i in range(cfg.layers):
        bp = f"{prefix}text_branch.resblocks.{i}"
        blocks.append({
            "ln_1": convert.norm_p(sd, bp + ".ln_1"),
            "attn": {
                "in_proj": {"w": sd[bp + ".attn.in_proj_weight"].transpose(1, 0),
                            "b": sd[bp + ".attn.in_proj_bias"]},
                "out_proj": convert.linear_p(sd, bp + ".attn.out_proj"),
            },
            "ln_2": convert.norm_p(sd, bp + ".ln_2"),
            "mlp": {"c_fc": convert.linear_p(sd, bp + ".mlp.c_fc"),
                    "c_proj": convert.linear_p(sd, bp + ".mlp.c_proj")},
        })
    return {
        "token_embedding": sd[prefix + "token_embedding.weight"],
        "positional_embedding": sd[prefix + "positional_embedding"],
        "blocks": blocks,
        "ln_final": convert.norm_p(sd, prefix + "ln_final"),
    }
