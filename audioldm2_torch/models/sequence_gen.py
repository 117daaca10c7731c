"""The GPT-2 "language of audio" sequence generator, in PyTorch.

Port of ``audioldm2_tpu/models/sequence_gen.py``: each input condition
named in ``sequence_input_keys`` is encoded by its nested conditioner,
projected to 768-d, wrapped with learned per-source SOS/EOS tokens,
concatenated and truncated to ``max_context - sequence_gen_length``; GPT-2
then generates ``sequence_gen_length`` continuous tokens from a KV cache.
The JAX ``lax.scan`` is a Python loop of ``sequence_gen_length`` steps.
Inside a request (``utils.profiling``) generation opens three spans,
``seqgen.prefix`` (the nested conditioners and input linears),
``seqgen.prefill`` and ``seqgen.decode``, and each decode step is a
``seqgen.token`` step counted on ``seqgen.decode``.
Every nested conditioner is drawn, as in JAX; those outside
``sequence_input_keys`` (the AudioMAE spec of audioldm2-full and the
speech families) feed no prefix, so generation never encodes them.
"""

from __future__ import annotations

from typing import Dict

import torch

from audioldm2_torch.config import ConditionerSpec
from audioldm2_torch.models import gpt2
from audioldm2_torch.ops import nn
from audioldm2_torch.params import Init
from audioldm2_torch.utils import profiling


def input_specs(spec: ConditionerSpec):
    """The nested specs that feed the prefix, in sequence_input_keys order."""
    nested = {ns.name: ns for ns in spec.nested}
    return [nested[k] for k in spec.sequence_gen.sequence_input_keys]


def init_sequence_gen(ini: Init, spec: ConditionerSpec):
    from audioldm2_torch.models import conditioners

    sg = spec.sequence_gen
    params: Dict = {
        "sos": ini.randn((32, 768), std=0.02),
        "eos": ini.randn((32, 768), std=0.02),
        "gpt2": gpt2.init_gpt2(ini, sg.gpt2),
        "input_linears": [ini.linear(dim, 768) for dim in sg.sequence_input_embed_dims],
        "cond": {},
    }
    # the inputs from the tree's generator, each other nested spec from a
    # fork of it: a spec that feeds no prefix then leaves the draws of every
    # other leaf of a seeded tree as they are without it
    inputs = {ns.name for ns in input_specs(spec)}
    for ns in input_specs(spec):
        params["cond"][ns.name] = conditioners.init_conditioner(ini, ns)
    for ns in spec.nested:
        if ns.name not in inputs:
            params["cond"][ns.name] = conditioners.init_conditioner(ini.fork(ns.name), ns)
    return params


def assemble_prefix(params, spec: ConditionerSpec, batch):
    """The GPT-2 input sequence [B, L, 768] and its mask [B, L] from the
    nested conditioners' outputs."""
    from audioldm2_torch.models import conditioners

    sg = spec.sequence_gen
    seqs, masks = [], []
    for i, ns in enumerate(input_specs(spec)):
        kind, val = conditioners.encode(params["cond"][ns.name], ns, batch)
        if kind == "film":
            emb = val if val.dim() == 3 else val[:, None, :]
            m = torch.ones(emb.shape[:2], device=emb.device)
        else:
            emb, m = val
        emb = nn.linear(params["input_linears"][i], emb).float()
        b = emb.shape[0]
        sos = params["sos"][i].expand(b, 1, 768)
        eos = params["eos"][i].expand(b, 1, 768)
        one = torch.ones((b, 1), device=emb.device)
        seqs.append(torch.cat([sos, emb, eos], dim=1))
        masks.append(torch.cat([one, m.float(), one], dim=1))
    max_len = sg.max_context - sg.sequence_gen_length
    return torch.cat(seqs, dim=1)[:, :max_len], torch.cat(masks, dim=1)[:, :max_len]


def generate(params, spec: ConditionerSpec, batch) -> torch.Tensor:
    """Generated continuous tokens [B, sequence_gen_length, 768]: token i is
    the input of decode step i (the first is GPT-2's hidden state at the
    last valid prefix position)."""
    sg = spec.sequence_gen
    with profiling.span("seqgen.prefix"):
        seq, mask = assemble_prefix(params, spec, batch)
    b, l_pre, _ = seq.shape
    steps = sg.sequence_gen_length
    with profiling.span("seqgen.prefill"):
        hidden, cache = gpt2.prefill(params["gpt2"], sg.gpt2, seq, mask, l_pre + steps)
    content_len = mask.sum(dim=1).long()
    # pads can sit mid-sequence (before the EOS wrapper token)
    idx = torch.arange(l_pre, device=seq.device)
    last_idx = (idx[None, :] * mask.long()).amax(dim=1)
    g = hidden[torch.arange(b, device=seq.device), last_idx]
    cache_mask = torch.nn.functional.pad(mask, (0, steps))
    tokens = []
    with profiling.span("seqgen.decode"):
        for i in range(steps):
            tokens.append(g)
            with profiling.step("seqgen.token"):
                g, cache = gpt2.step(params["gpt2"], sg.gpt2, g, cache, cache_mask, l_pre + i,
                                     content_len + i)
                cache_mask[:, l_pre + i] = 1.0
    return torch.stack(tokens, dim=1)
