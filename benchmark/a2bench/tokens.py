"""The GPT-2 sequence generator's token loop: its least time on the card,
and the readers of its traced token steps.

``audioldm2_torch`` runs the loop inside ``conditioning`` as the spans
``seqgen.prefix``, ``seqgen.prefill`` and ``seqgen.decode``; each generated
token is a ``record_function("seqgen.token")`` range, which a trace holds
on the device ops' clock. Each reader below returns None where the run has
nothing to read: no trace, no device op, a configuration without a
sequence generator, or a program without the ranges.

The least time of token step ``i`` is the longer of its bytes at the HBM
peak and its FLOPs at the card's float32 peak without tensor cores (the
loop runs in float32 with TF32 off). Bytes: every GPT-2 block weight read
once in float32, and the K and V of the cache slots the step attends over
(the whole prefix, pads included, and the tokens up to and including this
one). FLOPs: the blocks' matrix products and the attention over the same
slots (one multiply-add is 2 FLOPs; norms and elementwise ops are not
counted). Rows: the request's distinct prompts, one in every mix of this
benchmark (a request is one caption); the program may run more rows of the
same prompt, which this count does not credit.
"""

from __future__ import annotations

from typing import Optional

from a2bench import spans, work
from a2bench.reference.config import ConditionerSpec, ModelConfig
from a2bench.window import Window

# one NVIDIA H100 SXM's dense float32 peak without tensor cores, at 700 W
PEAK_F32_FLOPS = 67e12
F32_BYTES = 4
# distinct prompts a request encodes
ROWS = 1


def sequence_gen(cfg: ModelConfig) -> Optional[ConditionerSpec]:
    """The configuration's GPT-2 sequence generator, or None."""
    for spec in cfg.conditioners:
        if spec.kind == "sequence_gen" and spec.sequence_gen is not None:
            return spec
    return None


def _input_length(spec: ConditionerSpec) -> int:
    """Tokens one nested conditioner feeds the prefix, before its SOS/EOS."""
    if spec.kind == "clap":
        return 1  # the pooled embedding, as one token
    if spec.kind == "phoneme":
        return spec.phoneme.pad_length
    if spec.kind == "flan_t5":
        return spec.flan_t5.max_length
    raise ValueError(f"no prefix length for a {spec.kind!r} input")


def prefix_slots(spec: ConditionerSpec) -> int:
    """The prefix GPT-2 generates from: each input with its SOS and EOS,
    cut to ``max_context - sequence_gen_length`` (315 on the speech
    configurations: CLAP 1 and the phonemes 310, each inside its pair)."""
    sg = spec.sequence_gen
    nested = {ns.name: ns for ns in spec.nested}
    total = sum(_input_length(nested[k]) + 2 for k in sg.sequence_input_keys)
    return min(total, sg.max_context - sg.sequence_gen_length)


def block_values(spec: ConditionerSpec) -> int:
    """Values in GPT-2's blocks: per block the QKV, output and two MLP
    matrices (12 d^2), their biases (9 d) and two LayerNorms (4 d); 85.1 M
    at d 768, 12 layers."""
    g = spec.sequence_gen.gpt2
    d = g.n_embd
    return g.n_layer * (12 * d * d + 13 * d)


def step_bytes(spec: ConditionerSpec, i: int) -> float:
    """Bytes token step ``i`` (from 0) has to move at the least."""
    g = spec.sequence_gen.gpt2
    slots = prefix_slots(spec) + i + 1
    kv = ROWS * g.n_layer * 2 * g.n_embd * slots * F32_BYTES
    return block_values(spec) * F32_BYTES + kv


def step_flops(spec: ConditionerSpec, i: int) -> float:
    """FLOPs of token step ``i`` (from 0)."""
    g = spec.sequence_gen.gpt2
    d = g.n_embd
    slots = prefix_slots(spec) + i + 1
    matmuls = work.linear_flops(ROWS, d, 12 * d)
    attention = work.attention_flops(ROWS, g.n_head, 1, slots, d // g.n_head)
    return g.n_layer * (matmuls + attention)


def least_s(spec: ConditionerSpec, steps: int) -> float:
    """The least time of token steps 0 .. ``steps - 1`` on the card."""
    return sum(max(step_bytes(spec, i) / work.PEAK_HBM_BYTES_PER_S,
                   step_flops(spec, i) / PEAK_F32_FLOPS) for i in range(steps))


def token_idle_ms(w: Window) -> Optional[float]:
    """The device's idle time inside the host intervals of the traced
    ``"seqgen.token"`` ranges, over the number of those ranges, ms."""
    if w.trace is None or not w.trace.device:
        return None
    steps = w.trace.ranges("seqgen.token")
    if not steps:
        return None
    busy = w.trace.busy_intervals()
    idle = sum((t - s) - spans.covered_us(busy, s, t) for s, t in steps)
    return idle / len(steps) / 1e3


def token_roofline(w: Window) -> Optional[float]:
    """The least time of the traced token steps (the first n of the loop,
    n the traced ranges) over the device time launched inside their
    ``"seqgen.token"`` ranges, in %."""
    spec = sequence_gen(w.cfg)
    if w.trace is None or spec is None:
        return None
    device_s, n = w.trace.range_device_s("seqgen.token")
    if n == 0 or device_s <= 0:
        return None
    return 100.0 * least_s(spec, n) / device_s
