"""Int8 weight quantization for the opt-in serving mode (per output
channel, symmetric).

Port of ``audioldm2_tpu/ops/quant.py``. A quantized parameter dict
replaces ``{"w": ...}`` with ``{"wq": int8, "ws": f32 [N]}``; biases and
norms stay as they were. The int8 values and scales are bitwise equal to
the JAX package's on the same input: both divide in float32 and round half
to even (``torch.round`` and ``jnp.round``), with the same ``s == 0 -> 1``
guard and the same clip.

The consumers (``ops.nn.linear``, ``ln_linear``, ``geglu_ff_out``,
``gn_silu_conv``, ``gn_silu_conv_cat``) dispatch on the ``"wq"`` key to the
int8 kernels, which apply ``ws`` to the f32 accumulator; the dequantized
weight never exists in device memory.
"""

from __future__ import annotations

import torch


def _absmax_quantize(w32: torch.Tensor, dims, absmax=None):
    absmax = w32.abs().amax(dim=dims) if absmax is None else absmax
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which leaves some scales one ulp off float32 division
    s = absmax / torch.full_like(absmax, 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(w32 / s), -127.0, 127.0).to(torch.int8)
    return q, s


def quantize_weight(w: torch.Tensor):
    """w: [K, N] -> (int8 [K, N], f32 scale [N]); per-output-column absmax."""
    return _absmax_quantize(w.float(), 0)


def dequantize(p) -> torch.Tensor:
    """Exact f32 reconstruction of a quantized linear's weight."""
    return p["wq"].float() * p["ws"]


def _quantized_linear(p, absmax=None):
    q, s = _absmax_quantize(p["w"].float(), 0, absmax)
    out = {k: v for k, v in p.items() if k != "w"}
    out["wq"], out["ws"] = q, s
    return out


def quantize_linear_dict(p):
    """{"w": [K, N], ...} -> {"wq", "ws", ...}; a dict without a 2-D "w"
    (or anything else) is returned unchanged."""
    if not isinstance(p, dict) or "w" not in p or p["w"].dim() != 2:
        return p
    return _quantized_linear(p)


def _default_pred(path, p):
    k, n = p["w"].shape
    return k % 128 == 0 and n % 128 == 0


def _eligible_linears(tree, pred, path: tuple = ()):
    """(path, linear dict) of every linear dict ({"w": 2-D}) that ``pred``
    keeps, in the tree's key order; a kept dict is not searched further."""
    if isinstance(tree, dict):
        w = tree.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2 and pred(path, tree):
            yield path, tree
            return
        for k, v in tree.items():
            yield from _eligible_linears(v, pred, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _eligible_linears(v, pred, path + (i,))


def quantize_tree(tree, should_quantize=None, whole_absmax=None):
    """Convert every eligible linear dict ({"w": 2-D}, optional bias) of a
    parameter tree. ``should_quantize(path, leaf_dict)`` vetoes individual
    linears; the default keeps those whose K and N are multiples of 128.
    ``whole_absmax({path: linear dict})``, given the eligible linears in
    walk order, returns {path: column absmax [N]} for those whose scale is
    not taken from their own rows (a tp rank's row slice takes the whole
    weight's: ``models.unet.quantize_st_linears``)."""
    linears = dict(_eligible_linears(tree, should_quantize or _default_pred))
    absmax = whole_absmax(linears) if whole_absmax else {}

    def walk(node, path):
        if path in linears:
            return _quantized_linear(node, absmax.get(path))
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        return node

    return walk(tree, ())


def quantize_conv3x3_dict(p):
    """{"w": [3, 3, Cin, Cout] HWIO, "b"} -> {"wq" int8, "ws" f32 [Cout], "b"};
    per-output-channel absmax over all 9 taps x Cin. A dict without a 4-D
    "w" is returned unchanged."""
    if not isinstance(p, dict) or "w" not in p or p["w"].dim() != 4:
        return p
    q, s = _absmax_quantize(p["w"].float(), (0, 1, 2))
    out = {k: v for k, v in p.items() if k != "w"}
    out["wq"], out["ws"] = q, s
    return out


def dequantize_conv(p) -> torch.Tensor:
    """Exact f32 reconstruction of a quantized conv's weight."""
    return p["wq"].float() * p["ws"]
