"""The weights both sides run: drawn on the device from the run's seed.

The tree has the layout of :mod:`a2bench.reference.layout`. Each subtree
is drawn in one call from a ``torch.Generator`` on the device, as normal
values, and cut into its leaves, each scaled by its role:

- two or more dimensions (a weight; the output features last): std
  1 / sqrt(fan_in), fan_in the product of all but the last dimension;
- a multiplicative scale (a norm's ``scale``, a running ``var``, the latent
  ``scale_factor``): 1 + 0.05 x, always positive in practice;
- any other vector or scalar (biases, running means, logit scales): 0.05 x.

No leaf is zero, so the UNet's output convs and ``proj_out`` leaves, zero
at a fresh init, are live. The UNet, the VAE and the vocoder are made in
bf16, the type they are served in; the conditioners and the reranker stay
float32, which is how the program runs them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from a2bench.reference import layout
from a2bench.reference.config import ModelConfig

ONE_NAMES = frozenset({"scale", "var", "scale_factor"})
SMALL_STD = 0.05
BF16_SUBTREES = ("unet", "vae", "vocoder")


def leaves(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) of every tensor in a tree of dicts and lists, in sorted
    key order."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += leaves(v, prefix + (i,))
    elif isinstance(tree, torch.Tensor):
        out.append((prefix, tree))
    return out


def _put(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def cast(tree, dtype: torch.dtype):
    """A copy of a tree with every floating leaf in ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _scaled(flat: torch.Tensor, path: Tuple, shape) -> torch.Tensor:
    x = flat.reshape(shape)
    if len(shape) >= 2:
        return x.mul_(1.0 / math.sqrt(math.prod(shape[:-1])))
    x = x.mul_(SMALL_STD)
    return x.add_(1.0) if path[-1] in ONE_NAMES else x


def make(cfg: ModelConfig, seed: int, device) -> Dict:
    """The tree of ``cfg`` on ``device`` from ``seed``: each top-level
    subtree one draw of a generator seeded with (seed, its index)."""
    tree = layout.model(cfg)
    for index, key in enumerate(sorted(tree)):
        sub = leaves(tree[key], (key,))
        total = sum(leaf.numel() for _, leaf in sub)
        gen = torch.Generator(device=device).manual_seed((int(seed) * 16 + index) % 2 ** 63)
        flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
        dtype = torch.bfloat16 if key in BF16_SUBTREES else torch.float32
        offset = 0
        for path, leaf in sub:
            n = leaf.numel()
            # float32 leaves stay views of the draw, which they fill exactly
            _put(tree, path, _scaled(flat[offset:offset + n], path, tuple(leaf.shape)).to(dtype))
            offset += n
        del flat
    return tree


def count(tree) -> int:
    """Number of values in a tree."""
    return sum(leaf.numel() for _, leaf in leaves(tree))
