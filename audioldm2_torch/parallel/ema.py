"""Exponential moving average of parameters, functional.

Port of ``audioldm2_tpu/parallel/ema.py`` (reference
``latent_diffusion/modules/ema.py:5-82``, LitEma): the decay ramp
``min(decay, (1 + updates) / (10 + updates))`` on a tree of tensors, each
update a new shadow tree. The ramp is computed in f32, as the JAX package
computes it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from audioldm2_torch.params import map_tree


class EmaState(NamedTuple):
    params: object  # the shadow tree
    updates: int  # updates applied so far


def init(params) -> EmaState:
    """A shadow tree equal to ``params`` (detached copies), no updates yet."""
    return EmaState(params=map_tree(lambda t: t.detach().clone(), params), updates=0)


def decay_at(updates: int, decay: float = 0.9999) -> float:
    """The decay of the ``updates``-th update (1-based): min(decay,
    (1 + updates) / (10 + updates)), in f32."""
    n = np.float32(updates)
    return float(np.minimum(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n)))


@torch.no_grad()
def update(state: EmaState, params, decay: float = 0.9999) -> EmaState:
    """shadow - (1 - d) * (shadow - params) with the ramped decay d."""
    updates = state.updates + 1
    keep = float(np.float32(1.0) - np.float32(decay_at(updates, decay)))
    shadow = _map2(lambda s, p: s - keep * (s - p.to(s.dtype)), state.params, params)
    return EmaState(params=shadow, updates=updates)


def _map2(fn, a, b):
    """fn over the tensor leaves of two trees of one structure."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b) if isinstance(a, torch.Tensor) else a
