"""K2: flash self-attention (no mask, no bias).

Replaces ``audioldm2_tpu/ops/attention_pallas.py:fused_self_attention``
with ``csrc/attention.cu``: K/V stream in tiles through an online f32
softmax, so the [T, T] logits never reach device memory.

:func:`flash_self_attention` takes the plain version for CPU tensors and
the kernel for CUDA tensors; :func:`self_attention_plain` is the oracle.
"""

from __future__ import annotations

import torch

from audioldm2_torch.ops import _build
from audioldm2_torch.ops import nn as _nn

HEAD_DIMS = (32, 64, 128)


def self_attention_plain(q, k, v, scale: float):
    return _nn.attention_plain(q, k, v, scale=scale)


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """q, k, v: [B, T, H, D] -> [B, T, H, D] in q.dtype."""
    if not q.is_cuda:
        return self_attention_plain(q, k, v, scale)
    name = "flash_self_attention"
    q, k, v = (t.contiguous() for t in (q, k, v))
    _build.require_cuda(name, q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, T, H, D] shape")
    bsz, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    _build.check(_build.lib().a2k_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, t, h, d,
        float(scale), _build.dtype_code(q), _build.stream_of(q),
    ), name)
    flash_self_attention.launches += 1
    return out


flash_self_attention.launches = 0
