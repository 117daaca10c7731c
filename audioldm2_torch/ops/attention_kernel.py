"""K2: flash self-attention (no mask, no bias).

Replaces ``audioldm2_tpu/ops/attention_pallas.py:fused_self_attention``
with ``csrc/attention.cu``: K/V stream in tiles through an online f32
softmax, so the [T, T] logits never reach device memory. In bf16 both
products run on the tensor cores with P kept in registers and K/V staged
by asynchronous copies; q, k and v may be strided views of one fused QKV
projection (see :func:`_strides`), which the kernel reads in place.

:func:`flash_self_attention` takes the plain version for CPU tensors and
the kernel for CUDA tensors; :func:`self_attention_plain` is the oracle.
A CUDA call that autograd must record goes through
``autograd.KernelFunction`` (the kernel forward, the plain version's
gradients backward).
"""

from __future__ import annotations

import torch

from audioldm2_torch.ops import _build, autograd
from audioldm2_torch.ops import nn as _nn

HEAD_DIMS = (32, 64, 128)


def self_attention_plain(q, k, v, scale: float):
    return _nn.attention_plain(q, k, v, scale=scale)


def _strides(t: torch.Tensor):
    """(token stride, batch stride) in elements if the bf16 kernel can read
    the [B, T, H, D] tensor ``t`` where it lies, else None: each token's
    H * D values contiguous, both strides multiples of 8 elements and the
    data 16-byte aligned (the kernel copies 16 bytes at a time). The chunks
    of a fused [B, T, 3 * H * D] projection, split into heads, qualify. A
    dimension of size 1 has no stride to speak of."""
    if t.dtype != torch.bfloat16 or t.data_ptr() % 16:
        return None
    bsz, tn, h, d = t.shape
    s_bat, s_tok, s_head, s_el = t.stride()  # one call: this runs per launch
    if s_el != 1 or (h > 1 and s_head != d):
        return None
    tok = s_tok if tn > 1 else h * d
    bat = s_bat if bsz > 1 else tn * tok
    if tok < h * d or bat < 0 or tok % 8 or bat % 8:
        return None
    return tok, bat


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """q, k, v: [B, T, H, D] -> [B, T, H, D] in q.dtype, contiguous."""
    if not q.is_cuda:
        return self_attention_plain(q, k, v, scale)
    if autograd.needs_grad(q, k, v):
        return autograd.KernelFunction.apply(flash_self_attention, self_attention_plain, q, k, v,
                                             scale)
    name = "flash_self_attention"
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, T, H, D] shape")
    bsz, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    strides = []
    tensors = []
    for x in (q, k, v):
        st = _strides(x)
        if st is None:
            x = x.contiguous()
            if x.data_ptr() % 16:
                x = x.clone()  # a fresh allocation is aligned
            st = (h * d, t * h * d)
        tensors.append(x)
        strides += st
    q, k, v = tensors
    for x in tensors:
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}, got {x.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name}: mixed dtypes {q.dtype} and {x.dtype}")
    out = torch.empty((bsz, t, h, d), device=q.device, dtype=q.dtype)
    _build.check(_build.lib().a2k_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides, bsz, t, h, d,
        float(scale), _build.dtype_code(q), _build.stream_of(q),
    ), name)
    flash_self_attention.launches += 1
    return out


flash_self_attention.launches = 0
