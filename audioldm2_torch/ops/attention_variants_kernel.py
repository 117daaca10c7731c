"""K7 and K8: the A/B tool's two candidate self-attention kernels.

K7 replaces ``tools/ab_attn_variants.py:v6bd_attention`` (exact softmax,
the whole row's max, the row sum over the unrounded f32 p) and K8
replaces ``tools/ab_attn_variants.py:v7_attention`` (exp2 of the logits
clamped to +-100 with no max, the row sum over the p rounded to v's
dtype), both with ``csrc/attention_variants.cu``. Each wrapper takes its
plain version for CPU tensors and the kernel for CUDA tensors; the plain
versions round where the Pallas kernels round and are the oracles.

The wrappers refuse what the Pallas kernels refuse: H * D not a multiple
of 128, D not dividing 128, and a T with no q block under the Pallas
kernels' VMEM budget (``_v6bd_block_q``, ``attention_pallas._block_q``).
The CUDA kernel also needs D >= 16 (one 16-deep tensor-core step).
"""

from __future__ import annotations

import torch

from audioldm2_torch.ops import _build
from audioldm2_torch.ops.nn import full_f32

LOG2E = 1.4426950408889634
LANE = 128
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_VMEM_SOFTMAX_BUDGET = 8 * 1024 * 1024


def _largest_block(t: int, per_row: int) -> int:
    """The Pallas kernels' q block: the largest multiple of 8 (or t itself)
    that divides t and keeps per_row * block bytes in the 8 MiB budget; 0
    when there is none."""
    cap = _VMEM_SOFTMAX_BUDGET // per_row
    if cap < 8:
        return 0
    bq = min(t, (cap // 8) * 8)
    while bq > 0 and t % bq:
        bq -= 8
    return max(bq, 0)


def v6bd_block_q(t: int) -> int:
    """``tools/ab_attn_variants.py:_v6bd_block_q`` (its per-row model
    assumes D = 32 whatever D is)."""
    return _largest_block(t, (LANE // 32) * t * 8)


def v7_block_q(t: int, head_dim: int) -> int:
    """``audioldm2_tpu/ops/attention_pallas.py:_block_q``, v7's q block."""
    return _largest_block(t, (LANE // head_dim) * t * 4 * 2)


def check_shape(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on the shapes the Pallas kernel does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, T, H, D] shape")
    _, t, h, d = q.shape
    if LANE % d or (h * d) % LANE:
        raise ValueError(f"{name}: head_dim {d} must divide {LANE} and H * D = {h * d} be a "
                         f"multiple of {LANE}")
    bq = v6bd_block_q(t) if name.startswith("v6bd") else v7_block_q(t, d)
    if bq == 0:
        raise ValueError(f"{name}: T = {t} has no q block under the kernel's VMEM budget")


def _logits(q, k, scale: float):
    """[B, H, Tq, Tk] f32 logits times scale * log2(e), from exact f32
    copies (no TF32)."""
    with full_f32():
        return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)


def _pv(p, v):
    with full_f32():
        return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())


def v6bd_attention_plain(q, k, v, scale: float):
    """v6bd: the whole row's max, p = exp2(l - m), the sum over the f32 p,
    p rounded to the output dtype (q's) before P.V, the division last. K
    and V are taken in q's dtype, as v6bd stages them."""
    k, v = k.to(q.dtype), v.to(q.dtype)
    logits = _logits(q, k, scale)
    p = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    s = p.sum(dim=-1)  # [B, H, Tq]
    acc = _pv(p.to(q.dtype), v)
    return (acc / s.permute(0, 2, 1)[..., None]).to(q.dtype)


def v7_attention_plain(q, k, v, scale: float):
    """v7: pb = exp2(clamp(l, -100, 100)) rounded to v's dtype, with no max
    subtraction; the sum over the rounded pb; out = (pb . v) / sum."""
    logits = _logits(q, k, scale)
    pb = torch.exp2(torch.clamp(logits, -100.0, 100.0)).to(v.dtype)
    s = pb.float().sum(dim=-1)
    acc = _pv(pb, v)
    return (acc / s.permute(0, 2, 1)[..., None]).to(q.dtype)


def _launch(name: str, variant: int, q, k, v, scale: float) -> torch.Tensor:
    q, k, v = (t.contiguous() for t in (q, k, v))
    _build.require_cuda(name, q, k, v)
    bsz, t, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if not _build.aligned16(q, k, v):
        raise ValueError(f"{name}: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    _build.check(_build.lib().a2k_attention_variant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, t, h, d,
        float(scale) * LOG2E, variant, _build.dtype_code(q), _build.stream_of(q),
    ), name)
    return out


def v6bd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """K7. q, k, v: [B, T, H, D] -> [B, T, H, D] in q.dtype."""
    check_shape("v6bd_attention", q, k, v)
    if not q.is_cuda:
        return v6bd_attention_plain(q, k, v, scale)
    out = _launch("v6bd_attention", 0, q, k, v, scale)
    v6bd_attention.launches += 1
    return out


def v7_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """K8. q, k, v: [B, T, H, D] -> [B, T, H, D] in q.dtype."""
    check_shape("v7_attention", q, k, v)
    if not q.is_cuda:
        return v7_attention_plain(q, k, v, scale)
    out = _launch("v7_attention", 1, q, k, v, scale)
    v7_attention.launches += 1
    return out


v6bd_attention.launches = 0
v7_attention.launches = 0
