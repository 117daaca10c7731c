"""K6: GroupNorm (+ SiLU) with no conv after it.

K6 replaces ``audioldm2_tpu/ops/groupnorm_pallas.py`` (group_norm_silu)
with two launches: K1's split statistics pass (``a2k_gn_stats`` in
``csrc/gn_silu_conv.cu`` through ``resblock_kernel.gn_stats``, one input),
which folds the norm into a per-(B, C) affine (a, c), then an elementwise
pass ``y = silu(x * a + c)``
(``a2k_gn_apply`` in ``csrc/groupnorm.cu``). Statistics, affine and SiLU
are f32 and the output is rounded once to x's dtype, as the Pallas kernel
does.

:func:`group_norm_silu` takes the plain version for CPU tensors and the
kernel for CUDA tensors; :func:`group_norm_silu_plain` is the oracle.
"""

from __future__ import annotations

import torch

from audioldm2_torch.ops import _build, resblock_kernel
from audioldm2_torch.ops import nn as _nn


def group_norm_silu_plain(x, gn_scale, gn_bias, groups: int = 32, eps: float = 1e-5,
                          silu: bool = True):
    """silu(GN(x) * gamma + beta) with the Pallas kernel's rounding points:
    statistics, affine and SiLU in f32, the output rounded once to x.dtype."""
    y = _nn.group_norm({"scale": gn_scale, "bias": gn_bias}, x.float(), groups, eps)
    if silu:
        y = _nn.silu(y)
    return y.to(x.dtype)


def group_norm_silu(x: torch.Tensor, gn_scale, gn_bias, groups: int = 32, eps: float = 1e-5,
                    silu: bool = True) -> torch.Tensor:
    """x: [B, ..., C] channels-last, f32 or bf16; returns x's shape and
    dtype."""
    if not x.is_cuda:
        return group_norm_silu_plain(x, gn_scale, gn_bias, groups, eps, silu)
    name = "group_norm_silu"
    _build.require_cuda(name, x)
    if x.dim() < 2:
        raise ValueError(f"{name}: input must be [B, ..., C], got {tuple(x.shape)}")
    bsz, c = x.shape[0], x.shape[-1]
    if c % groups:
        raise ValueError(f"{name}: {c} channels do not split into {groups} groups")
    s = x.numel() // (bsz * c) if x.numel() else 0
    a, shift = resblock_kernel.gn_stats(x, None, gn_scale, gn_bias, groups, eps)
    out = torch.empty_like(x)
    lib = _build.lib()
    dt = _build.dtype_code(x)
    stream = _build.stream_of(x)
    vec = c % 8 == 0 and _build.aligned16(x, out)
    _build.check(lib.a2k_gn_apply(
        x.data_ptr(), a.data_ptr(), shift.data_ptr(), out.data_ptr(), bsz, s, c, int(silu),
        int(vec), dt, stream,
    ), name)
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
