"""K6: GroupNorm (+ SiLU) with no conv after it.

K6 replaces ``audioldm2_tpu/ops/groupnorm_pallas.py`` (group_norm_silu)
with two launches: K1's two-pass stats kernel (``a2k_gn_stats`` in
``csrc/gn_silu_conv.cu``, one input), which folds the norm into a per-(B, C)
affine (a, c), then an elementwise pass ``y = silu(x * a + c)``
(``a2k_gn_apply`` in ``csrc/groupnorm.cu``). Statistics, affine and SiLU
are f32 and the output is rounded once to x's dtype, as the Pallas kernel
does.

:func:`group_norm_silu` takes the plain version for CPU tensors and the
kernel for CUDA tensors; :func:`group_norm_silu_plain` is the oracle.
"""

from __future__ import annotations

import torch

from audioldm2_torch.ops import _build
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
    dev = x.device
    gamma = gn_scale.to(dev, torch.float32).contiguous()
    beta = gn_bias.to(dev, torch.float32).contiguous()
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"{name}: scale and bias must be [{c}]")
    s = x.numel() // (bsz * c) if x.numel() else 0
    a = torch.empty((bsz, c), device=dev, dtype=torch.float32)
    shift = torch.empty((bsz, c), device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    lib = _build.lib()
    dt = _build.dtype_code(x)
    stream = _build.stream_of(x)
    _build.check(lib.a2k_gn_stats(
        x.data_ptr(), None, bsz, s, c, 0, groups, float(eps), gamma.data_ptr(),
        beta.data_ptr(), a.data_ptr(), shift.data_ptr(), dt, stream,
    ), "a2k_gn_stats")
    vec = c % 8 == 0 and _build.aligned16(x, out)
    _build.check(lib.a2k_gn_apply(
        x.data_ptr(), a.data_ptr(), shift.data_ptr(), out.data_ptr(), bsz, s, c, int(silu),
        int(vec), dt, stream,
    ), name)
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
