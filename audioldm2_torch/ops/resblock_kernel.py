"""K1: fused GroupNorm + SiLU + 3x3 SAME conv (the ResBlock body).

Replaces ``audioldm2_tpu/ops/resblock_pallas.py`` (gn_silu_conv3x3,
_cat, _tiled, _cat_tiled) with one CUDA design in ``csrc/gn_silu_conv.cu``:
a two-pass GroupNorm stats kernel that folds the norm into a per-(B, C)
affine, then an implicit-GEMM conv that applies silu(x*a + c) as it loads
and zero-pads after the activation. ``x2`` is the decoder's skip tensor,
read in place of a materialized channel concat.

:func:`gn_silu_conv3x3` takes the plain version for CPU tensors and the
kernel for CUDA tensors; :func:`gn_silu_conv3x3_plain` is the oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

from audioldm2_torch.ops import _build
from audioldm2_torch.ops import nn as _nn


def gn_silu_conv3x3_plain(x1, x2, gn_scale, gn_bias, w, b, groups: int = 32,
                          eps: float = 1e-5):
    """conv3x3_SAME(silu(GN(concat(x1, x2)))) + b with the Pallas kernel's
    rounding points: GroupNorm and SiLU in f32, the activation rounded once
    to the weight dtype (x1.dtype), the conv accumulated in f32, the output
    rounded once. In f32 this is the JAX package's plain composition."""
    dt = x1.dtype
    x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
    h = _nn.group_norm_silu({"scale": gn_scale, "bias": gn_bias}, x.float(), groups, eps)
    y = _nn.conv2d({"w": w.to(dt).float(), "b": b}, h.to(dt).float())
    return y.to(dt)


def gn_silu_conv3x3(x1: torch.Tensor, x2: Optional[torch.Tensor], gn_scale, gn_bias, w, b,
                    groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """x1: [B, T, F, C1]; x2: [B, T, F, C2] or None; w: [3, 3, C1+C2, Cout]
    (HWIO); returns [B, T, F, Cout] in x1.dtype."""
    if not x1.is_cuda:
        return gn_silu_conv3x3_plain(x1, x2, gn_scale, gn_bias, w, b, groups, eps)
    name = "gn_silu_conv3x3"
    w = w.to(x1.dtype).contiguous()
    parts = (x1,) if x2 is None else (x1, x2)
    _build.require_cuda(name, *parts, w)
    if x1.dim() != 4 or (x2 is not None and (x2.dim() != 4 or x2.shape[:3] != x1.shape[:3])):
        raise ValueError(f"{name}: inputs must be [B, T, F, C] with equal B, T, F")
    bsz, t, f, c1 = x1.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    cin = c1 + c2
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: weight {tuple(w.shape)} is not [3, 3, {cin}, Cout]")
    if cin % groups:
        raise ValueError(f"{name}: {cin} channels do not split into {groups} groups")
    cout = w.shape[-1]
    dev = x1.device
    gamma = gn_scale.to(dev, torch.float32).contiguous()
    beta = gn_bias.to(dev, torch.float32).contiguous()
    bias = b.to(dev, torch.float32).contiguous()
    a = torch.empty((bsz, cin), device=dev, dtype=torch.float32)
    c = torch.empty((bsz, cin), device=dev, dtype=torch.float32)
    out = torch.empty((bsz, t, f, cout), device=dev, dtype=x1.dtype)
    lib = _build.lib()
    dt = _build.dtype_code(x1)
    stream = _build.stream_of(x1)
    x2_ptr = None if x2 is None else x2.data_ptr()
    _build.check(lib.a2k_gn_stats(
        x1.data_ptr(), x2_ptr, bsz, t * f, c1, c2, groups, float(eps),
        gamma.data_ptr(), beta.data_ptr(), a.data_ptr(), c.data_ptr(), dt, stream,
    ), "a2k_gn_stats")
    vec_a = c1 % 8 == 0 and c2 % 8 == 0 and _build.aligned16(x1, x2)
    ws, k_split, vec = _build.gemm_launch_args(dev, bsz * t * f, cout, 9 * cin, vec_a, w)
    _build.check(lib.a2k_gn_silu_conv3x3(
        x1.data_ptr(), x2_ptr, a.data_ptr(), c.data_ptr(), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), bsz, t, f, c1, c2, cout, None if ws is None else ws.data_ptr(),
        k_split, vec, dt, stream,
    ), name)
    gn_silu_conv3x3.launches += 1
    return out


gn_silu_conv3x3.launches = 0
