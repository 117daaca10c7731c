"""K1 and K1q: fused GroupNorm + SiLU + 3x3 SAME conv (the ResBlock body).

K1 replaces ``audioldm2_tpu/ops/resblock_pallas.py`` (gn_silu_conv3x3,
_cat, _tiled, _cat_tiled) with one CUDA design in ``csrc/gn_silu_conv.cu``:
a two-pass GroupNorm stats kernel that folds the norm into a per-(B, C)
affine, then an implicit-GEMM conv that applies silu(x*a + c) as it loads
and zero-pads after the activation. ``x2`` is the decoder's skip tensor,
read in place of a materialized channel concat. K1q replaces
``gn_silu_conv3x3_q`` (the int8 serving mode): the same design with an
int8 weight [3, 3, Cin, Cout] and a per-output-channel f32 scale.

:func:`gn_silu_conv3x3` and :func:`gn_silu_conv3x3_q` take their plain
versions for CPU tensors and the kernels for CUDA tensors; the ``*_plain``
functions are the oracles.
"""

from __future__ import annotations

from typing import Optional

import torch

from audioldm2_torch.ops import _build, groupnorm_kernel
from audioldm2_torch.ops import nn as _nn

BF16 = torch.bfloat16


def gn_silu_conv3x3_plain(x1, x2, gn_scale, gn_bias, w, b, groups: int = 32,
                          eps: float = 1e-5):
    """conv3x3_SAME(silu(GN(concat(x1, x2)))) + b with the Pallas kernel's
    rounding points: GroupNorm and SiLU in f32, the activation rounded once
    to the weight dtype (x1.dtype), the conv accumulated in f32, the output
    rounded once. In f32 this is the JAX package's plain composition."""
    dt = x1.dtype
    x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
    h = groupnorm_kernel.group_norm_silu_plain(x.float(), gn_scale, gn_bias, groups, eps)
    y = _nn.conv2d({"w": w.to(dt).float(), "b": b}, h.to(dt).float())
    return y.to(dt)


def gn_silu_conv3x3_q_plain(x1, x2, gn_scale, gn_bias, wq, ws, b, groups: int = 32,
                            eps: float = 1e-5):
    """conv3x3_SAME(silu(GN(concat(x1, x2)))) . dequant(wq) + b with the
    Pallas kernel's rounding points (``_kernel_q``): GroupNorm and SiLU in
    f32, the activation rounded to bf16 whatever x1's dtype, the int8 taps
    as exact f32, the conv accumulated in f32, then acc * ws + b and one
    rounding to x1.dtype."""
    x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
    h = groupnorm_kernel.group_norm_silu_plain(x.float(), gn_scale, gn_bias, groups, eps)
    zero = torch.zeros(wq.shape[-1], device=x1.device)
    acc = _nn.conv2d({"w": wq.float(), "b": zero}, h.to(BF16).float())
    return (acc * ws.float() + b.float()).to(x1.dtype)


def _launch(name, x1, x2, gn_scale, gn_bias, w, ws, b, groups, eps):
    """The GroupNorm stats kernel, then the conv: K1 (ws None, w in
    x1.dtype) or K1q (w int8, ws its f32 scale)."""
    parts = (x1,) if x2 is None else (x1, x2)
    _build.require_cuda(name, *parts)
    if ws is None:
        _build.require_cuda(name, x1, w)
    else:
        _build.require_int8(name, w, ws, x1.device)
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
    work, k_split, vec = _build.gemm_launch_args(dev, bsz * t * f, cout, 9 * cin, vec_a, w)
    work_ptr = None if work is None else work.data_ptr()
    if ws is None:
        rc = lib.a2k_gn_silu_conv3x3(
            x1.data_ptr(), x2_ptr, a.data_ptr(), c.data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), bsz, t, f, c1, c2, cout, work_ptr, k_split, vec, dt, stream)
    else:
        rc = lib.a2k_gn_silu_conv3x3_q(
            x1.data_ptr(), x2_ptr, a.data_ptr(), c.data_ptr(), w.data_ptr(), ws.data_ptr(),
            bias.data_ptr(), out.data_ptr(), bsz, t, f, c1, c2, cout, work_ptr, k_split, vec,
            dt, stream)
    _build.check(rc, name)
    return out


def gn_silu_conv3x3(x1: torch.Tensor, x2: Optional[torch.Tensor], gn_scale, gn_bias, w, b,
                    groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """x1: [B, T, F, C1]; x2: [B, T, F, C2] or None; w: [3, 3, C1+C2, Cout]
    (HWIO); returns [B, T, F, Cout] in x1.dtype."""
    if not x1.is_cuda:
        return gn_silu_conv3x3_plain(x1, x2, gn_scale, gn_bias, w, b, groups, eps)
    out = _launch("gn_silu_conv3x3", x1, x2, gn_scale, gn_bias, w.to(x1.dtype).contiguous(),
                  None, b, groups, eps)
    gn_silu_conv3x3.launches += 1
    return out


def gn_silu_conv3x3_q(x1: torch.Tensor, x2: Optional[torch.Tensor], gn_scale, gn_bias, wq, ws,
                      b, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """As gn_silu_conv3x3 with wq: int8 [3, 3, C1+C2, Cout] and ws: f32
    [Cout]; returns [B, T, F, Cout] in x1.dtype."""
    if not x1.is_cuda:
        return gn_silu_conv3x3_q_plain(x1, x2, gn_scale, gn_bias, wq, ws, b, groups, eps)
    ws = ws.to(x1.device, torch.float32).contiguous()
    out = _launch("gn_silu_conv3x3_q", x1, x2, gn_scale, gn_bias, wq, ws, b, groups, eps)
    gn_silu_conv3x3_q.launches += 1
    return out


gn_silu_conv3x3.launches = 0
gn_silu_conv3x3_q.launches = 0
