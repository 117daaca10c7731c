"""K6: GroupNorm (+ SiLU) with no conv after it.

K6 replaces ``audioldm2_tpu/ops/groupnorm_pallas.py`` (group_norm_silu)
with one cooperative launch of ``a2k_group_norm_silu``
(``csrc/groupnorm.cu``) under ``_build.group_norm_silu_plan``: the blocks
of a sample hold its rows in shared memory, form exact two-pass group
statistics there, meet at a per-sample barrier, each combine the sample's
partials in the same fixed order and write ``y = silu(x * a + c)`` from
shared memory, so x is read once and y written once. A batch above the SM
count is taken that many samples at a time in the same launch; the barrier
words and partials belong to the stream the launch is on. Statistics,
affine and SiLU are f32 and the output is rounded once to x's dtype, as
the Pallas kernel does.

:func:`group_norm_silu` takes the plain version for CPU tensors and the
kernel for CUDA tensors; :func:`group_norm_silu_plain` is the oracle. A
CUDA call that autograd must record goes through ``autograd.KernelFunction``
(the kernel forward, the plain version's gradients backward).
"""

from __future__ import annotations

import torch

from audioldm2_torch.ops import _build, autograd
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
    if autograd.needs_grad(x, gn_scale, gn_bias):
        return autograd.KernelFunction.apply(group_norm_silu, group_norm_silu_plain, x, gn_scale,
                                             gn_bias, groups, eps, silu)
    name = "group_norm_silu"
    _build.require_cuda(name, x)
    if x.dim() < 2:
        raise ValueError(f"{name}: input must be [B, ..., C], got {tuple(x.shape)}")
    bsz, c = x.shape[0], x.shape[-1]
    if c % groups:
        raise ValueError(f"{name}: {c} channels do not split into {groups} groups")
    s = x.numel() // (bsz * c) if x.numel() else 0
    dev = x.device
    (gamma, beta), param_code = _build.params_as_stored(dev, gn_scale, gn_bias)
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"{name}: scale and bias must be [{c}]")
    out = torch.empty_like(x)
    if s == 0:
        return out
    index = dev.index or 0
    stream = _build.stream_of(x)
    dt = _build.dtype_code(x)
    vec = c % 8 == 0 and _build.aligned16(x, out)
    plan = _build.group_norm_silu_plan(bsz, s, c, "bf16" if dt else "f32",
                                       _build.sm_count(index), groups, vec)
    if plan is None:
        raise ValueError(f"{name}: no launch plan for [{bsz}, {s}, {c}] on this card")
    occupancy = _build.gn_silu_occupancy(index, dt, vec, plan.smem_bytes)
    if plan.grid > occupancy * _build.sm_count(index):
        raise RuntimeError(f"{name}: {plan.grid} blocks do not fit on the card at once "
                           f"({occupancy} a SM)")
    part = _build.gn_partials(index, stream)
    bar = _build.gn_barrier(index, stream)
    if bsz * plan.blocks_per_sample * groups * 2 > part.numel() or 2 * bsz > bar.numel():
        raise ValueError(f"{name}: {bsz} samples x {plan.blocks_per_sample} blocks x {groups} "
                         f"groups exceed the scratch")
    _build.check(_build.lib().a2k_group_norm_silu(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), param_code, out.data_ptr(), bsz, s, c,
        groups, float(eps), int(silu), plan.slots, plan.blocks_per_sample, plan.rows,
        plan.rows_held, int(vec), part.data_ptr(), bar.data_ptr(), dt, stream,
    ), name)
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
