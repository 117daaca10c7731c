"""K3: LayerNorm + matmul, and K4: GEGLU gate + matmul + residual.

Replace ``audioldm2_tpu/ops/lnmm_pallas.py:ln_matmul`` and
``geglu_matmul`` (full-precision weights; the int8 ``w_scale`` paths are
not ported yet) with ``csrc/lnmm.cu``: the LN output and the gate product
are computed as the GEMM loads its A tile and never reach device memory.

Each wrapper takes the plain version for CPU tensors and the kernel for
CUDA tensors; the ``*_plain`` functions are the oracles.
"""

from __future__ import annotations

from typing import Optional

import torch

from audioldm2_torch.ops import _build
from audioldm2_torch.ops import nn as _nn


def ln_matmul_plain(x, ln_scale, ln_bias, w, bias=None, eps: float = 1e-5):
    """linear(layer_norm(x)) with the Pallas kernel's rounding points: LN in
    f32, rounded once to the weight dtype (x.dtype), the product accumulated
    in f32 with the bias, the output rounded once."""
    dt = x.dtype
    y = _nn.layer_norm({"scale": ln_scale, "bias": ln_bias}, x.float(), eps).to(dt)
    p_lin = {"w": w.to(dt).float()}
    if bias is not None:
        p_lin["b"] = bias
    return _nn.linear(p_lin, y.float()).to(dt)


def geglu_matmul_plain(h, w, bias, residual):
    """residual + (a * gelu(g)) @ w + bias with the Pallas kernel's rounding
    points: the gate product in f32, rounded once to the weight dtype
    (h.dtype), product, bias and residual summed in f32, one rounding to the
    residual dtype."""
    a, gate = torch.chunk(h.float(), 2, dim=-1)
    u = (a * _nn.gelu(gate)).to(h.dtype).float()
    out = torch.matmul(u, w.to(h.dtype).float()) + bias.float() + residual.float()
    return out.to(residual.dtype)


def ln_matmul(x: torch.Tensor, ln_scale, ln_bias, w, bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """x: [..., C]; w: [C, N]; returns [..., N] in x.dtype."""
    if not x.is_cuda:
        return ln_matmul_plain(x, ln_scale, ln_bias, w, bias, eps)
    name = "ln_matmul"
    w = w.to(x.dtype).contiguous()
    x = x.contiguous()
    _build.require_cuda(name, x, w)
    c = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != c:
        raise ValueError(f"{name}: weight {tuple(w.shape)} is not [{c}, N]")
    n = w.shape[1]
    m = x.numel() // c
    dev = x.device
    gamma = ln_scale.to(dev, torch.float32).contiguous()
    beta = ln_bias.to(dev, torch.float32).contiguous()
    b = None if bias is None else bias.to(dev, torch.float32).contiguous()
    out = torch.empty((*x.shape[:-1], n), device=dev, dtype=x.dtype)
    vec_a = c % 8 == 0 and _build.aligned16(x, gamma, beta)
    ws, k_split, vec = _build.gemm_launch_args(dev, m, n, c, vec_a, w)
    _build.check(_build.lib().a2k_ln_matmul(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), m, c, n, float(eps),
        None if ws is None else ws.data_ptr(), k_split, vec,
        _build.dtype_code(x), _build.stream_of(x),
    ), name)
    ln_matmul.launches += 1
    return out


def geglu_matmul(h: torch.Tensor, w, bias, residual: torch.Tensor) -> torch.Tensor:
    """h: [..., 2F] (value | gate); w: [F, N]; residual: [..., N]; returns
    residual + (a * gelu(g)) @ w + bias in residual.dtype."""
    if not h.is_cuda:
        return geglu_matmul_plain(h, w, bias, residual)
    name = "geglu_matmul"
    w = w.to(h.dtype).contiguous()
    h = h.contiguous()
    residual = residual.contiguous()
    _build.require_cuda(name, h, w, residual)
    f2 = h.shape[-1]
    f = f2 // 2
    if f2 % 2 or w.dim() != 2 or w.shape[0] != f:
        raise ValueError(f"{name}: h [..., {f2}] does not match weight {tuple(w.shape)}")
    n = w.shape[1]
    m = h.numel() // f2
    if residual.shape != (*h.shape[:-1], n):
        raise ValueError(f"{name}: residual {tuple(residual.shape)} is not [..., {n}]")
    b = bias.to(h.device, torch.float32).contiguous()
    out = torch.empty_like(residual)
    vec_a = f % 8 == 0 and _build.aligned16(h)
    ws, k_split, vec = _build.gemm_launch_args(h.device, m, n, f, vec_a, w)
    _build.check(_build.lib().a2k_geglu_matmul(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), residual.data_ptr(), out.data_ptr(),
        m, f, n, None if ws is None else ws.data_ptr(), k_split, vec,
        _build.dtype_code(h), _build.stream_of(h),
    ), name)
    geglu_matmul.launches += 1
    return out


ln_matmul.launches = 0
geglu_matmul.launches = 0
