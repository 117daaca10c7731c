"""K3: LayerNorm + matmul, K4: GEGLU gate + matmul + residual, their int8
variants K3q/K4q, and K5: int8-weight matmul.

K3 and K4 replace ``audioldm2_tpu/ops/lnmm_pallas.py:ln_matmul`` and
``geglu_matmul`` with ``csrc/lnmm.cu``: the LN output and the gate product
never reach device memory. In bf16 both run one pipelined row-block kernel
under a launch plan (``_build.ln_matmul_plan``, ``_build.geglu_matmul_plan``):
each block forms its rows' A tile once in shared memory (K3 the LayerNorm,
K4 the gate product a * gelu(g)) and walks a strip of N tiles; parameters
are read as stored. In f32, or at a shape a plan does not take, they
compute their A tile as the shared GEMM core loads it.
K3q and K4q are the Pallas functions' ``w_scale`` path: an int8 weight
tile converted to bf16 in shared memory, the A tile rounded to bf16
whatever x's dtype, and the per-column scale applied to the f32
accumulator. K5 replaces ``lnmm_pallas.int8_matmul``: a plain GEMM with
the int8 weight, whose activation stays in x's dtype. In bf16 all three run
the row-block kernel with an int8 ring (``_build.ln_matmul_plan(...,
w_bytes=1)``, ``geglu_matmul_plan(..., w_bytes=1)``, ``int8_matmul_plan``;
K5's pass only copies x's rows); in f32, or at a shape or an alignment a
plan does not take, the shared GEMM core.

Each wrapper takes the plain version for CPU tensors and the kernel for
CUDA tensors; the ``*_plain`` functions are the oracles. A CUDA call that
autograd must record (``autograd.needs_grad``) goes through
``autograd.KernelFunction`` for K3 and K4 (the kernel forward, the plain
version's gradients backward); K3q, K4q and K5 refuse it.
"""

from __future__ import annotations

from typing import Optional

import torch

from audioldm2_torch.ops import _build, autograd
from audioldm2_torch.ops import nn as _nn

BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# Plain versions (the Pallas kernels' rounding points)
# ---------------------------------------------------------------------------


def _scaled(acc: torch.Tensor, ws, bias) -> torch.Tensor:
    """The int8 epilogue in f32: acc * ws (+ bias)."""
    acc = acc * ws.float()
    return acc if bias is None else acc + bias.float()


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


def ln_matmul_q_plain(x, ln_scale, ln_bias, wq, ws, bias=None, eps: float = 1e-5):
    """ln_matmul with an int8 weight (``_ln_matmul_kernel`` with w_scale):
    LN in f32 rounded to bf16 whatever x's dtype, the int8 weight as exact
    f32, an f32 product, * ws + bias, one rounding to x.dtype."""
    y = _nn.layer_norm({"scale": ln_scale, "bias": ln_bias}, x.float(), eps)
    return _scaled(y.to(BF16).float() @ wq.float(), ws, bias).to(x.dtype)


def geglu_matmul_q_plain(h, wq, ws, bias, residual):
    """geglu_matmul with an int8 weight (``_geglu_matmul_kernel`` with
    w_scale): the gate product rounded to bf16 whatever h's dtype, an f32
    product, * ws + bias + residual, one rounding to residual.dtype."""
    a, gate = torch.chunk(h.float(), 2, dim=-1)
    u = (a * _nn.gelu(gate)).to(BF16).float()
    return (_scaled(u @ wq.float(), ws, bias) + residual.float()).to(residual.dtype)


def int8_matmul_plain(x, wq, ws, bias=None):
    """x @ dequant(wq) + bias as ``_matmul_kernel``: x is not rounded (the
    int8 values are exact in any float type), an f32 product, * ws + bias,
    one rounding to x.dtype."""
    return _scaled(x.float() @ wq.float(), ws, bias).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _f32(t: Optional[torch.Tensor], dev) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dev, torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _weight(name, x, w, ws, k):
    """Checks of the [K, N] weight (in x.dtype, or int8 with its scale)."""
    if ws is None:
        _build.require_cuda(name, x, w)
    else:
        _build.require_int8(name, w, ws, x.device)
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"{name}: weight {tuple(w.shape)} is not [{k}, N]")
    return w.shape[1]


def _ln(name, x, ln_scale, ln_bias, w, ws, bias, eps):
    x = x.contiguous()
    _build.require_cuda(name, x)
    c = x.shape[-1]
    n = _weight(name, x, w, ws, c)
    m = x.numel() // c
    dev = x.device
    gamma, beta, b = _f32(ln_scale, dev), _f32(ln_bias, dev), _f32(bias, dev)
    out = torch.empty((*x.shape[:-1], n), device=dev, dtype=x.dtype)
    vec_a = c % 8 == 0 and _build.aligned16(x, gamma, beta)
    work, k_split, vec = _build.gemm_launch_args(dev, m, n, c, vec_a, w)
    lib = _build.lib()
    head = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr())
    tail = (_ptr(b), out.data_ptr(), m, c, n, float(eps), _ptr(work), k_split, vec,
            _build.dtype_code(x), _build.stream_of(x))
    if ws is None:
        rc = lib.a2k_ln_matmul(*head, *tail)
    else:
        rc = lib.a2k_ln_matmul_q(*head, ws.data_ptr(), *tail)
    _build.check(rc, name)
    return out


# The LN scale and bias and the linear bias (or None) as the bf16 K3 kernel
# reads them: (tensors, param dtype code).
_ln_params = _build.params_as_stored


def _ln_bf16(name, x, ln_scale, ln_bias, w, bias, eps, ws=None):
    """The bf16 K3 kernel (ws None) or K3q (w int8, ws its f32 scale) under
    its launch plan, or None for a shape or an alignment it does not take.
    The parameters, wq and ws are read as stored."""
    x = x.contiguous()
    c = x.shape[-1]
    n = _weight(name, x, w, ws, c)
    m = x.numel() // c
    dev = x.device
    w_bytes = 2 if ws is None else 1
    plan = (_build.ln_matmul_plan(m, c, n, _build.sm_count(dev.index or 0), w_bytes)
            if m else None)
    (gamma, beta, b), param_code = _ln_params(dev, ln_scale, ln_bias, bias)
    if gamma.shape != (c,) or beta.shape != (c,) or (b is not None and b.shape != (n,)):
        raise ValueError(f"{name}: LN parameters must be [{c}] and the bias [{n}]")
    if plan is None or not _build.aligned16(x, w, ws, gamma, beta, b):
        return None
    out = torch.empty((*x.shape[:-1], n), device=dev, dtype=x.dtype)
    lib = _build.lib()
    head = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr())
    tail = (_ptr(b), param_code, out.data_ptr(), m, c, n, float(eps), plan.bm, plan.bn,
            plan.strip_tiles, plan.stages)
    if ws is None:
        rc = lib.a2k_ln_matmul_bf16(*head, *tail, _build.stream_of(x))
    else:
        rc = lib.a2k_ln_matmul_q_bf16(*head, ws.data_ptr(), *tail, _build.stream_of(x))
    _build.check(rc, name)
    return out


def _geglu(name, h, w, ws, bias, residual):
    h = h.contiguous()
    residual = residual.contiguous()
    _build.require_cuda(name, h, residual)
    f2 = h.shape[-1]
    f = f2 // 2
    if f2 % 2:
        raise ValueError(f"{name}: h [..., {f2}] has no value | gate halves")
    n = _weight(name, h, w, ws, f)
    m = h.numel() // f2
    if residual.shape != (*h.shape[:-1], n):
        raise ValueError(f"{name}: residual {tuple(residual.shape)} is not [..., {n}]")
    if bias.shape != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} is not [{n}]")
    out = torch.empty_like(residual)
    if h.dtype == BF16 and m:
        plan = _build.geglu_matmul_plan(m, f, n, _build.sm_count(h.device.index or 0),
                                        w_bytes=2 if ws is None else 1)
        (b,), param_code = _build.params_as_stored(h.device, bias)
        if plan is not None and _build.aligned16(h, w, ws, b, residual, out):
            tail = (b.data_ptr(), param_code, residual.data_ptr(), out.data_ptr(), m, f, n,
                    plan.bm, plan.bn, plan.strip_tiles, plan.stages, plan.splits,
                    _build.stream_of(h))
            lib = _build.lib()
            if ws is None:
                rc = lib.a2k_geglu_matmul_bf16(h.data_ptr(), w.data_ptr(), *tail)
            else:
                rc = lib.a2k_geglu_matmul_q_bf16(h.data_ptr(), w.data_ptr(), ws.data_ptr(), *tail)
            _build.check(rc, name)
            return out
    return _geglu_shared_core(name, h, w, ws, bias, residual, out)


def _geglu_shared_core(name, h, w, ws, bias, residual, out):
    """K4 or K4q on the shared GEMM core: f32, and the bf16 shapes or
    alignments the plans decline."""
    m, f, n = h.numel() // h.shape[-1], h.shape[-1] // 2, out.shape[-1]
    b = _f32(bias, h.device)
    vec_a = f % 8 == 0 and _build.aligned16(h)
    work, k_split, vec = _build.gemm_launch_args(h.device, m, n, f, vec_a, w)
    lib = _build.lib()
    tail = (b.data_ptr(), residual.data_ptr(), out.data_ptr(), m, f, n, _ptr(work), k_split,
            vec, _build.dtype_code(h), _build.stream_of(h))
    if ws is None:
        rc = lib.a2k_geglu_matmul(h.data_ptr(), w.data_ptr(), *tail)
    else:
        rc = lib.a2k_geglu_matmul_q(h.data_ptr(), w.data_ptr(), ws.data_ptr(), *tail)
    _build.check(rc, name)
    return out


def ln_matmul(x: torch.Tensor, ln_scale, ln_bias, w, bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """x: [..., C]; w: [C, N]; returns [..., N] in x.dtype."""
    if not x.is_cuda:
        return ln_matmul_plain(x, ln_scale, ln_bias, w, bias, eps)
    if autograd.needs_grad(x, ln_scale, ln_bias, w, bias):
        return autograd.KernelFunction.apply(ln_matmul, ln_matmul_plain, x, ln_scale, ln_bias, w,
                                             bias, eps)
    w = w.to(x.dtype).contiguous()
    out = _ln_bf16("ln_matmul", x, ln_scale, ln_bias, w, bias, eps) if x.dtype == BF16 else None
    if out is None:  # f32, or C or N no multiple of 8, or unaligned: the shared core
        out = _ln("ln_matmul", x, ln_scale, ln_bias, w, None, bias, eps)
    ln_matmul.launches += 1
    return out


def geglu_matmul(h: torch.Tensor, w, bias, residual: torch.Tensor) -> torch.Tensor:
    """h: [..., 2F] (value | gate); w: [F, N]; residual: [..., N]; returns
    residual + (a * gelu(g)) @ w + bias in residual.dtype."""
    if not h.is_cuda:
        return geglu_matmul_plain(h, w, bias, residual)
    if autograd.needs_grad(h, w, bias, residual):
        return autograd.KernelFunction.apply(geglu_matmul, geglu_matmul_plain, h, w, bias, residual)
    out = _geglu("geglu_matmul", h, w.to(h.dtype).contiguous(), None, bias, residual)
    geglu_matmul.launches += 1
    return out


def ln_matmul_q(x: torch.Tensor, ln_scale, ln_bias, wq, ws,
                bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., C]; wq: int8 [C, N]; ws: f32 [N]; returns [..., N] in x.dtype."""
    if not x.is_cuda:
        return ln_matmul_q_plain(x, ln_scale, ln_bias, wq, ws, bias, eps)
    if autograd.needs_grad(x, ln_scale, ln_bias, ws, bias):
        autograd.refuse_grad("ln_matmul_q")
    ws = _f32(ws, x.device)
    out = (_ln_bf16("ln_matmul_q", x, ln_scale, ln_bias, wq, bias, eps, ws)
           if x.dtype == BF16 else None)
    if out is None:  # f32, or a shape or an alignment the plan declines: the shared core
        out = _ln("ln_matmul_q", x, ln_scale, ln_bias, wq, ws, bias, eps)
    ln_matmul_q.launches += 1
    return out


def geglu_matmul_q(h: torch.Tensor, wq, ws, bias, residual: torch.Tensor) -> torch.Tensor:
    """h: [..., 2F]; wq: int8 [F, N]; ws: f32 [N]; residual: [..., N];
    returns residual + (a * gelu(g)) @ dequant(wq) + bias in residual.dtype."""
    if not h.is_cuda:
        return geglu_matmul_q_plain(h, wq, ws, bias, residual)
    if autograd.needs_grad(h, ws, bias, residual):
        autograd.refuse_grad("geglu_matmul_q")
    out = _geglu("geglu_matmul_q", h, wq, _f32(ws, h.device), bias, residual)
    geglu_matmul_q.launches += 1
    return out


def int8_matmul(x: torch.Tensor, wq, ws, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., K]; wq: int8 [K, N]; ws: f32 [N]; returns
    x @ dequant(wq) + bias in x.dtype."""
    if not x.is_cuda:
        return int8_matmul_plain(x, wq, ws, bias)
    if autograd.needs_grad(x, ws, bias):
        autograd.refuse_grad("int8_matmul")
    name = "int8_matmul"
    x = x.contiguous()
    _build.require_cuda(name, x)
    k = x.shape[-1]
    ws = _f32(ws, x.device)
    n = _weight(name, x, wq, ws, k)
    m = x.numel() // k
    dev = x.device
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} is not [{n}]")
    out = torch.empty((*x.shape[:-1], n), device=dev, dtype=x.dtype)
    plan = (_build.int8_matmul_plan(m, k, n, _build.sm_count(dev.index or 0))
            if x.dtype == BF16 and m else None)
    (b,), param_code = _build.params_as_stored(dev, bias)
    if plan is not None and _build.aligned16(x, wq, ws, b, out):
        _build.check(_build.lib().a2k_int8_matmul_bf16(
            x.data_ptr(), wq.data_ptr(), ws.data_ptr(), _ptr(b), param_code, out.data_ptr(),
            m, k, n, plan.bm, plan.bn, plan.strip_tiles, plan.stages, plan.splits,
            _build.stream_of(x),
        ), name)
    else:  # f32, or a shape or an alignment the plan declines
        _int8_shared_core(name, x, wq, ws, bias, out)
    int8_matmul.launches += 1
    return out


def _int8_shared_core(name, x, wq, ws, bias, out):
    """K5 on the shared GEMM core (f32, and the bf16 shapes or alignments
    the plan declines) into ``out``."""
    k, n = x.shape[-1], out.shape[-1]
    m = x.numel() // k
    b = _f32(bias, x.device)
    vec_a = k % 8 == 0 and _build.aligned16(x)
    work, k_split, vec = _build.gemm_launch_args(x.device, m, n, k, vec_a, wq)
    _build.check(_build.lib().a2k_int8_matmul(
        x.data_ptr(), wq.data_ptr(), ws.data_ptr(), _ptr(b), out.data_ptr(), m, k, n,
        _ptr(work), k_split, vec, _build.dtype_code(x), _build.stream_of(x),
    ), name)
    return out


ln_matmul.launches = 0
geglu_matmul.launches = 0
ln_matmul_q.launches = 0
geglu_matmul_q.launches = 0
int8_matmul.launches = 0
