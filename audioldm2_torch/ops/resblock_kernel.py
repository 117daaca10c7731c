"""K1 and K1q: fused GroupNorm + SiLU + 3x3 SAME conv (the ResBlock body).

K1 replaces ``audioldm2_tpu/ops/resblock_pallas.py`` (gn_silu_conv3x3,
_cat, _tiled, _cat_tiled) with two launches of ``csrc/gn_silu_conv.cu``: a
split GroupNorm statistics pass (:func:`gn_stats`) that folds the norm into a
per-(B, C) affine, then the conv, which applies silu(x*a + c) to each input
patch once and zero-pads after the activation. The conv is its own kernel
under a launch plan (``_build.gn_silu_conv_plan``: a halo'd patch in shared
memory, nine shifted views of it, a cp.async ring of weight tiles,
mma.sync, a thread-block cluster splitting the input channels at small M),
in bf16 or, for the sr path's f32 VAE encode, in f32 with 3xTF32 products
(each operand split into two TF32 parts, three tensor-core products); at
the shapes the plan declines it runs on the shared GEMM core. ``x2`` is the
decoder's skip tensor, read in place of a materialized channel concat. K1q
replaces ``gn_silu_conv3x3_q`` (the int8 serving mode):
the same statistics, then, in bf16, the same conv kernel with an int8
weight [3, 3, Cin, Cout] streamed as int8 tiles and converted in shared
memory, and a per-output-channel f32 scale applied to the f32 sums
(``_build.gn_silu_conv_plan(..., w_bytes=1)``); in f32, and at the shapes
the plan declines, the shared core. The GroupNorm scale and bias, the conv
bias, and K1q's int8 weight and f32 scale are read as stored: no
conversion kernel runs before a bf16 K1 or K1q launch.

The plain conv (:func:`conv2d`: every bf16 conv2d of the UNet and the VAE
decoder outside the ResBlock bodies, which cuDNN would run on f32 copies)
replaces no Pallas function: the JAX package leaves those convs to XLA. It
is K1's bf16 kernel with its geometry at run time (``a2k_conv2d_bf16``): 1x1
or 3x3 taps, stride 1 or 2, the input read in place through a nearest-2x
upsample or as two concat parts, and a prologue of nothing or the GroupNorm
alone (the statistics pass, then x * a + c rounded once to bf16); bf16
products with f32 sums, the bias added to them and one rounding, as
``nn._conv_one_rounding`` computes on f32 copies; the output written
channels-last in bf16.

:func:`gn_silu_conv3x3` and :func:`gn_silu_conv3x3_q` take their plain
versions for CPU tensors and the kernels for CUDA tensors; the ``*_plain``
functions are the oracles. A CUDA call that autograd must record
(``autograd.needs_grad``) goes through ``autograd.KernelFunction``: K1 in
the forward, the plain version's gradients in the backward; K1q refuses it.
"""

from __future__ import annotations

from typing import Optional

import torch

from audioldm2_torch.ops import _build, autograd, groupnorm_kernel
from audioldm2_torch.ops import nn as _nn

BF16 = torch.bfloat16
SAME3 = ((1, 1), (1, 1))  # a 3x3 SAME conv's padding


def gn_silu_conv3x3_plain(x1, x2, gn_scale, gn_bias, w, b, groups: int = 32,
                          eps: float = 1e-5):
    """conv3x3_SAME(silu(GN(concat(x1, x2)))) + b with the Pallas kernel's
    rounding points: GroupNorm and SiLU in f32, the activation rounded once
    to the weight dtype (x1.dtype), the conv accumulated in f32, the output
    rounded once. In f32 this is the JAX package's plain composition."""
    dt = x1.dtype
    x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
    h = groupnorm_kernel.group_norm_silu_plain(x.float(), gn_scale, gn_bias, groups, eps)
    y = _nn.conv2d_plain({"w": w.to(dt).float(), "b": b}, h.to(dt).float(), (1, 1), SAME3)
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
    acc = _nn.conv2d_plain({"w": wq.float(), "b": zero}, h.to(BF16).float(), (1, 1), SAME3)
    return (acc * ws.float() + b.float()).to(x1.dtype)


def gn_stats(x1, x2, gn_scale, gn_bias, groups: int = 32, eps: float = 1e-5):
    """The GroupNorm statistics pass of K1 and K1q (``a2k_gn_stats``) on
    CUDA tensors: the per-(B, C) affine (a, c), f32 [B, C1+C2], that folds
    GroupNorm over [x1 ; x2] with scale and bias, y = x * a + c. The scale
    and bias are read as stored (bf16 or f32)."""
    name = "gn_stats"
    parts = (x1,) if x2 is None else (x1, x2)
    _build.require_cuda(name, *parts)
    bsz, c1 = x1.shape[0], x1.shape[-1]
    c2 = 0 if x2 is None else x2.shape[-1]
    cin = c1 + c2
    if cin % groups:
        raise ValueError(f"{name}: {cin} channels do not split into {groups} groups")
    s = x1.numel() // (bsz * c1) if x1.numel() else 0
    dev = x1.device
    (gamma, beta), param_code = _build.params_as_stored(dev, gn_scale, gn_bias)
    if gamma.shape != (cin,) or beta.shape != (cin,):
        raise ValueError(f"{name}: scale and bias must be [{cin}]")
    chunks = _build.gn_stats_chunks(s, cin) if s else 1
    if bsz > _build.GN_COUNTER_SLOTS:
        raise ValueError(f"{name}: batch {bsz} above {_build.GN_COUNTER_SLOTS}")
    ac = torch.empty((2, bsz, cin), device=dev, dtype=torch.float32)
    part = torch.empty((bsz, chunks, groups, 2), device=dev, dtype=torch.float32)
    _build.check(_build.lib().a2k_gn_stats(
        x1.data_ptr(), None if x2 is None else x2.data_ptr(), bsz, s, c1, c2, groups,
        float(eps), gamma.data_ptr(), beta.data_ptr(), param_code, ac[0].data_ptr(),
        ac[1].data_ptr(), part.data_ptr(), chunks,
        _build.gn_counter(dev.index or 0, _build.stream_of(x1)).data_ptr(),
        _build.dtype_code(x1), _build.stream_of(x1),
    ), "a2k_gn_stats")
    return ac[0], ac[1]


def _conv_kernel(x1, x2, a, c, w, b, out, ws=None):
    """The conv under its launch plan: K1 in bf16 (ws None), in f32 (3xTF32
    on the tensor cores) or K1q in bf16 (w int8, ws its f32 scale); False
    (nothing launched) for a dtype, shape or alignment the kernels do not
    take."""
    bsz, t, f, c1 = x1.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    cout = w.shape[-1]
    dev = x1.device
    f32 = x1.dtype == torch.float32
    plan = _build.gn_silu_conv_plan(bsz, t, f, c1 + c2, cout, _build.sm_count(dev.index or 0),
                                    "f32" if f32 else "bf16", 2 if ws is None else 1)
    (bias,), param_code = _build.params_as_stored(dev, b)
    if plan is None or c1 % 8 or c2 % 8 or not _build.aligned16(x1, x2, a, c, w, ws, bias, out):
        return False
    head = (x1.data_ptr(), None if x2 is None else x2.data_ptr(), a.data_ptr(), c.data_ptr(),
            w.data_ptr())
    tail = (bias.data_ptr(), param_code, out.data_ptr(), bsz, t, f, c1, c2, cout, plan.bm,
            plan.bn, plan.tt, plan.ft, plan.strip_tiles, plan.stages, plan.splits,
            _build.stream_of(x1))
    lib = _build.lib()
    if ws is not None:
        rc = lib.a2k_gn_silu_conv3x3_q_bf16(*head, ws.data_ptr(), *tail)
    elif f32:
        rc = lib.a2k_gn_silu_conv3x3_f32(*head, *tail)
    else:
        rc = lib.a2k_gn_silu_conv3x3_bf16(*head, *tail)
    _build.check(rc, "gn_silu_conv3x3" if ws is None else "gn_silu_conv3x3_q")
    return True


def _conv_shared_core(name, x1, x2, a, c, w, ws, b, out):
    """The conv on the shared GEMM core: K1 (ws None, w in x1.dtype) or K1q
    (w int8, ws its f32 scale), any dtype and alignment; a split-K
    workspace where M is small."""
    bsz, t, f, c1 = x1.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    cout = w.shape[-1]
    dev = x1.device
    bias = b.to(dev, torch.float32).contiguous()
    lib = _build.lib()
    dt = _build.dtype_code(x1)
    stream = _build.stream_of(x1)
    x2_ptr = None if x2 is None else x2.data_ptr()
    vec_a = c1 % 8 == 0 and c2 % 8 == 0 and _build.aligned16(x1, x2)
    work, k_split, vec = _build.gemm_launch_args(dev, bsz * t * f, cout, 9 * (c1 + c2), vec_a, w)
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


def _launch(name, x1, x2, gn_scale, gn_bias, w, ws, b, groups, eps):
    """The GroupNorm statistics pass, then the conv: K1 (ws None, w in
    x1.dtype) on its bf16 or f32 kernel, K1q (w int8, ws its f32 scale) on
    the bf16 kernel where x1 is bf16, where the plan takes the shape; else
    on the shared GEMM core."""
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
    if b.shape != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} is not [{cout}]")
    dev = x1.device
    a, c = gn_stats(x1, x2, gn_scale, gn_bias, groups, eps)
    out = torch.empty((bsz, t, f, cout), device=dev, dtype=x1.dtype)
    if not _conv_kernel(x1, x2, a, c, w, b, out, ws):
        # K1q in f32, and the shapes the plans decline
        _conv_shared_core(name, x1, x2, a, c, w, ws, b, out)
    return out


def gn_silu_conv3x3(x1: torch.Tensor, x2: Optional[torch.Tensor], gn_scale, gn_bias, w, b,
                    groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """x1: [B, T, F, C1]; x2: [B, T, F, C2] or None; w: [3, 3, C1+C2, Cout]
    (HWIO); returns [B, T, F, Cout] in x1.dtype."""
    if not x1.is_cuda:
        return gn_silu_conv3x3_plain(x1, x2, gn_scale, gn_bias, w, b, groups, eps)
    if autograd.needs_grad(x1, x2, gn_scale, gn_bias, w, b):
        return autograd.KernelFunction.apply(gn_silu_conv3x3, gn_silu_conv3x3_plain, x1, x2,
                                             gn_scale, gn_bias, w, b, groups, eps)
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
    if autograd.needs_grad(x1, x2, gn_scale, gn_bias, ws, b):
        autograd.refuse_grad("gn_silu_conv3x3_q")
    ws = ws.to(x1.device, torch.float32).contiguous()
    out = _launch("gn_silu_conv3x3_q", x1, x2, gn_scale, gn_bias, wq, ws, b, groups, eps)
    gn_silu_conv3x3_q.launches += 1
    return out


gn_silu_conv3x3.launches = 0
gn_silu_conv3x3_q.launches = 0


def conv2d_plain(x1, x2, w, b, gn_scale=None, gn_bias=None, stride: int = 1,
                 pads=((1, 1), (1, 1)), up: int = 1, groups: int = 32, eps: float = 1e-5):
    """The plain conv's oracle: conv(pro([x1 ; x2])) + b on nn.conv2d's f32
    copies with one rounding (``nn.conv2d_plain``), where pro is the
    GroupNorm (gn_scale given) rounded once to x1.dtype, as nn.group_norm
    rounds it, and the nearest upsample by ``up``."""
    x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
    if gn_scale is not None:
        x = _nn.group_norm({"scale": gn_scale, "bias": gn_bias}, x, groups, eps)
    if up > 1:
        x = _nn.nearest_upsample_2d(x, up, up)
    return _nn.conv2d_plain({"w": w, "b": b}, x, (stride, stride), pads)


def _conv2d_launch(x1, x2, w, b, gn_scale, gn_bias, stride, pads, up, groups, eps, plan=None):
    """The statistics pass (with a GroupNorm) and a2k_conv2d_bf16 under
    ``plan``, by default conv2d_plan's (tools.time_conv2d --sweep gives
    others)."""
    name = "conv2d"
    parts = (x1,) if x2 is None else (x1, x2)
    _build.require_cuda(name, *parts, w)
    if x1.dtype != BF16:
        raise TypeError(f"{name}: takes bfloat16, got {x1.dtype}")
    if x1.dim() != 4 or (x2 is not None and (x2.dim() != 4 or x2.shape[:3] != x1.shape[:3])):
        raise ValueError(f"{name}: inputs must be [B, T, F, C] with equal B, T, F")
    bsz, ti, fi, c1 = x1.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    k, cout = w.shape[0], w.shape[-1]
    if w.dim() != 4 or tuple(w.shape[1:3]) != (k, c1 + c2):
        raise ValueError(f"{name}: weight {tuple(w.shape)} is not [k, k, {c1 + c2}, Cout]")
    if b.shape != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} is not [{cout}]")
    (pt0, pt1), (pf0, pf1) = pads
    t = (ti * up + pt0 + pt1 - k) // stride + 1
    f = (fi * up + pf0 + pf1 - k) // stride + 1
    dev = x1.device
    plan = plan or _build.conv2d_plan(bsz, t, f, c1 + c2, cout, _build.sm_count(dev.index or 0),
                                      k, stride)
    if plan is None or up not in (1, 2) or min(pt0, pt1, pf0, pf1) < 0 or c1 % 8 or c2 % 8:
        raise ValueError(f"{name}: the kernel does not take a {k}x{k} conv at stride {stride}, "
                         f"padding {pads}, upsample {up} of {c1}+{c2} onto {cout} channels")
    a = c = None
    if gn_scale is not None:
        a, c = gn_stats(x1, x2, gn_scale, gn_bias, groups, eps)
    (bias,), param_code = _build.params_as_stored(dev, b)
    out = torch.empty((bsz, t, f, cout), device=dev, dtype=BF16)
    if not (all(t.is_contiguous() for t in (*parts, w)) and _build.aligned16(x1, x2, w, bias,
                                                                             out)):
        raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")
    _build.check(_build.lib().a2k_conv2d_bf16(
        x1.data_ptr(), None if x2 is None else x2.data_ptr(),
        None if a is None else a.data_ptr(), None if c is None else c.data_ptr(), w.data_ptr(),
        bias.data_ptr(), param_code, out.data_ptr(), bsz, t, f, ti, fi, c1, c2, cout, k, stride,
        int(up == 2), pt0, pf0, 0 if a is None else 2, plan.bm, plan.bn, plan.tt, plan.ft,
        plan.strip_tiles, plan.stages, plan.splits, _build.stream_of(x1),
    ), "a2k_conv2d_bf16")
    return out


def conv2d(x1: torch.Tensor, x2: Optional[torch.Tensor], w, b, gn_scale=None, gn_bias=None,
           stride: int = 1, pads=((1, 1), (1, 1)), up: int = 1, groups: int = 32,
           eps: float = 1e-5) -> torch.Tensor:
    """The plain conv: x1 [B, Ti, Fi, C1], x2 [B, Ti, Fi, C2] or None; w [k, k,
    C1+C2, Cout] (HWIO, k 1 or 3), stride 1 or 2, pads ((low, high) in T,
    (low, high) in F) of the input as read, up 1 or 2 (a nearest upsample
    read in place); gn_scale, gn_bias [C1+C2]: the GroupNorm before the conv
    (``groups``, ``eps``), or None. Returns [B, T, F, Cout] in bf16. A
    bf16 CUDA call is one statistics pass (with a GroupNorm) and one
    ``a2k_conv2d_bf16``; CPU tensors take conv2d_plain. ``nn`` dispatches
    here only what ``nn.conv2d_uses_kernel`` takes; a bf16 CUDA call it does
    not take counts in ``conv2d.declined``."""
    if not x1.is_cuda:
        return conv2d_plain(x1, x2, w, b, gn_scale, gn_bias, stride, pads, up, groups, eps)
    if autograd.needs_grad(x1, x2, w, b, gn_scale, gn_bias):
        return autograd.KernelFunction.apply(conv2d, conv2d_plain, x1, x2, w, b, gn_scale,
                                             gn_bias, stride, pads, up, groups, eps)
    out = _conv2d_launch(x1.contiguous(), None if x2 is None else x2.contiguous(),
                         w.to(x1.dtype).contiguous(), b, gn_scale, gn_bias, stride, pads, up,
                         groups, eps)
    conv2d.launches += 1
    return out


conv2d.launches = 0
conv2d.declined = 0
