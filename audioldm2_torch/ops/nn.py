"""Core neural-net ops on torch tensors, in the JAX package's layout.

Layout (same as ``audioldm2_tpu.ops.nn``): activations are channels-last
([B, T, C] / [B, H, W, C]); conv weights are HWIO ([kh, kw, in, out]);
1-D conv weights are [k, in, out]; transposed-conv weights are
[k, out, in]. Conversion to torch's NCHW/OIHW happens inside each op, so
every public function takes and returns the JAX layout.

Numerics: normalizations and softmax compute in float32 and cast back to
the input dtype. Matmuls and convs take the bias inside the op
(``F.linear``, ``F.conv*d(..., bias=)``), so the f32 accumulator and the
bias are summed before the one rounding to the input dtype, as the JAX ops
do with ``preferred_element_type``; a bias of another dtype than the input
sends the op through float32 with one rounding at the end.

On a CUDA bf16 input cuDNN rounds the conv product before PyTorch adds
the bias, so ``conv1d`` and ``conv_transpose1d`` convolve exact f32 copies
there and round once (``_conv_one_rounding``). ``conv2d`` (and
``gn_conv2d``, ``upsample_conv2d``, ``conv1x1_cat``) on a CUDA bf16 input
takes the plain conv kernel with the same one rounding
(``resblock_kernel.conv2d``) where ``conv2d_uses_kernel`` says so; the rest
keeps the f32 copies, counted as declined.

Dispatch points (``gn_silu_conv``, ``gn_silu_conv_cat``, ``group_norm_silu``,
``ln_linear``, ``geglu_ff_out``, ``attention``, ``linear`` for an int8
weight, and the plain convs above) route by device: a CPU tensor takes the
plain composition; a CUDA tensor takes the hand-written Hopper kernel, whose
wrapper raises if the kernel cannot take the call. A parameter dict with
``"wq"`` (``ops.quant``) selects the int8 kernels.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Plain ops
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_f32():
    """Full-precision f32 matmuls and cuDNN convs (no TF32) inside the block,
    whatever the process-wide settings; the previous settings come back on
    exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _one_rounding(op, x: torch.Tensor, w: torch.Tensor, b, **kw) -> torch.Tensor:
    """op(x, w, bias=b) with the bias summed into the accumulator before the
    one rounding to x.dtype. A bias in x.dtype goes into the op itself; any
    other bias (an f32 bias on a bf16 input) runs the op in f32."""
    if b is None or b.dtype == x.dtype:
        return op(x, w.to(x.dtype), b, **kw)
    return op(x.float(), w.to(x.dtype).float(), b.float(), **kw).to(x.dtype)


def _conv_one_rounding(op, x: torch.Tensor, w: torch.Tensor, b, **kw) -> torch.Tensor:
    """_one_rounding for the cuDNN convs. On a CUDA bf16 input cuDNN returns
    the product already rounded to bf16 and PyTorch adds the bias after it
    (two roundings), so the conv runs on exact f32 copies of the bf16
    operands with an f32 bias, and the sum is rounded once. TF32 stays off
    there: cuDNN's TF32 convs of those copies left 0.1-0.2% of outputs off
    one rounding on an H100, full f32 none."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        return _one_rounding(op, x, w, b, **kw)
    with full_f32():
        y = op(x.float(), w.to(x.dtype).float(), None if b is None else b.float(), **kw)
    return y.to(x.dtype)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    if "wq" in p:  # int8 weight (ops/quant.py): K5
        from audioldm2_torch.ops import lnmm_kernel

        return lnmm_kernel.int8_matmul(x, p["wq"], p["ws"], p.get("b"))
    return _one_rounding(F.linear, x, p["w"].t(), p.get("b"))


def _same_pads(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """XLA 'SAME' padding (low, high) for one spatial dim."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def _conv2d_pads(x_shape, w_shape, stride, padding):
    """((low, high) in H, (low, high) in W) of a conv2d call."""
    kh, kw = w_shape[0], w_shape[1]
    if padding == "SAME":
        return (_same_pads(x_shape[1], kh, stride[0]), _same_pads(x_shape[2], kw, stride[1]))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple(tuple(pp) for pp in padding)


def conv2d_uses_kernel(w_shape, stride, pads, parts) -> bool:
    """The one rule that sends a conv2d on a CUDA bf16 input to the plain
    conv kernel: what its plan takes (``_build.conv2d_takes``: a 1x1 or 3x3
    weight [k, k, Cin, Cout] at stride 1 or 2, Cin and Cout multiples of 8),
    square taps, an equal stride in both dims, no negative padding, and
    every channel part of the input (``parts``: C, or C1, C2 of a concat) a
    multiple of 8. The rest (the VAE's 5x5 time-stride-4 upsample, its Cout
    1 conv_out) keeps the f32 copies."""
    from audioldm2_torch.ops import _build

    k = w_shape[0]
    return (w_shape[1] == k and stride[0] == stride[1] and min(min(pp) for pp in pads) >= 0
            and all(c % 8 == 0 for c in parts)
            and _build.conv2d_takes(k, stride[0], w_shape[2], w_shape[3]))


def _conv_kernel(x1, x2, p, stride=(1, 1), pads=((0, 0), (0, 0)), up=1, p_norm=None,
                 groups=32, eps=1e-5):
    """The plain conv kernel's output for a CUDA bf16 call that
    conv2d_uses_kernel takes; None for any other input (a declined CUDA bf16
    call is counted: ``ops.declined_counts()``)."""
    if not (x1.is_cuda and x1.dtype == torch.bfloat16):
        return None
    from audioldm2_torch.ops import resblock_kernel

    parts = (x1,) if x2 is None else (x1, x2)
    if not conv2d_uses_kernel(p["w"].shape, stride, pads, [t.shape[-1] for t in parts]):
        resblock_kernel.conv2d.declined += 1
        return None
    gn = (None, None) if p_norm is None else (p_norm["scale"], p_norm["bias"])
    return resblock_kernel.conv2d(x1, x2, p["w"], p["b"], *gn, stride[0], pads, up, groups, eps)


def conv2d(p, x: torch.Tensor, stride: Tuple[int, int] = (1, 1),
           padding: Union[str, int, Sequence[Tuple[int, int]]] = "SAME") -> torch.Tensor:
    """x: [B, H, W, Cin]; p['w']: [kh, kw, Cin, Cout]; padding "SAME" (XLA's
    rule), "VALID", an int for both sides of both dims, or XLA's
    [(low, high), (low, high)]."""
    pads = _conv2d_pads(x.shape, p["w"].shape, stride, padding)
    y = _conv_kernel(x, None, p, stride, pads)
    return conv2d_plain(p, x, stride, pads) if y is None else y


def conv2d_plain(p, x: torch.Tensor, stride: Tuple[int, int], pads) -> torch.Tensor:
    """conv2d on the f32 copies (a CUDA bf16 input) or the plain op: the
    oracle of the plain conv kernel; ``pads`` as _conv2d_pads gives them."""
    w = p["w"]
    xn = x.permute(0, 3, 1, 2)
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 == ph1 and pw0 == pw1:
        pad = (ph0, pw0)
    else:
        xn, pad = F.pad(xn, (pw0, pw1, ph0, ph1)), 0
    y = _conv_one_rounding(F.conv2d, xn, w.permute(3, 2, 0, 1), p["b"], stride=stride,
                           padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def conv1d(p, x: torch.Tensor, stride: int = 1, padding: Union[str, int] = "SAME",
           dilation: int = 1) -> torch.Tensor:
    """x: [B, T, Cin]; p['w']: [k, Cin, Cout]; padding "SAME" or an int."""
    w = p["w"]
    k = w.shape[0]
    if padding == "SAME":
        lo, hi = _same_pads(x.shape[1], k, stride, dilation)
    else:
        lo = hi = padding
    xn = x.permute(0, 2, 1)
    if lo != hi:
        xn = F.pad(xn, (lo, hi))
        lo = 0
    y = _conv_one_rounding(F.conv1d, xn, w.permute(2, 1, 0), p["b"], stride=stride,
                           padding=lo, dilation=dilation)
    return y.permute(0, 2, 1).contiguous()


def conv_transpose1d(p, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """torch ConvTranspose1d semantics, L_out = (L-1)*stride - 2*padding + k.

    p['w']: [k, Cout, Cin]; x: [B, T, Cin]. The JAX op flips the kernel and
    runs a dilated conv; torch's transposed conv is the same map with the
    weight as [Cin, Cout, k] unflipped."""
    y = _conv_one_rounding(F.conv_transpose1d, x.permute(0, 2, 1), p["w"].permute(2, 1, 0),
                           p["b"], stride=stride, padding=padding)
    return y.permute(0, 2, 1).contiguous()


def group_norm(p, x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Channels-last GroupNorm, float32 two-pass statistics."""
    dt = x.dtype
    x32 = x.float()
    c = x.shape[-1]
    xg = x32.reshape(x.shape[0], -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(dt)


def group_norm_silu(p, x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm -> SiLU (the UNet's out_norm, the VAE's norm_out): K6."""
    from audioldm2_torch.ops import groupnorm_kernel

    return groupnorm_kernel.group_norm_silu(x, p["scale"], p["bias"], groups, eps)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """T5-style RMSNorm (no mean subtraction, no bias)."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"].float()).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def nearest_upsample_2d(x: torch.Tensor, factor_h: int = 2, factor_w: int = 2) -> torch.Tensor:
    """[B, H, W, C] nearest-neighbour upsampling."""
    return x.repeat_interleave(factor_h, dim=1).repeat_interleave(factor_w, dim=2)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] order."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


def attention_plain(q, k, v, mask=None, bias=None, scale: Optional[float] = None):
    """q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; mask: [B, Tk] (1 = keep) or
    broadcastable to [B, H, Tq, Tk]; bias: additive [B|1, H|1, Tq, Tk].

    Float32 logits and softmax. Masked logits are filled with
    -finfo(f32).max (not -inf), so a fully masked row softmaxes to uniform
    weights instead of NaN, as in the JAX package."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[:, None, None, :]
        neg = torch.finfo(torch.float32).max
        logits = torch.where(mask.bool(), logits, torch.full_like(logits, -neg))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel dispatch points (JAX signatures, nn.py:174-185,332-426,606-714)
# ---------------------------------------------------------------------------


def attention_uses_kernel(q_shape, k_shape, has_mask: bool, has_bias: bool) -> bool:
    """The one rule that sends an attention call to the flash kernel:
    unmasked, unbiased self-attention (Tq == Tk) with head_dim in
    {32, 64, 128}. Everything else (masked cross-attention, T5 with its
    position bias, the VAE's single 512-wide head) takes the plain path,
    as the JAX package leaves it to XLA."""
    if has_mask or has_bias:
        return False
    return q_shape[1] == k_shape[1] and q_shape[-1] in (32, 64, 128)


def attention(q, k, v, mask=None, bias=None, scale: Optional[float] = None):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda and attention_uses_kernel(q.shape, k.shape, mask is not None, bias is not None):
        from audioldm2_torch.ops import attention_kernel

        return attention_kernel.flash_self_attention(q, k, v, float(scale))
    return attention_plain(q, k, v, mask=mask, bias=bias, scale=scale)


def gn_silu_conv(p_norm, p_conv, x, groups: int = 32, eps: float = 1e-5):
    """GroupNorm -> SiLU -> 3x3 SAME conv (the ResBlock body): K1, or K1q
    for an int8 weight."""
    return _gn_silu_conv(p_norm, p_conv, x, None, groups, eps)


def gn_silu_conv_cat(p_norm, p_conv, x1, x2, groups: int = 32, eps: float = 1e-5):
    """gn_silu_conv over the virtual channel concat [x1 ; x2]. The int8
    kernel takes the two parts as K1 does, where the JAX package
    concatenates before its int8 kernel."""
    return _gn_silu_conv(p_norm, p_conv, x1, x2, groups, eps)


def _gn_silu_conv(p_norm, p_conv, x1, x2, groups: int, eps: float):
    from audioldm2_torch.ops import resblock_kernel

    if "wq" in p_conv:
        return resblock_kernel.gn_silu_conv3x3_q(
            x1, x2, p_norm["scale"], p_norm["bias"], p_conv["wq"], p_conv["ws"], p_conv["b"],
            groups, eps,
        )
    return resblock_kernel.gn_silu_conv3x3(
        x1, x2, p_norm["scale"], p_norm["bias"], p_conv["w"], p_conv["b"], groups, eps
    )


def conv1x1_cat(p, x1, x2):
    """1x1 conv over the channel concat [x1 ; x2] as one matmul against the
    [C1+C2, Cout] weight, so both parts' products and the bias are summed
    before the one rounding (the JAX op's two f32 einsums); on a CUDA bf16
    input the plain conv kernel, reading the two parts in place."""
    y = _conv_kernel(x1, x2, p)
    if y is not None:
        return y
    return _one_rounding(F.linear, torch.cat([x1, x2], -1), p["w"][0, 0].t(), p.get("b"))


def gn_conv2d(p_norm, p_conv, x, groups: int = 32, eps: float = 1e-5):
    """conv2d(p_conv, group_norm(p_norm, x)), 1x1 or 3x3 SAME (the spatial
    transformer's norm and proj_in): on a CUDA bf16 input the plain conv
    kernel with the GroupNorm folded into its load, the normalized input
    rounded once to bf16, as group_norm rounds it."""
    pads = _conv2d_pads(x.shape, p_conv["w"].shape, (1, 1), "SAME")
    y = _conv_kernel(x, None, p_conv, pads=pads, p_norm=p_norm, groups=groups, eps=eps)
    if y is None:
        y = conv2d_plain(p_conv, group_norm(p_norm, x, groups, eps), (1, 1), pads)
    return y


def upsample_conv2d(p, x):
    """conv2d(p, nearest_upsample_2d(x)), 3x3 SAME on the 2x grid (the UNet's
    and the VAE decoder's upsample): on a CUDA bf16 input the plain conv
    kernel reads x through the upsample, which is never written."""
    b, t, f, _ = x.shape
    pads = _conv2d_pads((b, 2 * t, 2 * f), p["w"].shape, (1, 1), "SAME")
    y = _conv_kernel(x, None, p, pads=pads, up=2)
    return conv2d_plain(p, nearest_upsample_2d(x), (1, 1), pads) if y is None else y


def ln_linear(p_norm, p_lin, x, eps: float = 1e-5):
    """linear(layer_norm(x)): K3, or K3q for an int8 weight."""
    from audioldm2_torch.ops import lnmm_kernel

    if "wq" in p_lin:
        return lnmm_kernel.ln_matmul_q(
            x, p_norm["scale"], p_norm["bias"], p_lin["wq"], p_lin["ws"], p_lin.get("b"), eps
        )
    return lnmm_kernel.ln_matmul(
        x, p_norm["scale"], p_norm["bias"], p_lin["w"], p_lin.get("b"), eps
    )


def geglu_ff_out(p_lin, h, residual):
    """residual + linear(a * gelu(gate)) for the GEGLU hidden h = [a | gate]:
    K4, or K4q for an int8 weight."""
    from audioldm2_torch.ops import lnmm_kernel

    if "wq" in p_lin:
        return lnmm_kernel.geglu_matmul_q(h, p_lin["wq"], p_lin["ws"], p_lin["b"], residual)
    return lnmm_kernel.geglu_matmul(h, p_lin["w"], p_lin["b"], residual)
