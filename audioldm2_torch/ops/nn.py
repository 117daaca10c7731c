"""Core neural-net ops on torch tensors, in the JAX package's layout.

Layout (same as ``audioldm2_tpu.ops.nn``): activations are channels-last
([B, T, C] / [B, H, W, C]); conv weights are HWIO ([kh, kw, in, out]);
1-D conv weights are [k, in, out]; transposed-conv weights are
[k, out, in]. Conversion to torch's NCHW/OIHW happens inside each op, so
every public function takes and returns the JAX layout.

Numerics: normalizations and softmax compute in float32 and cast back to
the input dtype; matmuls and convs run in the input dtype with the bias
added in float32, as the JAX ops do with ``preferred_element_type``.

Dispatch points (``gn_silu_conv``, ``gn_silu_conv_cat``, ``ln_linear``,
``geglu_ff_out``, ``attention``) route by device: a CPU tensor takes the
plain composition; a CUDA tensor takes the hand-written Hopper kernel,
whose wrapper raises if the kernel cannot take the call.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Plain ops
# ---------------------------------------------------------------------------


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(x.dtype)


def _same_pads(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """XLA 'SAME' padding (low, high) for one spatial dim."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x: torch.Tensor, stride: Tuple[int, int] = (1, 1),
           padding: Union[str, int] = "SAME") -> torch.Tensor:
    """x: [B, H, W, Cin]; p['w']: [kh, kw, Cin, Cout]; padding "SAME" (XLA's
    rule) or an int for both sides of both dims."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        pads = [_same_pads(x.shape[1], kh, stride[0]), _same_pads(x.shape[2], kw, stride[1])]
    else:
        pads = [(padding, padding), (padding, padding)]
    xn = x.permute(0, 3, 1, 2)
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 == ph1 and pw0 == pw1:
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, padding=(ph0, pw0))
    else:
        y = F.conv2d(F.pad(xn, (pw0, pw1, ph0, ph1)), w.permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1).float() + p["b"].float()
    return y.to(x.dtype).contiguous()


def conv1d(p, x: torch.Tensor, stride: int = 1, padding: Union[str, int] = "SAME",
           dilation: int = 1) -> torch.Tensor:
    """x: [B, T, Cin]; p['w']: [k, Cin, Cout]; padding "SAME" or an int."""
    w = p["w"].to(x.dtype)
    k = w.shape[0]
    if padding == "SAME":
        lo, hi = _same_pads(x.shape[1], k, stride, dilation)
    else:
        lo = hi = padding
    xn = x.permute(0, 2, 1)
    if lo != hi:
        xn = F.pad(xn, (lo, hi))
        lo = 0
    y = F.conv1d(xn, w.permute(2, 1, 0), stride=stride, padding=lo, dilation=dilation)
    y = y.permute(0, 2, 1).float() + p["b"].float()
    return y.to(x.dtype).contiguous()


def conv_transpose1d(p, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """torch ConvTranspose1d semantics, L_out = (L-1)*stride - 2*padding + k.

    p['w']: [k, Cout, Cin]; x: [B, T, Cin]. The JAX op flips the kernel and
    runs a dilated conv; torch's transposed conv is the same map with the
    weight as [Cin, Cout, k] unflipped."""
    w = p["w"].to(x.dtype).permute(2, 1, 0)
    y = F.conv_transpose1d(x.permute(0, 2, 1), w, stride=stride, padding=padding)
    y = y.permute(0, 2, 1).float() + p["b"].float()
    return y.to(x.dtype).contiguous()


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
    return silu(group_norm(p, x, groups, eps))


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
# Kernel dispatch points (JAX signatures, nn.py:332-426,606-714)
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
    """GroupNorm -> SiLU -> 3x3 SAME conv (the ResBlock body)."""
    from audioldm2_torch.ops import resblock_kernel

    return resblock_kernel.gn_silu_conv3x3(
        x, None, p_norm["scale"], p_norm["bias"], p_conv["w"], p_conv["b"], groups, eps
    )


def gn_silu_conv_cat(p_norm, p_conv, x1, x2, groups: int = 32, eps: float = 1e-5):
    """gn_silu_conv over the virtual channel concat [x1 ; x2]."""
    from audioldm2_torch.ops import resblock_kernel

    return resblock_kernel.gn_silu_conv3x3(
        x1, x2, p_norm["scale"], p_norm["bias"], p_conv["w"], p_conv["b"], groups, eps
    )


def conv1x1_cat(p, x1, x2):
    """1x1 conv over the virtual concat [x1 ; x2] as two matmuls against
    the row slices of the [1, 1, C1+C2, Cout] weight."""
    w = p["w"][0, 0].to(x1.dtype)
    c1 = x1.shape[-1]
    y = torch.matmul(x1, w[:c1]).float() + torch.matmul(x2, w[c1:]).float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x1.dtype)


def ln_linear(p_norm, p_lin, x, eps: float = 1e-5):
    """linear(layer_norm(x))."""
    from audioldm2_torch.ops import lnmm_kernel

    return lnmm_kernel.ln_matmul(
        x, p_norm["scale"], p_norm["bias"], p_lin["w"], p_lin.get("b"), eps
    )


def geglu_ff_out(p_lin, h, residual):
    """residual + linear(a * gelu(gate)) for the GEGLU hidden h = [a | gate]."""
    from audioldm2_torch.ops import lnmm_kernel

    return lnmm_kernel.geglu_matmul(h, p_lin["w"], p_lin["b"], residual)
