"""Plain PyTorch ops of the reference, in the program's layout.

A frozen copy of the plain compositions of ``audioldm2_torch/ops/nn.py``:
channels-last activations ([B, T, C] / [B, H, W, C]), HWIO conv weights,
[k, in, out] 1-D conv weights and [k, out, in] transposed-conv weights.
No kernel is reached from here. Every op computes in float32 whatever the
dtype of its weights (a bf16 weight is upcast, exactly).

Three precisions, chosen with :func:`precision`:

- ``"f32"``: full float32, TF32 off for matmuls and cuDNN convs. The
  reference.
- ``"tf32"``: TF32 on for both. The control of a stage the program runs in
  float32 with TF32 off.
- ``"fp8"``: each conv and matmul weight and input rounded to float8
  (e4m3), the weight with one absmax scale per output channel, the input
  with one per tensor. The control of a stage the program runs in bf16.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

_MODE = contextvars.ContextVar("reference_precision", default="f32")
MODES = ("f32", "tf32", "fp8")


@contextlib.contextmanager
def precision(mode: str):
    """Run the block in ``mode`` (one of :data:`MODES`); the previous mode
    and TF32 settings come back on exit."""
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r} (known: {MODES})")
    token = _MODE.set(mode)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        _MODE.reset(token)


def _fp8(t: torch.Tensor, out_dim=None) -> torch.Tensor:
    """t rounded to float8 e4m3 under one absmax scale (per index of
    ``out_dim``, or one for the tensor)."""
    dims = [d for d in range(t.dim()) if out_dim is None or d != out_dim % t.dim()]
    amax = t.abs().amax(dim=dims, keepdim=True) if dims else t.abs()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _operands(x: torch.Tensor, w: torch.Tensor, out_dim: int):
    """(x, w) in float32 as the current precision sees them."""
    x, w = x.float(), w.float()
    if _MODE.get() == "fp8":
        return _fp8(x), _fp8(w, out_dim)
    return x, w


def _bias(b):
    return None if b is None else b.float()


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x @ p["w"] + p["b"]; p["w"]: [in, out]."""
    x, w = _operands(x, p["w"], out_dim=1)
    return F.linear(x, w.t(), _bias(p.get("b")))


def _same_pads(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """XLA 'SAME' padding (low, high) for one spatial dim."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x: torch.Tensor, stride: Tuple[int, int] = (1, 1),
           padding: Union[str, int, Sequence[Tuple[int, int]]] = "SAME") -> torch.Tensor:
    """x: [B, H, W, Cin]; p['w']: [kh, kw, Cin, Cout]; padding "SAME" (XLA's
    rule), "VALID", an int for both sides of both dims, or XLA's
    [(low, high), (low, high)]."""
    kh, kw = p["w"].shape[0], p["w"].shape[1]
    if padding == "SAME":
        pads = [_same_pads(x.shape[1], kh, stride[0]), _same_pads(x.shape[2], kw, stride[1])]
    elif padding == "VALID":
        pads = [(0, 0), (0, 0)]
    elif isinstance(padding, int):
        pads = [(padding, padding), (padding, padding)]
    else:
        pads = [tuple(pp) for pp in padding]
    x, w = _operands(x, p["w"], out_dim=3)
    xn = x.permute(0, 3, 1, 2)
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 == ph1 and pw0 == pw1:
        pad = (ph0, pw0)
    else:
        xn, pad = F.pad(xn, (pw0, pw1, ph0, ph1)), 0
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), _bias(p.get("b")), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def conv1d(p, x: torch.Tensor, stride: int = 1, padding: Union[str, int] = "SAME",
           dilation: int = 1) -> torch.Tensor:
    """x: [B, T, Cin]; p['w']: [k, Cin, Cout]; padding "SAME" or an int."""
    k = p["w"].shape[0]
    if padding == "SAME":
        lo, hi = _same_pads(x.shape[1], k, stride, dilation)
    else:
        lo = hi = padding
    x, w = _operands(x, p["w"], out_dim=2)
    xn = x.permute(0, 2, 1)
    if lo != hi:
        xn = F.pad(xn, (lo, hi))
        lo = 0
    y = F.conv1d(xn, w.permute(2, 1, 0), _bias(p.get("b")), stride=stride, padding=lo,
                 dilation=dilation)
    return y.permute(0, 2, 1).contiguous()


def conv_transpose1d(p, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """torch ConvTranspose1d, L_out = (L-1)*stride - 2*padding + k;
    p['w']: [k, Cout, Cin]; x: [B, T, Cin]."""
    x, w = _operands(x, p["w"], out_dim=1)
    y = F.conv_transpose1d(x.permute(0, 2, 1), w.permute(2, 1, 0), _bias(p.get("b")),
                           stride=stride, padding=padding)
    return y.permute(0, 2, 1).contiguous()


def group_norm(p, x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Channels-last GroupNorm, two-pass statistics."""
    x = x.float()
    c = x.shape[-1]
    xg = x.reshape(x.shape[0], -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * p["scale"].float() + p["bias"].float()


def group_norm_silu(p, x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    return silu(group_norm(p, x, groups, eps))


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """T5-style RMSNorm (no mean subtraction, no bias)."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * p["scale"].float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def nearest_upsample_2d(x: torch.Tensor, factor_h: int = 2, factor_w: int = 2) -> torch.Tensor:
    return x.repeat_interleave(factor_h, dim=1).repeat_interleave(factor_w, dim=2)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
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


def attention(q, k, v, mask=None, bias=None, scale: Optional[float] = None):
    """q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; mask: [B, Tk] (1 = keep) or
    broadcastable to [B, H, Tq, Tk]; bias: additive [B|1, H|1, Tq, Tk].
    Masked logits are filled with -finfo(f32).max, so a fully masked row
    softmaxes to uniform weights."""
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
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
