"""The Hopper kernels (K1-K4, the int8 K1q, K3q, K4q, K5, K6, the A/B
attention variants K7 and K8, and the plain conv on K1's kernel) against
their plain PyTorch versions on the card, the plain bf16 convs' one
rounding, the gradients through K1, K2, K3, K4, K6 and the plain conv
under autograd (ops.autograd) against the plain ones, and the UNet
forward's CUDA graph (diffusion/unet_graph.py) against the eager forward.

Run on a machine with an NVIDIA GPU (and no JAX, hence no tests/conftest.py):
    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
Without CUDA every test here skips (decided inside the ``cuda`` fixture,
never at import, so every worker collects the same tests).

Bound: max|kernel - plain| / max|plain| <= 2e-2 in bf16 and <= 1e-4 in
f32, with TF32 off so the f32 plain path is a full-precision oracle. K1q,
K3q and K4q round their activation to bf16 even in f32; their f32 inputs
come from chip_smoke.exact_f32_args, which keeps that activation off the
bf16 rounding boundaries."""

import contextlib
import sys

import numpy as np
import pytest
import torch

from audioldm2_torch import ops
from audioldm2_torch.ops import attention_kernel, groupnorm_kernel, lnmm_kernel, resblock_kernel
from audioldm2_torch.ops import attention_variants_kernel as avk
from audioldm2_torch.ops import nn
from chip_smoke import exact_f32_args

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (see the module docstring for the command on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, shape, dt, device, scale=1.0, offset=0.0):
    return (torch.randn(shape, generator=g, device=device) * scale + offset).to(dt)


def _check(got, want, dt):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err / want.float().abs().max().item() <= TOL[dt], err


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,T,F,c1,c2,cout,offset", [
    (2, 8, 4, 128, 0, 128, 0.0),
    (1, 5, 3, 64, 32, 96, 0.0),     # concat with a group straddling the split
    (1, 5, 3, 60, 36, 96, 0.0),     # channels not a multiple of 8: scalar loads
    (1, 33, 7, 256, 0, 70, 0.0),    # ragged M and N tiles
    (1, 64, 64, 128, 0, 128, 10.0),  # offset input: GroupNorm cancellation
    (1, 1, 24, 64, 0, 64, 0.0),     # halo edges of the bf16 kernel: T = 1,
    (2, 40, 1, 64, 0, 128, 0.0),    # F = 1,
    (1, 96, 2, 128, 0, 128, 0.0),   # F = 2,
    (1, 50, 3, 64, 32, 96, 0.0),    # F = 3, with a group straddling the concat split
    (1, 33, 7, 256, 0, 200, 0.0),   # Cout no multiple of the bf16 kernel's N tile
    (1, 1024, 64, 128, 0, 128, 0.0),   # the VAE decoder's full 1024 x 64 level
    (1, 1024, 64, 128, 0, 128, 10.0),  # ... offset: cancellation at S = 65536
    (2, 32, 2, 640, 640, 640, 0.0),    # the deep level at CFG batch 2: split over a cluster
])
def test_gn_silu_conv3x3_kernel(cuda, dt, B, T, F, c1, c2, cout, offset):
    g = torch.Generator(device=cuda).manual_seed(0)
    x1 = _rand(g, (B, T, F, c1), dt, cuda, offset=offset)
    x2 = _rand(g, (B, T, F, c2), dt, cuda) if c2 else None
    cin = c1 + c2
    args = (x1, x2, _rand(g, (cin,), torch.float32, cuda), _rand(g, (cin,), torch.float32, cuda),
            _rand(g, (3, 3, cin, cout), dt, cuda, scale=cin ** -0.5 / 3),
            _rand(g, (cout,), torch.float32, cuda), 32, 1e-6)
    _check(resblock_kernel.gn_silu_conv3x3(*args), resblock_kernel.gn_silu_conv3x3_plain(*args), dt)


@pytest.mark.parametrize("B,T,F,c1,c2,cout", [(2, 64, 4, 384, 256, 384), (1, 256, 16, 512, 0, 512),
                                              (6, 32, 2, 640, 384, 640)])
def test_gn_silu_conv3x3_kernel_reads_bf16_parameters(cuda, B, T, F, c1, c2, cout):
    """GroupNorm scale and bias and the conv bias as bf16 leaves of the cast
    parameter tree: read as stored by the statistics pass and the bf16 conv."""
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(8)
    cin = c1 + c2
    args = (_rand(g, (B, T, F, c1), dt, cuda, offset=1.0),
            _rand(g, (B, T, F, c2), dt, cuda) if c2 else None,
            _rand(g, (cin,), dt, cuda, offset=1.0), _rand(g, (cin,), dt, cuda),
            _rand(g, (3, 3, cin, cout), dt, cuda, scale=(9 * cin) ** -0.5),
            _rand(g, (cout,), dt, cuda), 32, 1e-5)
    _check(resblock_kernel.gn_silu_conv3x3(*args), resblock_kernel.gn_silu_conv3x3_plain(*args), dt)


def test_k1_and_k4_give_the_same_bits_twice(cuda):
    """Fixed-order sums and no atomics in a sum: the statistics pass (split
    over row chunks), K1 (also split over a cluster) and K4 give bitwise
    equal outputs on the same inputs."""
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(12)
    for B, T, F, c1, c2, cout in ((1, 1024, 64, 128, 0, 128), (2, 32, 2, 640, 640, 640)):
        cin = c1 + c2
        args = (_rand(g, (B, T, F, c1), dt, cuda), _rand(g, (B, T, F, c2), dt, cuda) if c2 else None,
                _rand(g, (cin,), dt, cuda), _rand(g, (cin,), dt, cuda),
                _rand(g, (3, 3, cin, cout), dt, cuda, scale=(9 * cin) ** -0.5),
                _rand(g, (cout,), dt, cuda), 32, 1e-5)
        first = resblock_kernel.gn_silu_conv3x3(*args)
        for _ in range(3):
            assert torch.equal(resblock_kernel.gn_silu_conv3x3(*args), first)
        a, c = resblock_kernel.gn_stats(*args[:4], 32, 1e-5)
        for _ in range(3):
            a2, c2_ = resblock_kernel.gn_stats(*args[:4], 32, 1e-5)
            assert torch.equal(a2, a) and torch.equal(c2_, c)
    args = (_rand(g, (6144, 2048), dt, cuda), _rand(g, (1024, 256), dt, cuda, scale=1 / 32),
            _rand(g, (256,), dt, cuda), _rand(g, (6144, 256), dt, cuda))
    first = lnmm_kernel.geglu_matmul(*args)
    for _ in range(3):
        assert torch.equal(lnmm_kernel.geglu_matmul(*args), first)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,T,H,D", [
    (2, 1024, 8, 32), (1, 100, 3, 64), (1, 65, 2, 128),
    (6, 1024, 8, 32),   # the large UNet's T = 1024 level at CFG batch 6: 128-row q tiles
    (2, 64, 20, 32),    # the deepest level at CFG batch 2: one K/V tile, 40 blocks
    (2, 256, 12, 32),
])
def test_flash_self_attention_kernel(cuda, dt, B, T, H, D):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_rand(g, (B, T, H, D), dt, cuda) for _ in range(3))
    args = (q, k, v, D ** -0.5)
    _check(attention_kernel.flash_self_attention(*args),
           attention_kernel.self_attention_plain(*args), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,T,H,D", [(2, 200, 8, 32), (6, 1024, 8, 32), (1, 65, 2, 128)])
def test_flash_self_attention_kernel_on_fused_qkv_views(cuda, dt, B, T, H, D):
    """q, k, v as the strided chunks of one fused [B, T, 3 * H * D] projection,
    which the bf16 kernel reads in place (f32 copies them)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    qkv = _rand(g, (B, T, 3 * H * D), dt, cuda)
    q, k, v = (nn.split_heads(x, H) for x in torch.chunk(qkv, 3, dim=-1))
    assert not q.is_contiguous()
    assert (attention_kernel._strides(q) is not None) == (dt == torch.bfloat16)
    before = attention_kernel.flash_self_attention.launches
    got = attention_kernel.flash_self_attention(q, k, v, D ** -0.5)
    assert attention_kernel.flash_self_attention.launches == before + 1
    assert got.is_contiguous()
    _check(got, attention_kernel.self_attention_plain(q, k, v, D ** -0.5), dt)


@pytest.mark.parametrize("variant", ["v6bd", "v7"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,T,H,D,q_scale", [
    (6, 1024, 8, 32, 1.0),   # the A/B tool's CFG-batch-6 shape
    (1, 200, 4, 32, 1.0),    # ragged K/V and q tiles
    (2, 100, 8, 16, 1.0),
    (1, 256, 2, 64, 1.0),
    (1, 384, 1, 128, 1.0),
    (1, 256, 4, 32, 40.0),   # scaled logits past +-100: v7 clamps, v6bd does not
])
def test_attention_variant_kernels(cuda, variant, dt, B, T, H, D, q_scale):
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (_rand(g, (B, T, H, D), dt, cuda, scale=s) for s in (q_scale, 1.0, 1.0))
    args = (q, k, v, D ** -0.5)
    _check(getattr(avk, f"{variant}_attention")(*args),
           getattr(avk, f"{variant}_attention_plain")(*args), dt)


@pytest.mark.parametrize("T", [100, 200])
def test_v7_kernel_ragged_columns_give_zero_after_the_clamp(cuda, T):
    """Every real logit below -100, so each real column's p is the clamp's
    2^-100: a ragged K/V column that got the clamp too (and not p = 0) would
    scale the output by T / T_padded. The kernel is held against the plain
    version and against the same function on inputs padded to whole 64-row
    tiles with the extra columns' p set to 0."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, H, D = 2, 4, 32
    k = (torch.randn((B, T, H, D), generator=g, device=cuda).abs() + 0.5).bfloat16()
    q = (-40.0 * (torch.randn((B, T, H, D), generator=g, device=cuda).abs() + 0.5)).bfloat16()
    v = _rand(g, (B, T, H, D), torch.bfloat16, cuda)
    scale = D ** -0.5
    assert avk._logits(q, k, scale).max().item() < -100.0
    got = avk.v7_attention(q, k, v, scale)
    _check(got, avk.v7_attention_plain(q, k, v, scale), torch.bfloat16)

    tp = -(-T // 64) * 64
    pad = [0, 0, 0, 0, 0, tp - T]
    qp, kp, vp = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
    pb = torch.exp2(avk._logits(qp, kp, scale).clamp(-100.0, 100.0)).bfloat16()
    pb[..., T:] = 0  # the extra columns masked
    acc = avk._pv(pb, vp)
    want = (acc / pb.float().sum(-1).permute(0, 2, 1)[..., None]).bfloat16()[:, :T]
    _check(got, want, torch.bfloat16)


@pytest.mark.parametrize("T", [1024, 200])
def test_v6bd_kernel_takes_the_max_of_the_whole_row(cuda, T):
    """One q row per (batch, head) whose max logit lies in the last K tile,
    about 200 above the rest in log2 units: with the whole row's m the other
    entries' p = exp2(l - m) underflow to 0, while a max taken from the
    earlier tiles alone would overflow exp2 (f32 ends at 2^128)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, H, D = 2, 8, 32
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=cuda) for _ in range(3))
    row, last = 5, T - 1
    qn = q[:, row] / q[:, row].norm(dim=-1, keepdim=True)
    k[:, last] = qn * 200.0 / (D ** -0.5 * avk.LOG2E)
    q[:, row] = qn
    q, k, v = (x.bfloat16() for x in (q, k, v))
    args = (q, k, v, D ** -0.5)
    lg = avk._logits(q, k, D ** -0.5)[:, :, row]  # [B, H, T]
    assert (lg.argmax(-1) == last).all() and (lg.max(-1).values > 150.0).all()
    _check(avk.v6bd_attention(*args), avk.v6bd_attention_plain(*args), torch.bfloat16)


def test_attention_variants_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 64, 4, 32, device=cuda)
    for fn in (avk.v6bd_attention, avk.v7_attention):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(q[:, :, :3], q[:, :, :3], q[:, :, :3], 0.2)
        with pytest.raises(ValueError, match="head_dim"):
            x = torch.randn(1, 64, 16, 8, device=cuda)
            fn(x, x, x, 0.2)
        with pytest.raises(TypeError, match="mixed dtypes"):
            fn(q, q, q.bfloat16(), 0.2)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M,C,N,with_bias", [
    (128, 320, 200, True), (128, 320, 200, False),
    (128, 100, 36, True),      # C, N no multiples of 8: the shared core in bf16 too
    (128, 640, 1920, False),
    (128, 640, 5120, True),    # the deepest level's GEGLU proj_in at CFG batch 2
    (6144, 256, 768, True),    # the large UNet's fused QKV at CFG batch 6
    (1536, 384, 384, False),
    (100, 384, 200, True),     # ragged row block and N tile
    (300, 648, 136, True),     # C no multiple of the 64-row K tile: zero-filled
    (64, 1024, 256, True),     # rows wider than the bf16 kernel takes: the shared core
])
def test_ln_matmul_kernel(cuda, dt, M, C, N, with_bias):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = _rand(g, (2, M // 2, C), dt, cuda, offset=3.0)
    args = (x, _rand(g, (C,), torch.float32, cuda), _rand(g, (C,), torch.float32, cuda),
            _rand(g, (C, N), dt, cuda, scale=0.05),
            _rand(g, (N,), torch.float32, cuda) if with_bias else None, 1e-5)
    _check(lnmm_kernel.ln_matmul(*args), lnmm_kernel.ln_matmul_plain(*args), dt)


@pytest.mark.parametrize("M,C,N,with_bias", [(512, 384, 1152, True), (100, 384, 200, False),
                                             (64, 1024, 256, True)])
def test_ln_matmul_kernel_reads_bf16_parameters(cuda, M, C, N, with_bias):
    """The LN scale and bias and the linear bias as bf16 leaves of the cast
    parameter tree: the bf16 kernel reads them as they are (no conversion
    kernels before the launch); the values are exact in f32 either way."""
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(9)
    args = (_rand(g, (1, M, C), dt, cuda, offset=3.0), _rand(g, (C,), dt, cuda),
            _rand(g, (C,), dt, cuda), _rand(g, (C, N), dt, cuda, scale=0.05),
            _rand(g, (N,), dt, cuda) if with_bias else None, 1e-5)
    assert lnmm_kernel._ln_params(args[0].device, args[1], args[2], args[4])[1] == 1
    _check(lnmm_kernel.ln_matmul(*args), lnmm_kernel.ln_matmul_plain(*args), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M,F,N", [
    (130, 160, 96), (128, 2560, 640), (50, 20, 12),
    (100, 1032, 136),   # F no multiple of the 64-deep K tile, ragged M and N
    (6144, 1024, 256),  # the large UNet's T = 1024 level at CFG batch 6
    (1536, 1536, 384),
])
def test_geglu_matmul_kernel(cuda, dt, M, F, N):
    g = torch.Generator(device=cuda).manual_seed(3)
    args = (_rand(g, (M, 2 * F), dt, cuda), _rand(g, (F, N), dt, cuda, scale=F ** -0.5),
            _rand(g, (N,), torch.float32, cuda), _rand(g, (M, N), dt, cuda))
    _check(lnmm_kernel.geglu_matmul(*args), lnmm_kernel.geglu_matmul_plain(*args), dt)


@pytest.mark.parametrize("M,F,N", [(2048, 1024, 256), (384, 2560, 640)])
def test_geglu_matmul_kernel_reads_bf16_parameters(cuda, M, F, N):
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(10)
    args = (_rand(g, (M, 2 * F), dt, cuda), _rand(g, (F, N), dt, cuda, scale=F ** -0.5),
            _rand(g, (N,), dt, cuda), _rand(g, (M, N), dt, cuda))
    _check(lnmm_kernel.geglu_matmul(*args), lnmm_kernel.geglu_matmul_plain(*args), dt)


@pytest.mark.parametrize("M,F,N", [(2048, 512, 256), (512, 768, 384), (128, 1280, 640),
                                   (6144, 512, 256), (100, 520, 136)])
def test_geglu_matmul_f32_residual_kernel(cuda, M, F, N):
    """K4's f32-residual mode, a tp 2 rank's FF out (the t5 UNet's three
    shapes, the large UNet's T = 1024 level at CFG batch 6, and a ragged
    one): bf16 h and w, an f32 residual, the f32 sum against the plain
    version's, to the f32 bound (both sum bf16 products in f32)."""
    g = torch.Generator(device=cuda).manual_seed(17)
    for bias_dt in (torch.float32, torch.bfloat16):
        args = (_rand(g, (M, 2 * F), torch.bfloat16, cuda),
                _rand(g, (F, N), torch.bfloat16, cuda, scale=F ** -0.5),
                _rand(g, (N,), bias_dt, cuda), _rand(g, (M, N), torch.float32, cuda))
        _check(lnmm_kernel.geglu_matmul(*args), lnmm_kernel.geglu_matmul_plain(*args),
               torch.float32)


def _int8(g, shape, device):
    wq = torch.randint(-127, 128, shape, generator=g, device=device).to(torch.int8)
    ws = torch.rand(shape[-1], generator=g, device=device) * 0.01 + 1e-3
    return wq, ws


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,T,F,c1,c2,cout", [
    (2, 32, 2, 640, 0, 640),       # deepest UNet level: split-K
    (2, 64, 4, 640, 384, 384),     # decoder concat
    (1, 6, 3, 64, 32, 96),         # a group straddling the split
    (1, 6, 3, 60, 36, 100),        # channels not a multiple of 8: scalar loads
])
def test_gn_silu_conv3x3_q_kernel(cuda, dt, B, T, F, c1, c2, cout):
    g = torch.Generator(device=cuda).manual_seed(4)
    x1 = _rand(g, (B, T, F, c1), dt, cuda)
    x2 = _rand(g, (B, T, F, c2), dt, cuda) if c2 else None
    cin = c1 + c2
    wq, ws = _int8(g, (3, 3, cin, cout), cuda)
    args = (x1, x2, _rand(g, (cin,), torch.float32, cuda), _rand(g, (cin,), torch.float32, cuda),
            wq, ws, _rand(g, (cout,), torch.float32, cuda), 32, 1e-5)
    if dt == torch.float32:
        args = exact_f32_args("gn_silu_conv3x3_q", args)
    _check(resblock_kernel.gn_silu_conv3x3_q(*args),
           resblock_kernel.gn_silu_conv3x3_q_plain(*args), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M,C,N,with_bias", [(4096, 128, 384, False), (128, 640, 5120, True),
                                             (100, 40, 36, True)])
def test_ln_matmul_q_kernel(cuda, dt, M, C, N, with_bias):
    g = torch.Generator(device=cuda).manual_seed(5)
    wq, ws = _int8(g, (C, N), cuda)
    args = (_rand(g, (1, M, C), dt, cuda, offset=2.0), _rand(g, (C,), torch.float32, cuda),
            _rand(g, (C,), torch.float32, cuda), wq, ws,
            _rand(g, (N,), torch.float32, cuda) if with_bias else None, 1e-5)
    if dt == torch.float32:
        args = exact_f32_args("ln_matmul_q", args)
    _check(lnmm_kernel.ln_matmul_q(*args), lnmm_kernel.ln_matmul_q_plain(*args), dt)


# K1q and K3q in bf16 on their own kernels: every (B, T, F, C1, C2, Cout)
# and (M, C, N) one audioldm2-full int8 UNet forward gives them at CFG batch
# 2 (unet.conv_shapes / ln_matmul_shapes with weight_quant="int8"), then
# ragged M, K1q's halo edges, a concat, and the cluster splits.
FULL8_K1Q = [(2, 32, 2, 384, 0, 640), (2, 32, 2, 640, 0, 640), (2, 32, 2, 640, 384, 640),
             (2, 32, 2, 640, 640, 640), (2, 64, 4, 256, 0, 384), (2, 64, 4, 384, 0, 384),
             (2, 64, 4, 384, 256, 384), (2, 64, 4, 384, 384, 384), (2, 64, 4, 640, 384, 384),
             (2, 128, 8, 128, 0, 256), (2, 128, 8, 256, 0, 256), (2, 128, 8, 256, 128, 256),
             (2, 128, 8, 256, 256, 256), (2, 128, 8, 384, 256, 256), (2, 256, 16, 128, 0, 128),
             (2, 256, 16, 128, 128, 128), (2, 256, 16, 256, 128, 128)]
K1Q_EDGES = [(1, 1, 24, 64, 0, 64), (2, 40, 1, 64, 0, 128), (1, 96, 2, 128, 0, 128),
             (1, 50, 3, 64, 32, 96), (1, 33, 7, 256, 0, 208), (6, 32, 2, 640, 384, 640)]
FULL8_K3Q = [(2048, 256, 256), (2048, 256, 768), (2048, 256, 2048), (512, 384, 384),
             (512, 384, 1152), (512, 384, 3072), (128, 640, 640), (128, 640, 1920),
             (128, 640, 5120)]
K3Q_EDGES = [(100, 384, 208), (130, 640, 640), (1, 256, 256), (2000, 256, 784), (70, 768, 96)]


def _int8_spread(g, shape, device):
    """int8 weights reaching +-127 in every output column, scales spread
    over 2^-8 .. 2^8 across the columns."""
    wq = torch.randint(-127, 128, shape, generator=g, device=device).to(torch.int8)
    flat = wq.view(-1, shape[-1])
    flat[0], flat[-1] = 127, -127
    ws = 2.0 ** torch.linspace(-8.0, 8.0, shape[-1], device=device)
    return wq, ws[torch.randperm(shape[-1], generator=g, device=device)]


@contextlib.contextmanager
def _entries_counted():
    """Count the C entry points the wrappers reach."""
    from audioldm2_torch.ops import _build

    lib, calls, saved = _build.lib(), {}, {}
    for name in _build.SIGNATURES:
        saved[name] = getattr(lib, name)

        def counting(*args, _fn=saved[name], _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)

        setattr(lib, name, counting)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(lib, name, fn)


@pytest.mark.parametrize("B,T,F,c1,c2,cout", FULL8_K1Q + K1Q_EDGES)
def test_gn_silu_conv3x3_q_bf16_kernel(cuda, B, T, F, c1, c2, cout):
    """bf16 K1q on its own kernel (never the shared core) against its plain
    version, with bf16 GroupNorm parameters and conv bias as the cast tree
    holds them."""
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(14)
    cin = c1 + c2
    wq, ws = _int8_spread(g, (3, 3, cin, cout), cuda)
    args = (_rand(g, (B, T, F, c1), dt, cuda, offset=1.0),
            _rand(g, (B, T, F, c2), dt, cuda) if c2 else None,
            _rand(g, (cin,), dt, cuda, offset=1.0), _rand(g, (cin,), dt, cuda), wq, ws,
            _rand(g, (cout,), dt, cuda, scale=100.0), 32, 1e-5)
    with _entries_counted() as calls:
        got = resblock_kernel.gn_silu_conv3x3_q(*args)
    assert calls.get("a2k_gn_silu_conv3x3_q_bf16") == 1 and "a2k_gn_silu_conv3x3_q" not in calls
    _check(got, resblock_kernel.gn_silu_conv3x3_q_plain(*args), dt)


@pytest.mark.parametrize("M,C,N", FULL8_K3Q + K3Q_EDGES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_ln_matmul_q_bf16_kernel(cuda, M, C, N, with_bias):
    """bf16 K3q on K3's row-block kernel (never the shared core) against its
    plain version, with bf16 LN parameters and bias as the cast tree holds
    them."""
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(15)
    wq, ws = _int8_spread(g, (C, N), cuda)
    args = (_rand(g, (1, M, C), dt, cuda, offset=2.0), _rand(g, (C,), dt, cuda, offset=1.0),
            _rand(g, (C,), dt, cuda), wq, ws,
            _rand(g, (N,), dt, cuda, scale=100.0) if with_bias else None, 1e-5)
    with _entries_counted() as calls:
        got = lnmm_kernel.ln_matmul_q(*args)
    assert calls.get("a2k_ln_matmul_q_bf16") == 1 and "a2k_ln_matmul_q" not in calls
    _check(got, lnmm_kernel.ln_matmul_q_plain(*args), dt)


def test_k1q_and_k3q_give_the_same_bits_twice(cuda):
    """Fixed-order sums, also over a cluster: bitwise equal outputs."""
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(16)
    for B, T, F, c1, c2, cout in ((2, 32, 2, 640, 640, 640), (2, 256, 16, 128, 128, 128)):
        cin = c1 + c2
        wq, ws = _int8_spread(g, (3, 3, cin, cout), cuda)
        args = (_rand(g, (B, T, F, c1), dt, cuda), _rand(g, (B, T, F, c2), dt, cuda),
                _rand(g, (cin,), dt, cuda), _rand(g, (cin,), dt, cuda), wq, ws,
                _rand(g, (cout,), dt, cuda), 32, 1e-5)
        first = resblock_kernel.gn_silu_conv3x3_q(*args)
        for _ in range(3):
            assert torch.equal(resblock_kernel.gn_silu_conv3x3_q(*args), first)
    for M, C, N in ((128, 640, 640), (2048, 256, 768)):
        wq, ws = _int8_spread(g, (C, N), cuda)
        args = (_rand(g, (M, C), dt, cuda), _rand(g, (C,), dt, cuda), _rand(g, (C,), dt, cuda),
                wq, ws, _rand(g, (N,), dt, cuda), 1e-5)
        first = lnmm_kernel.ln_matmul_q(*args)
        for _ in range(3):
            assert torch.equal(lnmm_kernel.ln_matmul_q(*args), first)


# K4q and K5 in bf16 on the row-block kernel: every (M, F, N) and (M, K, N)
# one audioldm2-full int8 UNet forward gives them at CFG batch 2
# (unet.geglu_matmul_shapes with weight_quant="int8", unet.int8_matmul_shapes),
# then ragged M, F and K no multiple of the 64-deep K tile, and the large
# config's CFG batch 6 level.
FULL8_K4Q = [(2048, 1024, 256), (512, 1536, 384), (128, 2560, 640)]
K4Q_EDGES = [(50, 1024, 256), (77, 2560, 640), (130, 200, 96), (100, 1032, 144), (384, 2560, 640)]
FULL8_K5 = [(2048, 256, 256), (512, 384, 384), (128, 640, 640)]
K5_EDGES = [(50, 256, 256), (77, 640, 640), (100, 200, 96), (1, 384, 384), (6144, 256, 256),
            (128, 2560, 640)]


def _k4q_args(g, M, F, N, device, dt=torch.bfloat16):
    wq, ws = _int8_spread(g, (F, N), device)
    return (_rand(g, (M, 2 * F), dt, device), wq, ws, _rand(g, (N,), dt, device, scale=100.0),
            _rand(g, (M, N), dt, device, scale=100.0))


def _k5_args(g, M, K, N, device, with_bias=True):
    wq, ws = _int8_spread(g, (K, N), device)
    return (_rand(g, (1, M, K), torch.bfloat16, device, offset=0.5), wq, ws,
            _rand(g, (N,), torch.bfloat16, device, scale=100.0) if with_bias else None)


@pytest.mark.parametrize("M,F,N", FULL8_K4Q + K4Q_EDGES)
def test_geglu_matmul_q_bf16_kernel(cuda, M, F, N):
    """bf16 K4q on the row-block kernel (never the shared core) against its
    plain version, with weights at +-127, spread scales and the bias and
    residual as the cast tree holds them."""
    g = torch.Generator(device=cuda).manual_seed(17)
    args = _k4q_args(g, M, F, N, cuda)
    with _entries_counted() as calls:
        got = lnmm_kernel.geglu_matmul_q(*args)
    assert calls == {"a2k_geglu_matmul_q_bf16": 1}
    _check(got, lnmm_kernel.geglu_matmul_q_plain(*args), torch.bfloat16)


@pytest.mark.parametrize("M,K,N", FULL8_K5 + K5_EDGES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_matmul_bf16_kernel(cuda, M, K, N, with_bias):
    """bf16 K5 on the row-block kernel (never the shared core) against its
    plain version, with weights at +-127, spread scales and a bf16 bias as
    the cast tree holds it, or none."""
    g = torch.Generator(device=cuda).manual_seed(18)
    args = _k5_args(g, M, K, N, cuda, with_bias)
    with _entries_counted() as calls:
        got = lnmm_kernel.int8_matmul(*args)
    assert calls == {"a2k_int8_matmul_bf16": 1}
    _check(got, lnmm_kernel.int8_matmul_plain(*args), torch.bfloat16)


@pytest.mark.parametrize("M,F,N", [(2048, 512, 256), (512, 768, 384), (128, 1280, 640),
                                   (6144, 512, 256), (100, 520, 144)])
def test_geglu_matmul_q_f32_residual_kernel(cuda, M, F, N):
    """K4q's f32-residual mode, a tp 2 rank's int8 FF out (the t5 UNet's
    three slices, the large UNet's T = 1024 level at CFG batch 6, a ragged
    one): the f32 sum against the plain version's, one launch of its own
    entry, to the f32 bound (both sum the same bf16 products in f32)."""
    g = torch.Generator(device=cuda).manual_seed(23)
    h, wq, ws, b, res = _k4q_args(g, M, F, N, cuda)
    args = (h, wq, ws, b, res.float())
    with _entries_counted() as calls:
        got = lnmm_kernel.geglu_matmul_q(*args)
    assert calls == {"a2k_geglu_matmul_q_bf16_f32res": 1} and got.dtype == torch.float32
    _check(got, lnmm_kernel.geglu_matmul_q_plain(*args), torch.float32)


@pytest.mark.parametrize("M,K,N", [(2048, 128, 256), (512, 192, 384), (128, 320, 640),
                                   (6144, 128, 256), (77, 200, 144)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_matmul_f32_output_kernel(cuda, M, K, N, with_bias):
    """K5's f32-output mode, a tp 2 rank's int8 to_out (the t5 UNet's three
    slices, the large UNet's T = 1024 level, a ragged one): the unrounded
    f32 product against the plain version's, one launch of its own entry."""
    g = torch.Generator(device=cuda).manual_seed(24)
    args = _k5_args(g, M, K, N, cuda, with_bias)
    with _entries_counted() as calls:
        got = lnmm_kernel.int8_matmul(*args, out_dtype=torch.float32)
    assert calls == {"a2k_int8_matmul_bf16_f32out": 1} and got.dtype == torch.float32
    _check(got, lnmm_kernel.int8_matmul_plain(*args, out_dtype=torch.float32), torch.float32)


@pytest.mark.parametrize("M,F,N", [(128, 2560, 632), (50, 256, 200)])
def test_int8_n_no_multiple_of_16_takes_the_shared_core(cuda, M, F, N):
    """The int8 ring copies 16 bytes a row: bf16 K4q and K5 with N no
    multiple of 16 reach the shared core's entries, which stay right."""
    g = torch.Generator(device=cuda).manual_seed(19)
    args = _k4q_args(g, M, F, N, cuda)
    with _entries_counted() as calls:
        got = lnmm_kernel.geglu_matmul_q(*args)
    assert calls == {"a2k_geglu_matmul_q": 1}
    _check(got, lnmm_kernel.geglu_matmul_q_plain(*args), torch.bfloat16)
    args = _k5_args(g, M, F, N, cuda)
    with _entries_counted() as calls:
        got = lnmm_kernel.int8_matmul(*args)
    assert calls == {"a2k_int8_matmul": 1}
    _check(got, lnmm_kernel.int8_matmul_plain(*args), torch.bfloat16)


@pytest.mark.parametrize("bm,bn", [(64, 128), (64, 64), (32, 128), (32, 64), (16, 128), (16, 64)])
@pytest.mark.parametrize("splits", [1, 2, 5])
def test_k4q_and_k5_every_tile_and_cluster_split(cuda, bm, bn, splits):
    """Each tile the kernel is built for (the thinner ones convert on their
    idle warps), with K split over a cluster of 1, 2 and 5 blocks, through
    the C entry points at the full8 deep level (M = 128, 10 and 40 K tiles)
    and at a ragged M, against the plain versions."""
    from audioldm2_torch.ops import _build

    g = torch.Generator(device=cuda).manual_seed(20)
    lib = _build.lib()
    stages = 3
    kps = -(-40 // splits) * _build.LNMM_BK  # K4q's share of F = 2560 a block holds
    fits = _build.row_block_smem(bm, bn, kps, stages, 1, splits) <= _build.LNMM_MAX_SMEM
    for m in (128, 77):
        h, wq, ws, b, res = _k4q_args(g, m, 2560, 640, cuda)
        out = torch.empty_like(res)
        rc = lib.a2k_geglu_matmul_q_bf16(
            h.data_ptr(), wq.data_ptr(), ws.data_ptr(), b.data_ptr(), 1, res.data_ptr(),
            out.data_ptr(), m, 2560, 640, bm, bn, 1, stages, splits, _build.stream_of(h))
        if not fits:  # a row block wider than shared memory holds is refused, not run
            assert rc == 1  # cudaErrorInvalidValue
        else:
            _build.check(rc, "K4q")
            _check(out, lnmm_kernel.geglu_matmul_q_plain(h, wq, ws, b, res), torch.bfloat16)
        x, wq, ws, b = _k5_args(g, m, 640, 640, cuda)
        out = torch.empty((1, m, 640), device=cuda, dtype=torch.bfloat16)
        _build.check(lib.a2k_int8_matmul_bf16(
            x.data_ptr(), wq.data_ptr(), ws.data_ptr(), b.data_ptr(), 1, out.data_ptr(), m, 640,
            640, bm, bn, 1, stages, splits, _build.stream_of(x)), "K5")
        _check(out, lnmm_kernel.int8_matmul_plain(x, wq, ws, b), torch.bfloat16)


def test_full8_plans_split_k_where_the_deep_level_needs_it(cuda):
    """Where K4q's plan splits K over a cluster at a full8 shape, the wrapper
    launches that split and agrees with the plain version."""
    from audioldm2_torch.ops import _build

    sms = _build.sm_count(torch.cuda.current_device())
    plan = _build.geglu_matmul_plan(128, 2560, 640, sms, w_bytes=1)
    assert plan.splits > 1
    g = torch.Generator(device=cuda).manual_seed(21)
    args = _k4q_args(g, 128, 2560, 640, cuda)
    _check(lnmm_kernel.geglu_matmul_q(*args), lnmm_kernel.geglu_matmul_q_plain(*args),
           torch.bfloat16)


def test_k4q_and_k5_give_the_same_bits_twice(cuda):
    """Fixed-order sums, also over a cluster: bitwise equal outputs."""
    g = torch.Generator(device=cuda).manual_seed(22)
    for M, F, N in FULL8_K4Q:
        args = _k4q_args(g, M, F, N, cuda)
        first = lnmm_kernel.geglu_matmul_q(*args)
        for _ in range(3):
            assert torch.equal(lnmm_kernel.geglu_matmul_q(*args), first)
    for M, K, N in FULL8_K5:
        args = _k5_args(g, M, K, N, cuda)
        first = lnmm_kernel.int8_matmul(*args)
        for _ in range(3):
            assert torch.equal(lnmm_kernel.int8_matmul(*args), first)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M,F,N", [(128, 2560, 640), (4096, 512, 128), (50, 20, 12)])
def test_geglu_matmul_q_kernel(cuda, dt, M, F, N):
    g = torch.Generator(device=cuda).manual_seed(6)
    wq, ws = _int8(g, (F, N), cuda)
    args = (_rand(g, (M, 2 * F), dt, cuda), wq, ws, _rand(g, (N,), torch.float32, cuda),
            _rand(g, (M, N), dt, cuda))
    if dt == torch.float32:
        args = exact_f32_args("geglu_matmul_q", args)
    _check(lnmm_kernel.geglu_matmul_q(*args), lnmm_kernel.geglu_matmul_q_plain(*args), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M,K,N,with_bias", [(4096, 128, 128, True), (128, 640, 640, True),
                                             (77, 36, 20, False)])
def test_int8_matmul_kernel(cuda, dt, M, K, N, with_bias):
    g = torch.Generator(device=cuda).manual_seed(7)
    wq, ws = _int8(g, (K, N), cuda)
    args = (_rand(g, (2, M, K), dt, cuda), wq, ws,
            _rand(g, (N,), torch.float32, cuda) if with_bias else None)
    _check(lnmm_kernel.int8_matmul(*args), lnmm_kernel.int8_matmul_plain(*args), dt)


# K1 in f32 on its own kernel (3xTF32): every shape of one full-width VAE
# encode (vae.encode_conv_shapes) at 16 kHz and at 48 kHz (256 mel bins:
# tiles narrower than F, several along it), the same with the input
# channels split into a concat [x1 ; x2], and each shape offset by +10
# (GroupNorm cancellation at S up to 262144 and K up to 9216)
ENCODE_K1 = [(1, 1024, 64, 128, 0, 128), (1, 512, 32, 128, 0, 256), (1, 512, 32, 256, 0, 256),
             (1, 256, 16, 256, 0, 512), (1, 256, 16, 512, 0, 512),
             (1, 1024, 256, 128, 0, 128), (1, 512, 128, 128, 0, 256), (1, 512, 128, 256, 0, 256),
             (1, 256, 64, 256, 0, 512), (1, 128, 32, 512, 0, 1024),
             (1, 128, 32, 1024, 0, 1024)]
ENCODE_K1_CAT = [(b, t, f, c1 // 2, c1 - c1 // 2, cout) for b, t, f, c1, _, cout in ENCODE_K1]


@pytest.mark.parametrize("offset", [0.0, 10.0])
@pytest.mark.parametrize("B,T,F,c1,c2,cout", ENCODE_K1 + ENCODE_K1_CAT)
def test_gn_silu_conv3x3_f32_kernel(cuda, B, T, F, c1, c2, cout, offset):
    """f32 K1 on its tensor-core kernel (never the shared core) within the
    f32 bar of its plain version, with and without x2 and with the +10
    offset, at the encoder's eps."""
    dt = torch.float32
    g = torch.Generator(device=cuda).manual_seed(21)
    cin = c1 + c2
    args = (_rand(g, (B, T, F, c1), dt, cuda, offset=offset),
            _rand(g, (B, T, F, c2), dt, cuda, offset=offset) if c2 else None,
            _rand(g, (cin,), dt, cuda, offset=1.0), _rand(g, (cin,), dt, cuda),
            _rand(g, (3, 3, cin, cout), dt, cuda, scale=(9 * cin) ** -0.5),
            _rand(g, (cout,), dt, cuda), 32, 1e-6)
    with _entries_counted() as calls:
        got = resblock_kernel.gn_silu_conv3x3(*args)
    assert calls.get("a2k_gn_silu_conv3x3_f32") == 1 and "a2k_gn_silu_conv3x3" not in calls
    _check(got, resblock_kernel.gn_silu_conv3x3_plain(*args), dt)


@pytest.mark.parametrize("bm,bn", [(256, 64)])
@pytest.mark.parametrize("splits", [1, 2, 5])
def test_f32_k1_every_tile_and_cluster_split(cuda, bm, bn, splits):
    """The tile the f32 conv is built for, cluster splits of 1, 2 and 5 (a
    ragged last share), two ring depths and, without a split, a strip of two
    N tiles, through the C entry point at a shape with ragged T and Cout
    tiles and a concat, against the plain version; another tile is
    refused."""
    from audioldm2_torch.ops import _build

    dt = torch.float32
    g = torch.Generator(device=cuda).manual_seed(22)
    B, T, F, c1, c2, cout = 2, 37, 16, 192, 96, 200
    cin = c1 + c2
    x1, x2 = _rand(g, (B, T, F, c1), dt, cuda, offset=0.5), _rand(g, (B, T, F, c2), dt, cuda)
    gamma, beta = _rand(g, (cin,), dt, cuda, offset=1.0), _rand(g, (cin,), dt, cuda)
    w = _rand(g, (3, 3, cin, cout), dt, cuda, scale=(9 * cin) ** -0.5)
    bias = _rand(g, (cout,), dt, cuda)
    want = resblock_kernel.gn_silu_conv3x3_plain(x1, x2, gamma, beta, w, bias, 32, 1e-5)
    a, c = resblock_kernel.gn_stats(x1, x2, gamma, beta, 32, 1e-5)
    ft = min(F, bm)
    tt = min(bm // ft, T)
    fits = [s for s in _build.CONV_STAGES
            if _build.conv32_smem_bytes(bm, bn, tt, ft, s) <= _build.LNMM_MAX_SMEM]
    for stages in sorted({fits[0], fits[-1]}):
        for strip in (1, 2) if splits == 1 else (1,):
            out = torch.full((B, T, F, cout), float("nan"), device=cuda)
            _build.check(_build.lib().a2k_gn_silu_conv3x3_f32(
                x1.data_ptr(), x2.data_ptr(), a.data_ptr(), c.data_ptr(), w.data_ptr(),
                bias.data_ptr(), 0, out.data_ptr(), B, T, F, c1, c2, cout, bm, bn, tt, ft, strip,
                stages, splits, _build.stream_of(x1)), "a2k_gn_silu_conv3x3_f32")
            _check(out, want, dt)
    assert _build.lib().a2k_gn_silu_conv3x3_f32(
        x1.data_ptr(), x2.data_ptr(), a.data_ptr(), c.data_ptr(), w.data_ptr(), bias.data_ptr(),
        0, out.data_ptr(), B, T, F, c1, c2, cout, 128, 128, 1, 16, 1, 2, 1,
        _build.stream_of(x1)) != 0


def test_f32_k1_gives_the_same_bits_twice(cuda):
    """Fixed-order sums, also over a cluster: bitwise equal f32 outputs."""
    dt = torch.float32
    g = torch.Generator(device=cuda).manual_seed(23)
    for B, T, F, c1, c2, cout in ((1, 256, 16, 512, 0, 512), (2, 32, 2, 640, 640, 640)):
        cin = c1 + c2
        args = (_rand(g, (B, T, F, c1), dt, cuda),
                _rand(g, (B, T, F, c2), dt, cuda) if c2 else None,
                _rand(g, (cin,), dt, cuda), _rand(g, (cin,), dt, cuda),
                _rand(g, (3, 3, cin, cout), dt, cuda, scale=(9 * cin) ** -0.5),
                _rand(g, (cout,), dt, cuda), 32, 1e-6)
        first = resblock_kernel.gn_silu_conv3x3(*args)
        for _ in range(3):
            assert torch.equal(resblock_kernel.gn_silu_conv3x3(*args), first)


# K6 in one launch: the main path's four shapes (t5 UNet out_norm at CFG 2,
# large at CFG 6, the VAE decoder's and encoder's norm_out), batches 1 to 6,
# C no multiple of 8 (scalar path), tensors above what the grid's shared
# memory holds (re-read mode: the VAE decoder's norm_out at batch 2 and 3,
# 67 and 134 MB in f32, and in f32 rows of 36 channels and wide rows of
# 520; the 48k VAE decoder's norm_out at batch 1, 2 and 3, 67 to 201 MB in
# bf16), and batches above the SM count (samples in turn)
K6_SHAPES = [((2, 256, 16, 128), 32, 1e-5), ((6, 256, 16, 128), 32, 1e-5),
             ((1, 1024, 64, 128), 32, 1e-6), ((1, 256, 16, 512), 32, 1e-6),
             ((3, 100, 7, 256), 32, 1e-5), ((4, 33, 64), 32, 1e-5), ((5, 9, 3, 64), 32, 1e-5),
             ((2, 7, 5, 36), 4, 1e-5), ((1, 2048, 64, 128), 32, 1e-6),
             ((1, 4096, 64, 128), 32, 1e-6), ((2, 1024, 64, 128), 32, 1e-6),
             ((3, 1024, 64, 128), 32, 1e-6), ((140, 8, 4, 64), 32, 1e-5),
             ((300, 16, 36), 4, 1e-5), ((1, 512, 512, 36), 4, 1e-5), ((1, 16384, 520), 4, 1e-5),
             ((1, 1024, 256, 128), 32, 1e-6), ((2, 1024, 256, 128), 32, 1e-6),
             ((3, 1024, 256, 128), 32, 1e-6)]


@pytest.mark.parametrize("offset", [0.0, 10.0])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape,groups,eps", K6_SHAPES)
def test_group_norm_silu_is_one_launch(cuda, dt, shape, groups, eps, offset):
    """K6 launches a2k_group_norm_silu once (no statistics pass) and agrees
    with its plain version, resident or re-reading, with the +10 offset;
    bf16 parameters as the cast tree holds them."""
    from audioldm2_torch.ops import _build

    g = torch.Generator(device=cuda).manual_seed(24)
    c = shape[-1]
    x = _rand(g, shape, dt, cuda, offset=offset)
    pdt = torch.bfloat16 if dt == torch.bfloat16 else torch.float32
    args = (x, _rand(g, (c,), pdt, cuda, offset=1.0), _rand(g, (c,), pdt, cuda), groups, eps)
    with _entries_counted() as calls:
        got = groupnorm_kernel.group_norm_silu(*args)
    assert calls.get("a2k_group_norm_silu") == 1 and "a2k_gn_stats" not in calls
    _check(got, groupnorm_kernel.group_norm_silu_plain(*args), dt)
    bsz = shape[0]
    s = x.numel() // (bsz * c)
    plan = _build.group_norm_silu_plan(bsz, s, c, "bf16" if dt == torch.bfloat16 else "f32",
                                       _build.sm_count(0), groups, c % 8 == 0)
    assert plan.resident == (x.numel() * x.element_size() < 20e6)


def test_group_norm_silu_gives_the_same_bits_twice(cuda):
    """Every block combines the sample's partials in one fixed order: the
    same bits in every run, resident and re-reading."""
    g = torch.Generator(device=cuda).manual_seed(25)
    for shape, dt in (((1, 1024, 64, 128), torch.bfloat16), ((1, 256, 16, 512), torch.float32),
                      ((1, 2048, 64, 128), torch.float32), ((6, 256, 16, 128), torch.bfloat16),
                      ((2, 1024, 64, 128), torch.bfloat16), ((140, 8, 4, 64), torch.float32)):
        c = shape[-1]
        args = (_rand(g, shape, dt, cuda, offset=3.0), _rand(g, (c,), torch.float32, cuda),
                _rand(g, (c,), torch.float32, cuda), 32, 1e-6)
        first = groupnorm_kernel.group_norm_silu(*args)
        for _ in range(3):
            assert torch.equal(groupnorm_kernel.group_norm_silu(*args), first)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape,groups,eps,offset,silu", [
    ((2, 256, 16, 128), 32, 1e-5, 0.0, True),     # UNet out_norm, CFG batch 2
    ((1, 1024, 64, 128), 32, 1e-6, 0.0, True),    # VAE decoder norm_out
    ((1, 1024, 64, 128), 32, 1e-6, 10.0, True),   # offset input: GroupNorm cancellation
    ((1, 256, 16, 512), 32, 1e-6, 0.0, True),     # VAE encoder norm_out
    ((2, 7, 5, 36), 4, 1e-5, 0.0, True),          # channels not a multiple of 8: scalar path
    ((2, 40, 64), 32, 1e-5, 0.0, False),          # rank 3, no SiLU
])
def test_group_norm_silu_kernel(cuda, dt, shape, groups, eps, offset, silu):
    g = torch.Generator(device=cuda).manual_seed(8)
    c = shape[-1]
    args = (_rand(g, shape, dt, cuda, offset=offset), _rand(g, (c,), torch.float32, cuda),
            _rand(g, (c,), torch.float32, cuda), groups, eps, silu)
    _check(groupnorm_kernel.group_norm_silu(*args), groupnorm_kernel.group_norm_silu_plain(*args),
           dt)


def test_group_norm_silu_on_two_streams_at_once(cuda):
    """Launches on two streams, queued without a wait between them, keep
    their barriers and partials apart: each agrees with its plain version
    and with the same call made alone."""
    g = torch.Generator(device=cuda).manual_seed(26)
    calls = []
    for shape in ((2, 1024, 64, 128), (6, 256, 16, 128)):
        c = shape[-1]
        calls.append((_rand(g, shape, torch.bfloat16, cuda, offset=2.0),
                      _rand(g, (c,), torch.float32, cuda), _rand(g, (c,), torch.float32, cuda),
                      32, 1e-6))
    alone = [groupnorm_kernel.group_norm_silu(*args) for args in calls]
    streams = [torch.cuda.Stream(cuda) for _ in calls]
    torch.cuda.synchronize(cuda)
    for _ in range(3):
        got = []
        for stream, args in zip(streams, calls):
            with torch.cuda.stream(stream):
                got.append(groupnorm_kernel.group_norm_silu(*args))
        torch.cuda.synchronize(cuda)
        for y, want in zip(got, alone):
            assert torch.equal(y, want)
    for args, y in zip(calls, alone):
        _check(y, groupnorm_kernel.group_norm_silu_plain(*args), torch.bfloat16)


def test_group_norm_silu_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(1, 8, 4, 64, device=cuda)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(TypeError):
        groupnorm_kernel.group_norm_silu(x.half(), ones, zeros)
    with pytest.raises(ValueError):
        groupnorm_kernel.group_norm_silu(x, ones, zeros, groups=24)
    with pytest.raises(ValueError):
        groupnorm_kernel.group_norm_silu(x.transpose(1, 2), ones, zeros)
    with pytest.raises(ValueError):
        groupnorm_kernel.group_norm_silu(x, ones[:32], zeros[:32])


@pytest.mark.parametrize("op", ["conv2d", "conv1d", "conv_transpose1d"])
def test_bf16_conv_rounds_once_on_the_card(cuda, op):
    """The plain convs sum the f32 product and the bias before the one
    rounding to bf16: at most 1e-3 of the outputs differ from an f32
    computation rounded once (cuDNN's own bf16 conv with the bias: 27-28%)."""
    g = torch.Generator(device=cuda).manual_seed(9)

    def rnd(*shape, scale=1.0):
        return _rand(g, shape, torch.bfloat16, cuda, scale=scale)

    kw = {}
    if op == "conv2d":
        p, x = {"w": rnd(3, 3, 256, 128, scale=0.02), "b": rnd(128)}, rnd(2, 64, 16, 256)
    elif op == "conv1d":
        p, x = {"w": rnd(7, 256, 256, scale=0.02), "b": rnd(256)}, rnd(1, 1024, 256)
    else:
        p, x = {"w": rnd(16, 256, 512, scale=0.02), "b": rnd(256)}, rnd(1, 128, 512)
        kw = dict(stride=8, padding=4)
    fn = getattr(nn, op)
    with torch.inference_mode():
        got = fn(p, x, **kw)
        once = fn({k: v.float() for k, v in p.items()}, x.float(), **kw).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == once.shape
    assert (got != once).float().mean().item() <= 1e-3


def test_int8_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 16, 128, device=cuda)
    wq = torch.zeros(128, 128, dtype=torch.int8, device=cuda)
    ws = torch.ones(128, device=cuda)
    with pytest.raises(TypeError):
        lnmm_kernel.int8_matmul(x, wq.float(), ws)
    with pytest.raises(ValueError):
        lnmm_kernel.int8_matmul(x, wq[:64], ws)
    with pytest.raises(ValueError):
        lnmm_kernel.int8_matmul(x, wq, torch.ones(64, device=cuda))
    with pytest.raises(ValueError):
        lnmm_kernel.ln_matmul_q(x, ws, ws, wq.cpu(), ws)
    with pytest.raises(ValueError):
        resblock_kernel.gn_silu_conv3x3_q(x[:, None], None, ws, ws, wq[None, None], ws, ws)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 4, 4, 64, device=cuda)
    w = torch.randn(3, 3, 64, 64, device=cuda)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(TypeError):
        resblock_kernel.gn_silu_conv3x3(x.half(), None, ones, zeros, w, zeros)
    with pytest.raises(ValueError):
        resblock_kernel.gn_silu_conv3x3(x, None, ones, zeros, torch.randn(1, 1, 64, 64,
                                                                          device=cuda), zeros)
    with pytest.raises(ValueError):
        resblock_kernel.gn_silu_conv3x3(x, x.transpose(1, 2), ones, zeros,
                                        torch.randn(3, 3, 128, 64, device=cuda), zeros)
    q = torch.randn(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        attention_kernel.flash_self_attention(q, q, q, 0.25)
    with pytest.raises(ValueError):
        lnmm_kernel.ln_matmul(x, ones, zeros, torch.randn(32, 8, device=cuda))


def test_launch_counters_count_launches(cuda):
    ops.reset_launch_counts()
    q = torch.randn(1, 64, 2, 32, device=cuda)
    attention_kernel.flash_self_attention(q, q, q, 0.2)
    attention_kernel.flash_self_attention(q, q, q, 0.2)
    attention_kernel.self_attention_plain(q, q, q, 0.2)
    wq = torch.zeros(32, 128, dtype=torch.int8, device=cuda)
    lnmm_kernel.int8_matmul(q.reshape(1, 64, 64)[..., :32], wq, torch.ones(128, device=cuda))
    lnmm_kernel.int8_matmul_plain(q.reshape(1, 64, 64)[..., :32], wq, torch.ones(128, device=cuda))
    x = torch.randn(1, 4, 4, 64, device=cuda)
    groupnorm_kernel.group_norm_silu(x, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
    groupnorm_kernel.group_norm_silu_plain(x, torch.ones(64, device=cuda),
                                           torch.zeros(64, device=cuda))
    q4 = torch.randn(1, 64, 4, 32, device=cuda)
    avk.v6bd_attention(q4, q4, q4, 0.2)
    avk.v7_attention(q4, q4, q4, 0.2)
    avk.v7_attention(q4, q4, q4, 0.2)
    avk.v7_attention_plain(q4, q4, q4, 0.2)
    counts = ops.launch_counts()
    assert counts.pop("v6bd_attention") == 1
    assert counts.pop("v7_attention") == 2
    assert counts.pop("flash_self_attention") == 2
    assert counts.pop("int8_matmul") == 1
    assert counts.pop("group_norm_silu") == 1
    assert set(counts.values()) == {0}


def test_tiny_slice_on_the_card_matches_cpu(cuda):
    """The whole tiny t5 slice in f32 on the card (its kernels where the
    shapes take them) against the same slice on the CPU (plain versions)."""
    import audioldm2_torch as at
    from audioldm2_torch import params as tparams
    from tiny import tiny_t5_model_config

    cfg = tiny_t5_model_config()
    tree = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu", nonzero=True)
    x_T = torch.randn((1, 16, cfg.latent_f_size, cfg.latent_channels),
                      generator=torch.Generator().manual_seed(1))
    mels = []
    for dev in ("cpu", cuda):
        model = at.build_model(config=cfg, device=dev, params=tparams.map_tree(np.asarray, tree))
        batch = model.make_batch("a dog barking")
        _, mel = model.ldm.generate(batch, None, latent_t_size=16, ddim_steps=4, ddim_eta=0.0,
                                    x_T=x_T.to(dev))
        mels.append(mel)
    assert float(np.abs(mels[0] - mels[1]).mean()) < 1e-3


def test_request_spans_time_every_stage_on_the_card(cuda):
    """After a request on the card every evented span has its device time
    in ``last_timings``, and the stages, each nested in the request span
    and run one after another on its stream, sum to no more than it."""
    import dataclasses

    import audioldm2_torch as at
    from audioldm2_torch import config as config_m
    from tiny import tiny_t5_model_config

    cfg = dataclasses.replace(config_m.coerce(tiny_t5_model_config()),
                              reranker_clap=config_m.CLAPConfig())
    model = at.build_model(config=cfg, device=cuda, seed=0, nonzero_init=True)
    kw = dict(ddim_steps=4, duration=0.32, duration_bucket=None, n_candidate_gen_per_text=2)
    at.text_to_audio(model, "rain", seed=1, **kw)  # warm: the kernels' first launches
    at.text_to_audio(model, "rain", seed=2, **kw)
    t = model.last_timings
    stages = ["conditioning", "prepare_unet", "sampler", "vae_decode", "vocoder", "to_host",
              "rerank"]
    device = {k: v for k, v in t.items() if k.endswith("_device_s")}
    assert set(device) == {f"{n}_device_s" for n in ["request"] + stages}
    assert all(v > 0 for v in device.values()), device
    assert sum(device[f"{n}_device_s"] for n in stages) <= device["request_device_s"]
    assert t["sampler_steps"] == 4
    spans = model.last_spans
    assert all(s.parent == spans[0].id for s in spans[1:])
    assert {s.name for s in spans if s.device_s is None} == {"tokenize"}


def test_speech_request_times_the_token_loop_on_the_card(cuda):
    """A speech request (CLAP and a narrow phoneme encoder into a one-layer
    GPT-2 of 512 tokens) times ``seqgen.prefix``, ``seqgen.prefill`` and
    ``seqgen.decode`` on the device inside ``conditioning`` and counts 512
    ``seqgen.token`` steps."""
    import dataclasses

    import audioldm2_torch as at
    from audioldm2_torch import config as config_m
    from tiny import tiny_t5_model_config

    phoneme = config_m.ConditionerSpec(
        name="crossattn_vits_phoneme", kind="phoneme", cond_stage_key="phoneme_idx",
        phoneme=config_m.PhonemeEncoderConfig(hidden_channels=16, filter_channels=32,
                                              n_heads=2, n_layers=2))
    clap = config_m.ConditionerSpec(name="film_clap_cond1", kind="clap",
                                    clap=config_m.CLAPConfig())
    seqgen = config_m.ConditionerSpec(
        name="crossattn_audiomae_generated", kind="sequence_gen", cond_stage_key="all",
        sequence_gen=config_m.SequenceGenConfig(
            sequence_gen_length=512,
            sequence_input_keys=("film_clap_cond1", "crossattn_vits_phoneme"),
            sequence_input_embed_dims=(512, 16), gpt2=config_m.GPT2Config(n_layer=1)),
        nested=(clap, phoneme))
    base = config_m.coerce(tiny_t5_model_config())
    cfg = dataclasses.replace(base, unet=dataclasses.replace(base.unet, context_dims=(768,)),
                              conditioners=(seqgen,))
    model = at.build_model(config=cfg, device=cuda, seed=0, nonzero_init=True)
    kw = dict(transcription="The quick brown fox jumps.", ddim_steps=2, duration=0.32,
              duration_bucket=None, n_candidate_gen_per_text=1)
    at.text_to_audio(model, "a man speaks", seed=1, **kw)  # warm
    at.text_to_audio(model, "a man speaks", seed=2, **kw)
    t = model.last_timings
    names = ["seqgen_prefix", "seqgen_prefill", "seqgen_decode"]
    assert all(t[f"{n}_device_s"] > 0 for n in names), t
    assert sum(t[f"{n}_device_s"] for n in names) <= t["conditioning_device_s"]
    assert t["seqgen_decode_steps"] == 512
    spans = model.last_spans
    (cond,) = [s for s in spans if s.name == "conditioning"]
    assert [s.name for s in spans if s.parent == cond.id] == [n.replace("_", ".") for n in names]


# SHA-256 of the bf16 K3 output at the 18 (M, C, N) the t5 and large-1150k
# UNets give it, on time_k2_k3.k3_args's inputs, from the tree before K3 and
# K4 shared one kernel (NVIDIA H100 80GB HBM3).
K3_SHA256_BEFORE_K4_JOINED = {
    (6144, 256, 2048): "21b7073707dcf2efafc72980a2a815131a04481f3c2553b53c9a24da9a936b88",
    (6144, 256, 768): "46cd13de6047e335d4ad1296cc345033862f724ef4305c00cbfdf4676d42ea6c",
    (6144, 256, 256): "53bdc24c6b020b57d65716d6090ecf280552a2cdfbe3d543641b6d6edb32eb0b",
    (2048, 256, 2048): "125bb58b5dc9a6496328626e1b61338a8753a45be3de68270b9a8a3b5875bfe2",
    (2048, 256, 768): "5c7fde3d9d42a01a14985f509b76c0269e7078766eec21e9b69e1fcb72ca79ed",
    (2048, 256, 256): "b7f9f0459c165f123349db5ac22ca546d0b61bde5bcc572e399852bcb0d7cf40",
    (1536, 384, 3072): "92aeb28ee842ac0822fa82f508c3a2f392a41acc3aaa39d2d70af2f693c0750f",
    (1536, 384, 1152): "1202d2986275ae944d0d3556a1802c388eaba5fe82f891478ea0550ee827c514",
    (1536, 384, 384): "116818b24fa55deff898281d5c211d5bfe3803b5aa5bd87998372a1ee6606998",
    (512, 384, 3072): "fec70f7dfb633a2ddd9950996d5c2de3633de0f23a6d6fb6a638339e05042310",
    (512, 384, 1152): "accfa93d162b62fbad8a0638310b76c328f9281a866be15657c332a1986b2d26",
    (512, 384, 384): "67748e4faa66f29acf8aa948a8749cfff79b56b7be9d26a52cf6593881a50d4f",
    (384, 640, 5120): "fbeb750402d0b0266f660192eaa7bb4bfe686dc8a906f4a6b0ab617c565a6c88",
    (384, 640, 1920): "e783a30d291353f5647b725e11ff6f711de11dc3bc519ccac29afb35b1dd48dd",
    (384, 640, 640): "4482c7fb4ca4ac1ab043e140419ded3c1ebe6a4eb75eef52c03f6bd13801be7c",
    (128, 640, 5120): "c864d4bcdf6908a4ec95760d5528ac395cb5c8fb6215a73c95728cf7818c1264",
    (128, 640, 1920): "0466c7405ba1aa72bc25798dfd7e4ed3949d854244824a3194bdaca0807429d6",
    (128, 640, 640): "e49175629fe524b2c16b72a0e0df7d045bdcab716341270fd8209fe1e36904f2",
}


def test_k3_gives_the_bits_it_gave_before_k4_shared_its_kernel(cuda):
    """K3 and K4 are one template on the row-block pass; K3's instantiations
    must give the same bytes as K3's own kernel did."""
    from audioldm2_torch.tools import time_k2_k3

    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the recorded hashes are an sm_90 card's")
    with torch.inference_mode():
        for shape, want in K3_SHA256_BEFORE_K4_JOINED.items():
            got = lnmm_kernel.ln_matmul(*time_k2_k3.k3_args(shape, cuda))
            assert time_k2_k3.sha256(got) == want, shape


# SHA-256 of the bf16 K1 output at its 39 main-path shapes and of the bf16 K1q
# output at its 17 full8 shapes (B, T, F, C1, C2, Cout), on time_k2_k3's inputs
# (time_k1, time_k1q), from the tree before the f32 K1 and K6 were redesigned
# (NVIDIA H100 80GB HBM3): the f32 work must leave the bf16 kernels' bits alone.
K1_SHA256_BEFORE_F32 = {
    (6, 256, 16, 256, 128, 128): "87e315cf6be43b245895c62743367efa7437addf6e4b391c8b1d59b90b4f7849",
    (6, 256, 16, 128, 128, 128): "fa8ad351c69b5e779e9743cf2db2fec2b268428f46fde15e742da0d05ec46c8b",
    (6, 256, 16, 128, 0, 128): "e7667244ebd0816ee35669893e3d3b672de6df26638e9e6bb26f8f3a4617f6fc",
    (6, 128, 8, 384, 256, 256): "6a1e64002b1aefa075719cdcf080e34ab729cb28f61c32aa3a89c51248ee2000",
    (6, 128, 8, 256, 256, 256): "c31b9e7857a268e8c97cfd8769f6be3412395b40d0a08aaf1ee9d04ae60579ca",
    (6, 128, 8, 256, 128, 256): "b90c707c508ab65bc492f5aee61a5c24acffb0029c6ea7bdeb1c0ab1531a9620",
    (6, 128, 8, 256, 0, 256): "518a751200e451a649e932055478d3081cbd3ae0e86b1a27ad74dbc6fab3899d",
    (6, 128, 8, 128, 0, 256): "e4192c8ab6f141deb0acd723577eeca28168aa3070848901ee47185390baa4ac",
    (6, 64, 4, 640, 384, 384): "e3cbdf6eb345e888631ca852cb7f5ac68baa129a7f55db2fedbf2e8a9c476faa",
    (6, 64, 4, 384, 384, 384): "1579ff558343e7e857e3ef2a635040340a15adeb20bc3bf07106c640521b634b",
    (6, 64, 4, 384, 256, 384): "6779fe18bd55cc24da3dd4fa14c3694a59a9aaa9c9695893d264ddbc325178c0",
    (6, 64, 4, 384, 0, 384): "9592dbdd2952edbbeeb3efafee6392a06195c401a246bc20036bfd7981a8e0b5",
    (6, 64, 4, 256, 0, 384): "26480482e49964da7eb5a5e8ea6602bd813f5d190d669d2dba482eb192975228",
    (6, 32, 2, 640, 640, 640): "b02cfa283b8f0f5faa4f9b9330cc07fd5564c748ec75bd29548c12eea00c367e",
    (6, 32, 2, 640, 384, 640): "0285336ee512ad69eb236e11174ad6e0b98980abd62f23cfab6b931ba76b6223",
    (6, 32, 2, 640, 0, 640): "face41d80f4ec1cb7f7ed6562a41ce292ae432e5f3fd9e9cd6dec524ab3cc1e8",
    (6, 32, 2, 384, 0, 640): "0821fe8300e9ffd7edb174e3b15ed7e69f7e6eb6084b3d893572d563242ccf2e",
    (2, 256, 16, 256, 128, 128): "f2efcbb55550626545c137a3c8e8f957cdce79d3b150ca5196b984d448c18c33",
    (2, 256, 16, 128, 128, 128): "2b089619f7b967da153518ec857664cbf3e4641039fa2bab364e5dfe125501c6",
    (2, 256, 16, 128, 0, 128): "e0b1600d76565c29c8a030307337d3d831da1ddd160c3f8d713c6fa2a5c69201",
    (2, 128, 8, 384, 256, 256): "1263fe8850ce034fd8cbf635314dd65e8a389a20ef0f82768326ae0930600ec4",
    (2, 128, 8, 256, 256, 256): "f275eb57ce0c84fd84246feb8061549102444da7e4472aae35ae0ab357c893c8",
    (2, 128, 8, 256, 128, 256): "cb5d1bc8d7de87b054d6e7d23262f671764c46b993ed3cf98a443d089f5ef6e0",
    (2, 128, 8, 256, 0, 256): "0cb610e231334101a44859378887b8c98ab38a5c0e8b927501ab0d47f76cd4ef",
    (2, 128, 8, 128, 0, 256): "f8f2fc2bce8d56608bec450f6860ec95cfe8c29be312e67cd6a15b593861fdb7",
    (2, 64, 4, 640, 384, 384): "7e90bfe91211110eb6206f2bdeee536ae8ad3edda0ef22dec58b056bf8d8314a",
    (2, 64, 4, 384, 384, 384): "b7d103e3502c6999dd2f0a3aad32c30826588f3e4e0d47cdbbb80a893b54a6d2",
    (2, 64, 4, 384, 256, 384): "aae630b4fa2c8feaa07d40fe1255a46bfd73041ad4d24755abbedd5d1c2675d4",
    (2, 64, 4, 384, 0, 384): "649c868ddf28628f0956bbc419de7f5c4ce2d29c6fb86c56e3c15adcc7cec92d",
    (2, 64, 4, 256, 0, 384): "6c79bb441b6b9364124f4993798b3c711843e22ce60b0cba23c964bb66104b35",
    (2, 32, 2, 640, 640, 640): "4082c9294259961231a8c24c8267bd56e6cececb39e9c3ddfd1a4572606266ba",
    (2, 32, 2, 640, 384, 640): "67672ad7513f2a2e7acf66f38cc3fb724afb73e1ecdeb52b76e99bae5c1bf1ca",
    (2, 32, 2, 640, 0, 640): "e2ca84f04283318aff8ff7a787888cfef950a54ae45359338c1f67c6e432ec25",
    (2, 32, 2, 384, 0, 640): "8d5376df3d3149743fbc29c10bdb2d83184246dc41e401ebb7fe04daba1071e9",
    (1, 1024, 64, 256, 0, 128): "8ba32936a30d2235a719aa66373bf2f7beee699aef2d0060e27ce0b4574776a3",
    (1, 1024, 64, 128, 0, 128): "96e5dfccab0b007265eb2ec01e66a1261bded76202a5db852cb5d6d705ff005c",
    (1, 512, 32, 512, 0, 256): "670553c0c439bafb593e163ca41270d2b35950110df23f6a208e38143ee50cc1",
    (1, 512, 32, 256, 0, 256): "8d66d25ac8ffcd847cbd550e4e70d3b630a039c67c98718b85c7f35c28785184",
    (1, 256, 16, 512, 0, 512): "ea4f1590bcaf783dbdea994120089afeab027e7509c417e37c7643a72e59fdc0",
}
K1Q_SHA256_BEFORE_F32 = {
    (2, 256, 16, 256, 128, 128): "be29692a46b80dc3f0e3465b5cfd535e4f03833d4aec9976f51dd9c6dff4f23b",
    (2, 256, 16, 128, 128, 128): "d4a7a4282a808012c6179c2314c030ee482f5b64a798dedbf86c7d28d084edc8",
    (2, 256, 16, 128, 0, 128): "dc40c0b9b7ebfb51f961be832016f439d056ab8b0138be7352f2cb0e64b48d7f",
    (2, 128, 8, 384, 256, 256): "c4b7a183fc6d0170b02bcd1cf504fca81028b2a9fd8f941dbae693d90d726b81",
    (2, 128, 8, 256, 256, 256): "cff3ea694e71167417643321460393fedb539b4219dfc4f8b81190e7ca83214d",
    (2, 128, 8, 256, 128, 256): "f875bdcc93f9c6cbbd7f7f8d3bca96a20fdcc1597e189ba4e9e5c2ea94f6da94",
    (2, 128, 8, 256, 0, 256): "dbf38367bf9ff93fc69dde82ba94ef2e4c3cfc52476d7a40208a6d0df758b22f",
    (2, 128, 8, 128, 0, 256): "8632942c99a0629f410493a765df9f7d849061963a9fc141bae5d44adbb33f7e",
    (2, 64, 4, 640, 384, 384): "59e4aa48c664ebca40745203bf2a3638056e05d210e1948cce18647dfa4ebb8c",
    (2, 64, 4, 384, 384, 384): "16be15d09a202bc4e564c5bb9f511e4bc82fc11d0b0f74650ac1298e8a41b431",
    (2, 64, 4, 384, 256, 384): "fbd842c9ebe7659b94da4d32081bb959706732a20a6e63fa3117d81489cb4ac4",
    (2, 64, 4, 384, 0, 384): "6c42d8761c734681a6b1316448f52a7d2ab855d4edab7aaefef7bdd35e6ca2a5",
    (2, 64, 4, 256, 0, 384): "d9ddccb3d9a1375035916497ec43b3f9288544e48ebf9d348570838a726eed9c",
    (2, 32, 2, 640, 640, 640): "fab8dd44f7246a5b46c3dd11b5866a1a83af1d97997b2d8e8b3829be3f87c219",
    (2, 32, 2, 640, 384, 640): "d50ebc3d99cb15ab82926b8930bf2f565153975a27811ad88912e4fb28824c2f",
    (2, 32, 2, 640, 0, 640): "fcbf96448f56a1ffa629aaf4342031bc28b2afc9688580371a54fc52b7352d42",
    (2, 32, 2, 384, 0, 640): "605b058a25a7260b6370537aa141c5eb813c82c04ffd389553df96abd4efdf53",
}


def test_bf16_k1_and_k1q_give_the_bits_they_gave_before_the_f32_kernel(cuda):
    """The f32 K1 is a sibling kernel in the same source: bf16 K1 and K1q
    must give the same bytes at every main-path shape as before it."""
    from audioldm2_torch.tools import time_k2_k3

    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the recorded hashes are an sm_90 card's")
    with torch.inference_mode():
        for shape, want in K1_SHA256_BEFORE_F32.items():
            got = resblock_kernel.gn_silu_conv3x3(*time_k2_k3.k1_args(shape, cuda))
            assert time_k2_k3.sha256(got) == want, shape
        for shape, want in K1Q_SHA256_BEFORE_F32.items():
            got = resblock_kernel.gn_silu_conv3x3_q(*time_k2_k3.k1q_args(shape, cuda))
            assert time_k2_k3.sha256(got) == want, shape


# ---------------------------------------------------------------------------
# Autograd through the kernels (ops.autograd): the f32 train step's path
# ---------------------------------------------------------------------------


def _grad_cases(g, device):
    """(wrapper, plain, args) of each kernel with a gradient, f32, at small
    shapes the kernels take (the f32 K1's plan, K2's head width 32)."""
    def r(*shape, scale=1.0, offset=0.0):
        return _rand(g, shape, torch.float32, device, scale, offset)

    k1 = lambda c2: (r(2, 8, 4, 64, offset=0.5), r(2, 8, 4, c2) if c2 else None,  # noqa: E731
                     r(64 + c2, scale=0.1, offset=1.0), r(64 + c2, scale=0.1),
                     r(3, 3, 64 + c2, 96, scale=(9 * (64 + c2)) ** -0.5), r(96), 32, 1e-5)

    def rb(*shape, scale=1.0, offset=0.0):
        return _rand(g, shape, torch.bfloat16, device, scale, offset)

    return {
        # the plain conv is bf16 only: a 3x3 stride-2 conv, and the GroupNorm
        # before a 1x1 over two parts read through the nearest 2x
        "conv2d": (resblock_kernel.conv2d, resblock_kernel.conv2d_plain,
                   (rb(2, 9, 5, 64), None, rb(3, 3, 64, 32, scale=1 / 24), rb(32), None, None,
                    2, ((1, 1), (1, 1)), 1, 32, 1e-5)),
        "conv2d with GroupNorm": (resblock_kernel.conv2d, resblock_kernel.conv2d_plain,
                                  (rb(2, 6, 4, 64, offset=0.5), rb(2, 6, 4, 32),
                                   rb(1, 1, 96, 64, scale=0.1), rb(64), rb(96, offset=1.0),
                                   rb(96, scale=0.1), 1, ((0, 0), (0, 0)), 2, 32, 1e-6)),
        "K1": (resblock_kernel.gn_silu_conv3x3, resblock_kernel.gn_silu_conv3x3_plain, k1(0)),
        "K1 with x2": (resblock_kernel.gn_silu_conv3x3, resblock_kernel.gn_silu_conv3x3_plain,
                       k1(32)),
        "K2": (attention_kernel.flash_self_attention, attention_kernel.self_attention_plain,
               (r(2, 200, 4, 32), r(2, 200, 4, 32), r(2, 200, 4, 32), 32 ** -0.5)),
        "K3": (lnmm_kernel.ln_matmul, lnmm_kernel.ln_matmul_plain,
               (r(2, 100, 256, offset=1.0), r(256, scale=0.1, offset=1.0), r(256, scale=0.1),
                r(256, 384, scale=1 / 16), r(384), 1e-5)),
        "K4": (lnmm_kernel.geglu_matmul, lnmm_kernel.geglu_matmul_plain,
               (r(2, 100, 512), r(256, 128, scale=1 / 16), r(128), r(2, 100, 128))),
        "K6": (groupnorm_kernel.group_norm_silu, groupnorm_kernel.group_norm_silu_plain,
               (r(2, 16, 8, 128, offset=2.0), r(128, scale=0.1, offset=1.0), r(128, scale=0.1),
                32, 1e-5, True)),
    }


@pytest.mark.parametrize("case", ["K1", "K1 with x2", "K2", "K3", "K4", "K6", "conv2d",
                                  "conv2d with GroupNorm"])
def test_kernels_under_autograd_give_the_plain_gradients(cuda, monkeypatch, case):
    """A CUDA call under grad launches the kernel once (its output within
    the bound of the plain version's in its dtype) and its backward
    recomputes the plain version once: every input's gradient within 1e-5
    of autograd of the plain version on the same inputs (the same operations
    on the same saved inputs; cuDNN deterministic, for the bf16 plain conv's
    f32 copies)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    g = torch.Generator(device=cuda).manual_seed(0)
    wrapper, plain, args = _grad_cases(g, cuda)[case]

    def leaves():
        return tuple(a.clone().requires_grad_(True) if isinstance(a, torch.Tensor) else a
                     for a in args)

    recomputes = []

    def counted(*a):
        recomputes.append(a)
        return plain(*a)

    monkeypatch.setattr(sys.modules[wrapper.__module__], plain.__name__, counted)
    a1, a2 = leaves(), leaves()
    launches = wrapper.launches
    got = wrapper(*a1)
    want = plain(*a2)
    assert wrapper.launches == launches + 1 and got.grad_fn is not None and not recomputes
    _check(got.detach(), want.detach(), got.dtype)
    up = torch.randn(want.shape, generator=g, device=cuda).to(want.dtype)
    got.backward(up)
    want.backward(up)
    assert len(recomputes) == 1
    for x, y in zip(a1, a2):
        if isinstance(x, torch.Tensor):
            err = (x.grad - y.grad).abs().max().item()
            assert err <= 1e-5 * y.grad.abs().max().item(), err


def test_int8_kernels_refuse_autograd_on_the_card(cuda):
    x = torch.randn(2, 10, 128, device=cuda, requires_grad=True)
    wq = torch.zeros(128, 128, dtype=torch.int8, device=cuda)
    ws = torch.ones(128, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        lnmm_kernel.int8_matmul(x, wq, ws, ws)
    with torch.no_grad():
        assert lnmm_kernel.int8_matmul(x, wq, ws, ws).shape == (2, 10, 128)


# ---------------------------------------------------------------------------
# The entry points' modules on the card: DDIM stochastic_encode and
# ddim_decode, the EncoderUNet and its legacy attention block, the inverse
# STFT and Griffin-Lim, and the host audio library on the card's machine
# ---------------------------------------------------------------------------

# a tiny UNet whose self-attention takes K2 (head_dim 32)
TINY_K2_UNET = dict(in_channels=4, out_channels=4, model_channels=64, num_res_blocks=1,
                    attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
                    context_dims=(32,))


def _rel(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("t_start", [1, 6, 10])
def test_stochastic_encode_and_ddim_decode_on_the_card_match_cpu(cuda, t_start):
    """A tiny UNet (K1, K2, K3, K4, K6 on the card) denoised from
    stochastic_encode's latent by ddim_decode, f32: card against CPU."""
    from audioldm2_torch.config import UNetConfig
    from audioldm2_torch.diffusion import ddim
    from audioldm2_torch.diffusion.schedule import DiffusionSchedule
    from audioldm2_torch.models import unet
    from audioldm2_torch.params import Init, map_tree

    ucfg = UNetConfig(**TINY_K2_UNET)
    p_cpu = unet.init_unet(Init(torch.Generator().manual_seed(0), "cpu", nonzero=True), ucfg)
    g = torch.Generator().manual_seed(1)
    x0, noise = (torch.randn((2, 16, 8, 4), generator=g) for _ in range(2))
    ctx = torch.randn((2, 7, 32), generator=g)
    mask = torch.ones((2, 7))
    sched = DiffusionSchedule.create()
    outs = []
    for dev in ("cpu", cuda):
        p = map_tree(lambda t: t.to(dev), p_cpu)
        c, m = ctx.to(dev), mask.to(dev)

        def eps(x, t):
            return unet.apply_unet(p, ucfg, x, t, [c], [m])

        with torch.inference_mode():
            z_t = ddim.stochastic_encode(x0.to(dev), t_start - 1, sched, 10, noise=noise.to(dev))
            outs.append((z_t, ddim.ddim_decode(eps, z_t, sched, t_start, 10)))
    assert _rel(outs[1][0], outs[0][0]) <= 1e-6
    assert torch.isfinite(outs[1][1]).all() and _rel(outs[1][1], outs[0][1]) <= 1e-4


@pytest.mark.parametrize("new_order", [False, True])
def test_legacy_attention_block_on_the_card(cuda, new_order):
    """The legacy block's self-attention is K2 on the card (strided q, k, v
    in the legacy order): f32 against the CPU, bf16 against the plain path."""
    from audioldm2_torch.models import unet
    from audioldm2_torch.params import Init, cast_floating, map_tree
    from chip_smoke import patched_dispatch

    p = unet.init_legacy_attention_block(Init(torch.Generator().manual_seed(2), "cpu",
                                              nonzero=True), 256, num_head_channels=32)
    x = torch.randn((2, 32, 8, 256), generator=torch.Generator().manual_seed(3))
    pc = map_tree(lambda t: t.to(cuda), p)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = unet.apply_legacy_attention_block(pc, x.to(cuda), new_order=new_order)
        want = unet.apply_legacy_attention_block(p, x, new_order=new_order)
    assert ops.launch_counts()["flash_self_attention"] == 1
    assert _rel(got, want) <= TOL[torch.float32]
    pb = cast_floating(pc, torch.bfloat16)
    with torch.inference_mode():
        got = unet.apply_legacy_attention_block(pb, x.to(cuda, torch.bfloat16), new_order=new_order)
        with patched_dispatch("plain"):
            want = unet.apply_legacy_attention_block(pb, x.to(cuda, torch.bfloat16),
                                                     new_order=new_order)
    assert _rel(got, want) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dt", DTYPES)
def test_encoder_unet_on_the_card_matches_the_plain_path(cuda, dt):
    """The EncoderUNet with K1, K2 and K6 against the all-plain path on the
    card, its launches against the formula."""
    from audioldm2_torch.config import UNetConfig
    from audioldm2_torch.models import unet
    from audioldm2_torch.params import Init, cast_floating
    from chip_smoke import patched_dispatch

    ucfg = UNetConfig(**{**TINY_K2_UNET, "out_channels": 10})
    p = cast_floating(unet.init_encoder_unet(
        Init(torch.Generator(device=cuda).manual_seed(4), cuda, nonzero=True), ucfg), dt)
    x = torch.randn((2, 32, 16, 4), generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).to(dt)
    t = torch.tensor([981, 5], device=cuda)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = unet.apply_encoder_unet(p, ucfg, x, t)
        counts = ops.launch_counts()
        with patched_dispatch("plain"):
            want = unet.apply_encoder_unet(p, ucfg, x, t)
    assert counts == unet.kernel_launches_per_encoder_forward(
        ucfg, "bfloat16" if dt == torch.bfloat16 else "float32")
    assert counts["flash_self_attention"] == 2
    _check(got, want, dt)


@pytest.mark.parametrize("f,h,w", [(1024, 160, 1024), (64, 16, 64)])
def test_istft_and_griffin_lim_on_the_card_match_cpu(cuda, f, h, w):
    from audioldm2_torch.ops import stft

    n = h * 200
    t = torch.arange(n) / n
    wav = (0.5 * torch.sin(2 * np.pi * (30 + 3000 * t) * t))[None].float()
    basis = torch.from_numpy(stft.stft_basis(f, w))
    mag, ph = stft.stft_full(wav, basis, f, h)
    mag_c, ph_c = stft.stft_full(wav.to(cuda), basis.to(cuda), f, h)
    assert _rel(mag_c, mag) <= 1e-5
    assert _rel(stft.istft(mag.to(cuda), ph.to(cuda), f, h, w), stft.istft(mag, ph, f, h, w)) <= 1e-5
    phase = torch.rand(mag.shape, generator=torch.Generator().manual_seed(6)) * 6.283 - 3.1415
    got = stft.griffin_lim(mag.to(cuda), f, h, w, n_iters=5, phase=phase.to(cuda))
    want = stft.griffin_lim(mag, f, h, w, n_iters=5, phase=phase)
    assert torch.isfinite(got).all() and _rel(got, want) <= 1e-4
    drawn = stft.griffin_lim(mag.to(cuda), f, h, w, n_iters=1,
                             generator=torch.Generator(device=cuda).manual_seed(0))
    assert drawn.is_cuda and drawn.shape == want.shape


def test_host_audio_library_builds_on_the_cards_machine(cuda):
    """The port's copy of the C++ resampler builds with g++ on the card's
    machine and equals the numpy path (1e-6, the JAX package's bound)."""
    from audioldm2_torch.utils import audio_io, native

    assert native.available(), native.build_error()
    x = np.random.default_rng(7).standard_normal((2, 48000)).astype(np.float32)
    for a, b in ((48000, 16000), (16000, 48000)):
        kernel, orig, new, width = audio_io.sinc_interp_hann_kernel(a, b)
        np.testing.assert_allclose(native.resample_sinc(x, kernel, orig, new, width),
                                   audio_io._resample_sinc_np(x, kernel, orig, new, width),
                                   atol=1e-6)
    want = x[0] - np.mean(x[0])
    want = (0.5 * want / (np.max(np.abs(want)) + 1e-8)).astype(np.float32)
    np.testing.assert_allclose(native.normalize_wav(x[0]), want, atol=1e-7)


def test_int8_quantization_on_the_card_is_the_cpus_bit_for_bit(cuda):
    """quantize_weight and quantize_conv3x3_dict on the card give the CPU's
    int8 values and scales bit for bit (float32 division, half to even), on
    absmax values whose reciprocal product is not their quotient."""
    from audioldm2_torch.ops import quant

    g = torch.Generator().manual_seed(19)
    w = torch.randn((1280, 640), generator=g)
    wc = torch.randn((3, 3, 256, 384), generator=g)
    for got, want in ((quant.quantize_weight(w.to(cuda)), quant.quantize_weight(w)),
                      (quant.quantize_conv3x3_dict({"w": wc.to(cuda), "b": wc[0, 0, 0]}),
                       quant.quantize_conv3x3_dict({"w": wc, "b": wc[0, 0, 0]}))):
        got = got.values() if isinstance(got, dict) else got
        want = want.values() if isinstance(want, dict) else want
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    s = w.abs().amax(0)
    assert not torch.equal((s.to(cuda) / 127.0).cpu(), s / 127.0)  # what the scalar divisor gave


# ---------------------------------------------------------------------------
# The plain conv on K1's bf16 kernel: every bf16 conv2d of the UNet and the
# VAE decoder outside the ResBlock bodies
# ---------------------------------------------------------------------------

ROUND_ONCE_SHARE = 1e-3

# (B, Ti, Fi, C1, C2, Cout, taps, stride, up, GroupNorm, input offset)
PLAIN_CONV_MODES = [
    (2, 16, 8, 128, 0, 128, 3, 1, 1, False, 0.0),   # 3x3, no prologue
    (2, 16, 8, 128, 0, 128, 1, 1, 1, False, 0.0),   # 1x1
    (1, 33, 7, 256, 0, 200, 3, 1, 1, False, 0.0),   # ragged T, F and N tile
    (2, 17, 9, 64, 0, 64, 3, 2, 1, False, 0.0),     # stride 2 on odd T and F
    (2, 9, 5, 128, 0, 128, 3, 1, 2, False, 0.0),    # read through the nearest 2x, ragged
    (2, 11, 6, 128, 64, 96, 1, 1, 1, False, 0.0),   # two parts in place
    (2, 32, 16, 128, 0, 8, 3, 1, 1, False, 0.0),    # Cout 8 (out_conv)
    (2, 32, 16, 128, 0, 16, 3, 1, 1, False, 0.0),   # Cout 16
    (2, 32, 16, 8, 0, 128, 3, 1, 1, False, 0.0),    # Cin 8 (the stem)
    (2, 32, 16, 256, 0, 256, 1, 1, 1, True, 0.0),   # GroupNorm + 1x1 (norm + proj_in)
    (2, 32, 16, 256, 0, 256, 1, 1, 1, True, 10.0),  # ... offset: GroupNorm cancellation
    (1, 13, 5, 96, 32, 64, 3, 1, 1, True, 0.0),     # GroupNorm + 3x3, a group straddling parts
    (2, 32, 2, 640, 0, 640, 3, 1, 1, False, 0.0),   # small M: split over a cluster
    (2, 32, 2, 640, 0, 640, 1, 1, 1, True, 0.0),    # ... 1x1 with the GroupNorm
]


def _plain_conv_args(g, device, b, ti, fi, c1, c2, cout, taps, stride, up, gn, offset=0.0):
    bf = torch.bfloat16
    cin = c1 + c2
    norm = ((_rand(g, (cin,), bf, device, offset=1.0), _rand(g, (cin,), bf, device)) if gn
            else (None, None))
    pad = taps // 2
    return (_rand(g, (b, ti, fi, c1), bf, device, offset=offset),
            _rand(g, (b, ti, fi, c2), bf, device) if c2 else None,
            _rand(g, (taps, taps, cin, cout), bf, device, scale=(taps * taps * cin) ** -0.5),
            _rand(g, (cout,), bf, device), *norm, stride, ((pad, pad), (pad, pad)), up, 32, 1e-6)


def _rounded_once(args):
    """The conv of the kernel's bf16 operands summed exactly (in float64)
    with the bias and rounded once to bf16 (cuDNN's f32 convs of the f32
    copies are no such oracle: at the upsample convs' shapes its FFT and
    Winograd algorithms left 0.13-0.52% of outputs off); with a GroupNorm,
    the operand is its affine from the kernel's own statistics pass, x * a
    + c rounded once to f32 (the kernel's fma) and then to bf16."""
    x1, x2, w, b, gs, gb, stride, pads, up, groups, eps = args
    x = x1 if x2 is None else torch.cat([x1, x2], -1)
    if gs is not None:
        a, c = (v.double()[:, None, None] for v in resblock_kernel.gn_stats(
            x1, x2, gs, gb, groups, eps))
        x = (x.double() * a + c).float().to(torch.bfloat16)
    d = torch.float64
    y = resblock_kernel.conv2d_plain(x.to(d), None, w.to(d), b.to(d), None, None, stride, pads,
                                     up)
    return y.to(torch.bfloat16)


def _check_plain_conv(args):
    """Within the bf16 bar of the plain version, and at most 1e-3 of the
    outputs off the one rounding of the f32 sum."""
    got = resblock_kernel.conv2d(*args)
    _check(got, resblock_kernel.conv2d_plain(*args), torch.bfloat16)
    share = (got != _rounded_once(args)).float().mean().item()
    assert share <= ROUND_ONCE_SHARE, share
    return got


@pytest.mark.parametrize("b,ti,fi,c1,c2,cout,taps,stride,up,gn,offset", PLAIN_CONV_MODES)
def test_plain_conv_kernel_modes(cuda, b, ti, fi, c1, c2, cout, taps, stride, up, gn, offset):
    g = torch.Generator(device=cuda).manual_seed(21)
    launches = resblock_kernel.conv2d.launches
    args = _plain_conv_args(g, cuda, b, ti, fi, c1, c2, cout, taps, stride, up, gn, offset)
    with torch.inference_mode():
        got = _check_plain_conv(args)
    assert resblock_kernel.conv2d.launches == launches + 1
    assert got.shape == (b, -(-ti * up // stride), -(-fi * up // stride), cout)


def _plain_conv_cells():
    """Every plain conv shape of the benchmark's two configurations: the
    UNet at CFG 48 (audioldm2-full, 24 clips) and 16 (audioldm_48k, 8), the
    VAE decode at 24 and 8."""
    import audioldm2_torch as at
    from audioldm2_torch.models import unet, vae

    shapes = set()
    for name, cfg_batch in (("audioldm2-full", 48), ("audioldm_48k", 16)):
        cfg = at.default_audioldm_config(name)
        size = (cfg.latent_t_size, cfg.latent_f_size)
        shapes |= set(unet.plain_conv_shapes(cfg.unet, cfg_batch, *size))
        shapes |= set(vae.decode_plain_conv_shapes(cfg.vae, cfg_batch // 2, *size))
    return sorted(shapes)


@pytest.mark.parametrize("b,ti,fi,c1,c2,cout,taps,stride,up,gn", _plain_conv_cells())
def test_plain_conv_kernel_at_every_benchmark_shape(cuda, b, ti, fi, c1, c2, cout, taps, stride,
                                                     up, gn):
    g = torch.Generator(device=cuda).manual_seed(22)
    with torch.inference_mode():
        _check_plain_conv(_plain_conv_args(g, cuda, b, ti, fi, c1, c2, cout, taps, stride, up,
                                           gn))


def test_plain_conv_gives_the_same_bits_twice(cuda):
    """No atomics in a sum: the kernel (split over a cluster too) and its
    statistics pass give bitwise equal outputs on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(23)
    with torch.inference_mode():
        for mode in (PLAIN_CONV_MODES[4], PLAIN_CONV_MODES[10], PLAIN_CONV_MODES[12],
                     PLAIN_CONV_MODES[13]):
            args = _plain_conv_args(g, cuda, *mode)
            first = resblock_kernel.conv2d(*args)
            for _ in range(3):
                assert torch.equal(resblock_kernel.conv2d(*args), first)


def test_bf16_conv2d_rounds_once_on_the_kernel(cuda):
    """test_bf16_conv_rounds_once_on_the_card's conv2d case now reaches the
    plain conv kernel: one launch, no declined call."""
    g = torch.Generator(device=cuda).manual_seed(9)
    p = {"w": _rand(g, (3, 3, 256, 128), torch.bfloat16, cuda, scale=0.02),
         "b": _rand(g, (128,), torch.bfloat16, cuda)}
    x = _rand(g, (2, 64, 16, 256), torch.bfloat16, cuda)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = nn.conv2d(p, x)
        once = nn.conv2d({k: v.float() for k, v in p.items()}, x.float()).to(torch.bfloat16)
    assert ops.launch_counts()["conv2d"] == 1 and ops.declined_counts() == {"conv2d": 0}
    assert (got != once).float().mean().item() <= ROUND_ONCE_SHARE


def test_plain_conv_takes_a_strided_input_on_the_card(cuda):
    """A channel slice of a wider tensor (not contiguous) reaches the plain
    conv kernel through a contiguous copy, gives the oracle's bits there and
    counts as no declined call."""
    g = torch.Generator(device=cuda).manual_seed(25)
    wide = _rand(g, (2, 32, 16, 192), torch.bfloat16, cuda)
    x = wide[..., 64:]
    p = {"w": _rand(g, (1, 1, 128, 64), torch.bfloat16, cuda, scale=0.05),
         "b": _rand(g, (64,), torch.bfloat16, cuda)}
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = nn.conv2d(p, x)
        want = nn.conv2d(p, x.contiguous())
    assert ops.launch_counts()["conv2d"] == 2 and ops.declined_counts() == {"conv2d": 0}
    assert torch.equal(got, want)

@pytest.mark.parametrize("name,convs", [("audioldm2-full", 119), ("audioldm_48k", 87)])
def test_unet_forward_declines_no_conv(cuda, name, convs):
    """A bf16 UNet forward of either benchmark configuration at full width
    (CFG batch 2) sends every conv to the plain conv kernel and declines
    none; its launches are kernel_launches_per_forward's; a bf16 VAE decode
    declines only its conv_out onto one channel."""
    import audioldm2_torch as at
    from audioldm2_torch.diffusion.latent_diffusion import prepare_unet
    from audioldm2_torch.models import unet, vae
    from audioldm2_torch.params import Init, cast_floating
    from chip_smoke import _ctx_inputs

    cfg = at.default_audioldm_config(name)
    g = torch.Generator(device=cuda).manual_seed(24)
    ctxs, masks, y = _ctx_inputs(cfg, cuda, g, 2)
    x = torch.randn((2, cfg.latent_t_size, cfg.latent_f_size, cfg.latent_channels),
                    generator=g, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        unet_p, kv = prepare_unet({"unet": unet.init_unet(Init(g, cuda), cfg.unet)}, cfg, ctxs)
        ops.reset_launch_counts()
        out = unet.apply_unet(unet_p, cfg.unet, x, torch.tensor([500, 500], device=cuda), ctxs,
                              masks, y=y, cross_kv=kv)
        torch.cuda.synchronize()
        assert ops.launch_counts() == unet.kernel_launches_per_forward(cfg.unet)
        assert ops.launch_counts()["conv2d"] == convs and ops.declined_counts()["conv2d"] == 0
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
        del unet_p, kv
        vae_p = cast_floating(vae.init_vae(Init(g, cuda), cfg.vae), torch.bfloat16)
        z = torch.randn((1, cfg.latent_t_size, cfg.latent_f_size, cfg.vae.embed_dim),
                        generator=g, device=cuda).to(torch.bfloat16)
        ops.reset_launch_counts()
        vae.decode(vae_p, cfg.vae, z)
        torch.cuda.synchronize()
    assert ops.launch_counts() == vae.kernel_launches_per_decode(cfg.vae)
    assert ops.declined_counts()["conv2d"] == 1



# The UNet forward on one CUDA graph a request (diffusion/unet_graph.py):
# the full, 48k (FiLM y) and speech (512-token mask) UNets, bf16 and int8.
GRAPH_UNETS = [(name, wq) for name in ("audioldm2-full", "audioldm_48k",
                                       "audioldm2-speech-gigaspeech") for wq in (None, "int8")]


@pytest.mark.parametrize("name,weight_quant", GRAPH_UNETS)
def test_graphed_unet_forward_gives_the_eager_bits(cuda, name, weight_quant):
    """conditioned_eps_fn's UNet forward at guidance 1 and CFG batch 2 on
    the graph (an eager call, a capture, then replays), each call with its
    own x and t, bit for bit the eager ``apply_unet``'s; no output is
    overwritten by a later replay, and the launches count each call as one
    forward's."""
    import dataclasses

    import audioldm2_torch as at
    from audioldm2_torch.diffusion import latent_diffusion as ld
    from audioldm2_torch.models import unet
    from audioldm2_torch.params import Init
    from chip_smoke import _ctx_inputs

    cfg = dataclasses.replace(at.default_audioldm_config(name), weight_quant=weight_quant)
    g = torch.Generator(device=cuda).manual_seed(26)
    ctxs, masks, y = _ctx_inputs(cfg, cuda, g, 2)
    if name.startswith("audioldm2-speech"):  # GPT-2's 512 tokens, one row's last 200 masked
        ctxs = [torch.randn((2, 512, 768), generator=g, device=cuda).to(torch.bfloat16)]
        masks = [torch.ones((2, 512), device=cuda)]
        masks[0][0, 312:] = 0.0
    shape = (2, cfg.latent_t_size, cfg.latent_f_size, cfg.latent_channels)
    calls = []
    with torch.inference_mode():
        params = {"unet": unet.init_unet(Init(g, cuda), cfg.unet)}
        model_fn = ld.conditioned_eps_fn(params, cfg, y, ctxs, masks, 1.0)
        unet_p, kv = ld.prepare_unet(params, cfg, ctxs)
        ops.reset_launch_counts()
        for i in range(6):
            x = torch.randn(shape, generator=g, device=cuda)
            t = torch.full((2,), 999 - 150 * i, dtype=torch.int32, device=cuda)
            calls.append((x, t, model_fn(x, t)))
        counts = ops.launch_counts()
        for x, t, got in calls:
            want = unet.apply_unet(unet_p, cfg.unet, x.to(torch.bfloat16), t, ctxs, masks, y=y,
                                   cross_kv=kv).float()
            assert torch.equal(got, want)
    per_forward = unet.kernel_launches_per_forward(cfg.unet, cfg.weight_quant, cfg.compute_dtype)
    assert counts == {k: 6 * v for k, v in per_forward.items()}


@pytest.mark.parametrize("shape", [(2, 64, 16, 320), (3, 256, 32, 128)])
def test_k6_cooperative_launch_is_captured_and_replayed(cuda, shape):
    """K6's cooperative launch captured on a side stream and replayed on
    new inputs gives the eager launch's bits."""
    g = torch.Generator(device=cuda).manual_seed(6)
    gamma = torch.randn(shape[-1], generator=g, device=cuda)
    beta = torch.randn(shape[-1], generator=g, device=cuda)
    static = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode():
        with torch.cuda.stream(stream):
            groupnorm_kernel.group_norm_silu(static, gamma, beta)  # the stream's barrier words
            graph.capture_begin()
            out = groupnorm_kernel.group_norm_silu(static, gamma, beta)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        for _ in range(4):
            x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
            static.copy_(x)
            graph.replay()
            assert torch.equal(out, groupnorm_kernel.group_norm_silu(x, gamma, beta))


def _tiny_model(cuda, compute_dtype):
    import dataclasses

    import audioldm2_torch as at
    from audioldm2_torch import config as config_m
    from tiny import tiny_t5_model_config

    cfg = dataclasses.replace(config_m.coerce(tiny_t5_model_config()), compute_dtype=compute_dtype)
    return at.build_model(config=cfg, device=cuda, seed=0, nonzero_init=True)


GRAPH_KW = dict(duration=0.32, duration_bucket=None, n_candidate_gen_per_text=1)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_plms_at_guidance_1_on_the_graph_gives_the_eager_waveform(cuda, monkeypatch,
                                                                  compute_dtype):
    """PLMS keeps its last three eps and, at guidance 1, the eps is the
    UNet call's own output: a graphed request (one eager call, one capture,
    five replays) gives the eager request's waveform bit for bit."""
    import audioldm2_torch as at
    from audioldm2_torch.diffusion import unet_graph

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = _tiny_model(cuda, compute_dtype)
    kw = dict(seed=3, ddim_steps=5, guidance_scale=1.0, sampler="plms", **GRAPH_KW)
    graphed = at.text_to_audio(model, "a dog barking", **kw)
    t = model.last_timings
    assert (t["unet_graph_captures"], t["unet_graph_replays"], t["sampler_steps"]) == (1, 5, 6)
    monkeypatch.setattr(unet_graph, "engages", lambda device: False)
    eager = at.text_to_audio(model, "a dog barking", **kw)
    assert model.last_timings["unet_graph_replays"] == 0
    assert np.array_equal(graphed, eager)


def test_launch_counts_after_a_graphed_request_are_the_eager_ones(cuda, monkeypatch):
    """The launch counts after a graphed request are
    ``kernel_launches_per_generate``'s and the eager request's."""
    import audioldm2_torch as at
    from audioldm2_torch.diffusion import latent_diffusion as ld
    from audioldm2_torch.diffusion import unet_graph

    model = _tiny_model(cuda, "bfloat16")
    at.text_to_audio(model, "rain", seed=1, ddim_steps=5, **GRAPH_KW)  # warm
    counts = []
    for engaged in (True, False):
        if not engaged:
            monkeypatch.setattr(unet_graph, "engages", lambda device: False)
        ops.reset_launch_counts()
        at.text_to_audio(model, "rain", seed=2, ddim_steps=5, **GRAPH_KW)
        counts.append((ops.launch_counts(), ops.declined_counts()))
        t = model.last_timings
        assert (t["unet_graph_captures"], t["unet_graph_replays"]) == ((1, 4) if engaged
                                                                       else (0, 0))
    assert counts[0] == counts[1]
    assert counts[0][0] == ld.kernel_launches_per_generate(model.cfg, 5)


def test_per_stream_scratch_does_not_grow_across_graphed_requests(cuda):
    """K1's statistics counters and K6's barrier words and partials are
    cached per (device, stream): graphed requests, each on one capture
    stream, add no entry after the first."""
    import audioldm2_torch as at
    from audioldm2_torch.ops import _build

    caches = (_build.gn_counter, _build.gn_barrier, _build.gn_partials)
    model = _tiny_model(cuda, "bfloat16")
    sizes = []
    for seed in range(4):
        at.text_to_audio(model, "rain", seed=seed, ddim_steps=4, **GRAPH_KW)
        assert model.last_timings["unet_graph_replays"] == 3
        sizes.append([c.cache_info().currsize for c in caches])
    assert sizes[0][0] >= 1 and sizes[0][1] >= 1
    assert sizes[1:] == [sizes[0]] * 3
