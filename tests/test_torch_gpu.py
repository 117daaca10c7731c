"""The Hopper kernels (K1-K4, the int8 K1q, K3q, K4q, K5, K6, and the A/B
attention variants K7 and K8) against their plain PyTorch versions on the
card, and the plain bf16 convs' one rounding.

Run on a machine with an NVIDIA GPU (and no JAX, hence no tests/conftest.py):
    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
Without CUDA every test here skips (decided inside the ``cuda`` fixture,
never at import, so every worker collects the same tests).

Bound: max|kernel - plain| / max|plain| <= 2e-2 in bf16 and <= 1e-4 in
f32, with TF32 off so the f32 plain path is a full-precision oracle. K1q,
K3q and K4q round their activation to bf16 even in f32; their f32 inputs
come from chip_smoke.exact_f32_args, which keeps that activation off the
bf16 rounding boundaries."""

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
@pytest.mark.parametrize("M,F,N", [(130, 160, 96), (128, 2560, 640), (50, 20, 12)])
def test_geglu_matmul_kernel(cuda, dt, M, F, N):
    g = torch.Generator(device=cuda).manual_seed(3)
    args = (_rand(g, (M, 2 * F), dt, cuda), _rand(g, (F, N), dt, cuda, scale=F ** -0.5),
            _rand(g, (N,), torch.float32, cuda), _rand(g, (M, N), dt, cuda))
    _check(lnmm_kernel.geglu_matmul(*args), lnmm_kernel.geglu_matmul_plain(*args), dt)


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
