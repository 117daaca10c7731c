"""The launch plan of the bf16 LayerNorm + matmul kernel (K3), on the CPU.

``_build.ln_matmul_plan`` is plain Python: it picks rows per block, N-tile
width, strip length and ring depth from (M, C, N) and the SM count. Held
here for every (M, C, N) that one UNet forward of the t5, audioldm2-full
and large-1150k configs gives K3 at CFG batch 2 and 6, and for the ragged
shapes of the GPU tests: the strips cover every column exactly once, the
block fits the shared memory a Hopper block may use, the K tiles cover C
(the kernel zero-fills past it), and the grid fills the SMs the shape could
fill, or at least ``LNMM_MIN_FILL`` of them in one wave.
"""

import math

import pytest

import audioldm2_torch as at
from audioldm2_torch.models import unet
from audioldm2_torch.ops import _build

SMS = 132  # an H100 SXM
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90
CONFIGS = ("audioldm_16k_crossattn_t5", "audioldm2-full", "audioldm2-full-large-1150k")
RAGGED = [(100, 384, 200), (128, 320, 200), (128, 640, 1920), (70, 40, 72), (300, 648, 136),
          (1, 64, 64), (6144, 256, 768), (1536, 384, 384), (128, 640, 5120)]


def _main_path_shapes():
    shapes = set()
    for name in CONFIGS:
        cfg = at.default_audioldm_config(name)
        for batch in (2, 6):
            shapes |= set(unet.ln_matmul_shapes(cfg.unet, batch, cfg.latent_t_size,
                                                cfg.latent_f_size))
    return sorted(shapes)


SHAPES = sorted(set(_main_path_shapes()) | set(RAGGED))


def test_main_path_shapes_are_the_published_widths():
    """C in {256, 384, 640}, N in {C, 3C, 8C}, M = batch x tokens of the
    10 s latent at downsampling 2, 4 and 8; the calls add up to the launch
    count the smoke run checks."""
    shapes = _main_path_shapes()
    assert {c for _, c, _ in shapes} == {256, 384, 640}
    assert all(n in (c, 3 * c, 8 * c) for _, c, n in shapes)
    assert {m for m, _, _ in shapes} == {128, 512, 2048, 384, 1536, 6144}
    for name, batch, calls in (("audioldm_16k_crossattn_t5", 2, 96), ("audioldm2-full", 2, 144),
                               ("audioldm2-full-large-1150k", 6, 352)):
        cfg = at.default_audioldm_config(name)
        got = unet.ln_matmul_shapes(cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
        assert sum(got.values()) == calls == unet.kernel_launches_per_forward(cfg.unet)["ln_matmul"]


@pytest.mark.parametrize("m,c,n", SHAPES)
def test_ln_matmul_plan(m, c, n):
    plan = _build.ln_matmul_plan(m, c, n, SMS)
    assert plan is not None
    assert (plan.bm, plan.bn) in _build.LNMM_TILES and plan.bk == _build.LNMM_BK
    strips, row_blocks = plan.grid
    n_tiles = math.ceil(n / plan.bn)

    # rows: the row blocks cover M, the last one may be ragged (masked)
    assert row_blocks == math.ceil(m / plan.bm)
    # columns: strip i owns N tiles [i * strip_tiles, (i + 1) * strip_tiles);
    # together they cover each of the N columns exactly once, none is empty
    covered = []
    for i in range(strips):
        lo = i * plan.strip_tiles * plan.bn
        hi = min((i + 1) * plan.strip_tiles, n_tiles) * plan.bn
        assert lo < hi
        covered += range(lo, min(hi, n))
    assert covered == list(range(n))

    # K: whole tiles that cover C; the kernel zero-fills A and W past C
    assert plan.k_tiles * plan.bk >= c > (plan.k_tiles - 1) * plan.bk
    # shared memory: the row block's normalized A plus the W ring
    a_bytes = plan.bm * (plan.k_tiles * plan.bk + _build.LNMM_PAD) * 2
    ring = plan.stages * plan.bk * (plan.bn + _build.LNMM_PAD) * 2
    assert plan.smem_bytes == a_bytes + ring <= SMEM_LIMIT
    assert 2 <= plan.stages <= _build.LNMM_MAX_STAGES

    # the grid fills the SMs the shape could fill, or at least LNMM_MIN_FILL
    # of them in a single wave
    blocks = strips * row_blocks
    fill = min(SMS, row_blocks * n_tiles)
    assert blocks >= fill or (blocks <= SMS and blocks >= _build.LNMM_MIN_FILL * fill)


@pytest.mark.parametrize("m,c,n", [(128, 100, 36), (100, 40, 36), (64, 12, 64), (0, 64, 64)])
def test_ln_matmul_plan_declines_what_the_kernel_does_not_take(m, c, n):
    """C or N no multiple of 8 (16-byte copies cannot address such rows), or
    no rows: the wrapper sends these to the shared GEMM core."""
    assert _build.ln_matmul_plan(m, c, n, SMS) is None


def test_ln_matmul_plan_declines_rows_wider_than_the_kernel_holds():
    """The kernel keeps a row in registers for its LayerNorm: up to
    LNMM_MAX_C columns (the UNets have 256, 384 and 640)."""
    assert _build.LNMM_MAX_C == 768
    assert _build.ln_matmul_plan(256, 768, 512, SMS) is not None
    assert _build.ln_matmul_plan(256, 776, 512, SMS) is None
    assert _build.ln_matmul_plan(256, 2048, 512, SMS) is None


@pytest.mark.parametrize("sms", [16, 78, 108, 132, 144])
def test_ln_matmul_plan_adapts_to_the_sm_count(sms):
    """On a smaller card the strips grow: never fewer blocks than the rule
    asks for, never more waves than tiles need."""
    for m, c, n in [(2048, 256, 2048), (128, 640, 640), (6144, 256, 2048)]:
        plan = _build.ln_matmul_plan(m, c, n, sms)
        strips, row_blocks = plan.grid
        blocks = strips * row_blocks
        fill = min(sms, row_blocks * math.ceil(n / plan.bn))
        assert blocks >= fill or (blocks <= sms and blocks >= _build.LNMM_MIN_FILL * fill)


def test_attention_strides_take_the_fused_qkv_views_in_place():
    """K2 reads q, k, v where they lie when each token's H * D values are
    contiguous, the strides multiples of 8 and the data 16-byte aligned:
    the chunks of a fused [B, T, 3 * H * D] projection qualify, so the UNet's
    self-attention copies nothing before the kernel."""
    import torch

    from audioldm2_torch.ops import attention_kernel as ak
    from audioldm2_torch.ops import nn

    b, t, h, d = 2, 24, 4, 32
    qkv = torch.zeros(b, t, 3 * h * d, dtype=torch.bfloat16)
    views = [nn.split_heads(x, h) for x in torch.chunk(qkv, 3, dim=-1)]
    for v in views:
        assert not v.is_contiguous()
        assert ak._strides(v) == (3 * h * d, t * 3 * h * d)
    assert ak._strides(torch.zeros(b, t, h, d, dtype=torch.bfloat16)) == (h * d, t * h * d)
    # what the kernel cannot address: f32 (its path wants contiguous inputs),
    # heads not contiguous within a token, a misaligned start, an odd stride
    assert ak._strides(views[0].float()) is None
    assert ak._strides(torch.zeros(b, h, t, d, dtype=torch.bfloat16).transpose(1, 2)) is None
    flat = torch.zeros(b * t * h * d + 8, dtype=torch.bfloat16)
    assert ak._strides(flat[4:4 + b * t * h * d].view(b, t, h, d)) is None
    odd = torch.zeros(b, t, h * d + 4, dtype=torch.bfloat16)[..., :h * d].view(b, t, h, d)
    assert ak._strides(odd) is None
    # a size-1 dimension has no stride to speak of
    one = torch.zeros(1, 1, h, d, dtype=torch.bfloat16)
    assert ak._strides(one) == (h * d, h * d)


def test_ln_parameters_go_to_the_kernel_as_they_are_stored():
    """bf16 LN scale, LN bias and linear bias (the cast parameter tree's
    leaves) reach the bf16 K3 kernel unconverted (code 1); anything else is
    converted to f32 once (code 0)."""
    import torch

    from audioldm2_torch.ops import lnmm_kernel as lk

    dev = torch.device("cpu")
    g16, b16, bias16 = (torch.ones(8, dtype=torch.bfloat16) for _ in range(3))
    params, code = lk._ln_params(dev, g16, b16, bias16)
    assert code == 1 and all(p is q for p, q in zip(params, (g16, b16, bias16)))
    params, code = lk._ln_params(dev, g16, b16, None)
    assert code == 1 and params[2] is None
    for mixed in ((g16.float(), b16, bias16), (g16, b16, bias16.float()),
                  (torch.ones(16, dtype=torch.bfloat16)[::2], b16, None)):
        params, code = lk._ln_params(dev, *mixed)
        assert code == 0
        assert all(p is None or (p.dtype == torch.float32 and p.is_contiguous()) for p in params)


@pytest.mark.parametrize("name,batch,calls", [("audioldm_16k_crossattn_t5", 2, 48),
                                              ("audioldm2-full", 2, 64),
                                              ("audioldm2-full-large-1150k", 6, 192)])
def test_self_attention_shapes_add_up_to_the_launch_count(name, batch, calls):
    """K2's (B, T, H, D) per forward: 32-wide heads on the three ladder
    widths; only the large config's None slot projects q, k, v separately."""
    cfg = at.default_audioldm_config(name)
    got = unet.self_attention_shapes(cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
    assert set(got) == {(batch, 1024, 8, 32), (batch, 256, 12, 32), (batch, 64, 20, 32)}
    assert sum(f + s for f, s in got.values()) == calls
    assert calls == unet.kernel_launches_per_forward(cfg.unet)["flash_self_attention"]
    separate = sum(s for _, s in got.values())
    assert separate == (calls // 6 if None in cfg.unet.context_dims else 0)


def test_timing_tool_sums_each_forward_from_its_calls():
    """tools.time_k2_k3: the shapes it times are the two forwards' own, and
    a forward's sum weighs every shape by its calls (fused K2 calls on the
    views, separate ones on contiguous tensors)."""
    from audioldm2_torch.tools import time_k2_k3 as tool

    shapes = tool.main_path_shapes()
    assert len(shapes["k3"]) == 18 and len(shapes["k2"]) == 6
    assert sum(c.get("t5", 0) for _, c in shapes["k3"]) == 96
    assert sum(c.get("large", 0) for _, c in shapes["k3"]) == 352
    assert sum(sum(c.get("large", (0, 0))) for _, c in shapes["k2"]) == 192
    k2 = [{"calls": c, "contiguous": {"held_us": 10.0, "unheld_us": 20.0},
           "views": {"held_us": 30.0, "unheld_us": 40.0}} for _, c in shapes["k2"]]
    k3 = [{"calls": c, "held_us": 5.0, "unheld_us": 50.0} for _, c in shapes["k3"]]
    sums = tool.per_forward(k2, k3)
    assert sums["t5"]["k3_held_ms"] == pytest.approx(96 * 5.0e-3)
    assert sums["large"]["k3_unheld_ms"] == pytest.approx(352 * 50.0e-3)
    assert sums["t5"]["k2_as_called_held_ms"] == pytest.approx(48 * 30.0e-3)
    assert sums["large"]["k2_as_called_held_ms"] == pytest.approx((160 * 30.0 + 32 * 10.0) * 1e-3)
    assert sums["large"]["k2_contiguous_unheld_ms"] == pytest.approx(192 * 20.0e-3)
