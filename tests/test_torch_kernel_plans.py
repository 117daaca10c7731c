"""The launch plan of the bf16 LayerNorm + matmul kernel (K3), on the CPU.

``_build.ln_matmul_plan`` is plain Python: it picks rows per block, N-tile
width, strip length and ring depth from (M, C, N) and the SM count. Held
here for every (M, C, N) that one UNet forward of the t5, audioldm2-full,
large-1150k, 48k and speech configs gives K3 at CFG batch 2 and 6, and for
the ragged
shapes of the GPU tests: the strips cover every column exactly once, the
block fits the shared memory a Hopper block may use, the K tiles cover C
(the kernel zero-fills past it), and the grid fills the SMs the shape could
fill, or at least ``LNMM_MIN_FILL`` of them in one wave.
"""

import math

import pytest
import torch

import audioldm2_torch as at
from audioldm2_torch.models import unet
from audioldm2_torch.ops import _build

SMS = 132  # an H100 SXM
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90
CONFIGS = ("audioldm_16k_crossattn_t5", "audioldm2-full", "audioldm2-full-large-1150k",
           "audioldm_48k", "audioldm2-speech-gigaspeech")
# the batches a VAE decodes on the main paths: a request at batch 1 or 2, of
# one or three candidates
DECODE_BATCHES = (1, 2, 3, 6)
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
    """tools.time_k2_k3: the shapes it times are the forwards' own, and a
    forward's sum weighs every shape by its calls (fused K2 calls on the
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
    # K1 on three forwards (the t5 VAE decode's 22 calls apart), K4 on two,
    # each with its yardstick
    assert len(shapes["k4"]) == 6 and len(shapes["k1"]) == 39
    for tag, calls in (("t5", 44), ("large", 44), ("t5_vae", 22)):
        assert sum(c.get(tag, 0) for _, c in shapes["k1"]) == calls
    assert sum(c.get("large", 0) for _, c in shapes["k4"]) == 128
    part = {"held_us": 4.0, "unheld_us": 8.0}
    k1 = [{"calls": c, "whole": {"held_us": 10.0, "unheld_us": 12.0}, "stats": part,
           "conv": {"held_us": 6.0, "unheld_us": 4.0}, "yardstick_held_us": 2.0}
          for _, c in shapes["k1"]]
    k4 = [{"calls": c, "held_us": 7.0, "unheld_us": 9.0, "yardstick_held_us": 1.0}
          for _, c in shapes["k4"]]
    sums = tool.per_forward(k2, k3, k1, k4)
    assert sums["t5_vae"]["k1_stats_held_ms"] == pytest.approx(22 * 4.0e-3)
    assert sums["t5_vae"]["k1_yardstick_held_ms"] == pytest.approx(22 * 2.0e-3)
    assert "k4_held_ms" not in sums["t5_vae"] and "k3_held_ms" not in sums["t5_vae"]
    assert sums["large"]["k1_conv_unheld_ms"] == pytest.approx(44 * 4.0e-3)
    assert sums["large"]["k4_held_ms"] == pytest.approx(128 * 7.0e-3)
    assert sums["t5"]["k4_yardstick_held_ms"] == pytest.approx(32 * 1.0e-3)
    # K5 and K4q on the full8 forward, each with its bf16 sibling and the
    # shared core's time
    assert [s for s, _ in shapes["k5"]] == [[2048, 256, 256], [512, 384, 384], [128, 640, 640]]
    assert [s for s, _ in shapes["k4q"]] == [[2048, 1024, 256], [512, 1536, 384],
                                             [128, 2560, 640]]
    assert sum(c["full8"] for _, c in shapes["k5"]) == 96
    assert sum(c["full8"] for _, c in shapes["k4q"]) == 48
    k5 = [{"calls": c, "held_us": 3.0, "unheld_us": 6.0, "sibling_held_us": 2.0,
           "shared_core_held_us": 9.0} for _, c in shapes["k5"]]
    k4q = [{"calls": c, "held_us": 5.0, "unheld_us": 7.0, "sibling_held_us": 4.0,
            "shared_core_held_us": 11.0} for _, c in shapes["k4q"]]
    sums = tool.per_forward(k2, k3, k1, k4, (), (), k5, k4q)
    assert sums["full8"]["k5_held_ms"] == pytest.approx(96 * 3.0e-3)
    assert sums["full8"]["k5_unheld_ms"] == pytest.approx(96 * 6.0e-3)
    assert sums["full8"]["k5_bf16_sibling_held_ms"] == pytest.approx(96 * 2.0e-3)
    assert sums["full8"]["k5_shared_core_held_ms"] == pytest.approx(96 * 9.0e-3)
    assert sums["full8"]["k4q_held_ms"] == pytest.approx(48 * 5.0e-3)
    assert sums["full8"]["k4q_bf16_sibling_held_ms"] == pytest.approx(48 * 4.0e-3)
    assert sums["full8"]["k4q_shared_core_held_ms"] == pytest.approx(48 * 11.0e-3)
    assert "k3q_held_ms" not in sums["full8"] and "k5_held_ms" not in sums["t5"]


# ---------------------------------------------------------------------------
# K1 (GroupNorm + SiLU + 3x3 conv) and K4 (GEGLU + matmul): shapes and plans
# ---------------------------------------------------------------------------

FORWARDS = [("audioldm_16k_crossattn_t5", 2), ("audioldm_16k_crossattn_t5", 6),
            ("audioldm2-full-large-1150k", 6), ("audioldm_48k", 2), ("audioldm_48k", 6)]
PLAN_SMS = [132, 108, 78]


@pytest.mark.parametrize("name,batch", FORWARDS)
def test_conv_and_geglu_shapes_add_up_to_the_launch_count(name, batch):
    """K1's (B, T, F, C1, C2, Cout) and K4's (M, F, N) per UNet forward: the
    ResBlocks' convs at the four levels of the 10 s latent (256 x 16, or
    the 48k family's 128 x 32; C2 > 0 on the decoder's concat), the GEGLU
    proj_out of every transformer block."""
    cfg = at.default_audioldm_config(name)
    size = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
    launches = unet.kernel_launches_per_forward(cfg.unet)
    convs = unet.conv_shapes(*size)
    assert sum(convs.values()) == launches["gn_silu_conv3x3"] == 44
    t0, f0 = (128, 32) if name == "audioldm_48k" else (256, 16)
    assert {(t, f) for _, t, f, _, _, _ in convs} == {(t0 >> k, f0 >> k) for k in range(4)}
    assert all(b == batch for b, *_ in convs) and any(c2 for *_, c2, _ in convs)
    geglu = unet.geglu_matmul_shapes(*size)
    assert sum(geglu.values()) == launches["geglu_matmul"]
    assert set(geglu) == {(batch * 1024 // 4 ** k, 4 * c, c)
                          for k, c in enumerate((256, 384, 640))}


def test_vae_decode_conv_shapes_add_up_to_the_launch_count():
    """The t5 VAE decoder at batch 1: 22 K1 calls from 16 x 256 to 64 x 1024."""
    from audioldm2_torch.models import vae

    cfg = at.default_audioldm_config("audioldm_16k_crossattn_t5")
    got = vae.decode_conv_shapes(cfg.vae, 1, cfg.latent_t_size, cfg.latent_f_size)
    assert sum(got.values()) == vae.kernel_launches_per_decode(cfg.vae)["gn_silu_conv3x3"] == 22
    assert got[(1, 1024, 64, 128, 0, 128)] == 5
    assert max(t * f for _, t, f, *_ in got) == 65536


def _conv_main_path_shapes():
    from audioldm2_torch.models import vae

    shapes = set()
    for name in CONFIGS:
        cfg = at.default_audioldm_config(name)
        for batch in (2, 6):
            shapes |= set(unet.conv_shapes(cfg.unet, batch, cfg.latent_t_size,
                                           cfg.latent_f_size))
        for batch in DECODE_BATCHES:
            shapes |= set(vae.decode_conv_shapes(cfg.vae, batch, cfg.latent_t_size,
                                                 cfg.latent_f_size))
    return sorted(shapes)


def test_48k_vae_decode_conv_shapes_add_up_to_the_launch_count():
    """The 48k VAE decoder: 28 K1 calls over four levels, from 128 x 32 at
    1024 channels to 1024 x 256 at 128 (the largest K1 calls of any path:
    262,144 positions a sample), at every batch a request decodes."""
    from audioldm2_torch.models import vae

    cfg = at.default_audioldm_config("audioldm_48k")
    for batch in DECODE_BATCHES:
        got = vae.decode_conv_shapes(cfg.vae, batch, cfg.latent_t_size, cfg.latent_f_size)
        assert sum(got.values()) == vae.kernel_launches_per_decode(cfg.vae)["gn_silu_conv3x3"]
        assert sum(got.values()) == 28 and got[(batch, 1024, 256, 128, 0, 128)] == 5
        assert {(c, co) for *_, c, _, co in got} >= {(1024, 1024), (256, 128)}
        assert set(got) <= set(CONV_SHAPES)


CONV_HALO = [(1, 1, 24, 64, 0, 64), (2, 40, 1, 64, 0, 128), (1, 96, 2, 128, 0, 128),
             (1, 50, 3, 64, 32, 96), (1, 33, 7, 256, 0, 200), (2, 8, 4, 128, 0, 128)]
CONV_SHAPES = sorted(set(_conv_main_path_shapes()) | set(CONV_HALO))


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("b,t,f,c1,c2,cout", CONV_SHAPES)
def test_gn_silu_conv_plan(b, t, f, c1, c2, cout, sms):
    plan = _build.gn_silu_conv_plan(b, t, f, c1 + c2, cout, sms)
    assert plan is not None
    assert (plan.bm, plan.bn) in _build.CONV_TILES and plan.ck == _build.CONV_CK
    # positions: a block's tile is tt rows of T by ft of F, within bm rows of
    # the product; the tiles cover every sample's T x F exactly
    assert 1 <= plan.tt <= t and 1 <= plan.ft <= f and plan.tt * plan.ft <= plan.bm
    strips, m_tiles, splits = plan.grid
    assert m_tiles == b * math.ceil(t / plan.tt) * math.ceil(f / plan.ft)
    # channels: whole chunks cover Cin; the split gives every block a chunk
    assert plan.k_chunks == math.ceil((c1 + c2) / plan.ck)
    cps = math.ceil(plan.k_chunks / splits)
    assert 1 <= splits <= _build.CONV_MAX_SPLITS and (splits - 1) * cps < plan.k_chunks
    # Cout: the strips cover the N tiles once; a split block owns one N tile
    n_tiles = math.ceil(cout / plan.bn)
    assert (strips - 1) * plan.strip_tiles < n_tiles <= strips * plan.strip_tiles
    assert splits == 1 or plan.strip_tiles == 1
    # shared memory: two halo'd patches, a and c, the W ring; the split's f32 tile fits in it
    patch = 2 * (plan.tt + 2) * (plan.ft + 2) * _build.CONV_LD * 2
    main = patch + 4 * plan.ck * 4 + plan.stages * plan.ck * (plan.bn + _build.CONV_PAD) * 2
    assert plan.smem_bytes == max(main, plan.bm * (plan.bn + 4) * 4) <= SMEM_LIMIT
    assert 2 <= plan.stages <= _build.CONV_MAX_STAGES
    # the grid fills the SMs the shape could fill, or LNMM_MIN_FILL of them in one wave
    blocks = strips * m_tiles * splits
    fill = min(sms, m_tiles * n_tiles * min(_build.CONV_MAX_SPLITS, plan.k_chunks))
    assert blocks >= fill or (blocks <= sms and blocks >= _build.LNMM_MIN_FILL * fill)


def _geglu_main_path_shapes():
    shapes = set()
    for name in CONFIGS:
        cfg = at.default_audioldm_config(name)
        for batch in (2, 6):
            shapes |= set(unet.geglu_matmul_shapes(cfg.unet, batch, cfg.latent_t_size,
                                                   cfg.latent_f_size))
    return sorted(shapes)


GEGLU_SHAPES = sorted(set(_geglu_main_path_shapes())
                      | {(130, 200, 96), (100, 1032, 136), (50, 24, 16), (1, 64, 64)})


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("m,f,n", GEGLU_SHAPES)
def test_geglu_matmul_plan(m, f, n, sms):
    plan = _build.geglu_matmul_plan(m, f, n, sms)
    assert plan is not None
    assert (plan.bm, plan.bn) in _build.GEGLU_TILES
    strips, row_blocks = plan.grid
    n_tiles = math.ceil(n / plan.bn)
    assert row_blocks == math.ceil(m / plan.bm)
    assert (strips - 1) * plan.strip_tiles < n_tiles <= strips * plan.strip_tiles
    assert plan.k_tiles * plan.bk >= f > (plan.k_tiles - 1) * plan.bk
    # K split over a cluster: every block has K tiles, a split block one N tile
    kps = math.ceil(plan.k_tiles / plan.splits)
    assert 1 <= plan.splits <= _build.GEGLU_MAX_SPLITS and (plan.splits - 1) * kps < plan.k_tiles
    assert plan.splits == 1 or plan.strip_tiles == 1
    # its share of the gate product [bm, kps * bk] stays in shared memory beside a
    # ring of >= 2 W tiles (the split's f32 tile [bm, bn + 4] fits in the same)
    a_bytes = plan.bm * (kps * plan.bk + _build.LNMM_PAD) * 2
    ring = plan.stages * plan.bk * (plan.bn + _build.LNMM_PAD) * 2
    assert plan.smem_bytes == max(a_bytes + ring, plan.bm * (plan.bn + 4) * 4 * (plan.splits > 1))
    assert plan.smem_bytes <= SMEM_LIMIT and plan.stages >= 2
    blocks = strips * row_blocks * plan.splits
    fill = min(sms, row_blocks * n_tiles * min(_build.GEGLU_MAX_SPLITS, plan.k_tiles))
    assert blocks >= fill or (blocks <= sms and blocks >= _build.LNMM_MIN_FILL * fill)


def test_plans_decline_what_the_kernels_do_not_take():
    """K4 in f32 (K1 in f32 has its own kernel; K1q in f32 does not),
    channels no multiple of 8, and K4 rows wider than a row block of the
    smallest tile holds beside two W tiles; those calls go to the shared
    GEMM core (never to a plain version on the card)."""
    assert _build.gn_silu_conv_plan(2, 32, 2, 640, 640, SMS) is not None
    assert _build.gn_silu_conv_plan(2, 32, 2, 640, 640, SMS, dtype="f32") is not None
    assert _build.gn_silu_conv_plan(2, 32, 2, 640, 640, SMS, dtype="f32", w_bytes=1) is None
    assert _build.gn_silu_conv_plan(1, 5, 3, 100, 64, SMS, dtype="f32") is None
    assert _build.gn_silu_conv_plan(1, 5, 3, 96, 70, SMS) is None
    assert _build.gn_silu_conv_plan(1, 5, 3, 100, 64, SMS) is None
    assert _build.geglu_matmul_plan(128, 2560, 640, SMS) is not None
    assert _build.geglu_matmul_plan(128, 2560, 640, SMS, dtype="f32") is None
    assert _build.geglu_matmul_plan(50, 20, 12, SMS) is None
    assert _build.geglu_matmul_plan(130, 164, 96, SMS) is None
    # a block holds a 1/GEGLU_MAX_SPLITS share of K of the fewest rows beside two
    # of the narrowest W tiles
    bm, bn = min(_build.GEGLU_TILES)
    widest = (SMEM_LIMIT - 2 * _build.LNMM_BK * (bn + _build.LNMM_PAD) * 2) // (bm * 2)
    widest = (widest - _build.LNMM_PAD) // _build.LNMM_BK * _build.LNMM_BK
    widest *= _build.GEGLU_MAX_SPLITS
    assert _build.geglu_matmul_plan(2048, widest, 640, SMS) is not None
    assert _build.geglu_matmul_plan(2048, widest + _build.LNMM_BK, 640, SMS) is None


class _Recorder:
    """A stand-in for the kernel library: records each entry point's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.fixture
def recorded_lib(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "sm_count", lambda index: SMS)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *ts: None)
    monkeypatch.setattr(_build, "gn_counter",
                        lambda index, stream: torch.zeros(8, dtype=torch.int32))
    monkeypatch.setattr(_build, "gn_barrier", lambda index, stream: torch.zeros(
        2 * _build.GN_COUNTER_SLOTS, dtype=torch.int32))
    monkeypatch.setattr(_build, "gn_partials",
                        lambda index, stream: torch.zeros(_build.GN_PARTIAL_FLOATS))
    monkeypatch.setattr(_build, "gn_silu_occupancy", lambda index, code, vec, smem: 1)
    return lib


def test_k1_and_k4_parameters_go_to_the_kernels_as_they_are_stored(recorded_lib):
    """bf16 GroupNorm scale and bias, conv bias and GEGLU bias (the cast
    parameter tree's leaves) reach the statistics pass, the bf16 K1 conv and
    the bf16 K4 kernel unconverted (code 1): no conversion kernel runs
    before them; f32 ones go as f32 (code 0)."""
    from audioldm2_torch.ops import lnmm_kernel as lk
    from audioldm2_torch.ops import resblock_kernel as rk

    bf16 = torch.bfloat16
    x1, x2 = torch.zeros(2, 8, 4, 64, dtype=bf16), torch.zeros(2, 8, 4, 64, dtype=bf16)
    gamma, beta, bias = (torch.ones(n, dtype=bf16) for n in (128, 128, 96))
    a, c = rk.gn_stats(x1, x2, gamma, beta, 32, 1e-5)
    args = recorded_lib.calls["a2k_gn_stats"]
    assert args[8:11] == (gamma.data_ptr(), beta.data_ptr(), 1)
    assert a.dtype == c.dtype == torch.float32 and a.shape == (2, 128)
    rk.gn_stats(x1, x2, gamma.float(), beta.float(), 32, 1e-5)
    assert recorded_lib.calls["a2k_gn_stats"][10] == 0

    w = torch.zeros(3, 3, 128, 96, dtype=bf16)
    out = torch.empty(2, 8, 4, 96, dtype=bf16)
    assert rk._conv_kernel(x1, x2, a, c, w, bias, out)
    args = recorded_lib.calls["a2k_gn_silu_conv3x3_bf16"]
    assert args[5:8] == (bias.data_ptr(), 1, out.data_ptr())

    h, wk = torch.zeros(130, 2 * 160, dtype=bf16), torch.zeros(160, 96, dtype=bf16)
    res = torch.zeros(130, 96, dtype=bf16)
    out = lk._geglu("geglu_matmul", h, wk, None, bias, res)
    args = recorded_lib.calls["a2k_geglu_matmul_bf16"]
    assert args[:6] == (h.data_ptr(), wk.data_ptr(), bias.data_ptr(), 1, res.data_ptr(),
                        out.data_ptr())
    lk._geglu("geglu_matmul", h, wk, None, bias.float(), res)
    assert recorded_lib.calls["a2k_geglu_matmul_bf16"][3] == 0


@pytest.mark.parametrize("s,cin", [(65536, 128), (65536, 256), (16384, 512), (4096, 128),
                                   (64, 1280), (64, 1024), (1, 128), (100, 96), (1000, 2056)])
def test_gn_stats_chunks_cover_every_row_once(s, cin):
    """The statistics pass's row chunks: none empty, together the sample's
    rows, and GN_STATS_ROWS_PER_THREAD rows for each thread of a block
    whose row lanes of eight channels fill it (so 512 chunks for the VAE's
    65,536 rows of 128 channels)."""
    chunks = _build.gn_stats_chunks(s, cin)
    rows = math.ceil(s / chunks)
    assert (chunks - 1) * rows < s <= chunks * rows
    lanes = max(1, _build.GN_STATS_THREADS // math.ceil(cin / 8))
    assert rows <= _build.GN_STATS_ROWS_PER_THREAD * lanes
    assert rows == s or rows >= _build.GN_STATS_ROWS_PER_THREAD * lanes - chunks
    if (s, cin) == (65536, 128):
        assert chunks == 512


# ---------------------------------------------------------------------------
# K3q and K1q (int8 weights) on the K3 and K1 kernels: shapes and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,batch,k3q,k1q,k5,k4q", [
    ("audioldm2-full", 2, 144, 44, 96, 48),
    ("audioldm2-full-large-1150k", 6, 352, 44, 288, 128),
    ("audioldm_16k_crossattn_t5", 2, 96, 44, 64, 32),
    ("audioldm_48k", 2, 80, 44, 80, 32), ("audioldm_48k", 6, 80, 44, 80, 32),
    ("audioldm2-speech-gigaspeech", 2, 96, 44, 64, 32)])
def test_int8_shapes_add_up_to_the_launch_count(name, batch, k3q, k1q, k5, k4q):
    """A quantized forward's K3q, K1q, K5 and K4q shapes (weight_quant=
    "int8"): their calls sum to the int8 launch counts, and every K3q, K1q
    and K4q shape is one of the unquantized forward's K3, K1 or K4 (the
    predicates keep K and N multiples of 128); K5's are the (M, C, C)
    to_out projections (and a None slot's to_q) of the K3 shapes' M and C."""
    cfg = at.default_audioldm_config(name)
    size = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
    launches = unet.kernel_launches_per_forward(cfg.unet, "int8")
    got_k3q = unet.ln_matmul_shapes(*size, weight_quant="int8")
    got_k1q = unet.conv_shapes(*size, weight_quant="int8")
    got_k5 = unet.int8_matmul_shapes(*size)
    got_k4q = unet.geglu_matmul_shapes(*size, weight_quant="int8")
    assert sum(got_k3q.values()) == launches["ln_matmul_q"] == k3q
    assert sum(got_k1q.values()) == launches["gn_silu_conv3x3_q"] == k1q
    assert sum(got_k5.values()) == launches["int8_matmul"] == k5
    assert sum(got_k4q.values()) == launches["geglu_matmul_q"] == k4q
    assert launches["ln_matmul"] == launches["gn_silu_conv3x3"] == launches["geglu_matmul"] == 0
    assert set(got_k3q) <= set(unet.ln_matmul_shapes(*size))
    assert set(got_k1q) <= set(unet.conv_shapes(*size))
    assert set(got_k4q) <= set(unet.geglu_matmul_shapes(*size))
    assert {(m, c, c) for m, c, _ in unet.ln_matmul_shapes(*size)} == set(got_k5)


def _full8_shapes():
    cfg = at.default_audioldm_config("audioldm2-full")
    size = (cfg.unet, 2, cfg.latent_t_size, cfg.latent_f_size)
    return (sorted(unet.ln_matmul_shapes(*size, weight_quant="int8")),
            sorted(unet.conv_shapes(*size, weight_quant="int8")),
            unet.int8_matmul_shapes(*size), unet.geglu_matmul_shapes(*size, weight_quant="int8"))


FULL8_K3Q, FULL8_K1Q, FULL8_K5_CALLS, FULL8_K4Q_CALLS = _full8_shapes()
FULL8_K5, FULL8_K4Q = sorted(FULL8_K5_CALLS), sorted(FULL8_K4Q_CALLS)


def _k48_int8_shapes():
    """The 48k UNet's K3q, K1q, K5 and K4q shapes at CFG batch 2 and 6 that
    the full8 forward does not give."""
    cfg = at.default_audioldm_config("audioldm_48k")
    out = [set(), set(), set(), set()]
    for batch in (2, 6):
        size = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
        for got, shapes in zip(out, (unet.ln_matmul_shapes(*size, weight_quant="int8"),
                                     unet.conv_shapes(*size, weight_quant="int8"),
                                     unet.int8_matmul_shapes(*size),
                                     unet.geglu_matmul_shapes(*size, weight_quant="int8"))):
            got |= set(shapes)
    return [sorted(got - set(full)) for got, full in
            zip(out, (FULL8_K3Q, FULL8_K1Q, FULL8_K5, FULL8_K4Q))]


K48_K3Q, K48_K1Q, K48_K5, K48_K4Q = _k48_int8_shapes()


def test_full8_shapes_are_nine_and_seventeen():
    """K3q's 9 and K1q's 17 shapes; K5's 3 and K4q's 3, with their calls."""
    assert len(FULL8_K3Q) == 9 and len(FULL8_K1Q) == 17
    assert {(m, c) for m, c, _ in FULL8_K3Q} == {(2048, 256), (512, 384), (128, 640)}
    assert FULL8_K5_CALLS == {(2048, 256, 256): 30, (512, 384, 384): 30, (128, 640, 640): 36}
    assert FULL8_K4Q_CALLS == {(2048, 1024, 256): 15, (512, 1536, 384): 15,
                               (128, 2560, 640): 18}


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("m,c,n", FULL8_K3Q + K48_K3Q)
def test_ln_matmul_q_plan(m, c, n, sms):
    """K3q's plan on K3's kernel: its tiles cover M, N and K (no split), its
    A beside two bf16 staging tiles and an int8 ring within the shared
    memory a block may use; the int8 ring holds at least as many of the
    strip's tiles as the bf16 plan's ring at the same shape, and at the bf16
    plan's geometry the int8 ring of the bf16 plan's depth fits."""
    plan = _build.ln_matmul_plan(m, c, n, sms, w_bytes=1)
    bf16 = _build.ln_matmul_plan(m, c, n, sms)
    assert plan is not None and (plan.bm, plan.bn) in _build.LNMM_TILES
    strips, row_blocks = plan.grid
    n_tiles = math.ceil(n / plan.bn)
    assert row_blocks == math.ceil(m / plan.bm)
    assert (strips - 1) * plan.strip_tiles < n_tiles <= strips * plan.strip_tiles
    assert plan.k_tiles * plan.bk >= c > (plan.k_tiles - 1) * plan.bk
    assert plan.splits == 1
    a_bytes = plan.bm * (plan.k_tiles * plan.bk + _build.LNMM_PAD) * 2
    staging = 2 * plan.bk * (plan.bn + _build.LNMM_PAD) * 2
    ring = plan.stages * plan.bk * (plan.bn + _build.LNMM_Q_PAD)
    assert plan.smem_bytes == a_bytes + staging + ring <= SMEM_LIMIT == _build.LNMM_MAX_SMEM
    assert 2 <= plan.stages <= _build.LNMM_MAX_STAGES
    assert plan.stages >= min(bf16.stages, plan.strip_tiles * plan.k_tiles)
    assert _build.row_block_smem(bf16.bm, bf16.bn, bf16.k_tiles * bf16.bk, bf16.stages,
                                 w_bytes=1) <= _build.LNMM_MAX_SMEM
    blocks = strips * row_blocks
    fill = min(sms, row_blocks * n_tiles)
    assert blocks >= fill or (blocks <= sms and blocks >= _build.LNMM_MIN_FILL * fill)


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("b,t,f,c1,c2,cout", FULL8_K1Q + K48_K1Q)
def test_gn_silu_conv_q_plan(b, t, f, c1, c2, cout, sms):
    """K1q's plan on K1's kernel: the same coverage as K1's, two patch
    buffers beside two bf16 staging tiles and an int8 ring within the shared
    memory a block may use; at the bf16 plan's geometry the int8 ring of
    the bf16 plan's depth fits. (Where the int8 plan picks a shallower ring,
    its model, fitted to tools/tune_k1_k4.py --only k1q, found it faster.)"""
    plan = _build.gn_silu_conv_plan(b, t, f, c1 + c2, cout, sms, w_bytes=1)
    bf16 = _build.gn_silu_conv_plan(b, t, f, c1 + c2, cout, sms)
    assert plan is not None and (plan.bm, plan.bn) in _build.CONV_TILES
    assert 1 <= plan.tt <= t and 1 <= plan.ft <= f and plan.tt * plan.ft <= plan.bm
    strips, m_tiles, splits = plan.grid
    assert m_tiles == b * math.ceil(t / plan.tt) * math.ceil(f / plan.ft)
    assert plan.k_chunks == math.ceil((c1 + c2) / plan.ck)
    cps = math.ceil(plan.k_chunks / splits)
    assert 1 <= splits <= _build.CONV_MAX_SPLITS and (splits - 1) * cps < plan.k_chunks
    n_tiles = math.ceil(cout / plan.bn)
    assert (strips - 1) * plan.strip_tiles < n_tiles <= strips * plan.strip_tiles
    patch = 2 * (plan.tt + 2) * (plan.ft + 2) * _build.CONV_LD * 2 + 4 * plan.ck * 4
    ring = (2 * plan.ck * (plan.bn + _build.CONV_PAD) * 2
            + plan.stages * plan.ck * (plan.bn + _build.LNMM_Q_PAD))
    assert plan.smem_bytes == max(patch + ring, plan.bm * (plan.bn + 4) * 4) <= SMEM_LIMIT
    assert 2 <= plan.stages <= _build.CONV_MAX_STAGES
    assert _build.conv_smem_bytes(bf16.bm, bf16.bn, bf16.tt, bf16.ft, bf16.stages,
                                  w_bytes=1) <= SMEM_LIMIT
    blocks = strips * m_tiles * splits
    fill = min(sms, m_tiles * n_tiles * min(_build.CONV_MAX_SPLITS, plan.k_chunks))
    assert blocks >= fill or (blocks <= sms and blocks >= _build.LNMM_MIN_FILL * fill)


def test_int8_plans_decline_what_the_int8_rings_do_not_take():
    """An int8 row is copied 16 bytes at a time: N (K3q) or Cout (K1q) no
    multiple of 16 goes to the shared core; the bf16 plans still take them."""
    assert _build.ln_matmul_plan(128, 640, 648, SMS, w_bytes=1) is None
    assert _build.ln_matmul_plan(128, 640, 648, SMS) is not None
    assert _build.ln_matmul_plan(128, 776, 640, SMS, w_bytes=1) is None
    assert _build.gn_silu_conv_plan(2, 32, 2, 640, 648, SMS, w_bytes=1) is None
    assert _build.gn_silu_conv_plan(2, 32, 2, 640, 648, SMS) is not None
    assert _build.gn_silu_conv_plan(2, 32, 2, 640, 656, SMS, w_bytes=1) is not None


@pytest.fixture
def as_if_on_the_card(recorded_lib, monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: every tensor reports
    is_cuda, so the public wrappers route as they do on the card, into the
    recording stand-in."""
    from audioldm2_torch import ops

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for fn in ops.kernel_wrappers().values():  # the stand-in's calls count no launch
        monkeypatch.setattr(fn, "launches", fn.launches)
    return recorded_lib


def test_k3q_reaches_its_bf16_kernel_with_its_weights_as_stored(as_if_on_the_card):
    """A bf16 ln_matmul_q call reaches a2k_ln_matmul_q_bf16 with the plan's
    launch arguments, the int8 weight and the f32 scale as stored (the same
    storage: nothing converted before the launch) and bf16 LN parameters
    and bias read as stored; f32 inputs reach the shared core."""
    from audioldm2_torch.ops import lnmm_kernel as lk

    lib = as_if_on_the_card
    bf16 = torch.bfloat16
    m, c, n = 128, 640, 640
    x = torch.zeros(2, m // 2, c, dtype=bf16)
    gamma, beta, bias = (torch.ones(k, dtype=bf16) for k in (c, c, n))
    wq, ws = torch.zeros(c, n, dtype=torch.int8), torch.ones(n)
    out = lk.ln_matmul_q(x, gamma, beta, wq, ws, bias)
    args = lib.calls.pop("a2k_ln_matmul_q_bf16")
    plan = _build.ln_matmul_plan(m, c, n, SMS, w_bytes=1)
    assert args[:8] == (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wq.data_ptr(),
                        ws.data_ptr(), bias.data_ptr(), 1, out.data_ptr())
    assert args[8:11] == (m, c, n)
    assert args[12:16] == (plan.bm, plan.bn, plan.strip_tiles, plan.stages)
    assert out.shape == (2, m // 2, n) and out.dtype == bf16
    assert not lib.calls  # no other launch: no conversion, no statistics, no shared core
    lk.ln_matmul_q(x.float(), gamma, beta, wq, ws, bias)
    assert set(lib.calls) == {"a2k_ln_matmul_q"}
    assert lib.calls["a2k_ln_matmul_q"][3:5] == (wq.data_ptr(), ws.data_ptr())


def test_k1q_reaches_its_bf16_kernel_with_its_weights_as_stored(as_if_on_the_card):
    """A bf16 gn_silu_conv3x3_q call runs the statistics pass and then
    a2k_gn_silu_conv3x3_q_bf16 with the plan's launch arguments, the int8
    taps and the f32 scale as stored and the bf16 conv bias read as stored;
    f32 inputs reach the shared core."""
    from audioldm2_torch.ops import resblock_kernel as rk

    lib = as_if_on_the_card
    bf16 = torch.bfloat16
    b, t, f, c1, c2, cout = 2, 32, 2, 640, 384, 640
    x1, x2 = torch.zeros(b, t, f, c1, dtype=bf16), torch.zeros(b, t, f, c2, dtype=bf16)
    gamma, beta, bias = (torch.ones(k, dtype=bf16) for k in (c1 + c2, c1 + c2, cout))
    wq, ws = torch.zeros(3, 3, c1 + c2, cout, dtype=torch.int8), torch.ones(cout)
    out = rk.gn_silu_conv3x3_q(x1, x2, gamma, beta, wq, ws, bias)
    assert set(lib.calls) == {"a2k_gn_stats", "a2k_gn_silu_conv3x3_q_bf16"}
    args = lib.calls.pop("a2k_gn_silu_conv3x3_q_bf16")
    plan = _build.gn_silu_conv_plan(b, t, f, c1 + c2, cout, SMS, w_bytes=1)
    assert args[4:9] == (wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), 1, out.data_ptr())
    assert args[9:15] == (b, t, f, c1, c2, cout)
    assert args[15:22] == (plan.bm, plan.bn, plan.tt, plan.ft, plan.strip_tiles, plan.stages,
                           plan.splits)
    assert lib.calls.pop("a2k_gn_stats")[10] == 1
    rk.gn_silu_conv3x3_q(x1.float(), x2.float(), gamma, beta, wq, ws, bias)
    assert set(lib.calls) == {"a2k_gn_stats", "a2k_gn_silu_conv3x3_q"}
    assert lib.calls["a2k_gn_silu_conv3x3_q"][4:6] == (wq.data_ptr(), ws.data_ptr())


# ---------------------------------------------------------------------------
# K5 and K4q (int8 weights) on the row-block kernel with K4's tiles
# ---------------------------------------------------------------------------


def _check_thin_q_plan(plan, m, k, n, sms, tiles):
    """Coverage, shared memory and fill of a K4q or K5 plan: the row blocks
    cover M, the strips N once, the (split) K tiles K; A's share beside two
    bf16 staging tiles and an int8 ring of at least two tiles (the split's
    f32 tile in the same memory) within what a block may use; the grid
    fills the SMs the shape could fill (counting splits), or LNMM_MIN_FILL
    of them in one wave."""
    assert plan is not None and (plan.bm, plan.bn) in tiles
    strips, row_blocks = plan.grid
    n_tiles = math.ceil(n / plan.bn)
    assert row_blocks == math.ceil(m / plan.bm)
    assert (strips - 1) * plan.strip_tiles < n_tiles <= strips * plan.strip_tiles
    assert plan.k_tiles * plan.bk >= k > (plan.k_tiles - 1) * plan.bk
    kps = math.ceil(plan.k_tiles / plan.splits)
    assert 1 <= plan.splits <= _build.GEGLU_MAX_SPLITS and (plan.splits - 1) * kps < plan.k_tiles
    assert plan.splits == 1 or plan.strip_tiles == 1
    a_bytes = plan.bm * (kps * plan.bk + _build.LNMM_PAD) * 2
    staging = 2 * plan.bk * (plan.bn + _build.LNMM_PAD) * 2
    ring = plan.stages * plan.bk * (plan.bn + _build.LNMM_Q_PAD)
    assert plan.smem_bytes == max(a_bytes + staging + ring,
                                  plan.bm * (plan.bn + 4) * 4 * (plan.splits > 1))
    assert plan.smem_bytes == _build.row_block_smem(plan.bm, plan.bn, kps * plan.bk, plan.stages,
                                                    1, plan.splits) <= SMEM_LIMIT
    assert 2 <= plan.stages <= _build.LNMM_MAX_STAGES
    blocks = strips * row_blocks * plan.splits
    fill = min(sms, row_blocks * n_tiles * min(_build.GEGLU_MAX_SPLITS, plan.k_tiles))
    assert blocks >= fill or (blocks <= sms and blocks >= _build.LNMM_MIN_FILL * fill)


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("m,k,n", FULL8_K5 + K48_K5 + [(50, 200, 96), (1, 384, 384)])
def test_int8_matmul_plan(m, k, n, sms):
    _check_thin_q_plan(_build.int8_matmul_plan(m, k, n, sms), m, k, n, sms, _build.GEGLU_TILES)


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("m,f,n", FULL8_K4Q + K48_K4Q + [(77, 2560, 640), (130, 200, 96)])
def test_geglu_matmul_q_plan(m, f, n, sms):
    _check_thin_q_plan(_build.geglu_matmul_plan(m, f, n, sms, w_bytes=1), m, f, n, sms,
                       _build.GEGLU_TILES)


def test_k5_and_k4q_plans_decline_what_the_kernel_does_not_take():
    """f32; N no multiple of 16 (an int8 row is copied 16 bytes at a time;
    the bf16 K4 plan still takes 8); K no multiple of 8; and a row block
    wider than shared memory holds beside two bf16 staging tiles and two
    int8 tiles, even split over the widest cluster. The wrappers send these
    to the shared GEMM core."""
    assert _build.int8_matmul_plan(128, 640, 640, SMS) is not None
    assert _build.int8_matmul_plan(128, 640, 640, SMS, dtype="f32") is None
    assert _build.geglu_matmul_plan(128, 2560, 640, SMS, dtype="f32", w_bytes=1) is None
    assert _build.int8_matmul_plan(128, 640, 648, SMS) is None
    assert _build.geglu_matmul_plan(128, 2560, 648, SMS, w_bytes=1) is None
    assert _build.geglu_matmul_plan(128, 2560, 648, SMS) is not None
    assert _build.int8_matmul_plan(128, 644, 640, SMS) is None
    assert _build.geglu_matmul_plan(128, 2564, 640, SMS, w_bytes=1) is None
    bm, bn = min(_build.GEGLU_TILES)
    fixed = 2 * _build.LNMM_BK * (bn + _build.LNMM_PAD) * 2 + 2 * _build.LNMM_BK * (bn + 16)
    widest = (SMEM_LIMIT - fixed) // (bm * 2)
    widest = (widest - _build.LNMM_PAD) // _build.LNMM_BK * _build.LNMM_BK
    widest *= _build.GEGLU_MAX_SPLITS
    for plan in (_build.int8_matmul_plan, lambda m, k, n, sms: _build.geglu_matmul_plan(
            m, k, n, sms, w_bytes=1)):
        assert plan(2048, widest, 640, SMS) is not None
        assert plan(2048, widest + _build.LNMM_BK, 640, SMS) is None


def test_k4q_reaches_its_bf16_kernel_with_its_weights_as_stored(as_if_on_the_card):
    """A bf16 geglu_matmul_q call reaches a2k_geglu_matmul_q_bf16 with the
    plan's launch arguments, the int8 weight and the f32 scale as stored and
    the bf16 bias and residual read as stored, and launches nothing else
    (no conversion, no workspace reduce); f32 inputs reach the shared core."""
    from audioldm2_torch.ops import lnmm_kernel as lk

    lib = as_if_on_the_card
    bf16 = torch.bfloat16
    m, f, n = 128, 2560, 640
    h, res = torch.zeros(2, m // 2, 2 * f, dtype=bf16), torch.zeros(2, m // 2, n, dtype=bf16)
    bias = torch.ones(n, dtype=bf16)
    wq, ws = torch.zeros(f, n, dtype=torch.int8), torch.ones(n)
    out = lk.geglu_matmul_q(h, wq, ws, bias, res)
    args = lib.calls.pop("a2k_geglu_matmul_q_bf16")
    plan = _build.geglu_matmul_plan(m, f, n, SMS, w_bytes=1)
    assert args[:7] == (h.data_ptr(), wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), 1,
                        res.data_ptr(), out.data_ptr())
    assert args[7:10] == (m, f, n)
    assert args[10:15] == (plan.bm, plan.bn, plan.strip_tiles, plan.stages, plan.splits)
    assert out.shape == res.shape and out.dtype == bf16
    assert not lib.calls
    lk.geglu_matmul_q(h.float(), wq, ws, bias, res.float())
    assert set(lib.calls) == {"a2k_geglu_matmul_q"}
    assert lib.calls["a2k_geglu_matmul_q"][1:3] == (wq.data_ptr(), ws.data_ptr())


@pytest.mark.parametrize("with_bias", [True, False])
def test_k5_reaches_its_bf16_kernel_with_its_weights_as_stored(as_if_on_the_card, with_bias):
    """A bf16 int8_matmul call reaches a2k_int8_matmul_bf16 with the plan's
    launch arguments, the int8 weight and the f32 scale as stored and a bf16
    bias read as stored (or null), and launches nothing else; f32 inputs
    reach the shared core."""
    from audioldm2_torch.ops import lnmm_kernel as lk

    lib = as_if_on_the_card
    bf16 = torch.bfloat16
    m, k, n = 128, 640, 640
    x = torch.zeros(2, m // 2, k, dtype=bf16)
    bias = torch.ones(n, dtype=bf16) if with_bias else None
    wq, ws = torch.zeros(k, n, dtype=torch.int8), torch.ones(n)
    out = lk.int8_matmul(x, wq, ws, bias)
    args = lib.calls.pop("a2k_int8_matmul_bf16")
    plan = _build.int8_matmul_plan(m, k, n, SMS)
    assert args[:6] == (x.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                        bias.data_ptr() if with_bias else None, 1, out.data_ptr())
    assert args[6:9] == (m, k, n)
    assert args[9:14] == (plan.bm, plan.bn, plan.strip_tiles, plan.stages, plan.splits)
    assert out.shape == (2, m // 2, n) and out.dtype == bf16
    assert not lib.calls
    lk.int8_matmul(x.float(), wq, ws, bias)
    assert set(lib.calls) == {"a2k_int8_matmul"}
    assert lib.calls["a2k_int8_matmul"][1:3] == (wq.data_ptr(), ws.data_ptr())


# ---------------------------------------------------------------------------
# K1 in f32 (3xTF32 on the tensor cores) and K6 in one launch
# ---------------------------------------------------------------------------


def _encode_shapes(name="audioldm2-full", batch=1):
    from audioldm2_torch.models import vae

    cfg = at.default_audioldm_config(name)
    t = int(10.0 * cfg.latent_t_per_second * cfg.vae.downsample_factor)
    return vae.encode_conv_shapes(cfg.vae, batch, t, cfg.preprocessing.n_mel_channels)


ENCODE_K1 = _encode_shapes()
ENCODE_48K_K1 = sorted({s for b in DECODE_BATCHES for s in _encode_shapes("audioldm_48k", b)})


def test_48k_encode_shapes_are_the_twenty_of_a_full_width_encode():
    """One 10 s VAE encode at 48 kHz gives K1 20 calls at seven shapes, from
    1024 x 256 at 128 channels (a tile narrower than F: see the f32 plan)
    to 128 x 32 at 1024."""
    from audioldm2_torch.models import vae

    cfg = at.default_audioldm_config("audioldm_48k")
    got = _encode_shapes("audioldm_48k")
    assert got == {(1, 1024, 256, 128, 0, 128): 4, (1, 512, 128, 128, 0, 256): 1,
                   (1, 512, 128, 256, 0, 256): 3, (1, 256, 64, 256, 0, 512): 1,
                   (1, 256, 64, 512, 0, 512): 3, (1, 128, 32, 512, 0, 1024): 1,
                   (1, 128, 32, 1024, 0, 1024): 7}
    assert sum(got.values()) == vae.kernel_launches_per_encode(cfg.vae)["gn_silu_conv3x3"]


def test_encode_shapes_are_the_sixteen_of_a_full_width_encode():
    """One 10 s VAE encode gives K1 16 calls at five shapes (the launch
    count the smoke run checks): 1024 x 64 at 128 channels, then 512 x 32
    and 256 x 16 at 256 and 512."""
    from audioldm2_torch.models import vae

    cfg = at.default_audioldm_config("audioldm2-full")
    assert ENCODE_K1 == {(1, 1024, 64, 128, 0, 128): 4, (1, 512, 32, 128, 0, 256): 1,
                         (1, 512, 32, 256, 0, 256): 3, (1, 256, 16, 256, 0, 512): 1,
                         (1, 256, 16, 512, 0, 512): 7}
    assert sum(ENCODE_K1.values()) == vae.kernel_launches_per_encode(cfg.vae)["gn_silu_conv3x3"]


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("b,t,f,c1,c2,cout", sorted(ENCODE_K1) + ENCODE_48K_K1 + CONV_HALO
                         + [(2, 32, 2, 640, 640, 640), (1, 256, 16, 256, 256, 512)])
def test_gn_silu_conv_f32_plan(b, t, f, c1, c2, cout, sms):
    """The f32 plan: its one tile, whole 32-channel chunks cover Cin, the
    tiles cover T x F (narrower than F where a full-width patch would not
    fit: F = 128 and 256) and the strips Cout once, the split gives every block a chunk, the
    block (raw patch, two activated planes, a ring of raw W tiles, two
    staging tiles of two planes) fits the shared memory a block may use,
    and the grid fills the SMs the shape could fill, or LNMM_MIN_FILL of
    them in one wave."""
    plan = _build.gn_silu_conv_plan(b, t, f, c1 + c2, cout, sms, dtype="f32")
    assert plan is not None and (plan.bm, plan.bn) == _build.CONV32_TILE == (256, 64)
    assert plan.ck == _build.CONV32_CK == 32
    assert 1 <= plan.tt <= t and 1 <= plan.ft <= f and plan.tt * plan.ft <= plan.bm
    strips, m_tiles, splits = plan.grid
    assert m_tiles == b * math.ceil(t / plan.tt) * math.ceil(f / plan.ft)
    assert plan.k_chunks == math.ceil((c1 + c2) / 32)
    cps = math.ceil(plan.k_chunks / splits)
    assert 1 <= splits <= _build.CONV_MAX_SPLITS and (splits - 1) * cps < plan.k_chunks
    n_tiles = math.ceil(cout / plan.bn)
    assert (strips - 1) * plan.strip_tiles < n_tiles <= strips * plan.strip_tiles
    assert splits == 1 or plan.strip_tiles == 1
    p = (plan.tt + 2) * (plan.ft + 2)
    main = (p * 32 * 4 + 2 * p * 36 * 4 + 2 * 32 * 4 + plan.stages * 32 * (plan.bn + 4) * 4
            + 2 * 2 * plan.bn * 36 * 4)
    assert plan.smem_bytes == max(main, plan.bm * (plan.bn + 4) * 4) <= SMEM_LIMIT
    assert 2 <= plan.stages <= _build.CONV_MAX_STAGES
    blocks = strips * m_tiles * splits
    fill = min(sms, m_tiles * n_tiles * min(_build.CONV_MAX_SPLITS, plan.k_chunks))
    assert blocks >= fill or (blocks <= sms and blocks >= _build.LNMM_MIN_FILL * fill)


# The bf16 K1 and K1q plans' picks before the f32 plan existed (ConvPlan fields)
_BF16_K1_PICKS = {
    (1, 1024, 64, 128, 128): (128, 128, 2, 64, 64, 2, 1, 8, 1, (1, 512, 1), 216320),
    (2, 32, 2, 1280, 640): (64, 64, 32, 2, 64, 20, 1, 8, 7, (10, 2, 7), 113920),
    (2, 32, 2, 1280, 640, "q"): (64, 128, 32, 2, 64, 20, 1, 6, 7, (5, 2, 7), 130304),
}


def test_f32_plans_leave_the_bf16_picks_as_they_were():
    """The f32 plan has constants of its own: the bf16 and K1q plans at
    every main-path shape are what they were before it existed (K1 at the
    t5 VAE's largest shape and the deep level, K1q at the full8 deep level)."""
    assert _build.gn_silu_conv_plan(1, 1024, 64, 128, 128, SMS) == _build.ConvPlan(
        *_BF16_K1_PICKS[(1, 1024, 64, 128, 128)])
    assert _build.gn_silu_conv_plan(2, 32, 2, 1280, 640, SMS) == _build.ConvPlan(
        *_BF16_K1_PICKS[(2, 32, 2, 1280, 640)])
    assert _build.gn_silu_conv_plan(2, 32, 2, 1280, 640, SMS, w_bytes=1) == _build.ConvPlan(
        *_BF16_K1_PICKS[(2, 32, 2, 1280, 640, "q")])


K6_MAIN = [(2, 4096, 128, "bf16"), (6, 4096, 128, "bf16"), (1, 65536, 128, "bf16"),
           (1, 4096, 512, "f32")]
K6_EDGES = [(1, 65536, 128, "f32"), (1, 131072, 128, "f32"), (3, 1000, 256, "bf16"),
            (4, 35, 36, "f32"), (5, 7, 64, "bf16"), (1, 1, 512, "f32"), (6, 40, 64, "f32"),
            (2, 65536, 128, "bf16"), (3, 65536, 128, "bf16"), (133, 64, 128, "bf16"),
            (300, 4096, 128, "bf16"), (1000, 3, 36, "f32")]


def _k6_groups(c):
    return 32 if c % 32 == 0 else 4


# the 48k path: the VAE decoder's norm_out at every batch a request decodes
# (67 to 403 MB), its +10 offset check in f32 (134 MB) and the f32 encoder's
# norm_out
K6_48K = [(b, 262144, 128, "bf16") for b in DECODE_BATCHES] + [(1, 262144, 128, "f32"),
                                                                (1, 4096, 1024, "f32")]


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("b,s,c,dtype", K6_MAIN + K6_EDGES + K6_48K)
def test_group_norm_silu_plan(b, s, c, dtype, sms):
    """K6's plan: each sample's blocks take its rows in consecutive runs
    that cover every row once, none empty, and the slots take every sample
    once; the grid (slots x blocks per sample) is never more than one block
    per SM, the co-residency the cooperative launch needs, nor more blocks
    than GN_BLOCK_BYTES of x each; a batch above the SM count gets one
    block a sample, sms samples at a time; the slab stays in shared memory
    exactly when its bytes fit, else the rows held are the most that fit."""
    groups, vec = _k6_groups(c), c % 8 == 0
    esize = 2 if dtype == "bf16" else 4
    plan = _build.group_norm_silu_plan(b, s, c, dtype, sms, groups, vec)
    assert plan is not None
    nb, rows = plan.blocks_per_sample, plan.rows
    assert plan.grid == plan.slots * nb <= sms and plan.slots == min(b, sms // nb)
    covered = []
    for k in range(nb):
        run = range(k * rows, min(s, (k + 1) * rows))
        assert len(run) >= 1
        covered += run
    assert covered == list(range(s))
    taken = sorted(q for slot in range(plan.slots) for q in range(slot, b, plan.slots))
    assert taken == list(range(b))
    # as many blocks as the SMs give each sample, unless a block would hold
    # less than GN_BLOCK_BYTES of x
    want = max(1, min(sms // b, math.ceil(s * c * esize / _build.GN_BLOCK_BYTES)))
    assert nb == math.ceil(s / math.ceil(s / want))
    whole = _build.gn_silu_smem_bytes(rows, c, groups, esize, vec)
    assert plan.resident == (whole <= _build.GN_MAX_SMEM)
    if plan.resident:
        assert plan.rows_held == rows and plan.smem_bytes == whole
    else:
        assert 1 <= plan.rows_held < rows
        assert plan.smem_bytes == _build.gn_silu_smem_bytes(plan.rows_held, c, groups, esize,
                                                            vec) <= _build.GN_MAX_SMEM
        assert _build.gn_silu_smem_bytes(plan.rows_held + 1, c, groups, esize,
                                         vec) > _build.GN_MAX_SMEM


def test_group_norm_silu_plan_switches_modes_where_the_bytes_say():
    """On 132 SMs the batch-1 main-path tensors (2 to 16.8 MB) are resident;
    the mode turns to re-read where a block's rows no longer fit in 227 KB
    of shared memory beside its fixed share (about 29 MB of x in all), as
    for the VAE decoder's norm_out at batch 2 and 3 (33.5 and 50 MB), whose
    blocks then hold the most rows that fit; a batch above the SM count
    takes one block a sample, 132 samples at a time."""
    for b, s, c, dtype in K6_MAIN:
        assert _build.group_norm_silu_plan(b, s, c, dtype, SMS).resident
    fixed = _build.gn_silu_smem_bytes(0, 128, 32, 4, True)
    fits = (_build.GN_MAX_SMEM - fixed) // (128 * 4)  # rows of 128 f32 a block holds
    assert _build.group_norm_silu_plan(1, fits * SMS, 128, "f32", SMS).resident
    assert not _build.group_norm_silu_plan(1, fits * SMS + SMS, 128, "f32", SMS).resident
    assert 28e6 < fits * SMS * 128 * 4 < 30e6
    for b in (2, 3):
        plan = _build.group_norm_silu_plan(b, 65536, 128, "bf16", SMS)
        held = (_build.GN_MAX_SMEM - _build.gn_silu_smem_bytes(0, 128, 32, 2, True)) // 256
        assert not plan.resident and plan.rows_held == held
        assert plan.grid == b * (SMS // b)
    plan = _build.group_norm_silu_plan(133, 64, 128, "bf16", SMS)
    assert (plan.blocks_per_sample, plan.slots, plan.grid) == (1, SMS, SMS) and plan.resident


def test_group_norm_silu_plan_takes_the_48k_norm_out_in_re_read_mode():
    """The 48k VAE decoder's norm_out, [B, 1024 x 256, 128] bf16, 67 MB a
    sample, is above what the grid's shared memory holds at every batch: at
    batch 1 each of the 132 blocks takes 1986 rows and holds its last 836;
    at 2, 3 and 6 the blocks split among the samples and hold as many. The
    f32 encoder's norm_out (16.8 MB) is resident."""
    held = (_build.GN_MAX_SMEM - _build.gn_silu_smem_bytes(0, 128, 32, 2, True)) // 256
    assert held == 836
    for b in DECODE_BATCHES:
        plan = _build.group_norm_silu_plan(b, 262144, 128, "bf16", SMS)
        assert not plan.resident and plan.rows_held == held
        assert plan.grid == b * (SMS // b) and plan.rows == math.ceil(262144 / (SMS // b))
    assert _build.group_norm_silu_plan(1, 262144, 128, "bf16", SMS).rows == 1986
    assert _build.group_norm_silu_plan(1, 4096, 1024, "f32", SMS).resident


def test_f32_k1_reaches_its_kernel_with_its_parameters_as_stored(as_if_on_the_card):
    """An f32 gn_silu_conv3x3 call runs the statistics pass and then
    a2k_gn_silu_conv3x3_f32 with the f32 plan's launch arguments, the weight
    and the f32 conv bias as stored (the same storage: nothing converted, no
    workspace, no reduce launch); a shape the plan declines reaches the
    shared core."""
    from audioldm2_torch.ops import resblock_kernel as rk

    lib = as_if_on_the_card
    for b, t, f, c1, c2, cout in ((1, 256, 16, 512, 0, 512), (2, 32, 2, 640, 384, 640)):
        x1 = torch.zeros(b, t, f, c1)
        x2 = torch.zeros(b, t, f, c2) if c2 else None
        gamma, beta, bias = (torch.ones(k) for k in (c1 + c2, c1 + c2, cout))
        w = torch.zeros(3, 3, c1 + c2, cout)
        out = rk.gn_silu_conv3x3(x1, x2, gamma, beta, w, bias)
        assert set(lib.calls) == {"a2k_gn_stats", "a2k_gn_silu_conv3x3_f32"}
        args = lib.calls.pop("a2k_gn_silu_conv3x3_f32")
        plan = _build.gn_silu_conv_plan(b, t, f, c1 + c2, cout, SMS, dtype="f32")
        assert args[0] == x1.data_ptr() and args[1] == (None if x2 is None else x2.data_ptr())
        assert args[4:8] == (w.data_ptr(), bias.data_ptr(), 0, out.data_ptr())
        assert args[8:14] == (b, t, f, c1, c2, cout)
        assert args[14:21] == (plan.bm, plan.bn, plan.tt, plan.ft, plan.strip_tiles, plan.stages,
                               plan.splits)
        assert out.shape == (b, t, f, cout) and out.dtype == torch.float32
        assert lib.calls.pop("a2k_gn_stats")[10] == 0
    x = torch.zeros(1, 5, 3, 100)
    rk.gn_silu_conv3x3(x, None, torch.ones(100), torch.zeros(100), torch.zeros(3, 3, 100, 64),
                       torch.zeros(64), 4)
    assert set(lib.calls) == {"a2k_gn_stats", "a2k_gn_silu_conv3x3"}


@pytest.mark.parametrize("shape", [(2, 256, 16, 128), (140, 8, 4, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_is_one_launch_with_its_parameters_as_stored(as_if_on_the_card, dtype, shape):
    """A group_norm_silu call launches a2k_group_norm_silu once, with the
    plan's slots, blocks per sample, rows and rows held, bf16 GroupNorm
    parameters as stored (code 1), and nothing else: no statistics pass, no
    second pass; a batch above the SM count too (its samples in turn)."""
    from audioldm2_torch.ops import groupnorm_kernel as gk

    lib = as_if_on_the_card
    x = torch.zeros(*shape, dtype=dtype)
    bsz, c = shape[0], shape[-1]
    s = x.numel() // (bsz * c)
    gamma, beta = torch.ones(c, dtype=torch.bfloat16), torch.zeros(c, dtype=torch.bfloat16)
    out = gk.group_norm_silu(x, gamma, beta, 32, 1e-5)
    assert set(lib.calls) == {"a2k_group_norm_silu"}
    args = lib.calls.pop("a2k_group_norm_silu")
    plan = _build.group_norm_silu_plan(bsz, s, c, "bf16" if dtype == torch.bfloat16 else "f32",
                                       SMS, 32, True)
    assert args[:5] == (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), 1, out.data_ptr())
    assert args[5:9] == (bsz, s, c, 32) and args[10] == 1
    assert args[11:16] == (plan.slots, plan.blocks_per_sample, plan.rows, plan.rows_held, 1)
    assert plan.slots == min(bsz, SMS)
    assert out.shape == x.shape and out.dtype == dtype
    gk.group_norm_silu(x, gamma.float(), beta.float(), 32, 1e-5, silu=False)
    args = lib.calls.pop("a2k_group_norm_silu")
    assert args[3] == 0 and args[10] == 0 and not lib.calls


def test_timing_tool_sums_the_f32_encode_and_k6():
    """tools.time_k2_k3's f32 K1 rows are the 16 calls of one full-width
    encode; its K6 rows are the main-path calls, one each on the t5 and
    large UNet forwards, the VAE decodes at batch 1, 2, 3 and 6 and the sr
    encode."""
    from audioldm2_torch.tools import time_k2_k3 as tool

    shapes = tool.main_path_shapes()
    assert {tuple(s): c["sr_encode"] for s, c in shapes["k1f32"]} == ENCODE_K1
    k6 = {tuple(s): c for s, c in shapes["k6"]}
    assert k6 == {(2, 256, 16, 128, "bf16", 1e-5): {"t5": 1},
                  (6, 256, 16, 128, "bf16", 1e-5): {"large": 1},
                  (1, 1024, 64, 128, "bf16", 1e-6): {"t5_vae": 1},
                  (2, 1024, 64, 128, "bf16", 1e-6): {"t5_vae_b2": 1},
                  (3, 1024, 64, 128, "bf16", 1e-6): {"large_vae_b3": 1},
                  (6, 1024, 64, 128, "bf16", 1e-6): {"large_vae_b6": 1},
                  (1, 256, 16, 512, "f32", 1e-6): {"sr_encode": 1}}
    part = {"held_us": 100.0, "unheld_us": 120.0}
    k1f32 = [{"calls": c, "whole": part, "stats": {"held_us": 10.0, "unheld_us": 30.0},
              "conv": {"held_us": 90.0, "unheld_us": 90.0}, "yardstick_held_us": 50.0}
             for _, c in shapes["k1f32"]]
    rows_k6 = [{"calls": c, "held_us": 20.0, "unheld_us": 40.0, "yardstick_held_us": 25.0}
               for _, c in shapes["k6"]]
    sums = tool.per_forward((), (), rows_k1f32=k1f32, rows_k6=rows_k6)
    assert sums["sr_encode"]["k1f32_whole_held_ms"] == pytest.approx(16 * 0.1)
    assert sums["sr_encode"]["k1f32_stats_unheld_ms"] == pytest.approx(16 * 0.03)
    assert sums["sr_encode"]["k1f32_yardstick_held_ms"] == pytest.approx(16 * 0.05)
    for tag in ("t5", "large", "t5_vae", "t5_vae_b2", "large_vae_b3", "large_vae_b6",
                "sr_encode"):
        assert sums[tag]["k6_held_ms"] == pytest.approx(0.02)
        assert sums[tag]["k6_yardstick_held_ms"] == pytest.approx(0.025)
    assert "k1f32_whole_held_ms" not in sums["t5"] and "k3_held_ms" not in sums["t5"]


def _tp2_rank_shapes():
    """The K3 and K4 shapes one rank of a tp 2 mesh gives the kernels on
    the t5 and large UNets at CFG batch 2 and 6: N / 2 (K3), F / 2 (K4)."""
    ln, geglu = set(), set()
    for name in CONFIGS:
        cfg = at.default_audioldm_config(name)
        for batch in (2, 6):
            args = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
            ln |= {(m, c, n // 2) for m, c, n in unet.ln_matmul_shapes(*args)}
            geglu |= {(m, f // 2, n) for m, f, n in unet.geglu_matmul_shapes(*args)}
    return sorted(ln), sorted(geglu)


@pytest.mark.parametrize("sms", PLAN_SMS)
def test_plans_take_every_tp2_rank_shape(sms):
    """A tp 2 rank's K3 and K4 calls have plans: K4's f32-residual mode,
    which the row-parallel FF takes, has no shared-core fallback."""
    ln, geglu = _tp2_rank_shapes()
    assert (2048, 256, 384) in ln and (128, 1280, 640) in geglu
    assert all(_build.ln_matmul_plan(m, c, n, sms) is not None for m, c, n in ln)
    assert all(_build.geglu_matmul_plan(m, f, n, sms) is not None for m, f, n in geglu)


def _tp2_int8_rank_shapes():
    """The K3q, K4q and K5 shapes one rank of a tp 2 mesh gives the int8
    kernels (the shape functions' tp=2) on every family's UNet at CFG batch
    2 and 6."""
    k3q, k4q, k5 = set(), set(), set()
    for name in CONFIGS:
        cfg = at.default_audioldm_config(name)
        for batch in (2, 6):
            args = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
            k3q |= set(unet.ln_matmul_shapes(*args, weight_quant="int8", tp=2))
            k4q |= set(unet.geglu_matmul_shapes(*args, weight_quant="int8", tp=2))
            k5 |= set(unet.int8_matmul_shapes(*args, tp=2))
    return sorted(k3q), sorted(k4q), sorted(k5)


@pytest.mark.parametrize("name", CONFIGS)
def test_tp2_int8_rank_shapes_are_the_whole_ones_cut(name):
    """A tp 2 rank launches as many K3q, K4q and K5 calls as the unsharded
    int8 forward (the predicate takes the whole weights' shapes), each at
    its slice: K3q at N / 2, K4q at F / 2, K5's to_out at K / 2 and a None
    slot's to_q at N / 2; the launch counts do not change with tp."""
    cfg = at.default_audioldm_config(name)
    size = (cfg.unet, 2, cfg.latent_t_size, cfg.latent_f_size)
    launches = unet.kernel_launches_per_forward(cfg.unet, "int8")
    for fn, kw, kernel in ((unet.ln_matmul_shapes, {"weight_quant": "int8"}, "ln_matmul_q"),
                           (unet.geglu_matmul_shapes, {"weight_quant": "int8"}, "geglu_matmul_q"),
                           (unet.int8_matmul_shapes, {}, "int8_matmul")):
        whole, rank = fn(*size, **kw), fn(*size, **kw, tp=2)
        assert sum(whole.values()) == sum(rank.values()) == launches[kernel]
        cut = {}
        for (m, k, n), calls in whole.items():
            if fn is unet.ln_matmul_shapes:
                keys = [(m, k, n // 2)]
            elif fn is unet.geglu_matmul_shapes:
                keys = [(m, k // 2, n)]
            else:
                keys = [(m, k // 2, n), (m, k, n // 2)]
            for key in keys:
                cut[key] = cut.get(key, 0) + calls
        assert set(rank) <= set(cut)


@pytest.mark.parametrize("sms", PLAN_SMS)
def test_plans_take_every_tp2_int8_rank_shape(sms):
    """A tp 2 rank's K3q, K4q and K5 calls have plans: K4q's f32-residual
    and K5's f32-output modes have no shared-core fallback, and a bf16 K3q
    call on the shared core fails chip_smoke.py. The t5 family's slices
    (N = 192, 320, 576, 960; F = 512, 768, 1280; K = 128, 192, 320) are
    among them."""
    k3q, k4q, k5 = _tp2_int8_rank_shapes()
    assert {(2048, 256, 384), (512, 384, 576), (512, 384, 192), (128, 640, 960),
            (128, 640, 320)} <= set(k3q)
    assert {(2048, 512, 256), (512, 768, 384), (128, 1280, 640)} <= set(k4q)
    assert {(2048, 128, 256), (512, 192, 384), (128, 320, 640)} <= set(k5)
    for m, c, n in k3q:
        plan = _build.ln_matmul_plan(m, c, n, sms, w_bytes=1)
        assert plan is not None, (m, c, n)
    for m, f, n in k4q:
        _check_thin_q_plan(_build.geglu_matmul_plan(m, f, n, sms, w_bytes=1), m, f, n, sms,
                           _build.GEGLU_TILES)
    for m, k, n in k5:
        _check_thin_q_plan(_build.int8_matmul_plan(m, k, n, sms), m, k, n, sms,
                           _build.GEGLU_TILES)


_REQUIRE_CUDA = _build.require_cuda  # the wrappers' own checks, before any fixture patches them


def test_k4_f32_residual_mode_reaches_its_entry(as_if_on_the_card, monkeypatch):
    """bf16 h and w with an f32 residual (a tp rank's K4) pass the
    wrapper's own device and dtype checks and reach
    a2k_geglu_matmul_bf16_f32res, which writes the f32 sum; K4q with an f32
    residual (a tp rank's int8 FF) reaches a2k_geglu_matmul_q_bf16_f32res;
    a residual of another type than h outside the mode, and an f32
    residual with a plan-less shape, are refused rather than sent to a
    kernel that reads another type."""
    from audioldm2_torch.ops import lnmm_kernel as lk

    monkeypatch.setattr(_build, "require_cuda", _REQUIRE_CUDA)

    bf16 = torch.bfloat16
    h, w = torch.zeros(2048, 2 * 512, dtype=bf16), torch.zeros(512, 256, dtype=bf16)
    bias, res = torch.zeros(256, dtype=bf16), torch.zeros(2048, 256)
    out = lk.geglu_matmul(h, w, bias, res)
    assert out.dtype == torch.float32 and out.shape == (2048, 256)
    args = as_if_on_the_card.calls["a2k_geglu_matmul_bf16_f32res"]
    assert args[:6] == (h.data_ptr(), w.data_ptr(), bias.data_ptr(), 1, res.data_ptr(),
                        out.data_ptr())
    assert "a2k_geglu_matmul_bf16" not in as_if_on_the_card.calls
    wq, ws = torch.zeros(512, 256, dtype=torch.int8), torch.ones(256)
    out_q = lk.geglu_matmul_q(h, wq, ws, bias, res)
    assert out_q.dtype == torch.float32 and out_q.shape == (2048, 256)
    args = as_if_on_the_card.calls["a2k_geglu_matmul_q_bf16_f32res"]
    plan = _build.geglu_matmul_plan(2048, 512, 256, SMS, w_bytes=1)
    assert args[:7] == (h.data_ptr(), wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), 1,
                        res.data_ptr(), out_q.data_ptr())
    assert args[7:15] == (2048, 512, 256, plan.bm, plan.bn, plan.strip_tiles, plan.stages,
                          plan.splits)
    assert "a2k_geglu_matmul_q_bf16" not in as_if_on_the_card.calls
    with pytest.raises(ValueError, match="f32 residual"):
        lk.geglu_matmul_q(h.float(), wq, ws, bias, res.to(bf16))
    with pytest.raises(ValueError, match="no plan"):
        lk.geglu_matmul(torch.zeros(4, 2 * 20, dtype=bf16), torch.zeros(20, 12, dtype=bf16),
                        torch.zeros(12, dtype=bf16), torch.zeros(4, 12))
    with pytest.raises(ValueError, match="no plan"):
        lk.geglu_matmul_q(torch.zeros(4, 2 * 64, dtype=bf16), torch.zeros(64, 24, dtype=torch.int8),
                          torch.ones(24), torch.zeros(24, dtype=bf16), torch.zeros(4, 24))


@pytest.mark.parametrize("with_bias", [True, False])
def test_k5_f32_output_mode_reaches_its_entry(as_if_on_the_card, monkeypatch, with_bias):
    """bf16 x with out_dtype=torch.float32 (a tp rank's int8 to_out) passes
    the wrapper's checks and reaches a2k_int8_matmul_bf16_f32out with the
    plan's launch arguments, which writes the f32 product; another output
    type, and the mode at a plan-less shape, are refused (never the shared
    core)."""
    from audioldm2_torch.ops import lnmm_kernel as lk

    monkeypatch.setattr(_build, "require_cuda", _REQUIRE_CUDA)
    lib = as_if_on_the_card
    bf16 = torch.bfloat16
    m, k, n = 128, 320, 640
    x = torch.zeros(m, k, dtype=bf16)
    wq, ws = torch.zeros(k, n, dtype=torch.int8), torch.ones(n)
    bias = torch.ones(n, dtype=bf16) if with_bias else None
    out = lk.int8_matmul(x, wq, ws, bias, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    args = lib.calls.pop("a2k_int8_matmul_bf16_f32out")
    plan = _build.int8_matmul_plan(m, k, n, SMS)
    assert args[:6] == (x.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                        bias.data_ptr() if with_bias else None, 1, out.data_ptr())
    assert args[6:14] == (m, k, n, plan.bm, plan.bn, plan.strip_tiles, plan.stages, plan.splits)
    assert not lib.calls
    with pytest.raises(ValueError, match="f32 output"):
        lk.int8_matmul(x, wq, ws, bias, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="no plan"):
        lk.int8_matmul(torch.zeros(4, 20, dtype=bf16), torch.zeros(20, 24, dtype=torch.int8),
                       torch.ones(24), None, out_dtype=torch.float32)
    assert not lib.calls


# ---------------------------------------------------------------------------
# The plain conv (every bf16 conv2d of the UNet and the VAE decoder outside
# the ResBlock bodies) on K1's bf16 kernel
# ---------------------------------------------------------------------------

# the benchmark's CFG batches (24 clips of audioldm2-full, 8 of audioldm_48k)
# and a 3-candidate request's; the decodes at those clip counts
PLAIN_CONV_CONFIGS = (("audioldm2-full", (48, 6), (24, 3)), ("audioldm_48k", (16, 6), (8, 3)))


def _plain_conv_shapes():
    from audioldm2_torch.models import vae

    shapes = set()
    for name, batches, decodes in PLAIN_CONV_CONFIGS:
        cfg = at.default_audioldm_config(name)
        for batch in batches:
            shapes |= set(unet.plain_conv_shapes(cfg.unet, batch, cfg.latent_t_size,
                                                 cfg.latent_f_size))
        for batch in decodes:
            shapes |= set(vae.decode_plain_conv_shapes(cfg.vae, batch, cfg.latent_t_size,
                                                       cfg.latent_f_size))
    return sorted(shapes)


# ragged T and F, Cout 8 and 16, a two-part 1x1, a tall stride-2 tile
PLAIN_CONV_EDGES = [(1, 5, 3, 64, 0, 8, 3, 1, 1, False), (2, 7, 9, 24, 16, 40, 1, 1, 1, False),
                    (1, 33, 7, 128, 0, 16, 3, 2, 1, False), (3, 9, 5, 256, 0, 256, 3, 1, 2, False),
                    (2, 256, 3, 96, 0, 96, 1, 1, 1, True), (1, 1, 1, 640, 0, 640, 3, 2, 1, False)]
PLAIN_CONV_SHAPES = _plain_conv_shapes() + PLAIN_CONV_EDGES


def _plain_conv_out(t, f, taps, stride, up):
    """The output's extent: SAME at stride 1 (on the 2x grid where up is 2),
    padding 1 at stride 2 (the downsample)."""
    return -(-t * up // stride), -(-f * up // stride)


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("b,t,f,c1,c2,cout,taps,stride,up,gn", PLAIN_CONV_SHAPES)
def test_conv2d_plan(b, t, f, c1, c2, cout, taps, stride, up, gn, sms):
    """The plain conv's plan at every conv shape of the two benchmark
    configurations' UNets and decodes and at ragged ones: K1's tiles, the
    tiles cover the output once, whole chunks cover Cin, the strips cover
    the N tiles once, a patch of the tile's taps and stride fits twice
    beside the ring, whose depth lets each chunk's patch land before its
    first tap, and the grid fills the SMs as K1's does, counting the widest
    split that leaves no block empty (a 1 x 1 output of 640 channels)."""
    to, fo = _plain_conv_out(t, f, taps, stride, up)
    plan = _build.conv2d_plan(b, to, fo, c1 + c2, cout, sms, taps, stride)
    assert plan is not None
    assert (plan.bm, plan.bn) in _build.CONV_TILES and plan.ck == _build.CONV_CK
    assert 1 <= plan.tt <= to and 1 <= plan.ft <= fo and plan.tt * plan.ft <= plan.bm
    strips, m_tiles, splits = plan.grid
    assert m_tiles == b * math.ceil(to / plan.tt) * math.ceil(fo / plan.ft)
    assert plan.k_chunks == math.ceil((c1 + c2) / plan.ck)
    cps = math.ceil(plan.k_chunks / splits)
    assert 1 <= splits <= _build.CONV_MAX_SPLITS and (splits - 1) * cps < plan.k_chunks
    n_tiles = math.ceil(cout / plan.bn)
    assert (strips - 1) * plan.strip_tiles < n_tiles <= strips * plan.strip_tiles
    assert splits == 1 or plan.strip_tiles == 1
    patch = ((plan.tt - 1) * stride + taps) * ((plan.ft - 1) * stride + taps)
    assert patch == _build.conv_patch(plan.tt, plan.ft, taps, stride)
    main = (2 * patch * _build.CONV_LD * 2 + 4 * plan.ck * 4
            + plan.stages * plan.ck * (plan.bn + _build.CONV_PAD) * 2)
    assert plan.smem_bytes == max(main, plan.bm * (plan.bn + 4) * 4) <= SMEM_LIMIT
    assert 2 <= plan.stages <= min(_build.CONV_MAX_STAGES, taps * taps + 1)
    blocks = strips * m_tiles * splits
    most = max(math.ceil(plan.k_chunks / math.ceil(plan.k_chunks / w))
               for w in range(1, min(_build.CONV_MAX_SPLITS, plan.k_chunks) + 1))
    fill = min(sms, m_tiles * n_tiles * most)
    assert blocks >= fill or (blocks <= sms and blocks >= _build.LNMM_MIN_FILL * fill)


@pytest.mark.parametrize("taps,stride,cin,cout,taken", [
    (3, 1, 128, 8, True), (1, 1, 8, 8, True), (3, 2, 640, 640, True), (1, 2, 64, 64, True),
    (5, 1, 128, 128, False), (2, 1, 128, 128, False), (3, 4, 128, 128, False),
    (3, 1, 128, 1, False), (3, 1, 4, 128, False), (1, 1, 100, 64, False), (3, 1, 64, 12, False)])
def test_conv2d_plan_declines_what_the_kernel_does_not_take(taps, stride, cin, cout, taken):
    """1x1 or 3x3 taps, stride 1 or 2, Cin and Cout multiples of 8: the
    VAE's 5x5 time-stride-4 upsample and its conv_out onto one channel, and
    the tiny test UNets' 4 latent channels, keep the f32 copies."""
    assert (_build.conv2d_plan(2, 16, 8, cin, cout, SMS, taps, stride) is not None) is taken
    assert nn_conv2d_uses_kernel((taps, taps, cin, cout), (stride, stride), ((0, 0),) * 2,
                                 (cin,)) is taken


def nn_conv2d_uses_kernel(*args):
    from audioldm2_torch.ops import nn

    return nn.conv2d_uses_kernel(*args)


@pytest.mark.parametrize("name,calls,decode_calls", [("audioldm2-full", 119, 10),
                                                     ("audioldm_48k", 87, 12)])
def test_plain_conv_shapes_add_up_to_the_launch_count(name, calls, decode_calls):
    """Every conv of a UNet forward of both benchmark configurations takes
    the plain conv (none declined: the walk of its convs, ``_plain_convs``,
    is as long as the shapes' calls), 119 in audioldm2-full (48 spatial
    transformers) and 87 in audioldm_48k (32); a decode takes all but its
    conv_out onto one channel. The calls sum to the launch counts."""
    from audioldm2_torch.models import vae

    cfg = at.default_audioldm_config(name)
    for batch in (16, 48):
        got = unet.plain_conv_shapes(cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
        assert sum(got.values()) == calls == len(unet._plain_convs(cfg.unet))
        assert sum(got.values()) == unet.kernel_launches_per_forward(cfg.unet)["conv2d"]
        assert sum(got.values()) == unet.kernel_launches_per_forward(cfg.unet, "int8")["conv2d"]
        sts = 16 * (1 + len(cfg.unet.context_dims))  # 16 ladders of a self-ST and the cross-STs
        assert sum(n for k, n in got.items() if k[-1]) == sts  # GroupNorm + proj_in
        assert {k[7] for k in got} == {1, 2} and {k[8] for k in got} == {1, 2}
        dec = vae.decode_plain_conv_shapes(cfg.vae, batch, cfg.latent_t_size, cfg.latent_f_size)
        assert sum(dec.values()) == decode_calls == len(vae._decode_plain_convs(cfg.vae)) - 1
        assert sum(dec.values()) == vae.kernel_launches_per_decode(cfg.vae)["conv2d"]
    assert unet.kernel_launches_per_forward(cfg.unet, compute_dtype="float32")["conv2d"] == 0
    assert vae.kernel_launches_per_decode(cfg.vae, "float32")["conv2d"] == 0
    assert vae.kernel_launches_per_encode(cfg.vae)["conv2d"] == 0


PORT_FAMILIES = ("audioldm_16k_crossattn_t5", "audioldm2-full", "audioldm2-full-large-1150k",
                 "audioldm_48k", "audioldm2-speech-gigaspeech")


@pytest.mark.parametrize("name", PORT_FAMILIES)
def test_port_census_of_the_plain_convs(name):
    """The census of the plain convs (every conv2d outside the ResBlock
    bodies, on K1's bf16 kernel on the card): each conv of a UNet forward of
    every shipped family is one the kernel takes, so a forward declines
    none; of a VAE decode all but conv_out onto the one mel channel."""
    from audioldm2_torch.models import vae
    from audioldm2_torch.ops import nn

    cfg = at.default_audioldm_config(name)

    def taken(c1, c2, cout, taps, stride):
        return nn.conv2d_uses_kernel((taps, taps, c1 + c2, cout), (stride, stride),
                                     ((0, 0), (0, 0)), (c1, c2) if c2 else (c1,))

    convs = unet._plain_convs(cfg.unet)
    assert convs and all(taken(*cv[:5]) for cv in convs)
    assert len(convs) == unet.kernel_launches_per_forward(cfg.unet)["conv2d"]
    declined = [cv for cv in vae._decode_plain_convs(cfg.vae)
                if not (cv[3] in (1, 2) and taken(cv[0], 0, cv[1], cv[2], 1))]
    assert declined == [(cfg.vae.ch, 1, 3, 1, declined[0][4])] and cfg.vae.out_ch == 1


@pytest.mark.parametrize("sms", PLAN_SMS)
def test_sweep_times_the_plans_own_candidates(sms):
    """tools/time_conv2d --sweep times, at each UNet shape of both benchmark
    configurations, the launches conv2d_plan chooses among, each once, and
    the plan's pick is the cheapest of them."""
    from audioldm2_torch.tools import time_conv2d

    for _, _, key, _ in time_conv2d.shapes("unet"):
        b, ti, fi, c1, c2, cout, taps, stride, up, _ = key
        t, f = _plain_conv_out(ti, fi, taps, stride, up)
        cands = time_conv2d.candidates(key, sms)
        costed = _build.conv2d_candidates(b, t, f, c1 + c2, cout, sms, taps, stride)
        pick = _build.conv2d_plan(b, t, f, c1 + c2, cout, sms, taps, stride)
        assert len(set(cands)) == len(cands) and pick in cands
        assert set(cands) == {plan for _, plan in costed}
        assert min(cost for cost, _ in costed) == next(c for c, p in costed if p == pick)

def test_a_strided_input_reaches_the_plain_conv_as_a_contiguous_copy(as_if_on_the_card,
                                                                     monkeypatch):
    """A bf16 call the rule takes reaches a2k_conv2d_bf16 whatever the
    input's layout: a channel slice of a wider tensor goes as a contiguous
    copy, and nothing counts as declined."""
    from audioldm2_torch import ops
    from audioldm2_torch.ops import nn
    from audioldm2_torch.ops import resblock_kernel as rk

    monkeypatch.setattr(rk.conv2d, "declined", 0)
    lib = as_if_on_the_card
    bf16 = torch.bfloat16
    wide = torch.zeros(2, 16, 8, 192, dtype=bf16)
    x = wide[..., :128]
    assert not x.is_contiguous()
    p = {"w": torch.zeros(1, 1, 128, 64, dtype=bf16), "b": torch.ones(64, dtype=bf16)}
    out = nn.conv2d(p, x)
    args = lib.calls.pop("a2k_conv2d_bf16")
    assert args[0] != wide.data_ptr() and args[1] is None and not lib.calls
    assert out.shape == (2, 16, 8, 64) and ops.declined_counts() == {"conv2d": 0}


def test_plain_convs_reach_the_kernel_with_parameters_as_stored(as_if_on_the_card, monkeypatch):
    """The dispatch points of the plain conv on bf16 inputs as on the card:
    nn.conv2d (3x3 SAME, the stride-2 downsample), upsample_conv2d (read
    through the nearest 2x), gn_conv2d (the statistics pass, then the conv
    with the GroupNorm folded in: act 2) and conv1x1_cat (two parts in
    place) each reach a2k_conv2d_bf16 once with the plan's arguments, the
    bf16 weight and bias as stored (code 1); a 5x5 conv and a conv onto one
    channel keep the f32 copies, counted as declined; an f32 input takes no
    kernel and counts nothing."""
    from audioldm2_torch import ops
    from audioldm2_torch.ops import nn
    from audioldm2_torch.ops import resblock_kernel as rk

    monkeypatch.setattr(rk.conv2d, "declined", 0)
    lib = as_if_on_the_card
    bf16 = torch.bfloat16
    b, t, f, c = 2, 16, 8, 128

    def conv(k, cin, cout):
        return {"w": torch.zeros(k, k, cin, cout, dtype=bf16), "b": torch.ones(cout, dtype=bf16)}

    x = torch.zeros(b, t, f, c, dtype=bf16)
    cases = [
        (lambda p: nn.conv2d(p, x), conv(3, c, c), (t, f, t, f, c, 0, c, 3, 1, 0, 1, 1, 0)),
        (lambda p: nn.conv2d(p, x, stride=(2, 2), padding=1), conv(3, c, c),
         (t // 2, f // 2, t, f, c, 0, c, 3, 2, 0, 1, 1, 0)),
        (lambda p: nn.upsample_conv2d(p, x), conv(3, c, c),
         (2 * t, 2 * f, t, f, c, 0, c, 3, 1, 1, 1, 1, 0)),
        (lambda p: nn.conv2d(p, x), conv(1, c, 8), (t, f, t, f, c, 0, 8, 1, 1, 0, 0, 0, 0)),
        (lambda p: nn.gn_conv2d({"scale": torch.ones(c, dtype=bf16),
                                 "bias": torch.zeros(c, dtype=bf16)}, p, x, eps=1e-6),
         conv(1, c, c), (t, f, t, f, c, 0, c, 1, 1, 0, 0, 0, 2)),
        (lambda p: nn.conv1x1_cat(p, x, x[..., :64].contiguous()), conv(1, c + 64, c),
         (t, f, t, f, c, 64, c, 1, 1, 0, 0, 0, 0)),
    ]
    for call, p, geometry in cases:
        out = call(p)
        args = lib.calls.pop("a2k_conv2d_bf16")
        assert set(lib.calls) <= {"a2k_gn_stats"}
        stats = lib.calls.pop("a2k_gn_stats", None)
        assert (stats is not None) is (geometry[-1] == 2)
        assert args[0] == x.data_ptr() and (args[1] is None) is (geometry[5] == 0)
        assert (args[2] is None) is (args[3] is None) is (stats is None)
        assert args[4:8] == (p["w"].data_ptr(), p["b"].data_ptr(), 1, out.data_ptr())
        assert args[8] == b and args[9:22] == geometry
        to, fo, cout = geometry[0], geometry[1], geometry[6]
        plan = _build.conv2d_plan(b, to, fo, geometry[4] + geometry[5], cout, SMS, geometry[7],
                                  geometry[8])
        assert args[22:29] == (plan.bm, plan.bn, plan.tt, plan.ft, plan.strip_tiles,
                               plan.stages, plan.splits)
        assert out.shape == (b, to, fo, cout) and out.dtype == bf16
    assert ops.declined_counts() == {"conv2d": 0}
    for p, kw in ((conv(5, c, c), {}), (conv(3, c, 1), {})):
        out = nn.conv2d(p, x, **kw)
        assert not lib.calls and out.dtype == bf16 and out.shape[:3] == (b, t, f)
    assert ops.declined_counts() == {"conv2d": 2}
    nn.conv2d(conv(3, c, c), x.float())
    assert not lib.calls and ops.declined_counts() == {"conv2d": 2}
