"""Time K1 (GroupNorm + SiLU + 3x3 conv), K2 (flash self-attention), K3
(LayerNorm + matmul), K4 (GEGLU + matmul) and the int8 K1q, K3q, K5 and K4q
on the card at every shape one forward gives them, call by call and summed per
forward, so that two trees of the package can be compared under one timer.

Forwards: the t5 UNet at CFG batch 2 and the large-1150k UNet at CFG batch 6
(``unet.self_attention_shapes``, ``unet.ln_matmul_shapes``,
``unet.conv_shapes``, ``unet.geglu_matmul_shapes`` on the 10 s latent), and
for K1 also the t5 VAE decode at batch 1 (``vae.decode_conv_shapes``). All
in bf16, through the public wrappers, with the parameters in bf16 as the
cast parameter tree holds them:
  K1  the whole call, and its GroupNorm statistics pass alone; "conv" is
      the whole call less the statistics (in a tree that converts the
      parameters first, those conversions are part of it). Beside it, as a
      yardstick of the product alone, cuDNN's channels-last bf16 conv on
      the activation already materialised;
  K2  on contiguous q, k, v and on the strided chunks of one fused
      [B, T, 3 * H * D] projection, which is what the UNet hands it at most
      calls (a tree whose wrapper copies them pays for the copies here);
  K3  with a bias where the UNet has one (the GEGLU proj_in, N = 8C), and
      the SHA-256 of its output, to show that two trees give the same bytes;
  K4  the whole call, and as a yardstick torch.matmul(u, W) on the gate
      product already materialised;
  K1q and K3q on the audioldm2-full UNet in the int8 serving mode at CFG
      batch 2 ("full8": ``weight_quant="int8"`` of the shape functions),
      K1q whole, its statistics pass and its conv apart, each with int8
      weights and f32 scales as the quantized tree holds them, and beside
      each the bf16 K1 or K3 at the same shape on the dequantized weight
      rounded to bf16 (int8 should cost no more), with the SHA-256 of K1q's
      and K3q's outputs (two runs of one tree give the same bytes);
  K5 and K4q on the same full8 forward (``unet.int8_matmul_shapes``,
      ``unet.geglu_matmul_shapes(..., weight_quant="int8")``), each beside
      its bf16 sibling (K5: the bf16 mode's own call at those sites,
      ``nn.linear`` on the dequantized weight, cuBLAS; K4q: bf16 K4 on it)
      and the parent design, the same call on the shared GEMM core (in a
      tree without the ``_*_shared_core`` functions, its wrapper, which is
      that core), with the SHA-256 of their outputs;
  K1 in f32 ("k1f32") at the 16 calls of one full-width VAE encode
      (``vae.encode_conv_shapes``, the sr path's "sr_encode"), whole, its
      statistics pass and its conv apart, with cuDNN's f32 conv (TF32 off)
      on the activation already materialised as the yardstick, and the
      SHA-256 of its output;
  K6 ("k6") at its main-path calls: the t5 UNet's out_norm at CFG batch 2
      and the large one's at 6 (bf16, one a forward), the t5 VAE decoder's
      norm_out (bf16) at batch 1 and at the batches requests also decode
      (2: a t5 batch-2 request; 3 and 6: a large request of three
      candidates at batch 1 and 2; above what the grid's shared memory
      holds, so re-read mode), and the VAE encoder's (f32, the sr path),
      with F.group_norm + F.silu (two PyTorch calls) as the yardstick.
Each call is checked against its plain version first, then timed with
``timing.cuda_ms``: with the device held while the host queues the calls
(device time) and without the hold (a call shorter than its launch then
reads as the host's launch rate). The yardsticks are held only.

To time an earlier tree at the same shapes, copy this file and ``timing.py``
into that tree's ``audioldm2_torch/tools/`` and pass this tree's JSON with
``--shapes-from`` (an earlier tree may lack the shape functions). A tree
without ``resblock_kernel.gn_stats`` has its statistics pass timed through
its C entry point ``a2k_gn_stats`` with f32 parameters.

``--no-check`` skips the comparison with the plain versions, to time an
ablation: a copy of the tree built with a part of a kernel compiled out,
whose output is then wrong by design.

Usage (on a machine with an NVIDIA GPU):
  python -m audioldm2_torch.tools.time_k2_k3 --json OUT.json
  python -m audioldm2_torch.tools.time_k2_k3 --shapes-from OUT.json --json OLD.json
  python -m audioldm2_torch.tools.time_k2_k3 --only k5,k4q --json OUT.json
  python -m audioldm2_torch.tools.time_k2_k3 --only k1f32,k6 --json OUT.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from audioldm2_torch.ops import (_build, attention_kernel, groupnorm_kernel, lnmm_kernel, nn,
                                 resblock_kernel)
from audioldm2_torch.tools.timing import cuda_ms

FORWARDS = (("t5", "audioldm_16k_crossattn_t5", 2), ("large", "audioldm2-full-large-1150k", 6))
VAE_FORWARD = ("t5_vae", "audioldm_16k_crossattn_t5", 1)
INT8_FORWARD = ("full8", "audioldm2-full", 2)
ENCODE_FORWARD = ("sr_encode", "audioldm2-full", 1)
# the VAE decodes at batches above 1: K6's norm_out there, one call each
DECODE_K6 = (("t5_vae_b2", "audioldm_16k_crossattn_t5", 2),
             ("large_vae_b3", "audioldm2-full-large-1150k", 3),
             ("large_vae_b6", "audioldm2-full-large-1150k", 6))
BF16_TOL = 2e-2
F32_TOL = 1e-4
BF16 = torch.bfloat16
CHECK_PLAIN = True  # --no-check clears it


def main_path_shapes() -> dict:
    """{"k1": [[(B, T, F, C1, C2, Cout), {forward: calls}]], "k2": [[shape,
    {forward: [fused calls, separate calls]}]], "k3": [[(M, C, N), {forward:
    calls}]], "k4": [[(M, F, N), {forward: calls}]], "k1q", "k3q", "k4q": as
    K1, K3 and K4 on the full8 forward, "k5": [[(M, K, N), {"full8":
    calls}]], "k1f32": K1's shapes of one f32 VAE encode, "k6": [[(B, T, F,
    C, dtype, eps), {forward: calls}]]} from this tree's configs; K1's
    forwards include the t5 VAE decode at batch 1."""
    import audioldm2_torch as at
    from audioldm2_torch.models import unet, vae

    k1, k2, k3, k4 = {}, {}, {}, {}
    for tag, name, batch in FORWARDS:
        cfg = at.default_audioldm_config(name)
        size = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
        for shape, calls in unet.self_attention_shapes(*size).items():
            k2.setdefault(shape, {})[tag] = list(calls)
        for table, fn in ((k1, unet.conv_shapes), (k3, unet.ln_matmul_shapes),
                          (k4, unet.geglu_matmul_shapes)):
            for shape, calls in fn(*size).items():
                table.setdefault(shape, {})[tag] = calls
    tag, name, batch = VAE_FORWARD
    cfg = at.default_audioldm_config(name)
    for shape, calls in vae.decode_conv_shapes(cfg.vae, batch, cfg.latent_t_size,
                                               cfg.latent_f_size).items():
        k1.setdefault(shape, {})[tag] = calls
    tag, name, batch = INT8_FORWARD
    cfg = at.default_audioldm_config(name)
    size = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
    k1q = {s: {tag: c} for s, c in unet.conv_shapes(*size, weight_quant="int8").items()}
    k3q = {s: {tag: c} for s, c in unet.ln_matmul_shapes(*size, weight_quant="int8").items()}
    k5 = {s: {tag: c} for s, c in unet.int8_matmul_shapes(*size).items()}
    k4q = {s: {tag: c} for s, c in unet.geglu_matmul_shapes(*size, weight_quant="int8").items()}
    tag, name, batch = ENCODE_FORWARD
    cfg = at.default_audioldm_config(name)
    frames = int(10.0 * cfg.latent_t_per_second * cfg.vae.downsample_factor)
    enc = vae.encode_conv_shapes(cfg.vae, batch, frames, cfg.preprocessing.n_mel_channels)
    k1f32 = {s: {tag: c} for s, c in enc.items()}
    deep = min(enc)  # the encoder's last level: its norm_out's input
    k6 = {}
    for tag, name, batch in FORWARDS:
        cfg = at.default_audioldm_config(name)
        k6[(batch, cfg.latent_t_size, cfg.latent_f_size, cfg.unet.model_channels, "bf16",
            1e-5)] = {tag: 1}
    for tag, name, batch in (VAE_FORWARD,) + DECODE_K6:
        cfg = at.default_audioldm_config(name)
        up = cfg.vae.downsample_factor
        k6.setdefault((batch, up * cfg.latent_t_size, up * cfg.latent_f_size,
                       cfg.vae.ch * cfg.vae.ch_mult[0], "bf16", 1e-6), {})[tag] = 1
    k6[(1, deep[1], deep[2], deep[5], "f32", 1e-6)] = {ENCODE_FORWARD[0]: 1}
    return {key: [[list(s), c] for s, c in sorted(table.items(), reverse=True)]
            for key, table in (("k1", k1), ("k2", k2), ("k3", k3), ("k4", k4), ("k1q", k1q),
                               ("k3q", k3q), ("k5", k5), ("k4q", k4q), ("k1f32", k1f32),
                               ("k6", k6))}


def _checked(got, want, what, tol=BF16_TOL):
    if not CHECK_PLAIN:
        return
    err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: rel {err:.3e} > {tol}")


def _both(fn) -> dict:
    return {"held_us": cuda_ms(fn) * 1e3, "unheld_us": cuda_ms(fn, hold=False) * 1e3}


def _rnd(g, device, *dims, scale=1.0, offset=0.0):
    return (torch.randn(dims, generator=g, device=device) * scale + offset).to(BF16)


def _stats_call(x1, x2, gamma, beta, groups, eps):
    """K1's statistics pass alone, in this tree's or in an earlier one's form."""
    if hasattr(resblock_kernel, "gn_stats"):
        return lambda: resblock_kernel.gn_stats(x1, x2, gamma, beta, groups, eps)
    bsz, t, f, c1 = x1.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    g32, b32 = gamma.float(), beta.float()
    a = torch.empty((bsz, c1 + c2), device=x1.device)
    c = torch.empty_like(a)
    lib = _build.lib()

    def call():
        _build.check(lib.a2k_gn_stats(
            x1.data_ptr(), None if x2 is None else x2.data_ptr(), bsz, t * f, c1, c2, groups,
            float(eps), g32.data_ptr(), b32.data_ptr(), a.data_ptr(), c.data_ptr(), 1,
            _build.stream_of(x1)), "a2k_gn_stats")
    return call


def k1_args(shape, device):
    """gn_silu_conv3x3's bf16 arguments at (B, T, F, C1, C2, Cout), drawn
    from seed 0 on ``device``: the inputs whose output hashes two trees
    compare."""
    bsz, t, f, c1, c2, cout = shape
    cin = c1 + c2
    g = torch.Generator(device=device).manual_seed(0)
    x1 = _rnd(g, device, bsz, t, f, c1, offset=1.0)
    x2 = _rnd(g, device, bsz, t, f, c2) if c2 else None
    return (x1, x2, _rnd(g, device, cin, offset=1.0), _rnd(g, device, cin),
            _rnd(g, device, 3, 3, cin, cout, scale=(9 * cin) ** -0.5), _rnd(g, device, cout),
            32, 1e-5)


def time_k1(shape, device) -> dict:
    args = k1_args(shape, device)
    x1, x2 = args[:2]
    got = resblock_kernel.gn_silu_conv3x3(*args)
    _checked(got, resblock_kernel.gn_silu_conv3x3_plain(*args), f"K1 {shape}")
    whole = _both(lambda: resblock_kernel.gn_silu_conv3x3(*args))
    stats = _both(_stats_call(x1, x2, args[2], args[3], 32, 1e-5))
    # the yardstick: cuDNN's conv alone, channels-last, on the activation
    x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
    h = F.silu(F.group_norm(x.float().permute(0, 3, 1, 2), 32, args[2].float(),
                            args[3].float(), 1e-5)).to(BF16).contiguous(
                                memory_format=torch.channels_last)
    w = args[4].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    yard = cuda_ms(lambda: F.conv2d(h, w, args[5], padding=1)) * 1e3
    return {"whole": whole, "stats": stats,
            "conv": {k: whole[k] - stats[k] for k in whole}, "yardstick_held_us": yard,
            "sha256": sha256(got)}


def time_k2(shape, device) -> dict:
    b, t, h, d = shape
    g = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=device).to(BF16)
    views = tuple(x.reshape(b, t, h, d) for x in torch.chunk(qkv, 3, dim=-1))
    dense = tuple(v.contiguous() for v in views)
    scale = d ** -0.5
    want = attention_kernel.self_attention_plain(*dense, scale)
    out = {}
    for tag, args in (("contiguous", dense), ("views", views)):
        _checked(attention_kernel.flash_self_attention(*args, scale), want, f"K2 {shape} {tag}")
        out[tag] = _both(lambda: attention_kernel.flash_self_attention(*args, scale))
    return out


def k3_args(shape, device):
    """ln_matmul's arguments at (M, C, N), drawn from seed 0 on ``device``
    (bf16 LN parameters, a bias where the UNet has one): the inputs whose
    output hashes two trees compare."""
    m, c, n = shape
    g = torch.Generator(device=device).manual_seed(0)
    return (_rnd(g, device, 1, m, c, offset=3.0), _rnd(g, device, c), _rnd(g, device, c),
            _rnd(g, device, c, n, scale=c ** -0.5), _rnd(g, device, n) if n == 8 * c else None,
            1e-5)


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def time_k3(shape, device) -> dict:
    args = k3_args(shape, device)
    got = lnmm_kernel.ln_matmul(*args)
    _checked(got, lnmm_kernel.ln_matmul_plain(*args), f"K3 {shape}")
    return {**_both(lambda: lnmm_kernel.ln_matmul(*args)), "sha256": sha256(got)}


def time_k4(shape, device) -> dict:
    m, f, n = shape
    g = torch.Generator(device=device).manual_seed(0)
    args = (_rnd(g, device, m, 2 * f), _rnd(g, device, f, n, scale=f ** -0.5),
            _rnd(g, device, n), _rnd(g, device, m, n))
    got = lnmm_kernel.geglu_matmul(*args)
    _checked(got, lnmm_kernel.geglu_matmul_plain(*args), f"K4 {shape}")
    a, gate = torch.chunk(args[0].float(), 2, dim=-1)
    u = (a * F.gelu(gate)).to(BF16)
    yard = cuda_ms(lambda: torch.matmul(u, args[1])) * 1e3
    return {**_both(lambda: lnmm_kernel.geglu_matmul(*args)), "yardstick_held_us": yard,
            "sha256": sha256(got)}


def _int8(g, device, *dims):
    """An int8 weight and its f32 per-column scale, as ops.quant makes them."""
    wq = torch.randint(-127, 128, dims, generator=g, device=device).to(torch.int8)
    return wq, torch.rand(dims[-1], generator=g, device=device) * 0.01 + 1e-3


def k1q_args(shape, device):
    """gn_silu_conv3x3_q's bf16 arguments at (B, T, F, C1, C2, Cout), drawn
    from seed 0 on ``device``, as k1_args."""
    bsz, t, f, c1, c2, cout = shape
    cin = c1 + c2
    g = torch.Generator(device=device).manual_seed(0)
    x1 = _rnd(g, device, bsz, t, f, c1, offset=1.0)
    x2 = _rnd(g, device, bsz, t, f, c2) if c2 else None
    wq, ws = _int8(g, device, 3, 3, cin, cout)
    return (x1, x2, _rnd(g, device, cin, offset=1.0), _rnd(g, device, cin), wq, ws,
            _rnd(g, device, cout), 32, 1e-5)


def time_k1q(shape, device) -> dict:
    args = k1q_args(shape, device)
    x1, x2, wq, ws = args[0], args[1], args[4], args[5]
    got = resblock_kernel.gn_silu_conv3x3_q(*args)
    _checked(got, resblock_kernel.gn_silu_conv3x3_q_plain(*args), f"K1q {shape}")
    whole = _both(lambda: resblock_kernel.gn_silu_conv3x3_q(*args))
    stats = _both(_stats_call(x1, x2, args[2], args[3], 32, 1e-5))
    w16 = (wq.float() * ws).to(BF16)
    sibling = cuda_ms(lambda: resblock_kernel.gn_silu_conv3x3(x1, x2, args[2], args[3], w16,
                                                              args[6], 32, 1e-5)) * 1e3
    return {"whole": whole, "stats": stats,
            "conv": {k: whole[k] - stats[k] for k in whole}, "sibling_held_us": sibling,
            "sibling_conv_held_us": sibling - stats["held_us"], "sha256": sha256(got)}


def time_k3q(shape, device) -> dict:
    m, c, n = shape
    g = torch.Generator(device=device).manual_seed(0)
    x = _rnd(g, device, 1, m, c, offset=3.0)
    wq, ws = _int8(g, device, c, n)
    args = (x, _rnd(g, device, c), _rnd(g, device, c), wq, ws,
            _rnd(g, device, n) if n == 8 * c else None, 1e-5)
    got = lnmm_kernel.ln_matmul_q(*args)
    _checked(got, lnmm_kernel.ln_matmul_q_plain(*args), f"K3q {shape}")
    w16 = (wq.float() * ws).to(BF16)
    sibling = cuda_ms(lambda: lnmm_kernel.ln_matmul(x, args[1], args[2], w16, args[5],
                                                    1e-5)) * 1e3
    return {**_both(lambda: lnmm_kernel.ln_matmul_q(*args)), "sibling_held_us": sibling,
            "sha256": sha256(got)}


def time_k5(shape, device) -> dict:
    m, k, n = shape
    g = torch.Generator(device=device).manual_seed(0)
    x = _rnd(g, device, 1, m, k)
    wq, ws = _int8(g, device, k, n)
    args = (x, wq, ws, _rnd(g, device, n))
    got = lnmm_kernel.int8_matmul(*args)
    _checked(got, lnmm_kernel.int8_matmul_plain(*args), f"K5 {shape}")
    p16 = {"w": (wq.float() * ws).to(BF16), "b": args[3]}
    sibling = cuda_ms(lambda: nn.linear(p16, x)) * 1e3
    if hasattr(lnmm_kernel, "_int8_shared_core"):
        y = torch.empty_like(got)
        parent = cuda_ms(lambda: lnmm_kernel._int8_shared_core("int8_matmul", *args, y)) * 1e3
    else:  # a tree whose wrapper is the shared core
        parent = cuda_ms(lambda: lnmm_kernel.int8_matmul(*args)) * 1e3
    return {**_both(lambda: lnmm_kernel.int8_matmul(*args)), "sibling_held_us": sibling,
            "shared_core_held_us": parent, "sha256": sha256(got)}


def time_k4q(shape, device) -> dict:
    m, f, n = shape
    g = torch.Generator(device=device).manual_seed(0)
    h = _rnd(g, device, m, 2 * f)
    wq, ws = _int8(g, device, f, n)
    args = (h, wq, ws, _rnd(g, device, n), _rnd(g, device, m, n))
    got = lnmm_kernel.geglu_matmul_q(*args)
    _checked(got, lnmm_kernel.geglu_matmul_q_plain(*args), f"K4q {shape}")
    w16 = (wq.float() * ws).to(BF16)
    sibling = cuda_ms(lambda: lnmm_kernel.geglu_matmul(h, w16, args[3], args[4])) * 1e3
    if hasattr(lnmm_kernel, "_geglu_shared_core"):
        y = torch.empty_like(got)
        parent = cuda_ms(lambda: lnmm_kernel._geglu_shared_core("geglu_matmul_q", *args,
                                                                y)) * 1e3
    else:  # a tree whose wrapper is the shared core
        parent = cuda_ms(lambda: lnmm_kernel.geglu_matmul_q(*args)) * 1e3
    return {**_both(lambda: lnmm_kernel.geglu_matmul_q(*args)), "sibling_held_us": sibling,
            "shared_core_held_us": parent, "sha256": sha256(got)}


def time_k1f32(shape, device) -> dict:
    """K1 in f32 at one encode shape: as time_k1, all in f32 (the VAE's f32
    parameters), the yardstick cuDNN's f32 conv with TF32 off."""
    bsz, t, f, c1, c2, cout = shape
    cin = c1 + c2
    g = torch.Generator(device=device).manual_seed(0)

    def rnd(*dims, scale=1.0, offset=0.0):
        return torch.randn(dims, generator=g, device=device) * scale + offset

    x1 = rnd(bsz, t, f, c1, offset=1.0)
    x2 = rnd(bsz, t, f, c2) if c2 else None
    args = (x1, x2, rnd(cin, offset=1.0), rnd(cin), rnd(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
            rnd(cout), 32, 1e-6)
    got = resblock_kernel.gn_silu_conv3x3(*args)
    _checked(got, resblock_kernel.gn_silu_conv3x3_plain(*args), f"K1 f32 {shape}", F32_TOL)
    whole = _both(lambda: resblock_kernel.gn_silu_conv3x3(*args))
    stats = _both(_stats_call(x1, x2, args[2], args[3], 32, 1e-6))
    x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
    h = F.silu(F.group_norm(x.permute(0, 3, 1, 2), 32, args[2], args[3], 1e-6)).contiguous(
        memory_format=torch.channels_last)
    w = args[4].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    yard = cuda_ms(lambda: F.conv2d(h, w, args[5], padding=1)) * 1e3
    return {"whole": whole, "stats": stats,
            "conv": {k: whole[k] - stats[k] for k in whole}, "yardstick_held_us": yard,
            "sha256": sha256(got)}


def time_k6(shape, device) -> dict:
    """K6 at one call (B, T, F, C, dtype, eps): the whole call, and F.group_norm
    + F.silu on a channels-first copy as the yardstick (two calls)."""
    bsz, t, f, c, dt, eps = shape
    dtype = BF16 if dt == "bf16" else torch.float32
    g = torch.Generator(device=device).manual_seed(0)
    x = (torch.randn((bsz, t, f, c), generator=g, device=device) + 1.0).to(dtype)
    gamma = (torch.randn(c, generator=g, device=device) + 1.0).to(dtype)
    beta = torch.randn(c, generator=g, device=device).to(dtype)
    args = (x, gamma, beta, 32, eps)
    got = groupnorm_kernel.group_norm_silu(*args)
    _checked(got, groupnorm_kernel.group_norm_silu_plain(*args), f"K6 {shape}",
             BF16_TOL if dtype == BF16 else F32_TOL)
    xc = x.movedim(-1, 1).contiguous()
    yard = cuda_ms(lambda: F.silu(F.group_norm(xc, 32, gamma, beta, eps))) * 1e3
    return {**_both(lambda: groupnorm_kernel.group_norm_silu(*args)), "yardstick_held_us": yard,
            "sha256": sha256(got)}


def _sum(rows, tag, value) -> float:
    """ms of one forward: each shape's us weighed by its calls in ``tag``."""
    return sum(r["calls"].get(tag, 0) * value(r) for r in rows) * 1e-3


def per_forward(rows_k2, rows_k3, rows_k1=(), rows_k4=(), rows_k1q=(), rows_k3q=(),
                rows_k5=(), rows_k4q=(), rows_k1f32=(), rows_k6=()) -> dict:
    """ms per forward: K1 (whole, stats, conv, yardstick), K3, K4 (whole,
    yardstick), K2 as the UNet calls it (fused calls on the views, the rest
    on contiguous tensors) and K2 on contiguous tensors throughout, each
    with and without the hold (the yardsticks held only); on the full8
    forward K1q (whole, stats, conv), K3q, K5 and K4q, their bf16 siblings
    held and K5's and K4q's shared-core design held; the f32 K1 (whole,
    stats, conv, yardstick) on the sr path's encode; K6 (and its yardstick)
    on each forward that calls it."""
    out = {}
    tag = INT8_FORWARD[0]
    if rows_k1q or rows_k3q or rows_k5 or rows_k4q:
        row = {}
        for key in ("held_us", "unheld_us"):
            k = key[:-3]
            for part in ("whole", "stats", "conv") if rows_k1q else ():
                row[f"k1q_{part}_{k}_ms"] = _sum(rows_k1q, tag, lambda r: r[part][key])
            for name, rows in (("k3q", rows_k3q), ("k5", rows_k5), ("k4q", rows_k4q)):
                if rows:
                    row[f"{name}_{k}_ms"] = _sum(rows, tag, lambda r: r[key])
        for name, rows in (("k1q", rows_k1q), ("k3q", rows_k3q), ("k5", rows_k5),
                           ("k4q", rows_k4q)):
            if rows and "sibling_held_us" in rows[0]:
                row[f"{name}_bf16_sibling_held_ms"] = _sum(rows, tag,
                                                           lambda r: r["sibling_held_us"])
            if rows and "shared_core_held_us" in rows[0]:
                row[f"{name}_shared_core_held_ms"] = _sum(rows, tag,
                                                          lambda r: r["shared_core_held_us"])
        if rows_k1q and "sibling_conv_held_us" in rows_k1q[0]:
            row["k1q_bf16_sibling_conv_held_ms"] = _sum(rows_k1q, tag,
                                                        lambda r: r["sibling_conv_held_us"])
        out[tag] = row
    for tag in [f[0] for f in FORWARDS] + [VAE_FORWARD[0]]:
        row = {}
        for key in ("held_us", "unheld_us"):
            k = key[:-3]
            if rows_k1:
                for part in ("whole", "stats", "conv"):
                    row[f"k1_{part}_{k}_ms"] = _sum(rows_k1, tag, lambda r: r[part][key])
            if tag == VAE_FORWARD[0] or not (rows_k2 or rows_k3):
                continue
            row[f"k3_{k}_ms"] = _sum(rows_k3, tag, lambda r: r[key])
            if rows_k4:
                row[f"k4_{k}_ms"] = _sum(rows_k4, tag, lambda r: r[key])
            row[f"k2_as_called_{k}_ms"] = sum(
                r["calls"].get(tag, (0, 0))[0] * r["views"][key]
                + r["calls"].get(tag, (0, 0))[1] * r["contiguous"][key] for r in rows_k2) * 1e-3
            row[f"k2_contiguous_{k}_ms"] = sum(
                sum(r["calls"].get(tag, (0, 0))) * r["contiguous"][key] for r in rows_k2) * 1e-3
        for name, rows in (("k1", rows_k1), ("k4", rows_k4)):
            if rows and (name == "k1" or tag != VAE_FORWARD[0]):
                row[f"{name}_yardstick_held_ms"] = _sum(rows, tag,
                                                        lambda r: r["yardstick_held_us"])
        out[tag] = row
    for tag in [f[0] for f in FORWARDS + (VAE_FORWARD, ENCODE_FORWARD) + DECODE_K6]:
        row = out.setdefault(tag, {})
        for key in ("held_us", "unheld_us"):
            k = key[:-3]
            if rows_k1f32 and tag == ENCODE_FORWARD[0]:
                for part in ("whole", "stats", "conv"):
                    row[f"k1f32_{part}_{k}_ms"] = _sum(rows_k1f32, tag, lambda r: r[part][key])
            if rows_k6:
                row[f"k6_{k}_ms"] = _sum(rows_k6, tag, lambda r: r[key])
        for name, rows in (("k1f32", rows_k1f32), ("k6", rows_k6)):
            if rows and (name == "k6" or tag == ENCODE_FORWARD[0]):
                row[f"{name}_yardstick_held_ms"] = _sum(rows, tag,
                                                        lambda r: r["yardstick_held_us"])
        if not row:
            del out[tag]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write the shapes and every time to this file")
    ap.add_argument("--shapes-from", help="take the shapes from this JSON of an earlier run")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the comparison with the plain versions (an ablation's timing)")
    ap.add_argument("--only", help="time these kernels only, comma-separated (e.g. k5,k4q)")
    args = ap.parse_args(argv)
    global CHECK_PLAIN
    CHECK_PLAIN = not args.no_check
    if not torch.cuda.is_available():
        print("time_k2_k3: no CUDA device", file=sys.stderr)
        return 2
    if args.shapes_from:
        with open(args.shapes_from) as f:
            shapes = json.load(f)["shapes"]
    else:
        shapes = main_path_shapes()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    timers = {"k1": time_k1, "k2": time_k2, "k3": time_k3, "k4": time_k4, "k1q": time_k1q,
              "k3q": time_k3q, "k5": time_k5, "k4q": time_k4q, "k1f32": time_k1f32,
              "k6": time_k6}
    rows = {key: [] for key in timers}
    if args.only:
        timers = {k: v for k, v in timers.items() if k in args.only.split(",")}
    with torch.inference_mode():
        for key, timer in timers.items():
            for shape, calls in shapes.get(key, []):
                row = {"shape": shape, "calls": calls, **timer(tuple(shape), "cuda")}
                rows[key].append(row)
                if key == "k2":
                    times = (f"contiguous {row['contiguous']['held_us']:.1f} us held, "
                             f"{row['contiguous']['unheld_us']:.1f} unheld; views "
                             f"{row['views']['held_us']:.1f} held, "
                             f"{row['views']['unheld_us']:.1f} unheld")
                elif key in ("k1", "k1q", "k1f32"):
                    times = ", ".join(f"{part} {row[part]['held_us']:.1f} us held, "
                                      f"{row[part]['unheld_us']:.1f} unheld"
                                      for part in ("whole", "stats", "conv"))
                    if key != "k1q":
                        times += f"; cuDNN conv alone {row['yardstick_held_us']:.1f} us held"
                else:
                    times = f"{row['held_us']:.1f} us held, {row['unheld_us']:.1f} unheld"
                    if "yardstick_held_us" in row:
                        alone = "F.group_norm + F.silu" if key == "k6" else "matmul alone"
                        times += f"; {alone} {row['yardstick_held_us']:.1f} us held"
                if "sibling_held_us" in row:
                    sibling = "cuBLAS linear" if key == "k5" else key[:2].upper()
                    times += (f"; bf16 {sibling} at this shape "
                              f"{row['sibling_held_us']:.1f} us held")
                if "shared_core_held_us" in row:
                    times += f"; shared core {row['shared_core_held_us']:.1f} us held"
                print(f"{key.upper()} {tuple(shape)} calls {calls}: {times}", flush=True)
    sums = per_forward(rows["k2"], rows["k3"], rows["k1"], rows["k4"], rows["k1q"], rows["k3q"],
                       rows["k5"], rows["k4q"], rows["k1f32"], rows["k6"])
    for tag, row in sums.items():
        print(f"{tag} forward, ms: " + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in row.items()))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": card, "shapes": shapes, **rows, "per_forward": sums}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
