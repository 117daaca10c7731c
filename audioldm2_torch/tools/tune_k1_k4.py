"""Sweep the launch parameters of the bf16 K1 conv (GroupNorm + SiLU + 3x3
conv), the bf16 K4 kernel (GEGLU + matmul) and the int8-weight K1q, K3q,
K5 and K4q on the same kernels on the card, beside the plans' own picks.

For every shape one forward gives them (``unet.conv_shapes`` and
``unet.geglu_matmul_shapes`` of the t5 UNet at CFG batch 2 and the
large-1150k UNet at CFG batch 6, and ``vae.decode_conv_shapes`` of the t5
VAE decoder at batch 1): device time of one call through the C entry point
for every tile the kernel is built for and a range of splits (K1), strip
lengths and ring depths, each checked against the plain version first. K1
is timed without its statistics pass, which the choice does not touch.
Printed per shape: the plan's pick (``_build.gn_silu_conv_plan``,
``_build.geglu_matmul_plan``) with its time and the fastest choices. The
plans' cost constants (``_build._CONV_*``, ``_GEGLU_COST`` and the tile
costs) are set against this table.

K1q and K3q (``--only k1q|k3q``): every shape of the audioldm2-full UNet
in the int8 serving mode at CFG batch 2 (``weight_quant="int8"`` of the
shape functions), through ``a2k_gn_silu_conv3x3_q_bf16`` (tile, split,
strip, ring depth) and ``a2k_ln_matmul_q_bf16`` (rows per block, N tile,
strip, ring depth), beside the plans' picks with ``w_bytes=1``; their
constants (``_CONV_Q_MODEL``, ``_Q_CVT_COST``, ``_Q_TILE_BARRIER_COST``,
``LNMMQ_RING_STAGES``) are set against this table.

K5 and K4q (``--only k5|k4q``): the same full8 forward's shapes
(``unet.int8_matmul_shapes``, ``unet.geglu_matmul_shapes(...,
weight_quant="int8")``) through ``a2k_int8_matmul_bf16`` and
``a2k_geglu_matmul_q_bf16`` over K4's tiles, cluster splits, strips and
int8 ring depths, beside ``_build.int8_matmul_plan`` and
``geglu_matmul_plan(..., w_bytes=1)``; their tile costs (``_K5_TILE_COST``,
``_GEGLU_Q_TILE_COST``) are set against this table.

K1 in f32 (``--only k1f32``): the five shapes of one full-width VAE encode
(``vae.encode_conv_shapes``, the sr path) through ``a2k_gn_silu_conv3x3_f32``
(3xTF32; its one tile ``_build.CONV32_TILE``: split, strip, ring depth)
beside ``_build.gn_silu_conv_plan(..., dtype="f32")``, each choice held to
the f32 bar of the plain version; ``_CONV_F32_MODEL`` is set against this
table.

K6 (``--only k6``): its main-path calls (``time_k2_k3.main_path_shapes``)
through ``a2k_group_norm_silu`` on grids of 8 to 132 blocks (blocks per
sample, each a run of rows resident in shared memory) beside
``_build.group_norm_silu_plan``'s; ``GN_BLOCK_BYTES`` is set against this
table.

Usage (on a machine with an NVIDIA GPU):
  python -m audioldm2_torch.tools.tune_k1_k4 [--json OUT.json]
      [--only k1|k4|k1q|k3q|k5|k4q|k1f32|k6]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import audioldm2_torch as at
from audioldm2_torch.models import unet, vae
from audioldm2_torch.ops import _build, lnmm_kernel, resblock_kernel
from audioldm2_torch.tools.timing import cuda_ms

FORWARDS = (("audioldm_16k_crossattn_t5", 2), ("audioldm2-full-large-1150k", 6))
INT8_FORWARD = ("audioldm2-full", 2)
Q_STAGES = (2, 3, 4, 6, 8, 12)  # K3q's ring depths where the ring does not hold the strip
STAGES = (2, 3, 4, 6)    # K4's ring depths; K1's are _build.CONV_STAGES
STRIPS = (1, 2, 3, 4, 6)
BF16_TOL = 2e-2
F32_TOL = 1e-4
BF16 = torch.bfloat16


def main_path_shapes():
    """(K1 shapes (B, T, F, C1, C2, Cout), K4 shapes (M, F, N)), largest first."""
    k1, k4 = set(), set()
    for name, batch in FORWARDS:
        cfg = at.default_audioldm_config(name)
        size = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
        k1 |= set(unet.conv_shapes(*size))
        k4 |= set(unet.geglu_matmul_shapes(*size))
    cfg = at.default_audioldm_config(FORWARDS[0][0])
    k1 |= set(vae.decode_conv_shapes(cfg.vae, 1, cfg.latent_t_size, cfg.latent_f_size))
    return sorted(k1, reverse=True), sorted(k4, reverse=True)


def int8_shapes():
    """(K1q shapes, K3q shapes (M, C, N), K5 shapes (M, K, N), K4q shapes
    (M, F, N)) of the full8 forward, largest first."""
    name, batch = INT8_FORWARD
    cfg = at.default_audioldm_config(name)
    size = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
    return (sorted(unet.conv_shapes(*size, weight_quant="int8"), reverse=True),
            sorted(unet.ln_matmul_shapes(*size, weight_quant="int8"), reverse=True),
            sorted(unet.int8_matmul_shapes(*size), reverse=True),
            sorted(unet.geglu_matmul_shapes(*size, weight_quant="int8"), reverse=True))


def encode_shapes():
    """The f32 K1 shapes of one 10 s VAE encode of audioldm2-full, largest
    first."""
    cfg = at.default_audioldm_config(INT8_FORWARD[0])
    frames = int(10.0 * cfg.latent_t_per_second * cfg.vae.downsample_factor)
    return sorted(vae.encode_conv_shapes(cfg.vae, 1, frames, cfg.preprocessing.n_mel_channels),
                  reverse=True)


def k6_shapes():
    """K6's main-path calls [(B, T, F, C, dtype, eps), {forward: calls}]."""
    from audioldm2_torch.tools import time_k2_k3

    return time_k2_k3.main_path_shapes()["k6"]


def _int8(g, *dims):
    wq = torch.randint(-127, 128, dims, generator=g, device="cuda").to(torch.int8)
    return wq, torch.rand(dims[-1], generator=g, device="cuda") * 0.01 + 1e-3


def _rnd(g, *dims, scale=1.0, offset=0.0):
    return (torch.randn(dims, generator=g, device="cuda") * scale + offset).to(BF16)


def _timed(call, out, want, what, reps, tol=BF16_TOL):
    call()
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item() / want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: rel {err:.3e}")
    return cuda_ms(call, reps)


def sweep_k1(shape, reps, int8=False, f32=False):
    """[(us, choice)] sorted by time and the plan's pick, for one K1 (with
    int8, K1q; with f32, the f32 kernel) shape; choice = (bm, bn, strip,
    stages, splits)."""
    b, t, f, c1, c2, cout = shape
    cin = c1 + c2
    w_bytes = 1 if int8 else 2
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.float32 if f32 else BF16

    def rnd(*dims, scale=1.0, offset=0.0):
        if f32:
            return torch.randn(dims, generator=g, device="cuda") * scale + offset
        return _rnd(g, *dims, scale=scale, offset=offset)

    x1 = rnd(b, t, f, c1, offset=1.0)
    x2 = rnd(b, t, f, c2) if c2 else None
    gamma, beta = rnd(cin, offset=1.0), rnd(cin)
    if int8:
        (w, ws), bias = _int8(g, 3, 3, cin, cout), _rnd(g, cout)
        want = resblock_kernel.gn_silu_conv3x3_q_plain(x1, x2, gamma, beta, w, ws, bias).float()
    else:
        w, bias = rnd(3, 3, cin, cout, scale=(9 * cin) ** -0.5), rnd(cout)
        want = resblock_kernel.gn_silu_conv3x3_plain(x1, x2, gamma, beta, w, bias).float()
    a, c = resblock_kernel.gn_stats(x1, x2, gamma, beta)
    out = torch.empty((b, t, f, cout), device="cuda", dtype=dt)
    lib, sms = _build.lib(), _build.sm_count(0)
    k_chunks = -(-cin // (_build.CONV32_CK if f32 else _build.CONV_CK))
    p = _build.gn_silu_conv_plan(b, t, f, cin, cout, sms, "f32" if f32 else "bf16", w_bytes)
    pick = (p.bm, p.bn, p.strip_tiles, p.stages, p.splits)
    choices = {pick}
    for bm, bn in (_build.CONV32_TILE,) if f32 else _build.CONV_TILES:
        ft = min(f, bm)
        tt = min(bm // ft, t)
        n_tiles = -(-cout // bn)
        for asked in range(1, min(_build.CONV_MAX_SPLITS, k_chunks) + 1):
            splits = -(-k_chunks // -(-k_chunks // asked))
            for strip in {s for s in (*STRIPS, n_tiles) if s <= n_tiles} if splits == 1 else (1,):
                for stages in _build.CONV_STAGES:
                    smem = (_build.conv32_smem_bytes(bm, bn, tt, ft, stages) if f32 else
                            _build.conv_smem_bytes(bm, bn, tt, ft, stages, w_bytes))
                    if smem <= _build.LNMM_MAX_SMEM:
                        choices.add((bm, bn, strip, stages, splits))
    rows = []
    for bm, bn, strip, stages, splits in choices:
        ft = min(f, bm)
        tt = min(bm // ft, t)

        def call(bm=bm, bn=bn, tt=tt, ft=ft, strip=strip, stages=stages, splits=splits):
            head = (x1.data_ptr(), None if x2 is None else x2.data_ptr(), a.data_ptr(),
                    c.data_ptr(), w.data_ptr())
            tail = (bias.data_ptr(), int(not f32), out.data_ptr(), b, t, f, c1, c2, cout, bm, bn,
                    tt, ft, strip, stages, splits, _build.stream_of(x1))
            if int8:
                rc = lib.a2k_gn_silu_conv3x3_q_bf16(*head, ws.data_ptr(), *tail)
            elif f32:
                rc = lib.a2k_gn_silu_conv3x3_f32(*head, *tail)
            else:
                rc = lib.a2k_gn_silu_conv3x3_bf16(*head, *tail)
            _build.check(rc, "gn_silu_conv3x3")

        choice = (bm, bn, strip, stages, splits)
        what = f"K1{'q' if int8 else ' f32' if f32 else ''} {shape} {choice}"
        rows.append((_timed(call, out, want, what, reps, F32_TOL if f32 else BF16_TOL) * 1e3,
                     choice))
    rows.sort()
    return rows, pick


def sweep_k6(shape, reps):
    """[(us, choice)] sorted by time and the plan's pick, for one K6 call
    (B, T, F, C, dtype, eps); choice = (blocks per sample,)."""
    from audioldm2_torch.ops import groupnorm_kernel

    bsz, t, f, c, dt, eps = shape
    dtype = BF16 if dt == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((bsz, t, f, c), generator=g, device="cuda") + 1.0).to(dtype)
    gamma = (torch.randn(c, generator=g, device="cuda") + 1.0).to(dtype)
    beta = torch.randn(c, generator=g, device="cuda").to(dtype)
    want = groupnorm_kernel.group_norm_silu_plain(x, gamma, beta, 32, eps).float()
    out = torch.empty_like(x)
    s = t * f
    lib, sms = _build.lib(), _build.sm_count(0)
    p = _build.group_norm_silu_plan(bsz, s, c, dt, sms)
    code, pcode = _build.dtype_code(x), int(dtype == BF16)
    stream = _build.stream_of(x)
    part, bar = _build.gn_partials(0, stream), _build.gn_barrier(0, stream)
    rows_by_nb = {}
    for total in (8, 16, 22, 33, 44, 66, 96, 132):
        nb = max(1, min(total, sms) // bsz)
        rows = -(-s // nb)
        nb = -(-s // rows)
        if _build.gn_silu_smem_bytes(rows, c, 32, x.element_size(), True) <= _build.GN_MAX_SMEM:
            rows_by_nb[nb] = (rows, rows)
    rows_by_nb[p.blocks_per_sample] = (p.rows, p.rows_held)
    rows = []
    for nb, (r, held) in sorted(rows_by_nb.items()):
        def call(nb=nb, r=r, held=held):
            _build.check(lib.a2k_group_norm_silu(
                x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), pcode, out.data_ptr(), bsz, s, c,
                32, eps, 1, bsz, nb, r, held, 1, part.data_ptr(), bar.data_ptr(), code, stream),
                "group_norm_silu")

        tol = BF16_TOL if dtype == BF16 else F32_TOL
        rows.append((_timed(call, out, want, f"K6 {shape} {nb}", reps, tol) * 1e3, (nb,)))
    rows.sort()
    return rows, (p.blocks_per_sample,)


def _thin_choices(pick, k, n, w_bytes, stage_choices):
    """Every (bm, bn, strip, stages, splits) of K4's tiles whose block fits."""
    k_tiles = -(-k // _build.LNMM_BK)
    choices = {pick}
    for bm, bn in _build.GEGLU_TILES:
        n_tiles = -(-n // bn)
        for asked in range(1, min(_build.GEGLU_MAX_SPLITS, k_tiles) + 1):
            kps = -(-k_tiles // asked)
            splits = -(-k_tiles // kps)
            for strip in {s for s in (*STRIPS, n_tiles) if s <= n_tiles} if splits == 1 else (1,):
                for stages in stage_choices(strip * kps):
                    if _build.row_block_smem(bm, bn, kps * _build.LNMM_BK, stages, w_bytes,
                                             splits) <= _build.LNMM_MAX_SMEM:
                        choices.add((bm, bn, strip, stages, splits))
    return choices


def _q_stages(total):
    """int8 ring depths: the whole strip where it fits, else the sweep's."""
    return {max(2, min(total, 12)), *(s for s in Q_STAGES if s < total)}


def sweep_k4(shape, reps, int8=False):
    """[(us, choice)] sorted by time and the plan's pick, for one K4 (or,
    with int8, K4q) shape; choice = (bm, bn, strip, stages, splits)."""
    m, f, n = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    h = _rnd(g, m, 2 * f)
    if int8:
        w, ws = _int8(g, f, n)
    else:
        w = _rnd(g, f, n, scale=f ** -0.5)
    bias, res = _rnd(g, n), _rnd(g, m, n)
    if int8:
        want = lnmm_kernel.geglu_matmul_q_plain(h, w, ws, bias, res).float()
    else:
        want = lnmm_kernel.geglu_matmul_plain(h, w, bias, res).float()
    out = torch.empty((m, n), device="cuda", dtype=BF16)
    lib, sms = _build.lib(), _build.sm_count(0)
    p = _build.geglu_matmul_plan(m, f, n, sms, w_bytes=1 if int8 else 2)
    pick = (p.bm, p.bn, p.strip_tiles, p.stages, p.splits)
    choices = _thin_choices(pick, f, n, 1 if int8 else 2,
                            _q_stages if int8 else lambda total: STAGES)
    rows = []
    for bm, bn, strip, stages, splits in choices:
        def call(bm=bm, bn=bn, strip=strip, stages=stages, splits=splits):
            tail = (bias.data_ptr(), 1, res.data_ptr(), out.data_ptr(), m, f, n, bm, bn, strip,
                    stages, splits, _build.stream_of(h))
            if int8:
                rc = lib.a2k_geglu_matmul_q_bf16(h.data_ptr(), w.data_ptr(), ws.data_ptr(), *tail)
            else:
                rc = lib.a2k_geglu_matmul_bf16(h.data_ptr(), w.data_ptr(), *tail)
            _build.check(rc, "geglu_matmul")

        choice = (bm, bn, strip, stages, splits)
        what = f"K4{'q' if int8 else ''} {shape} {choice}"
        rows.append((_timed(call, out, want, what, reps) * 1e3, choice))
    rows.sort()
    return rows, pick


def sweep_k5(shape, reps):
    """[(us, choice)] sorted by time and the plan's pick, for one K5 shape;
    choice = (bm, bn, strip, stages, splits)."""
    m, k, n = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    x = _rnd(g, m, k)
    (wq, ws), bias = _int8(g, k, n), _rnd(g, n)
    want = lnmm_kernel.int8_matmul_plain(x, wq, ws, bias).float()
    out = torch.empty((m, n), device="cuda", dtype=BF16)
    lib, sms = _build.lib(), _build.sm_count(0)
    p = _build.int8_matmul_plan(m, k, n, sms)
    pick = (p.bm, p.bn, p.strip_tiles, p.stages, p.splits)
    rows = []
    for bm, bn, strip, stages, splits in _thin_choices(pick, k, n, 1, _q_stages):
        def call(bm=bm, bn=bn, strip=strip, stages=stages, splits=splits):
            _build.check(lib.a2k_int8_matmul_bf16(
                x.data_ptr(), wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), 1, out.data_ptr(),
                m, k, n, bm, bn, strip, stages, splits, _build.stream_of(x)), "int8_matmul")

        choice = (bm, bn, strip, stages, splits)
        rows.append((_timed(call, out, want, f"K5 {shape} {choice}", reps) * 1e3, choice))
    rows.sort()
    return rows, pick


def sweep_k3q(shape, reps):
    """[(us, choice)] sorted by time and the plan's pick, for one K3q shape;
    choice = (bm, bn, strip, stages)."""
    m, c, n = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    x, gamma, beta = _rnd(g, m, c, offset=3.0), _rnd(g, c), _rnd(g, c)
    (wq, ws), bias = _int8(g, c, n), _rnd(g, n)
    want = lnmm_kernel.ln_matmul_q_plain(x, gamma, beta, wq, ws, bias).float()
    out = torch.empty((m, n), device="cuda", dtype=BF16)
    lib, sms = _build.lib(), _build.sm_count(0)
    k_tiles = -(-c // _build.LNMM_BK)
    p = _build.ln_matmul_plan(m, c, n, sms, 1)
    pick = (p.bm, p.bn, p.strip_tiles, p.stages)
    choices = {pick}
    for bm, bn in _build.LNMM_TILES:
        n_tiles = -(-n // bn)
        for strip in {s for s in (*STRIPS, n_tiles) if s <= n_tiles}:
            total = strip * k_tiles
            for stages in {min(total, 12), *(s for s in Q_STAGES if s < total)}:
                stages = max(2, stages)
                if _build.row_block_smem(bm, bn, k_tiles * _build.LNMM_BK, stages,
                                         1) <= _build.LNMM_MAX_SMEM:
                    choices.add((bm, bn, strip, stages))
    rows = []
    for bm, bn, strip, stages in choices:
        def call(bm=bm, bn=bn, strip=strip, stages=stages):
            _build.check(lib.a2k_ln_matmul_q_bf16(
                x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                bias.data_ptr(), 1, out.data_ptr(), m, c, n, 1e-5, bm, bn, strip, stages,
                _build.stream_of(x)), "ln_matmul_q")

        choice = (bm, bn, strip, stages)
        rows.append((_timed(call, out, want, f"K3q {shape} {choice}", reps) * 1e3, choice))
    rows.sort()
    return rows, pick


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10, help="timed calls per choice")
    ap.add_argument("--json", help="write every row of every shape to this file")
    ap.add_argument("--only", choices=("k1", "k4", "k1q", "k3q", "k5", "k4q", "k1f32", "k6"),
                    help="sweep one kernel only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_k1_k4: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}, {_build.sm_count(0)} SMs")
    torch.backends.cudnn.allow_tf32 = False  # the f32 plain version: a full-precision oracle
    torch.backends.cuda.matmul.allow_tf32 = False
    k1, k4 = main_path_shapes()
    k1q, k3q, k5, k4q = int8_shapes()
    table = {}
    with torch.inference_mode():
        for key, shapes, sweep in (("k1", k1, sweep_k1), ("k4", k4, sweep_k4),
                                   ("k1q", k1q, lambda s, r: sweep_k1(s, r, int8=True)),
                                   ("k3q", k3q, sweep_k3q), ("k5", k5, sweep_k5),
                                   ("k4q", k4q, lambda s, r: sweep_k4(s, r, int8=True)),
                                   ("k1f32", encode_shapes(),
                                    lambda s, r: sweep_k1(s, r, f32=True)),
                                   ("k6", [tuple(sh) for sh, _ in k6_shapes()], sweep_k6)):
            if args.only not in (None, key):
                continue
            for shape in shapes:
                rows, pick = sweep(shape, args.reps)
                pick_us = next(us for us, choice in rows if choice == pick)
                table[f"{key} {shape}"] = {"pick": pick, "rows": rows}
                print(f"{key.upper()} {shape}: plan {pick} {pick_us:.1f} us, fastest "
                      f"{rows[0][0]:.1f} us {rows[0][1]} (plan / fastest "
                      f"{pick_us / rows[0][0]:.2f}); next "
                      + ", ".join(f"{us:.1f} {choice}" for us, choice in rows[1:3]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(table, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
