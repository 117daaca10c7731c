"""Sweep the launch parameters of the bf16 LayerNorm + matmul kernel (K3) on
the card, beside the plan's own pick and the shared GEMM core.

For every (M, C, N) that one UNet forward of the t5 and large-1150k configs
gives K3 (``unet.ln_matmul_shapes`` at CFG batch 2 and 6), every (rows per
block, N-tile width) the kernel is built for, a range of strip lengths and
ring depths: device time of one call through the C entry point, checked
against the plain version first. Printed per shape: the pick of
``_build.ln_matmul_plan`` with its time, the fastest choices, the fastest
choice that fills min(SMs, row blocks x N tiles) blocks, and the shared
core's time for the same call (``lnmm_kernel._ln``, what K3 ran before it
had a kernel of its own). The constants of the plan's cost model
(``_build._LNMM_*``) were fitted to this table; refit them after a change
to the kernel's main loop.

Usage (on a machine with an NVIDIA GPU):
  python -m audioldm2_torch.tools.tune_ln_matmul [--json OUT.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import audioldm2_torch as at
from audioldm2_torch.models import unet
from audioldm2_torch.ops import _build, lnmm_kernel
from audioldm2_torch.tools.timing import cuda_ms

CONFIGS = (("audioldm_16k_crossattn_t5", 2), ("audioldm2-full-large-1150k", 6))
STRIPS = (1, 2, 3, 4, 6, 8)
STAGES = (3, 4, 6, 8, 10, 12)
BF16_TOL = 2e-2


def main_path_shapes():
    shapes = []
    for name, batch in CONFIGS:
        cfg = at.default_audioldm_config(name)
        shapes += sorted(unet.ln_matmul_shapes(cfg.unet, batch, cfg.latent_t_size,
                                               cfg.latent_f_size), reverse=True)
    return shapes


def sweep(m: int, c: int, n: int, device, reps: int):
    """[(ms, bm, bn, strip_tiles, stages, blocks)] sorted by time, the plan's
    pick and the shared core's ms, for one shape."""
    g = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape, dt=torch.float32, scale=1.0, offset=0.0):
        return (torch.randn(shape, generator=g, device=device) * scale + offset).to(dt)

    bf16 = torch.bfloat16
    x = rnd(1, m, c, dt=bf16, offset=3.0)
    gamma, beta, bias = rnd(c), rnd(c), rnd(n)
    w = rnd(c, n, dt=bf16, scale=c ** -0.5)
    want = lnmm_kernel.ln_matmul_plain(x, gamma, beta, w, bias, 1e-5).float()
    out = torch.empty((1, m, n), device=device, dtype=bf16)
    lib = _build.lib()
    sms = _build.sm_count(torch.device(device).index or 0)
    k_tiles = -(-c // _build.LNMM_BK)
    rows = []
    for bm, bn in _build.LNMM_TILES:
        n_tiles = -(-n // bn)
        a_bytes = bm * (k_tiles * _build.LNMM_BK + _build.LNMM_PAD) * 2
        for strip in sorted({s for s in (*STRIPS, n_tiles) if s <= n_tiles}):
            for stages in STAGES:
                smem = a_bytes + stages * _build.LNMM_BK * (bn + _build.LNMM_PAD) * 2
                if smem > _build.LNMM_MAX_SMEM or stages > max(2, strip * k_tiles):
                    continue

                def call():
                    _build.check(lib.a2k_ln_matmul_bf16(
                        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
                        bias.data_ptr(), 0, out.data_ptr(), m, c, n, 1e-5, bm, bn, strip,
                        stages, _build.stream_of(x)), "ln_matmul")

                call()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item() / want.abs().max().item()
                if err > BF16_TOL:
                    raise AssertionError(f"{(m, c, n)} {(bm, bn, strip, stages)}: rel {err:.3e}")
                blocks = -(-m // bm) * -(-n_tiles // strip)
                fills = blocks >= min(sms, -(-m // bm) * n_tiles)
                rows.append((cuda_ms(call, reps), bm, bn, strip, stages, blocks, fills))
    rows.sort()
    plan = _build.ln_matmul_plan(m, c, n, sms)
    plan_ms = cuda_ms(lambda: lnmm_kernel.ln_matmul(x, gamma, beta, w, bias, 1e-5), reps)
    core_ms = cuda_ms(lambda: lnmm_kernel._ln("ln_matmul", x, gamma, beta, w, None, bias, 1e-5),
                      reps)
    return rows, plan, plan_ms, core_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="timed calls per choice")
    ap.add_argument("--json", help="write every row of every shape to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_ln_matmul: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}, {_build.sm_count(0)} SMs")
    table = {}
    for m, c, n in main_path_shapes():
        rows, plan, plan_ms, core_ms = sweep(m, c, n, "cuda", args.reps)
        table[str((m, c, n))] = rows
        full = next(r for r in rows if r[6])
        print(f"{(m, c, n)}: plan {(plan.bm, plan.bn, plan.strip_tiles, plan.stages)} on "
              f"{plan.grid[0] * plan.grid[1]} blocks {plan_ms * 1e3:.1f} us; shared core "
              f"{core_ms * 1e3:.1f} us; fastest with every SM it could fill "
              f"{full[0] * 1e3:.1f} us {full[1:6]}; fastest:")
        for ms, *choice in rows[:3]:
            print(f"    {ms * 1e3:7.1f} us  (bm, bn, strip, stages, blocks) = {tuple(choice[:5])}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(table, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
