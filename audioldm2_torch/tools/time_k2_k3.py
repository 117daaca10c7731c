"""Time K2 (flash self-attention) and K3 (LayerNorm + matmul) on the card at
every shape one UNet forward gives them, call by call and summed per
forward, so that two trees of the package can be compared under one timer.

For the t5 UNet at CFG batch 2 and the large-1150k UNet at CFG batch 6
(``unet.self_attention_shapes`` and ``unet.ln_matmul_shapes`` on the 10 s
latent), in bf16, through the public wrappers:
  K2  on contiguous q, k, v and on the strided chunks of one fused
      [B, T, 3 * H * D] projection, which is what the UNet hands it at most
      calls (a tree whose wrapper copies them pays for the copies here);
  K3  with bf16 LN parameters, as the cast parameter tree holds them, and a
      bias where the UNet has one (the GEGLU proj_in, N = 8C).
Each call is checked against its plain version first, then timed twice with
``timing.cuda_ms``: with the device held while the host queues the calls
(device time) and without the hold (a call shorter than its launch then
reads as the host's launch rate).

To time an earlier tree at the same shapes, copy this file and ``timing.py``
into that tree's ``audioldm2_torch/tools/`` and pass this tree's JSON with
``--shapes-from`` (an earlier tree may lack the two shape functions).

Usage (on a machine with an NVIDIA GPU):
  python -m audioldm2_torch.tools.time_k2_k3 --json OUT.json
  python -m audioldm2_torch.tools.time_k2_k3 --shapes-from OUT.json --json OLD.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from audioldm2_torch.ops import attention_kernel, lnmm_kernel
from audioldm2_torch.tools.timing import cuda_ms

FORWARDS = (("t5", "audioldm_16k_crossattn_t5", 2), ("large", "audioldm2-full-large-1150k", 6))
BF16_TOL = 2e-2


def main_path_shapes() -> dict:
    """{"k2": [[shape, {forward: [fused calls, separate calls]}]],
    "k3": [[shape, {forward: calls}]]} from this tree's configs."""
    import audioldm2_torch as at
    from audioldm2_torch.models import unet

    k2, k3 = {}, {}
    for tag, name, batch in FORWARDS:
        cfg = at.default_audioldm_config(name)
        size = (cfg.unet, batch, cfg.latent_t_size, cfg.latent_f_size)
        for shape, calls in unet.self_attention_shapes(*size).items():
            k2.setdefault(shape, {})[tag] = list(calls)
        for shape, calls in unet.ln_matmul_shapes(*size).items():
            k3.setdefault(shape, {})[tag] = calls
    return {"k2": [[list(s), c] for s, c in sorted(k2.items(), reverse=True)],
            "k3": [[list(s), c] for s, c in sorted(k3.items(), reverse=True)]}


def _checked(got, want, what):
    err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    if not err <= BF16_TOL:
        raise AssertionError(f"{what}: rel {err:.3e} > {BF16_TOL}")


def _both(fn) -> dict:
    return {"held_us": cuda_ms(fn) * 1e3, "unheld_us": cuda_ms(fn, hold=False) * 1e3}


def time_k2(shape, device) -> dict:
    b, t, h, d = shape
    g = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=device).to(torch.bfloat16)
    views = tuple(x.reshape(b, t, h, d) for x in torch.chunk(qkv, 3, dim=-1))
    dense = tuple(v.contiguous() for v in views)
    scale = d ** -0.5
    want = attention_kernel.self_attention_plain(*dense, scale)
    out = {}
    for tag, args in (("contiguous", dense), ("views", views)):
        _checked(attention_kernel.flash_self_attention(*args, scale), want, f"K2 {shape} {tag}")
        out[tag] = _both(lambda: attention_kernel.flash_self_attention(*args, scale))
    return out


def time_k3(shape, device) -> dict:
    m, c, n = shape
    g = torch.Generator(device=device).manual_seed(0)

    def rnd(*dims, scale=1.0, offset=0.0):
        return (torch.randn(dims, generator=g, device=device) * scale + offset).to(torch.bfloat16)

    args = (rnd(1, m, c, offset=3.0), rnd(c), rnd(c), rnd(c, n, scale=c ** -0.5),
            rnd(n) if n == 8 * c else None, 1e-5)
    _checked(lnmm_kernel.ln_matmul(*args), lnmm_kernel.ln_matmul_plain(*args), f"K3 {shape}")
    return _both(lambda: lnmm_kernel.ln_matmul(*args))


def per_forward(rows_k2, rows_k3) -> dict:
    """ms per UNet forward: K3, K2 as the UNet calls it (fused calls on the
    views, the rest on contiguous tensors) and K2 on contiguous tensors
    throughout, each with and without the hold."""
    out = {}
    for tag, _, _ in FORWARDS:
        row = {}
        for key in ("held_us", "unheld_us"):
            row[f"k3_{key[:-3]}_ms"] = sum(
                r["calls"].get(tag, 0) * r[key] for r in rows_k3) * 1e-3
            row[f"k2_as_called_{key[:-3]}_ms"] = sum(
                r["calls"].get(tag, (0, 0))[0] * r["views"][key]
                + r["calls"].get(tag, (0, 0))[1] * r["contiguous"][key] for r in rows_k2) * 1e-3
            row[f"k2_contiguous_{key[:-3]}_ms"] = sum(
                sum(r["calls"].get(tag, (0, 0))) * r["contiguous"][key] for r in rows_k2) * 1e-3
        out[tag] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write the shapes and every time to this file")
    ap.add_argument("--shapes-from", help="take the shapes from this JSON of an earlier run")
    args = ap.parse_args(argv)
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
    rows_k2, rows_k3 = [], []
    with torch.inference_mode():
        for shape, calls in shapes["k2"]:
            row = {"shape": shape, "calls": calls, **time_k2(tuple(shape), "cuda")}
            rows_k2.append(row)
            print(f"K2 {tuple(shape)} calls {calls}: contiguous "
                  f"{row['contiguous']['held_us']:.1f} us held, "
                  f"{row['contiguous']['unheld_us']:.1f} unheld; views "
                  f"{row['views']['held_us']:.1f} held, {row['views']['unheld_us']:.1f} unheld")
        for shape, calls in shapes["k3"]:
            row = {"shape": shape, "calls": calls, **time_k3(tuple(shape), "cuda")}
            rows_k3.append(row)
            print(f"K3 {tuple(shape)} calls {calls}: {row['held_us']:.1f} us held, "
                  f"{row['unheld_us']:.1f} unheld")
    sums = per_forward(rows_k2, rows_k3)
    for tag, row in sums.items():
        print(f"{tag} UNet forward, ms: " + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in row.items()))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": card, "shapes": shapes, "k2": rows_k2, "k3": rows_k3,
                       "per_forward": sums}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
