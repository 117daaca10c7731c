"""A/B of the candidate self-attention kernels on the card: the plain
version, K2 (flash, online softmax), K7 (v6bd: exact softmax with the whole
row's max) and K8 (v7: clamped exp2 with no max), with
``F.scaled_dot_product_attention`` timed beside them as the yardstick.

Port of the harness of ``tools/ab_attn_variants.py`` (which runs the Pallas
kernels on a TPU). The shapes are that tool's: T = 1024, H = 8, D = 32 (the
audioldm2-full-large-1150k UNet's ds-2 self-attention, 256 channels) at
CFG batches 2, 6 and 8, and T = 2048 for 20 s clips.

Usage:
  python -m audioldm2_torch.tools.ab_attn_variants --check   # CPU: plain numerics
  python -m audioldm2_torch.tools.ab_attn_variants           # on the card
  python -m audioldm2_torch.tools.ab_attn_variants --json OUT.json

``--json`` writes the card, every time, K7's and K8's max|d| against K2
and the SHA-256 of K2's output bytes per shape (fixed seed), so that two
trees' runs can be diffed: K2's hashes are equal where its results are
bit-identical.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import torch

from audioldm2_torch.ops import attention_kernel, attention_variants_kernel as avk
from audioldm2_torch.ops import nn
from audioldm2_torch.tools.timing import cuda_ms

SHAPES = [
    ("n3 ds2", 6, 1024, 8, 32),
    ("b4 ds2", 8, 1024, 8, 32),
    ("b1 ds2", 2, 1024, 8, 32),
    ("b4 20s", 8, 2048, 8, 32),
]
H100_BF16_TFLOPS = 989.0  # dense bf16 tensor-core peak of one H100 SXM
CHECK_TOL = 5e-3


def check_plain() -> None:
    """The plain versions of K7 and K8 against the plain softmax attention
    at the JAX tool's own small f32 shapes (its ``check_interpret``)."""
    g = torch.Generator().manual_seed(0)
    for b, t, h, d in [(2, 256, 8, 32), (1, 384, 4, 32)]:
        q, k, v = (torch.randn((b, t, h, d), generator=g) for _ in range(3))
        scale = d ** -0.5
        want = nn.attention_plain(q, k, v, scale=scale)
        for name, fn in (("v6bd", avk.v6bd_attention_plain), ("v7", avk.v7_attention_plain)):
            err = (fn(q, k, v, scale) - want).abs().max().item()
            print(f"{name:<4} ({b},{t},{h},{d}): max|d| = {err:.2e}")
            assert err < CHECK_TOL, (name, err)
    print("plain numerics OK")


def sdpa(q, k, v, scale):
    """The yardstick: one PyTorch call on the same [B, T, H, D] inputs
    (the [B, H, T, D] views need no copy)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale).transpose(1, 2)


def run(shapes=SHAPES, reps: int = 20, device="cuda", log=print):
    """Each shape in bf16 on the card: CUDA-event ms per call of every
    variant, K7's and K8's max|d| against K2, their achieved TFLOP/s and
    the SHA-256 of K2's output bytes. Returns one dict per shape."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the A/B timing runs on a CUDA device (use --check on the CPU)")
    rows = []
    log(f"device: {torch.cuda.get_device_name(0)}")
    log(f"{'shape':>8} {'B':>3} {'T':>5}  {'plain':>8} {'K2':>8} {'K7 v6bd':>8} {'K8 v7':>8} "
        f"{'sdpa':>8}  {'K7 TF/s':>8} {'K8 TF/s':>8} {'K7 max|d|':>10} {'K8 max|d|':>10}")
    for label, b, t, h, d in shapes:
        g = torch.Generator(device=device).manual_seed(0)
        q, k, v = (torch.randn((b, t, h, d), generator=g, device=device).to(torch.bfloat16)
                   for _ in range(3))
        scale = d ** -0.5
        fns = {
            "plain": lambda: attention_kernel.self_attention_plain(q, k, v, scale),
            "k2": lambda: attention_kernel.flash_self_attention(q, k, v, scale),
            "k7": lambda: avk.v6bd_attention(q, k, v, scale),
            "k8": lambda: avk.v7_attention(q, k, v, scale),
            "sdpa": lambda: sdpa(q, k, v, scale),
        }
        with torch.inference_mode():
            ms = {name: cuda_ms(fn, reps) for name, fn in fns.items()}
            k2_out = fns["k2"]()
            ref = k2_out.float()
            err = {n: (fns[n]().float() - ref).abs().max().item() for n in ("k7", "k8")}
            k2_sha = hashlib.sha256(k2_out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        torch.cuda.synchronize()
        flop = 4.0 * b * h * t * t * d
        tflops = {n: flop / (ms[n] * 1e-3) / 1e12 for n in ("k7", "k8")}
        log(f"{label:>8} {b:>3} {t:>5}  {ms['plain']:8.4f} {ms['k2']:8.4f} {ms['k7']:8.4f} "
            f"{ms['k8']:8.4f} {ms['sdpa']:8.4f}  {tflops['k7']:8.1f} {tflops['k8']:8.1f} "
            f"{err['k7']:10.2e} {err['k8']:10.2e}   ({tflops['k7'] / H100_BF16_TFLOPS:.1%} / "
            f"{tflops['k8'] / H100_BF16_TFLOPS:.1%} of {H100_BF16_TFLOPS:g} TF/s)")
        rows.append({"label": label, "shape": (b, t, h, d), "ms": ms, "max_abs_err": err,
                     "tflops": tflops, "k2_sha256": k2_sha})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true", help="CPU check of the plain versions")
    ap.add_argument("--reps", type=int, default=20, help="timed calls per variant and shape")
    ap.add_argument("--json", metavar="OUT", help="also write the card and the rows to OUT")
    args = ap.parse_args(argv)
    if args.check:
        check_plain()
        return 0
    rows = run(reps=args.reps)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
