"""Time the plain conv (``resblock_kernel.conv2d``, K1's bf16 kernel with
its geometry at run time) against the path it replaced: ``conv2d_plain``
on the card, the f32 copies of the bf16 operands through cuDNN with TF32 off
and one rounding (with the GroupNorm, ``nn.group_norm`` in f32 first).

Every plain conv shape of a UNet forward and a VAE decode of audioldm2-full
(CFG batch 48, 24 decodes) and audioldm_48k (CFG 16, 8 decodes), each with
its bound: the larger of its FLOPs at 989 TF/s (bf16 dense) and its input,
weight and output bytes at 3.35 TB/s. Prints one line a shape and, per UNet
forward and per decode, the sums over the calls.

    python -m audioldm2_torch.tools.time_conv2d [--json OUT] [--only unet|vae] [--sweep]

``--sweep`` times, at each UNet shape, every launch the plan chooses among
(``_build.conv2d_candidates``: tile, ring depth, split over a cluster,
strip) beside the plan's pick: the data ``_build._CONV2D_MODEL`` is set
against.

Runs on the card only (``tools.timing.cuda_ms``).
"""

from __future__ import annotations

import argparse
import json

import torch

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
CELLS = (("audioldm2-full", 48), ("audioldm_48k", 16))


def shapes(only=None):
    """[(config, "unet" | "vae", shape key, calls)] of both configurations."""
    import audioldm2_torch as at
    from audioldm2_torch.models import unet, vae

    out = []
    for name, cfg_batch in CELLS:
        cfg = at.default_audioldm_config(name)
        size = (cfg.latent_t_size, cfg.latent_f_size)
        parts = {"unet": unet.plain_conv_shapes(cfg.unet, cfg_batch, *size),
                 "vae": vae.decode_plain_conv_shapes(cfg.vae, cfg_batch // 2, *size)}
        for part, got in parts.items():
            if only in (None, part):
                out += [(name, part, key, calls) for key, calls in sorted(got.items())]
    return out


def conv_args(key, device, seed=0):
    """The wrapper's arguments at a shape key of unet.plain_conv_shapes."""
    b, ti, fi, c1, c2, cout, taps, stride, up, gn = key
    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16
    cin = c1 + c2

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(bf)

    norm = (r(cin) + 1, r(cin)) if gn else (None, None)
    pad = taps // 2
    return (r(b, ti, fi, c1), r(b, ti, fi, c2) if c2 else None,
            r(taps, taps, cin, cout, scale=(taps * taps * cin) ** -0.5), r(cout), *norm, stride,
            ((pad, pad), (pad, pad)), up, 32, 1e-6)


def bound_ms(key) -> float:
    b, ti, fi, c1, c2, cout, taps, stride, up, _ = key
    to, fo = -(-ti * up // stride), -(-fi * up // stride)
    flops = 2.0 * b * to * fo * cout * taps * taps * (c1 + c2)
    nbytes = 2.0 * (b * ti * fi * (c1 + c2) + taps * taps * (c1 + c2) * cout + b * to * fo * cout)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def run(only=None, log=print):
    from audioldm2_torch.ops import resblock_kernel as rk
    from audioldm2_torch.tools.timing import cuda_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows, sums = [], {}
    with torch.inference_mode():
        for name, part, key, calls in shapes(only):
            args = conv_args(key, dev)
            kern = cuda_ms(lambda: rk.conv2d(*args))
            plain = cuda_ms(lambda: rk.conv2d_plain(*args))
            row = {"config": name, "part": part, "shape": list(key), "calls": calls,
                   "kernel_ms": kern, "f32_copy_ms": plain, "bound_ms": bound_ms(key)}
            rows.append(row)
            s = sums.setdefault(f"{name}.{part}", {"kernel_ms": 0.0, "f32_copy_ms": 0.0,
                                                   "bound_ms": 0.0})
            for k in s:
                s[k] += calls * row[k]
            log(f"{name} {part} {key} x{calls}: kernel {kern:.4f} ms, f32 copies {plain:.4f} ms "
                f"({plain / kern:.2f}x), bound {row['bound_ms']:.4f} ms")
    for k, s in sums.items():
        log(f"{k} per {'forward' if k.endswith('unet') else 'decode'}: kernel "
            f"{s['kernel_ms']:.3f} ms, f32 copies {s['f32_copy_ms']:.3f} ms, bound "
            f"{s['bound_ms']:.3f} ms")
    return {"device": torch.cuda.get_device_name(0), "rows": rows, "sums": sums}


def candidates(key, sms):
    """Every ConvPlan conv2d_plan chooses among at a shape key
    (``_build.conv2d_candidates``), each once."""
    from audioldm2_torch.ops import _build

    b, ti, fi, c1, c2, cout, taps, stride, up, _ = key
    t, f = -(-ti * up // stride), -(-fi * up // stride)
    return list(dict.fromkeys(plan for _, plan in _build.conv2d_candidates(
        b, t, f, c1 + c2, cout, sms, taps, stride)))


def sweep(log=print):
    """The plan's pick and every candidate at each UNet shape of both
    configurations: [{shape, calls, pick, pick_ms, best, best_ms}]."""
    from audioldm2_torch.ops import _build
    from audioldm2_torch.ops import resblock_kernel as rk
    from audioldm2_torch.tools.timing import cuda_ms

    dev = torch.device("cuda")
    sms = _build.sm_count(0)
    rows = []
    with torch.inference_mode():
        for name, part, key, calls in shapes("unet"):
            args = conv_args(key, dev)
            w = args[2].contiguous()
            times = {}
            for plan in candidates(key, sms):
                try:
                    times[plan] = cuda_ms(lambda: rk._conv2d_launch(*args[:2], w, *args[3:],
                                                                    plan=plan), target_ms=5.0)
                except RuntimeError as err:  # a launch the card refuses (a cluster's blocks)
                    log(f"  {tuple(plan[:9])}: {err}")
            b, ti, fi, c1, c2, cout, taps, stride, up, _ = key
            pick = _build.conv2d_plan(b, -(-ti * up // stride), -(-fi * up // stride), c1 + c2,
                                      cout, sms, taps, stride)
            pick_ms = cuda_ms(lambda: rk._conv2d_launch(*args[:2], w, *args[3:], plan=pick),
                              target_ms=5.0)
            best = min(times, key=times.get)
            rows.append({"config": name, "shape": list(key), "calls": calls,
                         "pick": list(pick[:9]), "pick_ms": pick_ms, "best": list(best[:9]),
                         "best_ms": times[best],
                         "all": [[list(p[:9]), ms] for p, ms in times.items()]})
            log(f"{name} {key} x{calls}: pick {tuple(pick[:9])} {pick_ms:.4f} ms, best "
                f"{tuple(best[:9])} {times[best]:.4f} ms ({pick_ms / times[best]:.2f}x)")
    for name in dict.fromkeys(r["config"] for r in rows):
        mine = [r for r in rows if r["config"] == name]
        log(f"{name} per forward: picks {sum(r['calls'] * r['pick_ms'] for r in mine):.3f} ms, "
            f"best {sum(r['calls'] * r['best_ms'] for r in mine):.3f} ms")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the rows and sums here")
    ap.add_argument("--only", choices=("unet", "vae"))
    ap.add_argument("--sweep", action="store_true", help="every launch choice at the UNet shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_conv2d runs on the card only")
    out = {"device": torch.cuda.get_device_name(0), "sweep": sweep()} if args.sweep else run(
        args.only)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
