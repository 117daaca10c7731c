#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # full run: 10 s clips, 200 DDIM steps

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device: card name and power limit, torch/CUDA versions, the kernels'
     nvcc build (sm_90a) with ptxas registers and spills;
  2. kernels: every distinct shape the main path gives each kernel (UNet at
     10 s and CFG batch 2, VAE decode at batch 1), kernel against its plain
     PyTorch version in bf16, plus one shape per kernel in f32 and a VAE
     shape offset by +10 (GroupNorm cancellation); times of both;
  3. one full-width UNet forward (all leaves non-zero): kernels against the
     all-plain path;
  4. requests through build_model / text_to_audio on random weights: three
     at the reference defaults (10 s, 200 steps, guidance 3.5, batch 1; their
     median is the p50 latency) and one at batch 2, each with output checks
     and launch counts held against the counts computed from the config.
The last two lines are the kernels' JSON record and {"ok": true, ...}.

Tolerances: max|kernel - plain| / max|plain| <= 2e-2 in bf16 and <= 1e-4
in f32. TF32 is switched off for cuDNN and matmuls, so the f32 plain path
is a full-precision oracle.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = "audioldm_16k_crossattn_t5"
BF16_TOL = 2e-2
F32_TOL = 1e-4

KERNELS = {
    "gn_silu_conv3x3": ("audioldm2_torch/csrc/gn_silu_conv.cu",
                        "audioldm2_tpu/ops/resblock_pallas.py:130"),
    "flash_self_attention": ("audioldm2_torch/csrc/attention.cu",
                             "audioldm2_tpu/ops/attention_pallas.py:114"),
    "ln_matmul": ("audioldm2_torch/csrc/lnmm.cu", "audioldm2_tpu/ops/lnmm_pallas.py:101"),
    "geglu_matmul": ("audioldm2_torch/csrc/lnmm.cu", "audioldm2_tpu/ops/lnmm_pallas.py:221"),
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, target_ms: float = 20.0, max_reps: int = 50) -> float:
    """Mean device time of fn() with CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    once = max(s.elapsed_time(e), 1e-3)
    reps = max(3, min(max_reps, int(target_ms / once)))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def rel_err(got, want):
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d, d / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# Interception at the ops.nn dispatch points (the wrappers and their launch
# counters stay untouched): record the kernel calls of a pass, or route a
# pass through the plain versions to serve as the oracle.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def patched_dispatch(mode: str, record=None):
    from audioldm2_torch.ops import attention_kernel, lnmm_kernel, nn, resblock_kernel

    orig = {k: getattr(nn, k) for k in
            ("gn_silu_conv", "gn_silu_conv_cat", "ln_linear", "geglu_ff_out", "attention")}

    def k1(x1, x2, p_norm, p_conv, groups, eps):
        args = (x1, x2, p_norm["scale"], p_norm["bias"], p_conv["w"].to(x1.dtype),
                p_conv["b"], groups, eps)
        if mode == "plain":
            return resblock_kernel.gn_silu_conv3x3_plain(*args)
        record("gn_silu_conv3x3", args)
        return resblock_kernel.gn_silu_conv3x3(*args)

    def gn_silu_conv(p_norm, p_conv, x, groups=32, eps=1e-5):
        return k1(x, None, p_norm, p_conv, groups, eps)

    def gn_silu_conv_cat(p_norm, p_conv, x1, x2, groups=32, eps=1e-5):
        return k1(x1, x2, p_norm, p_conv, groups, eps)

    def ln_linear(p_norm, p_lin, x, eps=1e-5):
        args = (x, p_norm["scale"], p_norm["bias"], p_lin["w"].to(x.dtype), p_lin.get("b"), eps)
        if mode == "plain":
            return lnmm_kernel.ln_matmul_plain(*args)
        record("ln_matmul", args)
        return lnmm_kernel.ln_matmul(*args)

    def geglu_ff_out(p_lin, h, residual):
        args = (h, p_lin["w"].to(h.dtype), p_lin["b"], residual)
        if mode == "plain":
            return lnmm_kernel.geglu_matmul_plain(*args)
        record("geglu_matmul", args)
        return lnmm_kernel.geglu_matmul(*args)

    def attention(q, k, v, mask=None, bias=None, scale=None):
        if not nn.attention_uses_kernel(q.shape, k.shape, mask is not None, bias is not None):
            return nn.attention_plain(q, k, v, mask=mask, bias=bias, scale=scale)
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        args = (q.contiguous(), k.contiguous(), v.contiguous(), float(scale))
        if mode == "plain":
            return attention_kernel.self_attention_plain(*args)
        record("flash_self_attention", args)
        return attention_kernel.flash_self_attention(*args)

    new = dict(gn_silu_conv=gn_silu_conv, gn_silu_conv_cat=gn_silu_conv_cat,
               ln_linear=ln_linear, geglu_ff_out=geglu_ff_out, attention=attention)
    for k, v in new.items():
        setattr(nn, k, v)
    try:
        yield
    finally:
        for k, v in orig.items():
            setattr(nn, k, v)


@contextlib.contextmanager
def plain_versions_forbidden():
    """Make every plain version of a kernel raise if handed a CUDA tensor,
    so a main-path run proves that no CUDA tensor took a plain path."""
    from audioldm2_torch.ops import attention_kernel, lnmm_kernel, resblock_kernel

    targets = [(resblock_kernel, "gn_silu_conv3x3_plain"),
               (attention_kernel, "self_attention_plain"),
               (lnmm_kernel, "ln_matmul_plain"), (lnmm_kernel, "geglu_matmul_plain")]
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def guard(*args, _fn=fn, _name=name, **kw):
            if any(getattr(a, "is_cuda", False) for a in args):
                raise AssertionError(f"{_name} reached with a CUDA tensor on the main path")
            return _fn(*args, **kw)

        setattr(mod, name, guard)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def signature(name, args):
    import torch

    return (name,) + tuple(
        (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor) else a for a in args
    )


def describe(sig) -> str:
    name, *rest = sig
    shapes = [("x".join(map(str, r[0])) if r[0] else "scalar") for r in rest
              if isinstance(r, tuple)]
    return f"{name}[{', '.join(shapes)}]"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch
    from audioldm2_torch.ops import _build

    log("== phase 1: device")
    log(f"card: {nvidia_smi_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.lib()
    info = _build.BUILD_INFO
    log(f"kernels built in {info['seconds']:.1f} s (nvcc; cached={info['cached']}; "
        f"load {time.perf_counter() - t0:.1f} s): {info['path']}")
    entry = None
    for line in str(info.get("log", "")).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            log(f"  ptxas {entry[:90]}: {line.split(':', 1)[1].strip()}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            log(f"  ptxas {entry[:90]}: spills {m.group(1)} B store / {m.group(2)} B load")


def discover_calls(cfg, unet_p, vae_p, ctx, mask, device):
    """One UNet forward (10 s, CFG batch 2) and one VAE decode (batch 1)
    through the kernels, recording the first call of each distinct shape
    and how many calls each shape gets."""
    import torch
    from audioldm2_torch.models import unet, vae

    first, counts = {}, {}

    def record(name, args):
        sig = signature(name, args)
        counts[sig] = counts.get(sig, 0) + 1
        if sig not in first:
            first[sig] = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)

    g = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((2, cfg.latent_t_size, cfg.latent_f_size, cfg.latent_channels),
                    generator=g, device=device).to(torch.bfloat16)
    t = torch.full((2,), 500, dtype=torch.int32, device=device)
    z = torch.randn((1, cfg.latent_t_size, cfg.latent_f_size, cfg.vae.embed_dim),
                    generator=g, device=device).to(torch.bfloat16)
    with torch.inference_mode(), patched_dispatch("record", record):
        kv = unet.precompute_cross_kv(unet_p, cfg.unet, [ctx])
        fused = unet.fuse_self_qkv(unet_p)
        unet.apply_unet(fused, cfg.unet, x, t, [ctx], [mask], cross_kv=kv)
        vae.decode(vae_p, cfg.vae, z)
    torch.cuda.synchronize()
    return first, counts


def phase_kernels(first, counts):
    import torch
    from audioldm2_torch.ops import attention_kernel, lnmm_kernel, resblock_kernel

    log("== phase 2: kernels against their plain versions")
    wrappers = {
        "gn_silu_conv3x3": (resblock_kernel.gn_silu_conv3x3, resblock_kernel.gn_silu_conv3x3_plain),
        "flash_self_attention": (attention_kernel.flash_self_attention,
                                 attention_kernel.self_attention_plain),
        "ln_matmul": (lnmm_kernel.ln_matmul, lnmm_kernel.ln_matmul_plain),
        "geglu_matmul": (lnmm_kernel.geglu_matmul, lnmm_kernel.geglu_matmul_plain),
    }
    stats = {k: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": 0}
             for k in wrappers}
    failures = []

    def check(name, args, tol, tag):
        kern, plain = wrappers[name]
        with torch.inference_mode():
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            ok_finite = bool(torch.isfinite(got).all())
            d, r = rel_err(got, want)
            k_ms = cuda_ms(lambda: kern(*args))
            p_ms = cuda_ms(lambda: plain(*args))
        status = "ok" if ok_finite and r <= tol else "FAIL"
        log(f"  {status} {tag}: max_abs_err {d:.3e} rel {r:.3e} (tol {tol:g}) "
            f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms")
        if status != "ok":
            failures.append(tag)
        return d, r, k_ms, p_ms

    for sig, args in first.items():
        name = sig[0]
        n = counts[sig]
        d, r, k_ms, p_ms = check(name, args, BF16_TOL, f"bf16 {describe(sig)} x{n}")
        st = stats[name]
        st["ms"] += n * k_ms
        st["plain_ms"] += n * p_ms
        st["max_abs_err"] = max(st["max_abs_err"], d)
        st["max_rel_err"] = max(st["max_rel_err"], r)
        st["shapes"] += 1

    # one shape per kernel in f32 (the smallest recorded), TF32 off
    for name in wrappers:
        sigs = sorted((s for s in first if s[0] == name),
                      key=lambda s: sum(math.prod(a[0]) for a in s[1:] if isinstance(a, tuple)))
        args = tuple(a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                     for a in first[sigs[0]])
        check(name, args, F32_TOL, f"f32 {describe(signature(name, args))}")

    # GroupNorm cancellation: the largest VAE-decoder shape, inputs offset by +10
    vae_sigs = [s for s in first if s[0] == "gn_silu_conv3x3" and s[-1] == 1e-6]
    big = max(vae_sigs, key=lambda s: math.prod(s[1][0]))
    for dt in (torch.bfloat16, torch.float32):
        args = list(first[big])
        args[0] = args[0].float() + 10.0
        args = tuple(a.to(dt) if isinstance(a, torch.Tensor) else a for a in args)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        check("gn_silu_conv3x3", args, tol, f"{dt} +10 offset {describe(big)}")

    for name, st in stats.items():
        log(f"  {name}: {st['shapes']} shapes, one UNet forward + one VAE decode: "
            f"kernel {st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms")
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return stats


def phase_unet(cfg, unet_f32, ctx, mask, device):
    """One UNet forward, kernels against the all-plain path, in bf16 (the
    production dtype) and in f32; the f32 plain forward also serves as the
    reference both bf16 paths are measured against."""
    import torch
    from audioldm2_torch.models import unet
    from audioldm2_torch.params import cast_floating

    log("== phase 3: full-width UNet forward, kernels against the all-plain path")
    g = torch.Generator(device=device).manual_seed(12)
    x = torch.randn((2, cfg.latent_t_size, cfg.latent_f_size, cfg.latent_channels),
                    generator=g, device=device)
    t = torch.tensor([981, 981], dtype=torch.int32, device=device)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        p = cast_floating(unet_f32, dt)
        with torch.inference_mode():
            kv = unet.precompute_cross_kv(p, cfg.unet, [ctx.to(dt)])
            fused = unet.fuse_self_qkv(p)
            args = (fused, cfg.unet, x.to(dt), t, [ctx.to(dt)], [mask])
            out["kernel", dt] = unet.apply_unet(*args, cross_kv=kv).float()
            with patched_dispatch("plain"):
                out["plain", dt] = unet.apply_unet(*args, cross_kv=kv).float()
        del p, kv, fused
    torch.cuda.synchronize()
    ref = out["plain", torch.float32]
    for (path, dt), y in out.items():
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"UNet forward ({path}, {dt}) is not finite")
        d, r = rel_err(y, ref)
        log(f"  {path} {dt} against plain f32: max_abs_err {d:.3e} rel {r:.3e}")
    failed = []
    for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        d, r = rel_err(out["kernel", dt], out["plain", dt])
        log(f"  eps {tuple(ref.shape)} {dt}: kernels against all-plain max_abs_err {d:.3e} "
            f"rel {r:.3e} (tol {tol:g}); |eps| max {ref.abs().max().item():.3e}")
        if r > tol:
            failed.append(str(dt))
    if failed:
        raise AssertionError(f"UNet forward: kernels disagree with the plain path in {failed}")


def phase_requests(cfg, steps: int, duration: float, device):
    import numpy as np
    import torch
    import audioldm2_torch as at
    from audioldm2_torch import ops
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate

    log("== phase 4: requests through build_model / text_to_audio")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = at.build_model(config=cfg, device=device, seed=0, nonzero_init=True)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(model.ldm.params))
    log(f"  build_model: {time.perf_counter() - t0:.2f} s, {n_params / 1e6:.1f} M parameters "
        f"drawn on {torch.cuda.get_device_name(0)}")
    for leaf in _leaves(model.ldm.params):
        if leaf.device.type != torch.device(device).type:
            raise AssertionError(f"a parameter lies on {leaf.device}, not {device}")
    expected = kernel_launches_per_generate(model.cfg, steps)
    sr = model.cfg.preprocessing.sampling_rate
    launches = None
    walls = {1: [], 2: []}
    # warm-up (allocator, cuDNN plans, lazy module state) on a short request
    at.text_to_audio(model, "warm up", seed=1, ddim_steps=10, duration=2.5)
    requests = [("A dog barking in the distance.", 1), ("Rain on a tin roof.", 1),
                ("A violin melody in a large hall.", 1), ("Waves crashing on rocks.", 2)]
    for prompt, bsz in requests:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with plain_versions_forbidden():
            wav = at.text_to_audio(model, prompt, seed=42, ddim_steps=steps, duration=duration,
                                   batchsize=bsz, guidance_scale=3.5, n_candidate_gen_per_text=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  request batch {bsz}, {duration} s, {steps} steps, guidance 3.5: wall {wall:.3f} s, "
            f"real-time factor {duration * bsz / wall:.3f}x, peak memory {peak:.2f} GiB, "
            f"timings {json.dumps({k: round(v, 4) for k, v in model.last_timings.items()})}")
        log(f"    launches {counts} expected {expected}")
        want_shape = (bsz, 1, int(duration * sr))
        if wav.shape != want_shape:
            raise AssertionError(f"waveform shape {wav.shape}, expected {want_shape}")
        if not np.isfinite(wav).all() or not np.abs(wav).max() > 0 or np.abs(wav).max() > 1.0:
            raise AssertionError("waveform is not finite, all zero, or out of [-1, 1]")
        log(f"    waveform {wav.shape} rms {float(np.sqrt(np.mean(wav ** 2))):.4f} "
            f"max {float(np.abs(wav).max()):.4f}")
        if counts != expected:
            raise AssertionError(f"launch counts {counts} != expected {expected}")
        if launches is None:
            launches = counts
        walls[bsz].append(wall)
    p50 = sorted(walls[1])[len(walls[1]) // 2]
    log(f"  end to end ({duration} s clips, {steps} steps): p50 latency at batch 1 {p50:.3f} s "
        f"over {len(walls[1])} requests; {duration * 2 / walls[2][0]:.3f} s-audio/s at batch 2")
    return launches


def _leaves(tree):
    import torch

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def run(cfg, device, steps: int, duration: float):
    """Phases 2-4 at ``cfg``'s widths on ``device``; returns the per-kernel
    stats of phase 2 and the launch counts of the first request."""
    import torch
    from audioldm2_torch.models import unet
    from audioldm2_torch.models.vae import init_vae
    from audioldm2_torch.params import Init, cast_floating

    g = torch.Generator(device=device).manual_seed(7)
    ini = Init(g, device, nonzero=True)
    unet_f32 = unet.init_unet(ini, cfg.unet)
    unet_p = cast_floating(unet_f32, torch.bfloat16)
    vae_p = cast_floating(init_vae(ini, cfg.vae), torch.bfloat16)
    n_tok = cfg.conditioners[0].flan_t5.max_length
    ctx = torch.randn((2, n_tok, cfg.unet.context_dims[0]), generator=g, device=device)
    ctx = ctx.to(torch.bfloat16)
    mask = torch.ones((2, n_tok), device=device)
    mask[0, 1:] = 0.0  # the unconditional "" prompt keeps one token
    mask[1, n_tok // 10:] = 0.0

    first, counts = discover_calls(cfg, unet_p, vae_p, ctx, mask, device)
    stats = phase_kernels(first, counts)
    del unet_p, vae_p, first
    phase_unet(cfg, unet_f32, ctx, mask, device)
    del unet_f32
    launches = phase_requests(cfg, steps, duration, device)
    return stats, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200, help="DDIM steps of the requests")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "audioldm2_torch")):
        print("chip_smoke: audioldm2_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    import audioldm2_torch as at

    t_start = time.perf_counter()
    phase_device()
    stats, launches = run(at.default_audioldm_config(MODEL), "cuda", args.steps, 10.0)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"]}
        for name in KERNELS
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi_line())
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
