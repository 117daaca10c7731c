#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # full run: 10 s clips, 200 DDIM steps

Paths, each through the public API on random weights at full published
width (the full, sr and full8 paths serve them from a checkpoint file):
  t5      audioldm_16k_crossattn_t5, bf16, text_to_audio (kernels K1-K4, K6),
          with one PLMS and one DDPM (1000-step) request besides DDIM;
  full    audioldm2-full (CLAP text tower, GPT-2 sequence generator, two
          cross-attention slots), bf16, text_to_audio (K1-K4, K6), built by
          build_model(ckpt_path=) from a .pth of the drawn weights (the
          nested AudioMAE encoder among them) in the reference's key layout
          (audioldm2_torch.tools.reference_layout), every loaded leaf equal
          to the written one;
  sr      audioldm2-full through super_resolution_and_inpainting on a
          synthesized 10 s 16 kHz wav: log-mel, f32 VAE encode (K1 and K6
          in f32), masked DDIM at guidance 2.5;
  full8   audioldm2-full in the int8 serving mode (weight_quant="int8":
          K1q, K3q, K4q and K5 in the UNet, K1 in the VAE decoder, K6),
          built from the same file, which is then deleted;
  large   audioldm2-full-large-1150k (depth-2 spatial transformers, a
          context-free third cross slot whose attn2 runs K2), bf16,
          text_to_audio at n_candidate_gen_per_text = 3 (CFG batch 6), with
          the CLAP rerank (HTSAT-base audio tower, RoBERTa text tower, f32);
  48k     audioldm_48k (the CLAP text embedding as the UNet's only, FiLM,
          condition; one context-free slot whose attn2 runs K2; the 48 kHz
          VAE, 256 mel bins, and vocoder), bf16, text_to_audio at 3
          candidates with the rerank at batch 1 (CFG batch 6, decode batch
          3) and at 1 candidate at batch 2;
  tts     audioldm2-speech-gigaspeech (the VITS phoneme encoder and the CLAP
          text embedding feeding a 512-token GPT-2 sequence generator, one
          768-wide context slot), bf16, text_to_audio with a transcription;
  clapaudio  audioldm_48k with its CLAP conditioner in embed_mode="audio"
          (HTSAT-base; RoBERTa for the unconditional "" branch): a 10 s
          48 kHz clip through make_batch("", waveform=), one batch-1 request
          through model.ldm.generate (K1-K4, K6 as on the 48k path);
  mae     audioldm2-full's UNet conditioned by the TTA generator's nested
          audiomae_pooled(8, 8) spec and the t5 spec (the 8 pooled AudioMAE
          tokens fill the 768-wide slot), on a 10 s 16 kHz clip through
          make_batch("", waveform=): one batch-1 request;
          and, on the full path's loaded model, its nested AudioMAE once,
          held against the CPU (the first read of those loaded weights);
  towers  the CLAP towers PANN-14, PANN-10, BERT, BART and the CLIP-BPE
          transformer at their published widths, batch 2, in f32, each held
          against the CPU; then one request on audioldm_16k_crossattn_t5 at
          3 candidates reranked by a PANN-14 + transformer CLAP;
  ab      the attention A/B entry point (audioldm2_torch.tools.
          ab_attn_variants) once: the plain version, K2, K7 (v6bd), K8 (v7)
          and scaled_dot_product_attention at the JAX tool's shapes;
  train   audioldm_16k_crossattn_t5 (the t5 path's drawn weights, after its
          requests) through make_full_train_step in f32: utils.data.
          AudioDataset reads 8 synthetic 16 kHz wavs at 10.24 s into a
          batch of 4 (mel [1024, 64, 1], ta_kaldi_fbank [1024, 128]), then
          8 AdamW steps (lr 1e-4) on it with the same draws every step, an
          EMA update after each: the VAE encode (K1, K6 in f32) and the
          conditioning under torch.no_grad(), the UNet's K1, K2, K3, K4 and
          K6 under autograd (ops.autograd: kernel forward, plain-version
          recompute backward);
  native  the host C++ audio library (audioldm2_torch/csrc/host, g++ -O3
          -march=native into _build/): the resampler 48k -> 16k and 16k -> 48k
          on 10 s and normalize_wav against the numpy path, both timed;
  griffinlim  30 Griffin-Lim rounds (ops.stft.griffin_lim, injected phase)
          on a 10 s 16 kHz chirp's magnitude (1024 / 160 / 1024), card
          against CPU in f32;
  encoder the EncoderUNet classifier (no shipped config instantiates it) at
          the t5 UNet's widths, in_channels 8, out_channels 10, on the t5
          latent [2, 256, 16, 8]: K1, K2 (the legacy attention blocks), K6;
  edit    audioldm_16k_crossattn_t5: a 10 s 16 kHz chirp read and encoded as
          the sr path does (log-mel, f32 VAE encode: K1, K6 in f32),
          ddim.stochastic_encode to t_enc = 100 of 200, ddim.ddim_decode
          under a new prompt at guidance 3.5 (CFG batch 2: K1-K4, K6), VAE
          decode, vocoder (LatentDiffusionModel.edit);
  profile utils.profiling.trace (torch.profiler, CUDA activity) around one
          batch-1 t5 request of 20 DDIM steps: the op table, the device's
          busy share, the UNet's device time and TF/s (ops.flops);
  app     audioldm2_torch.app.text2audio(model_name=
          "audioldm_crossattn_flant5") at n = 3 and the app's 200 steps,
          through the app's model cache;
  cli     python -m audioldm2_torch (-d auto) in a subprocess on the t5
          family at the CLI's defaults (n = 3, CFG batch 6, the rerank): one
          generation and one --mode sr_inpainting -f request on a 10 s
          48 kHz chirp (the native resampler to 16 kHz);
  multi   audioldm2_torch.parallel: ShardedGenerator on a one-process mesh
          (dp 1 x tp 1) on the t5 path's model, one 10 s request, bit for
          bit model.ldm.generate's under cudnn.deterministic; then, as two
          ranks on the one card over gloo (launch.spawn; NCCL refuses two
          ranks on one device), serve.dryrun_infer(2): the t5 family at
          full width sharded tp 2 (the UNet's and T5's attention and FF
          split Megatron-style: K2 at half the heads, K3 at half of N, K4
          at half of F in its f32-residual mode), one 1.25 s request of 2
          DDIM steps, and in each rank a full-width UNet forward at the 10 s
          latent and CFG batch 2 on its slices and K6 in both processes at
          once; the same in the int8 serving mode (multi8: each rank's int8
          slices quantized from the whole weights, K1q whole, K3q at half
          of N, K4q at half of F in its f32-residual mode, K5 at half of K
          in its f32-output mode); then train.dryrun(2) at dp 2 and at tp 2
          (one sharded AdamW step of JAX's dry-run UNet against one
          process);
  golden  the eleven cases of the full-width golden that the JAX package
          made on the CPU in f32 (audioldm2_torch/assets/
          golden_fullwidth.npz, audioldm2_torch.tools.golden_parity):
          t5_headline (audioldm_16k_crossattn_t5, 200 steps), full, large,
          k48 (3 candidates and the CLAP rerank) and tts (with a
          transcription); sr_large (bench's sr request on large-1150k: the
          f32 VAE encode of a 440 Hz sine's fbank, the 40-60% latent mask,
          guidance 2.5), edit_t5 (two chirps encoded at batch 2, noised to
          step 10 of 20, decoded under a new prompt), plms_t5, mae_full
          (audioldm2-full's UNet on AudioMAE + T5, two chirps, CFG batch
          4), clapaudio_48k (CLAP embedding a 10 s 48 kHz chirp) and
          full_int8 (audioldm2-full with int8 weights in f32); 10 steps
          each, 10.24 s; each tree drawn once with numpy
          (params.draw_tree) to the stored digest, each request from the
          stored x_T and draws at eta 0, in f32, in bf16 and (full,
          full_int8) in the int8 serving mode.

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device: card name and power limit, torch/CUDA versions, the kernels'
     nvcc build (sm_90a, one nvcc per source, in parallel) with ptxas
     registers and spills;
  2. rounding: the plain bf16 convs (cuDNN) must round the f32 product plus
     bias once: at most 1e-3 of outputs may differ from one rounding (the
     cuBLAS linear is printed); the convs' times before and after the repair;
  3. kernels: every distinct shape the t5 path gives K1-K4 and K6 (UNet at
     10 s and CFG batch 2, VAE decode at batch 1), the f32 shapes of one
     full-width VAE encode (K1, K6), the full8 path's int8 kernels (its
     UNet), the large path's UNet at CFG batch 6, and the 48k path's UNet
     at CFG batch 2, VAE decode at batch 1 and f32 VAE encode of a 48 kHz
     chirp (256 mel bins), kernel against its
     plain PyTorch version, plus one shape per kernel in f32 and the VAE
     decoder's largest K1 and K6 shapes offset by +10 (GroupNorm
     cancellation); K6 at the VAE decoder's norm_out at the batches
     requests also decode (2, 3 and 6: re-read mode, above what the grid's
     shared memory holds) and at the 48k decoder's at 1, 2 and 3 (67, 134
     and 201 MB, re-read mode), checked and timed beside its bound, its plain
     version and F.group_norm + F.silu, outside the per-forward sums;
     K1's and K1q's statistics pass and conv timed apart,
     beside K1 and K4 the product alone on the materialised activation
     (cuDNN's conv, in f32 with TF32 off, cuBLAS's matmul: yardsticks,
     never library_ms), beside K6 F.group_norm + F.silu (two calls, a
     yardstick), beside the f32 K1 its bound in 3xTF32 at the TF32 rate,
     on the FMA units, and the same call on the shared GEMM core (the
     design before its tensor-core kernel); the C entries of each K6 call
     (one launch) and f32 K1 call (its statistics pass and its own conv,
     not the shared core) are counted and checked; beside
     each bf16 K1q, K3q, K4q and K5 shape its bound, its bf16 sibling (K1,
     K3 or K4 at the same shape on the dequantized weight; for K5 the bf16
     mode's own cuBLAS linear) and the same call on the shared GEMM core
     (the design before their bf16 kernels), and beside K5
     aten::_weight_int8pack_mm where it has a CUDA kernel (its
     library_ms; no bias); K1-K4 in bf16 at
     ragged shapes (T, M, N, F and Cout no multiples of their tiles; K1 at
     T = 1, F = 1, 2, 3 and with a group straddling the concat split) and K2
     on strided q, k, v; K7 and K8 at the
     A/B tool's four shapes (bf16), one f32 shape, the q, k, v of the large
     UNet's T = 1024 K2 calls, and inputs whose logits clamp; times of both,
     the least time the card could take (bound) and, for the attention
     kernels, scaled_dot_product_attention's (library_ms);
  4. one full-width UNet forward (all leaves non-zero), kernels against the
     all-plain path: the t5 UNet in bf16 and f32, the audioldm2-full UNet
     in int8 (bf16 activations), the large UNet at CFG batch 6 and the 48k
     UNet at CFG batch 2 in bf16 and f32; one full-width f32 VAE encode at
     16 and at 48 kHz, kernels against the all-plain path, and its time;
  5. the full path's checkpoint: its size, the torch.save seconds, and
     build_model(ckpt_path)'s seconds split into torch.load, conversion and
     transfer to the card, the host's RSS (current and, from
     resource.getrusage, peak) and the device memory after the build, for
     the full and the full8 builds, with the card's name and power limit;
     requests on each path at the reference defaults (10 s, 200 steps,
     guidance 3.5, or 2.5 for sr): one at batch 1 on the t5 path (its
     wall is the p50 latency), one on the full, sr, full8, large, 48k,
     tts and mae paths, and one at batch 2 on the t5, 48k and tts paths
     (the clapaudio and towers paths answer one batch-1 request),
     with output checks (and,
     on the paths with a sequence generator, the GPT-2 tokens finite and the
     CLAP text embedding of unit norm; the walls of the sequence generator
     and of the vocoder apart), no CUDA tensor reaching a plain version, no
     K1 call (bf16 or f32) and no bf16 K4, K1q, K3q, K5 or K4q call
     reaching the shared GEMM core instead of its own kernel, no split-K
     workspace allocated, and launch counts, reset to 0 just before the
     request, equal to the counts computed from the config (the sr path's
     VAE encode included); the PLMS and DDPM requests likewise, once each
     at batch 1; on the large, 48k and towers paths also the rerank: the
     similarities finite and in [-1, 1], the kept candidate the argmax of
     each prompt's, the CLAP audio embeddings of unit norm. The audio-in
     paths: clap_waveform_48k (1, 480000) and HTSAT's unit-norm embedding
     of it (timed), the clapaudio request's launches equal to the 48k
     path's; AudioMAE's tokens (b, 8, 768) timed at batch 1 and 2; each
     tower and the loaded AudioMAE within AUDIO_IN_TOL (1e-4) of the CPU.
     After the t5 requests, the train path: the kernels at the step's f32
     shapes (the UNet at batch 4, the VAE encode of 4 mels) against their
     plain versions, beside their bounds and yardsticks (cuDNN's f32 conv
     for K1, F.linear or the product alone for K3 and K4, f32 SDPA for K2,
     F.group_norm + F.silu for K6); one step's loss and UNet gradients
     through the kernels against the plain path (loss within 1e-4, every
     leaf's gradient within 1e-3 relative in norm, the worst printed); the
     8 steps: every UNet leaf with a finite gradient, the losses finite and
     falling (the least of the last four below the first), the first
     step's launches equal to the UNet forward's plus the VAE encode's, its
     backward's plain-version recomputes (the only CUDA calls a plain
     version may take) equal to the UNet forward's launches of K1, K2, K3,
     K4 and K6, no f32 K1 call on the shared core, the EMA of one leaf
     against its ramp formula; the step's wall, forward, backward and
     optimizer device times (CUDA events) and peak memory.
  6. the entry points and the last single-device modules: the native,
     griffinlim, encoder, edit, profile, app and cli paths above. native:
     the resamplers within NATIVE_RESAMPLE_TOL (1e-6) and normalize_wav
     within NATIVE_NORMALIZE_TOL (1e-7) of numpy; griffinlim: card within
     GL_ONE_ROUND_TOL (1e-4) of the CPU after one round and GL_TOL (2e-3)
     after 30 (relative to the peak); encoder: kernels against all-plain
     within 2e-2 (bf16) and 1e-4 (f32), launches equal to
     unet.kernel_launches_per_encoder_forward; edit: the request's launches
     equal to 100 UNet forwards, one VAE encode and one decode, and the f32
     latent after t_enc = 5 steps on injected noise within 1e-4 of the
     all-plain one; profile: the op table's top 25 (the kernels named), the
     union of the device ops' intervals over the traced window, the 20
     "unet" ranges' device time against ops.flops.unet_step_flops and
     989 TF/s; app: the rendered artifact,
     one model build for two get_model calls; cli: each wav at 16 kHz,
     160000 samples, finite, non-zero, within [-1, 1], the process on the
     card, its wall. The edit, profile and app requests go through the
     same request checks as phase 5.
  7. the multi path (its dp 1 request runs in phase 5, after the t5
     path's samplers, on the same weights): the dp 1 waveform equal to
     model.ldm.generate's bit for bit, its launches the config's; in each
     tp 2 rank the generate's launches equal to the unsharded generate's
     (every kernel launches as often, at narrower shapes), the waveform
     one per dp rank, at least 1.25 s, finite; K6 within 2e-2 of its
     plain version; the tp 2 UNet eps within max(2e-2, 1.25 x the bf16
     floor) of the tp 1 eps (phase 4's bound); each rank's wall and peak
     device memory printed; the same for the int8 serving mode, whose
     ranks must each launch K1q, K3q, K4q and K5 and whose int8 tp 2 eps
     is held to max(2e-2, 1.25 x the int8 forward's bf16 floor) of the
     int8 tp 1 eps; no call of a rank's tp forward on the shared GEMM
     core; the train dry runs' loss within 1e-5 and every updated leaf
     within 1e-5 relative of one process. Phase 3 holds K2, K3 and K4 at
     one tp 2 rank's shapes of the t5 UNet against their plain versions
     (K4 in its f32-residual mode to 1e-4) beside the tp 1 rows, and K3q,
     K4q (f32-residual mode, to 1e-4) and K5 (f32-output mode, to 1e-4)
     at one tp 2 rank's shapes of the t5 int8 UNet beside the uncut
     calls, none of them on the shared core.
  8. the golden path: the batch's ids equal to the golden's; in f32 (TF32
     off) each case within its mel MAE limit (golden_parity.f32_limit: 4x
     the port's CPU reading, under the round's bar of 1e-3; full_int8
     under twice JAX's own one-ulp spread), sr_large's and edit_t5's
     encode within its z0_rel limit, full_int8's served int8 UNet tree
     JAX's (digest and int8 leaf count), k48's pick the golden's; on the
     five text-to-audio cases two controls over the mel limit: the same
     request with the UNet's weights rounded to TF32 (what a 1xTF32 K1, K3
     or K4 would read) and with TF32 on for cuBLAS and cuDNN; on sr_large
     and edit_t5 the encode with the VAE's weights rounded to TF32 (what a
     1xTF32 f32 K1 would read) over the z0_rel limit; the launches of each
     request (the encode and the generate) equal to the config's (every
     kernel it predicts launched), no CUDA tensor in a
     plain version, no shared-core call (the f32 K3 and K4 run on the
     shared core, as in the train step, and their split-K workspaces are
     counted; bf16 and int8 requests allocate none); printed: the
     GPT-2 sequence, each context slot, y, the latent, the mel (MAE, max),
     the waveform and the CLAP scores against the golden, and each stage on
     the golden's own input (the first step's eps at x_T on t5_headline,
     the VAE decode of the golden latent, the vocoder on the golden mel);
     in bf16 and, on full and full_int8, in int8, under
     cudnn.deterministic, the same
     request through the kernels and through the plain versions (the
     floor), the kernels' mel MAE held to FLOOR_FACTOR (1.25) x the
     floor's.
The last two lines are the kernels' JSON record and {"ok": true, ...}.

Tolerances: max|kernel - plain| / max|plain| <= 2e-2 in bf16 and <= 1e-4
in f32; the whole audioldm2-full int8 UNet, whose bf16 rounding alone moves
its output by more than 2e-2, is held to 1.25 times that movement (see
FLOOR_FACTOR), and so are the large-1150k and 48k UNets in bf16. TF32 is switched off
for cuDNN and matmuls, so the f32 plain path is a full-precision oracle (the
f32 K1 multiplies in 3xTF32, about 22 bits of each operand). K1q, K3q and
K4q round their activation to bf16 even in f32, as the Pallas kernels do;
their f32 inputs are built so that this activation is an exact bf16 value
in both versions (see exact_f32_args), since a value within an f32 ulp of a
bf16 rounding boundary may round the other way in the other version.
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
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
T5_MODEL = "audioldm_16k_crossattn_t5"
FULL_MODEL = "audioldm2-full"
LARGE_MODEL = "audioldm2-full-large-1150k"
K48_MODEL = "audioldm_48k"
TTS_MODEL = "audioldm2-speech-gigaspeech"
BF16_TOL = 2e-2
F32_TOL = 1e-4
ROUND_ONCE_SHARE = 1e-3
# The audioldm2-full UNet with every leaf drawn non-zero amplifies bf16
# rounding: its all-plain bf16 forward lies 2.2e-2 from its all-plain f32
# forward (H100 run), above BF16_TOL, so two bf16 paths that round at
# different points cannot agree within BF16_TOL. Its int8 check is held to
# this factor times that floor, measured in the same run.
FLOOR_FACTOR = 1.25
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and operations/s
# by the type a kernel multiplies in (bf16 tensor cores; f32 FMA units)
# (bf16 tensor cores; TF32 tensor cores, where the f32 K1 does its 3xTF32
# products: three a multiply-add; f32 FMA units)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}

# The bf16 call each int8 kernel is held beside (side_times)
SIBLINGS = {"gn_silu_conv3x3_q": "K1", "ln_matmul_q": "K3", "geglu_matmul_q": "K4",
            "int8_matmul": "cuBLAS linear"}

KERNELS = {
    "gn_silu_conv3x3": ("audioldm2_torch/csrc/gn_silu_conv.cu",
                        "audioldm2_tpu/ops/resblock_pallas.py:130"),
    "flash_self_attention": ("audioldm2_torch/csrc/attention.cu",
                             "audioldm2_tpu/ops/attention_pallas.py:114"),
    "ln_matmul": ("audioldm2_torch/csrc/lnmm.cu", "audioldm2_tpu/ops/lnmm_pallas.py:101"),
    "geglu_matmul": ("audioldm2_torch/csrc/lnmm.cu", "audioldm2_tpu/ops/lnmm_pallas.py:221"),
    "gn_silu_conv3x3_q": ("audioldm2_torch/csrc/gn_silu_conv.cu",
                          "audioldm2_tpu/ops/resblock_pallas.py:157"),
    "int8_matmul": ("audioldm2_torch/csrc/lnmm.cu", "audioldm2_tpu/ops/lnmm_pallas.py:143"),
    "ln_matmul_q": ("audioldm2_torch/csrc/lnmm.cu", "audioldm2_tpu/ops/lnmm_pallas.py:101"),
    "geglu_matmul_q": ("audioldm2_torch/csrc/lnmm.cu", "audioldm2_tpu/ops/lnmm_pallas.py:221"),
    "group_norm_silu": ("audioldm2_torch/csrc/groupnorm.cu",
                        "audioldm2_tpu/ops/groupnorm_pallas.py:51"),
    "v6bd_attention": ("audioldm2_torch/csrc/attention_variants.cu",
                       "tools/ab_attn_variants.py:109"),
    "v7_attention": ("audioldm2_torch/csrc/attention_variants.cu",
                     "tools/ab_attn_variants.py:190"),
    "conv2d": ("audioldm2_torch/csrc/gn_silu_conv.cu", "none: XLA"),
}
ATTENTION_KERNELS = ("flash_self_attention", "v6bd_attention", "v7_attention")


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
    """Mean device time of fn() with CUDA events, the device held busy while
    the host queues the timed launches: the package's one timer."""
    from audioldm2_torch.tools.timing import cuda_ms as timed

    return timed(fn, target_ms=target_ms, max_reps=max_reps)


def rel_err(got, want):
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d, d / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# Interception at the ops.nn dispatch points (the wrappers and their launch
# counters stay untouched): record the kernel calls of a pass, or route a
# pass through the plain versions to serve as the oracle.
# ---------------------------------------------------------------------------


def _wrappers():
    """name -> (kernel wrapper, plain version) of every kernel."""
    from audioldm2_torch.ops import attention_kernel as ak, attention_variants_kernel as avk
    from audioldm2_torch.ops import groupnorm_kernel as gk, lnmm_kernel as lk
    from audioldm2_torch.ops import resblock_kernel as rk

    return {
        "gn_silu_conv3x3": (rk.gn_silu_conv3x3, rk.gn_silu_conv3x3_plain),
        "flash_self_attention": (ak.flash_self_attention, ak.self_attention_plain),
        "ln_matmul": (lk.ln_matmul, lk.ln_matmul_plain),
        "geglu_matmul": (lk.geglu_matmul, lk.geglu_matmul_plain),
        "gn_silu_conv3x3_q": (rk.gn_silu_conv3x3_q, rk.gn_silu_conv3x3_q_plain),
        "int8_matmul": (lk.int8_matmul, lk.int8_matmul_plain),
        "ln_matmul_q": (lk.ln_matmul_q, lk.ln_matmul_q_plain),
        "geglu_matmul_q": (lk.geglu_matmul_q, lk.geglu_matmul_q_plain),
        "group_norm_silu": (gk.group_norm_silu, gk.group_norm_silu_plain),
        "v6bd_attention": (avk.v6bd_attention, avk.v6bd_attention_plain),
        "v7_attention": (avk.v7_attention, avk.v7_attention_plain),
        "conv2d": (rk.conv2d, rk.conv2d_plain),
    }


@contextlib.contextmanager
def patched_dispatch(mode: str, record=None):
    import torch
    from audioldm2_torch.ops import nn

    wrappers = _wrappers()
    orig = {k: getattr(nn, k) for k in
            ("gn_silu_conv", "gn_silu_conv_cat", "ln_linear", "geglu_ff_out", "attention",
             "linear", "group_norm_silu", "_conv_kernel")}

    def call(name, args):
        if mode == "plain":
            return wrappers[name][1](*args)
        record(name, args)
        return wrappers[name][0](*args)

    def k1(x1, x2, p_norm, p_conv, groups, eps):
        norm = (p_norm["scale"], p_norm["bias"])
        if "wq" in p_conv:
            return call("gn_silu_conv3x3_q", (x1, x2, *norm, p_conv["wq"], p_conv["ws"],
                                              p_conv["b"], groups, eps))
        return call("gn_silu_conv3x3", (x1, x2, *norm, p_conv["w"].to(x1.dtype), p_conv["b"],
                                        groups, eps))

    def gn_silu_conv(p_norm, p_conv, x, groups=32, eps=1e-5):
        return k1(x, None, p_norm, p_conv, groups, eps)

    def gn_silu_conv_cat(p_norm, p_conv, x1, x2, groups=32, eps=1e-5):
        return k1(x1, x2, p_norm, p_conv, groups, eps)

    def group_norm_silu(p, x, groups=32, eps=1e-5):
        return call("group_norm_silu", (x, p["scale"], p["bias"], groups, eps))

    def ln_linear(p_norm, p_lin, x, eps=1e-5):
        norm = (p_norm["scale"], p_norm["bias"])
        if "wq" in p_lin:
            return call("ln_matmul_q", (x, *norm, p_lin["wq"], p_lin["ws"], p_lin.get("b"), eps))
        return call("ln_matmul", (x, *norm, p_lin["w"].to(x.dtype), p_lin.get("b"), eps))

    def geglu_ff_out(p_lin, h, residual):
        if "wq" in p_lin:
            return call("geglu_matmul_q", (h, p_lin["wq"], p_lin["ws"], p_lin["b"], residual))
        return call("geglu_matmul", (h, p_lin["w"].to(h.dtype), p_lin["b"], residual))

    def linear(p, x):
        if "wq" not in p:
            return orig["linear"](p, x)
        return call("int8_matmul", (x, p["wq"], p["ws"], p.get("b")))

    def _conv_kernel(x1, x2, p, stride=(1, 1), pads=((0, 0), (0, 0)), up=1, p_norm=None,
                     groups=32, eps=1e-5):
        """A call that nn sends to the plain conv kernel (CUDA bf16, the
        rule's shapes) as one "conv2d" call; the rest as nn has it."""
        parts = (x1,) if x2 is None else (x1, x2)
        if not (x1.is_cuda and x1.dtype == torch.bfloat16 and
                nn.conv2d_uses_kernel(p["w"].shape, stride, pads, [t.shape[-1] for t in parts])):
            return orig["_conv_kernel"](x1, x2, p, stride, pads, up, p_norm, groups, eps)
        gn = (None, None) if p_norm is None else (p_norm["scale"], p_norm["bias"])
        return call("conv2d", (x1, x2, p["w"].to(x1.dtype), p["b"], *gn, stride[0], pads, up,
                               groups, eps))

    def attention(q, k, v, mask=None, bias=None, scale=None):
        if not nn.attention_uses_kernel(q.shape, k.shape, mask is not None, bias is not None):
            return nn.attention_plain(q, k, v, mask=mask, bias=bias, scale=scale)
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return call("flash_self_attention", (q.contiguous(), k.contiguous(), v.contiguous(),
                                             float(scale)))

    new = dict(gn_silu_conv=gn_silu_conv, gn_silu_conv_cat=gn_silu_conv_cat,
               ln_linear=ln_linear, geglu_ff_out=geglu_ff_out, attention=attention,
               linear=linear, group_norm_silu=group_norm_silu, _conv_kernel=_conv_kernel)
    for k, v in new.items():
        setattr(nn, k, v)
    try:
        yield
    finally:
        for k, v in orig.items():
            setattr(nn, k, v)


@contextlib.contextmanager
def plain_versions_forbidden(recomputes=None):
    """Make every plain version of a kernel raise if handed a CUDA tensor,
    so a main-path run proves that no CUDA tensor took a plain path. The
    one exception is the recompute inside a kernel's autograd backward
    (``ops.autograd.KernelFunction.backward``, wrapped here), each of which
    adds one to ``recomputes[kernel name]`` where a dict is given."""
    import functools
    import importlib
    import threading

    from audioldm2_torch.ops import autograd

    inside = threading.local()  # the CUDA backward runs on autograd's device thread
    names, saved = {}, []
    for name, (kern, plain) in _wrappers().items():
        mod = importlib.import_module(plain.__module__)
        saved.append((mod, plain.__name__, plain))
        names[plain.__name__] = name

        @functools.wraps(plain)
        def guard(*args, _fn=plain, **kw):
            if not getattr(inside, "backward", False) and any(
                    getattr(a, "is_cuda", False) for a in args):
                raise AssertionError(f"{_fn.__name__} reached with a CUDA tensor on the main path")
            return _fn(*args, **kw)

        setattr(mod, plain.__name__, guard)
    backward = vars(autograd.KernelFunction)["backward"]

    def counted_backward(ctx, grad):
        if recomputes is not None:
            name = names[ctx.plain.__name__]
            recomputes[name] = recomputes.get(name, 0) + 1
        inside.backward = True
        try:
            return backward.__func__(ctx, grad)
        finally:
            inside.backward = False

    autograd.KernelFunction.backward = staticmethod(counted_backward)
    try:
        yield
    finally:
        autograd.KernelFunction.backward = backward
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# The shared GEMM core's entry points that a main-path call must not reach,
# with the dtypes whose calls have a kernel of their own: K1 in bf16 and in
# f32 (the sr path's VAE encode), K4, K1q, K3q, K5 and K4q in bf16.
SHARED_CORE_ENTRIES = {"a2k_gn_silu_conv3x3": ("bf16", "f32"), "a2k_geglu_matmul": ("bf16",),
                       "a2k_gn_silu_conv3x3_q": ("bf16",), "a2k_ln_matmul_q": ("bf16",),
                       "a2k_int8_matmul": ("bf16",), "a2k_geglu_matmul_q": ("bf16",)}


@contextlib.contextmanager
def shared_core_bf16_counted(out):
    """Count in ``out`` the K1 (bf16 or f32), K4, K1q, K3q, K5 and K4q (bf16)
    calls that reach the shared GEMM core's entry points (a shape or an
    alignment their own kernels' plans decline) instead of their kernels."""
    import torch
    from audioldm2_torch.ops import _build

    if not torch.cuda.is_available():  # a rehearsal on the CPU: no kernel launches
        yield
        return
    lib = _build.lib()
    codes = {"bf16": _build.DTYPE_CODES[torch.bfloat16], "f32": _build.DTYPE_CODES[torch.float32]}
    saved = {}
    for name, dtypes in SHARED_CORE_ENTRIES.items():
        saved[name] = getattr(lib, name)

        def counting(*args, _fn=saved[name], _name=name, _codes={codes[d] for d in dtypes}):
            if args[-2] in _codes:  # (..., dtype, stream)
                out[_name] = out.get(_name, 0) + 1
            return _fn(*args)

        setattr(lib, name, counting)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(lib, name, fn)


@contextlib.contextmanager
def entries_counted(out):
    """Count in ``out`` every call of each C entry point of the kernel
    library (what one wrapper call launches)."""
    import torch
    from audioldm2_torch.ops import _build

    if not torch.cuda.is_available():  # a rehearsal on the CPU: no kernel launches
        yield
        return
    lib, saved = _build.lib(), {}
    for name in _build.SIGNATURES:
        saved[name] = getattr(lib, name)

        def counting(*args, _fn=saved[name], _name=name):
            out[_name] = out.get(_name, 0) + 1
            return _fn(*args)

        setattr(lib, name, counting)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(lib, name, fn)


# The C entry points one wrapper call of a redesigned kernel launches, by
# (kernel, dtype), checked on its first call at every phase-3 shape: K6 is
# one launch (no statistics pass); K1 in f32 its statistics pass and the
# tensor-core conv, never the shared core.
ONE_CALL_ENTRIES = {("group_norm_silu", "torch.bfloat16"): {"a2k_group_norm_silu": 1},
                    ("group_norm_silu", "torch.float32"): {"a2k_group_norm_silu": 1},
                    ("gn_silu_conv3x3", "torch.float32"): {"a2k_gn_stats": 1,
                                                           "a2k_gn_silu_conv3x3_f32": 1}}


@contextlib.contextmanager
def workspaces_counted(out):
    """Count in ``out["workspaces"]`` the split-K workspaces the shared GEMM
    core's launch arguments allocate (a torch.empty and a reduce launch
    each)."""
    from audioldm2_torch.ops import _build

    saved = _build.gemm_launch_args
    out["workspaces"] = 0

    def counting(*args, **kw):
        got = saved(*args, **kw)
        out["workspaces"] += got[0] is not None
        return got

    _build.gemm_launch_args = counting
    try:
        yield
    finally:
        _build.gemm_launch_args = saved


@contextlib.contextmanager
def conditioning_recorded(out):
    """Record the GPT-2 tokens, the CLAP text and audio embeddings a request
    makes, each rerank's candidates, batch size and kept waveforms, and the
    walls of the sequence generator and the vocoder (the device synchronized
    before and after each) with the vocoder's operations."""
    import torch
    from audioldm2_torch import pipeline
    from audioldm2_torch.models import clap, sequence_gen, vocoder

    saved = (clap.text_embedding, clap.audio_embedding, sequence_gen.generate,
             pipeline.rerank_and_select, vocoder.apply_vocoder)

    def recorder(key, fn, wall_key=None, ops=None):
        def wrapped(*a, **kw):
            if wall_key:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            got = fn(*a, **kw)
            if wall_key:
                torch.cuda.synchronize()
                out.setdefault(wall_key, []).append(time.perf_counter() - t0)
            if key:
                out.setdefault(key, []).append(got)
            if ops:
                out.setdefault(wall_key + "_ops", []).append(ops(*a))
            return got
        return wrapped

    def rerank_and_select(model, wav, text, batchsize, n_gen):
        kept = saved[3](model, wav, text, batchsize, n_gen)
        out.setdefault("rerank", []).append((wav, batchsize, n_gen, kept))
        return kept

    clap.text_embedding = recorder("clap", saved[0])
    clap.audio_embedding = recorder("clap_audio", saved[1])
    sequence_gen.generate = recorder("gpt2", saved[2], "gpt2_s")
    pipeline.rerank_and_select = rerank_and_select
    vocoder.apply_vocoder = recorder(None, saved[4], "vocoder_s",
                                     lambda p, cfg, mel: vocoder_ops(cfg, tuple(mel.shape)))
    try:
        yield
    finally:
        (clap.text_embedding, clap.audio_embedding, sequence_gen.generate,
         pipeline.rerank_and_select, vocoder.apply_vocoder) = saved


def vocoder_ops(cfg, mel_shape) -> float:
    """Operations (two a multiply-add) of one apply_vocoder call on a mel of
    ``mel_shape`` [B, T, num_mels]: each conv's 2 k Cin Cout a sample it
    writes (a transposed conv's a sample it reads)."""
    b, length, _ = mel_shape
    ch = cfg.upsample_initial_channel
    convs = 2 if cfg.resblock == "1" else 1
    ops = 2 * 7 * cfg.num_mels * ch * length  # conv_pre
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cin, cout = ch >> i, ch >> (i + 1)
        ops += 2 * k * cin * cout * length
        length = (length - 1) * u - 2 * ((k - u) // 2) + k
        ops += sum(2 * convs * len(d) * ks * cout * cout * length
                   for ks, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
    return b * (ops + 2 * 7 * (ch >> len(cfg.upsample_rates)) * length)  # + conv_post


def exact_f32_args(name, args, seed: int = 0):
    """f32 inputs at the shapes of ``args`` for a kernel that rounds its
    activation to bf16 whatever its dtype (K1q, K3q, K4q), built so that
    the activation is the same bf16 value in the kernel and in the plain
    version: K1q and K3q get +-1 inputs balanced over each GroupNorm group
    or LayerNorm row (mean 0 and variance 1 exactly in any summation
    order), then an affine (gamma 20 or a power of two, beta 0) that keeps
    the activation a bf16 value times (1 - 5e-6), far from a rounding
    boundary; K4q gets a gate of 12 (gelu(12) = 12 in f32) and a value in
    -4..4. The weights, scales, biases and residual are the call's own."""
    import torch

    g = torch.Generator(device=args[0].device).manual_seed(seed)
    dev = args[0].device
    f32 = [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
           for a in args]

    def balanced_signs(rows, n):  # [rows, n] of +-1, each row summing to 0
        if n % 2:
            raise ValueError(f"{name}: {n} elements per normalization group, not even")
        rank = torch.rand((rows, n), generator=g, device=dev).argsort(-1).argsort(-1)
        return torch.where(rank < n // 2, 1.0, -1.0)

    if name == "gn_silu_conv3x3_q":
        x1, x2, groups = f32[0], f32[1], f32[7]
        bsz, t, f, c1 = x1.shape
        cin = c1 + (0 if x2 is None else x2.shape[-1])
        cg = cin // groups
        x = balanced_signs(bsz * groups, t * f * cg).reshape(bsz, groups, t * f, cg)
        x = x.permute(0, 2, 1, 3).reshape(bsz, t, f, cin)
        f32[0], f32[1] = x[..., :c1].contiguous(), None if x2 is None else x[..., c1:].contiguous()
        f32[2] = torch.full((cin,), 20.0, device=dev)
        f32[3] = torch.zeros(cin, device=dev)
    elif name == "ln_matmul_q":
        x = f32[0]
        c = x.shape[-1]
        f32[0] = balanced_signs(x.numel() // c, c).reshape(x.shape)
        f32[1] = 2.0 ** torch.randint(-1, 2, (c,), generator=g, device=dev).float()
        f32[2] = torch.zeros(c, device=dev)
    elif name == "geglu_matmul_q":
        h = f32[0]
        f = h.shape[-1] // 2
        a = torch.randint(-4, 5, (*h.shape[:-1], f), generator=g, device=dev).float()
        f32[0] = torch.cat([a, torch.full_like(a, 12.0)], dim=-1)
    else:
        raise ValueError(f"{name} does not round its activation to bf16")
    return tuple(f32)


def kernel_work(name, args):
    """(bytes, operations, the type it multiplies in) of one kernel call:
    each input read once and the output written once; the products' (or,
    for K6, the elementwise) operations. K1q, K3q and K4q multiply bf16
    tiles; K1 in f32 multiplies in 3xTF32 on the tensor cores, three TF32
    products a multiply-add (its FMA-unit bound: fma_bound_ms); the others in
    their activation's type."""
    import torch

    def nbytes(t):
        return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0

    x = args[0]
    kind = "bf16" if name.endswith("_q") or x.dtype == torch.bfloat16 else "f32"
    rows = x.numel() // x.shape[-1]
    if name in ("gn_silu_conv3x3", "gn_silu_conv3x3_q"):
        cin = x.shape[-1] + (0 if args[1] is None else args[1].shape[-1])
        cout = args[4].shape[-1]
        ops = 2 * rows * 9 * cin * cout
        if kind == "f32" and name == "gn_silu_conv3x3":
            return sum(map(nbytes, args)) + rows * cout * x.element_size(), 3 * ops, "tf32"
        return sum(map(nbytes, args)) + rows * cout * x.element_size(), ops, kind
    if name in ATTENTION_KERNELS:
        b, t, h, d = x.shape
        return sum(map(nbytes, args[:3])) + nbytes(x), 4 * b * h * t * t * d, kind
    if name in ("ln_matmul", "ln_matmul_q", "int8_matmul", "geglu_matmul", "geglu_matmul_q"):
        w = args[1] if name.startswith(("int8", "geglu")) else args[3]
        k, n = w.shape
        # K4 and K4q write the residual's type (their last argument); K5 in
        # its f32-output mode (out_dtype, its fifth) f32
        if name.startswith("geglu"):
            out_bytes = args[-1].element_size()
        elif name == "int8_matmul" and len(args) > 4 and args[4] is not None:
            out_bytes = torch.empty((), dtype=args[4]).element_size()
        else:
            out_bytes = x.element_size()
        return sum(map(nbytes, args)) + rows * n * out_bytes, 2 * rows * k * n, kind
    if name == "group_norm_silu":  # stats, normalize, affine and SiLU: ~10 f32 ops an element
        return sum(map(nbytes, args)) + nbytes(x), 10 * x.numel(), "f32"
    if name == "conv2d":  # its input read once (not the upsample), bf16 products
        x2, w, stride, pads, up = args[1], args[2], args[6], args[7], args[8]
        k, cin, cout = w.shape[0], w.shape[2], w.shape[3]
        b, ti, fi = x.shape[:3]
        t = (ti * up + sum(pads[0]) - k) // stride + 1
        f = (fi * up + sum(pads[1]) - k) // stride + 1
        out = b * t * f * cout
        return (sum(map(nbytes, args[:6])) + out * x.element_size(),
                2 * out * k * k * cin, kind)
    raise ValueError(f"no work model for {name}")


def bound_times(name, args):
    """(bytes over the HBM rate, operations over the peak of their type), ms."""
    nbytes, ops, kind = kernel_work(name, args)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[kind] * 1e3


def fma_bound_ms(name, args) -> float:
    """The f32 K1's product bound on the FMA units (one f32 multiply-add a
    multiply-add, 67 TF/s), printed beside its 3xTF32 bound; 0 otherwise."""
    nbytes, ops, kind = kernel_work(name, args)
    return ops / 3 / PEAK_OPS_PER_S["f32"] * 1e3 if kind == "tf32" else 0.0


def int8pack_mm_on_cuda() -> bool:
    """Whether this PyTorch has a CUDA kernel for aten::_weight_int8pack_mm."""
    import torch

    return torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA")


def library_call(name, args):
    """(label, fn): one PyTorch call computing the same function, where
    there is one, else None: scaled_dot_product_attention for the unmasked
    self-attentions; for bf16 K5, aten::_weight_int8pack_mm where it has a
    CUDA kernel (x . wq^T * scale on an [N, K] copy of the weight made here,
    outside the timed call; it adds no bias). Timed as a yardstick only; the
    port never calls it."""
    import torch

    if name in ATTENTION_KERNELS:
        from audioldm2_torch.tools.ab_attn_variants import sdpa

        return "sdpa", lambda: sdpa(*args[:4])
    if name == "int8_matmul" and args[0].is_cuda and args[0].dtype == torch.bfloat16 \
            and int8pack_mm_on_cuda():
        x, wq, ws = args[:3]
        x2, wt = x.reshape(-1, x.shape[-1]), wq.t().contiguous()
        return "_weight_int8pack_mm (no bias)", lambda: torch._weight_int8pack_mm(x2, wt, ws)
    return None


def side_times(name, args):
    """K1's and K1q's GroupNorm statistics pass alone, and the yardsticks of
    the product alone on the same inputs with the activation already
    materialised: cuDNN's channels-last conv for K1, cuBLAS's matmul for K4
    (ms a call). Neither yardstick computes the kernel's function, so
    neither is its library_ms. For bf16 K1q, K3q and K4q: the bf16 sibling
    (K1, K3 or K4 at the same shape, on the dequantized weight rounded to
    bf16); for bf16 K5 the bf16 mode's own call at those sites (nn.linear:
    cuBLAS on the dequantized bf16 weight, with the bias); and for all four
    the parent design, the same call on the shared GEMM core."""
    import torch
    import torch.nn.functional as F
    from audioldm2_torch.ops import lnmm_kernel, nn, resblock_kernel

    out = {}
    if not args[0].is_cuda:  # a rehearsal on the CPU: no kernel to time
        return out
    with torch.inference_mode():
        if name in ("int8_matmul", "geglu_matmul_q") and args[0].dtype == torch.bfloat16:
            x, wq, ws, b = args[:4]
            w16 = (wq.float() * ws).to(torch.bfloat16)
            if name == "int8_matmul":
                p16 = {"w": w16} if b is None else {"w": w16, "b": b}
                y = torch.empty((*x.shape[:-1], wq.shape[-1]), device=x.device, dtype=x.dtype)
                out["sibling_ms"] = cuda_ms(lambda: nn.linear(p16, x))
                out["parent_ms"] = cuda_ms(lambda: lnmm_kernel._int8_shared_core(
                    name, x, wq, ws, b, y))
            else:
                res = args[4]
                y = torch.empty_like(res)
                out["sibling_ms"] = cuda_ms(lambda: lnmm_kernel.geglu_matmul(x, w16, b, res))
                out["parent_ms"] = cuda_ms(lambda: lnmm_kernel._geglu_shared_core(
                    name, x, wq, ws, b, res, y))
            return out
        if name in ("gn_silu_conv3x3_q", "ln_matmul_q") and args[0].dtype == torch.bfloat16:
            if name == "gn_silu_conv3x3_q":
                x1, x2, gamma, beta, wq, ws, b, groups, eps = args
                w16 = (wq.float() * ws).to(torch.bfloat16)
                out["stats_ms"] = cuda_ms(lambda: resblock_kernel.gn_stats(x1, x2, gamma, beta,
                                                                           groups, eps))
                out["sibling_ms"] = cuda_ms(lambda: resblock_kernel.gn_silu_conv3x3(
                    x1, x2, gamma, beta, w16, b, groups, eps))
                def on_shared_core():
                    a, c = resblock_kernel.gn_stats(x1, x2, gamma, beta, groups, eps)
                    out = torch.empty((*x1.shape[:3], wq.shape[-1]), device=x1.device,
                                      dtype=x1.dtype)
                    resblock_kernel._conv_shared_core(name, x1, x2, a, c, wq, ws, b, out)

                out["parent_ms"] = cuda_ms(on_shared_core)
            else:
                x, gamma, beta, wq, ws, b, eps = args
                w16 = (wq.float() * ws).to(torch.bfloat16)
                out["sibling_ms"] = cuda_ms(lambda: lnmm_kernel.ln_matmul(x, gamma, beta, w16,
                                                                          b, eps))
                out["parent_ms"] = cuda_ms(lambda: lnmm_kernel._ln(name, x, gamma, beta, wq, ws,
                                                                   b, eps))
            return out
        if name == "gn_silu_conv3x3":
            x1, x2, gamma, beta, w, b, groups, eps = args
            out["stats_ms"] = cuda_ms(lambda: resblock_kernel.gn_stats(x1, x2, gamma, beta,
                                                                       groups, eps))
            if x1.dtype == torch.float32:  # the parent design: the conv on the shared core
                y = torch.empty((*x1.shape[:3], w.shape[-1]), device=x1.device)

                def on_shared_core():
                    a, c = resblock_kernel.gn_stats(x1, x2, gamma, beta, groups, eps)
                    resblock_kernel._conv_shared_core(name, x1, x2, a, c, w, None, b, y)

                out["parent_ms"] = cuda_ms(on_shared_core)
            x = x1 if x2 is None else torch.cat([x1, x2], dim=-1)
            h = F.silu(F.group_norm(x.float().permute(0, 3, 1, 2), groups, gamma.float(),
                                    beta.float(), eps)).to(x1.dtype)
            h = h.contiguous(memory_format=torch.channels_last)
            wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bt = b.to(x1.dtype)
            out["yardstick_ms"] = cuda_ms(lambda: F.conv2d(h, wt, bt, padding=1))
        elif name == "ln_matmul":
            x, gamma, beta, w, b, eps = args
            y = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(),
                             eps).to(x.dtype)
            wt, bt = w.t().contiguous(), None if b is None else b.to(x.dtype)
            out["yardstick_ms"] = cuda_ms(lambda: F.linear(y, wt, bt))
        elif name == "geglu_matmul":
            h, w = args[0], args[1]
            a, gate = torch.chunk(h.float(), 2, dim=-1)
            u = (a * F.gelu(gate)).to(h.dtype)
            out["yardstick_ms"] = cuda_ms(lambda: torch.matmul(u, w))
        elif name == "group_norm_silu":  # two PyTorch calls, channels first
            x, gamma, beta, groups, eps = args[:5]
            xc = x.movedim(-1, 1).contiguous()
            gc, bc = gamma.to(x.dtype), beta.to(x.dtype)
            out["yardstick_ms"] = cuda_ms(lambda: F.silu(F.group_norm(xc, groups, gc, bc, eps)))
    return out


def new_stats():
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
            "library_ms": None, "max_abs_err": 0.0, "max_rel_err": 0.0, "f32_rel_err": 0.0,
            "shapes": 0, "stats_ms": 0.0, "yardstick_ms": 0.0, "sibling_ms": 0.0,
            "parent_ms": 0.0, "fma_ms": 0.0}


def check_kernel(name, args, tol, tag, failures):
    """The kernel against its plain version on the same inputs; logs the
    error and both times. Returns (max_abs_err, rel_err, kernel ms, plain ms)."""
    import torch

    kern, plain = _wrappers()[name]
    calls = {}
    with torch.inference_mode():
        with entries_counted(calls):
            got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        ok_finite = bool(torch.isfinite(got).all())
        d, r = rel_err(got, want)
        k_ms = cuda_ms(lambda: kern(*args))
        p_ms = cuda_ms(lambda: plain(*args))
    want_calls = ONE_CALL_ENTRIES.get((name, str(args[0].dtype)))
    calls.pop("a2k_group_norm_silu_occupancy", None)  # a query, read once per size
    launched_as_designed = want_calls is None or not args[0].is_cuda or calls == want_calls
    status = "ok" if ok_finite and r <= tol and launched_as_designed else "FAIL"
    log(f"  {status} {tag}: max_abs_err {d:.3e} rel {r:.3e} (tol {tol:g}) "
        f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms"
        + ("" if want_calls is None else f"; C entries of one call {calls}"))
    if status != "ok":
        failures.append(tag)
    return d, r, k_ms, p_ms


def add_call(st, name, args, n, d, r, k_ms, p_ms):
    """Add n calls of one shape to a kernel's stats: times, bound, the
    library call's time (timed here) and the errors."""
    import torch

    b_ms, o_ms = bound_times(name, args)
    st["ms"] += n * k_ms
    st["plain_ms"] += n * p_ms
    st["bound_ms"] += n * max(b_ms, o_ms)
    st["bytes_ms"] += n * b_ms
    st["ops_ms"] += n * o_ms
    st["fma_ms"] += n * fma_bound_ms(name, args)
    lib = library_call(name, args)
    if lib is not None:
        label, fn = lib
        with torch.inference_mode():
            lib_ms = cuda_ms(fn)
        st["library_ms"] = (st["library_ms"] or 0.0) + n * lib_ms
        log(f"       {label} {lib_ms:.4f} ms a call: the kernel takes {k_ms / lib_ms:.2f}x that; "
            f"bound {max(b_ms, o_ms):.4f} ms")
    st["max_abs_err"] = max(st["max_abs_err"], d)
    st["max_rel_err"] = max(st["max_rel_err"], r)
    st["shapes"] += 1


def signature(name, args):
    import torch

    return (name,) + tuple(
        (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor) else a for a in args
    )


def describe(sig) -> str:
    name, *rest = sig
    shapes = [("x".join(map(str, r[0])) if r[0] else "scalar") for r in rest
              if isinstance(r, tuple) and len(r) == 2 and isinstance(r[1], str)]
    mode = f" stride {rest[6]} up {rest[8]}" if name == "conv2d" else ""
    return f"{name}[{', '.join(shapes)}]{mode}"


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
    log("aten::_weight_int8pack_mm " + ("has a CUDA kernel: K5's library_ms is its time (no bias)"
                                        if int8pack_mm_on_cuda() else
                                        "has no CUDA kernel here: K5's library_ms is null"))
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


@contextlib.contextmanager
def _convs_as(mode: str):
    """The convs as nn runs them ("now"), or with conv2d kept off the plain
    conv kernel: on the f32 copies with one rounding ("f32 copies"), or as
    before the one-rounding repair, cuDNN's own bf16 conv with the bias
    given to it ("before")."""
    from audioldm2_torch.ops import nn

    saved = nn._conv_one_rounding, nn._conv_kernel
    if mode != "now":
        nn._conv_kernel = lambda *args, **kw: None
    if mode == "before":
        nn._conv_one_rounding = nn._one_rounding
    try:
        yield
    finally:
        nn._conv_one_rounding, nn._conv_kernel = saved


def phase_rounding(device):
    """The share of bf16 outputs of the plain ops that differ from an f32
    computation rounded once. Each conv's must be at most ROUND_ONCE_SHARE
    (cuBLAS linear: printed only); conv2d runs on the plain conv kernel.
    Also the share and time of each conv as before the repair and, for
    conv2d, on the f32 copies the kernel replaced."""
    import torch
    from audioldm2_torch.ops import nn

    log("== phase 2: bf16 rounding of the plain ops (cuBLAS/cuDNN, conv2d on the plain conv "
        "kernel), share differing from one rounding")
    g = torch.Generator(device=device).manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)

    cases = {
        "linear [2048, 640] x [640, 640]": (nn.linear, {"w": rnd(640, 640, scale=0.04),
                                                        "b": rnd(640)}, rnd(2, 1024, 640), {}),
        "conv2d 3x3 256->128 [2, 64, 16]": (nn.conv2d, {"w": rnd(3, 3, 256, 128, scale=0.02),
                                                        "b": rnd(128)}, rnd(2, 64, 16, 256), {}),
        "conv2d 3x3 128->128 [1, 1024, 64]": (nn.conv2d, {"w": rnd(3, 3, 128, 128, scale=0.03),
                                                          "b": rnd(128)}, rnd(1, 1024, 64, 128),
                                              {}),
        "conv1d k7 256->256 [1, 1024]": (nn.conv1d, {"w": rnd(7, 256, 256, scale=0.02),
                                                     "b": rnd(256)}, rnd(1, 1024, 256), {}),
        "conv_transpose1d k16 s8 512->256 [1, 128]": (
            nn.conv_transpose1d, {"w": rnd(16, 256, 512, scale=0.02), "b": rnd(256)},
            rnd(1, 128, 512), dict(stride=8, padding=4)),
    }
    shares, failures = {}, []
    with torch.inference_mode():
        for tag, (op, p, x, kw) in cases.items():
            once = op({k: v.float() for k, v in p.items()}, x.float(), **kw).to(torch.bfloat16)
            is_conv = op is not nn.linear
            row = {}
            modes = ("now", "f32 copies", "before") if op is nn.conv2d else (
                ("now", "before") if is_conv else ("now",))
            for mode in modes:
                with _convs_as(mode):
                    got = op(p, x, **kw)
                    share = (got != once).float().mean().item()
                    row[mode] = (share, cuda_ms(lambda: op(p, x, **kw)))
            shares[tag] = row["now"][0]
            status = ("ok" if shares[tag] <= ROUND_ONCE_SHARE else "FAIL") if is_conv else "info"
            log(f"  {status} {tag}: {shares[tag]:.3e} of outputs differ from one rounding "
                f"(bound {ROUND_ONCE_SHARE:g} for the convs), {row['now'][1]:.4f} ms"
                + (f"; on the f32 copies {row['f32 copies'][0]:.3e}, "
                   f"{row['f32 copies'][1]:.4f} ms" if "f32 copies" in row else "")
                + (f"; before the repair {row['before'][0]:.3e}, {row['before'][1]:.4f} ms"
                   if is_conv else ""))
            if status == "FAIL":
                failures.append(tag)
    if failures:
        raise AssertionError(f"bf16 convs round twice: {failures}")
    return shares


def _ctx_inputs(cfg, device, g, batch: int = 2):
    """The UNet's conditioning at CFG batch ``batch``: (one bf16 context per
    set cross slot (a None slot takes none), their masks, the FiLM y or
    None). A T5 context's unconditional half keeps one token, its
    conditional half a tenth; y, where the config has a FiLM condition, is
    a unit-norm row per sample (as the CLAP text embedding is)."""
    import torch

    n_tok = {1024: 128, 768: 8}  # T5 tokens; the GPT-2 sequence generator's 8
    ctxs, masks = [], []
    for dim in (d for d in cfg.unet.context_dims if d is not None):
        n = n_tok.get(dim, 16)
        ctxs.append(torch.randn((batch, n, dim), generator=g, device=device).to(torch.bfloat16))
        mask = torch.ones((batch, n), device=device)
        if dim == 1024:
            mask[:batch // 2, 1:] = 0.0
            mask[batch // 2:, n // 10:] = 0.0
        masks.append(mask)
    y = None
    if cfg.unet.extra_film_condition_dim is not None:
        y = torch.randn((batch, cfg.unet.extra_film_condition_dim), generator=g, device=device)
        y = (y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)).to(torch.bfloat16)
    return ctxs, masks, y


def _cond_batch(cond) -> int:
    ctxs, _, y = cond
    return (ctxs[0] if ctxs else y).shape[0]


def discover_calls(cfg, unet_f32, vae_p, cond, device):
    """One UNet forward (10 s, the conditioning's CFG batch; cond from
    _ctx_inputs) with the config's per-call transforms (int8 ones included)
    and, when vae_p is given, one VAE decode (batch 1), through the kernels,
    recording the first call of each distinct shape and how many calls each
    shape gets."""
    import torch
    from audioldm2_torch.diffusion.latent_diffusion import prepare_unet
    from audioldm2_torch.models import unet, vae

    first, counts = {}, {}

    def record(name, args):
        sig = signature(name, args)
        counts[sig] = counts.get(sig, 0) + 1
        if sig not in first:
            first[sig] = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)

    g = torch.Generator(device=device).manual_seed(11)
    ctxs, masks, y = cond
    batch = _cond_batch(cond)
    x = torch.randn((batch, cfg.latent_t_size, cfg.latent_f_size, cfg.latent_channels),
                    generator=g, device=device).to(torch.bfloat16)
    t = torch.full((batch,), 500, dtype=torch.int32, device=device)
    with torch.inference_mode(), patched_dispatch("record", record):
        unet_p, kv = prepare_unet({"unet": unet_f32}, cfg, ctxs)
        unet.apply_unet(unet_p, cfg.unet, x, t, ctxs, masks, y=y, cross_kv=kv)
        if vae_p is not None:
            z = torch.randn((1, cfg.latent_t_size, cfg.latent_f_size, cfg.vae.embed_dim),
                            generator=g, device=device).to(torch.bfloat16)
            vae.decode(vae_p, cfg.vae, z)
    torch.cuda.synchronize()
    return first, counts


def chirp(sr: int, seconds: float, seed: int = 0):
    """A 10 s-style test signal: golden_parity.chirp, a linear chirp over
    most of the band plus noise, peak 0.5, float32 numpy [N]."""
    from audioldm2_torch.tools.golden_parity import chirp as golden_chirp

    return golden_chirp(sr, seconds, seed)


def encoder_mel(cfg, device, duration: float):
    """The [1, T, M, 1] log-mel of a chirp at the sr path's frame count."""
    from audioldm2_torch.ops.stft import MelSpectrogram

    pre = cfg.preprocessing
    frames = int(duration * cfg.latent_t_per_second * cfg.vae.downsample_factor)
    mel = MelSpectrogram(pre.filter_length, pre.hop_length, pre.win_length, pre.n_mel_channels,
                         pre.sampling_rate, pre.mel_fmin, pre.mel_fmax, device=device)
    wav = chirp(pre.sampling_rate, frames * pre.hop_length / pre.sampling_rate)
    return mel.fbank(wav[None], target_length=frames)[..., None]


def discover_encode_calls(cfg, vae_f32, mel):
    """One f32 VAE encode through the kernels, recording the first call of
    each distinct shape and how many calls each shape gets."""
    import torch
    from audioldm2_torch.models import vae
    from audioldm2_torch.ops.nn import full_f32

    first, counts = {}, {}

    def record(name, args):
        sig = signature(name, args)
        counts[sig] = counts.get(sig, 0) + 1
        first.setdefault(sig, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                    for a in args))

    with torch.inference_mode(), full_f32(), patched_dispatch("record", record):
        vae.encode_moments(vae_f32, cfg.vae, mel)
    torch.cuda.synchronize()
    return first, counts


def phase_kernels(first, counts, offset_check: bool, f32_pass: bool = True):
    """Each recorded shape in its dtype, then (f32_pass) the smallest shape
    of each kernel in f32 (exact_f32_args for the kernels that round their
    activation to bf16); with offset_check, the largest VAE K1 and K6
    shapes offset by +10."""
    import torch

    names = sorted({sig[0] for sig in first}, key=list(KERNELS).index)
    stats = {k: new_stats() for k in names}
    failures = []
    vae = {}  # the VAE's calls (its norms have eps 1e-6), apart from the UNet's
    slower = []  # plain conv shapes slower on the kernel than on the f32 copies it replaced

    for sig, args in first.items():
        name = sig[0]
        n = counts[sig]
        bf16 = args[0].dtype == torch.bfloat16
        res = check_kernel(name, args, BF16_TOL if bf16 else F32_TOL,
                           f"{'bf16' if bf16 else 'f32'} {describe(sig)} x{n}", failures)
        add_call(stats[name], name, args, n, *res)
        side = side_times(name, args)
        for key, ms in side.items():
            stats[name][key] += n * ms
        if name == "conv2d":
            log(f"       bound {max(bound_times(name, args)):.4f} ms; the f32-copy path it "
                f"replaced (plain) {res[3] / res[2]:.2f}x this kernel")
            if res[2] > res[3]:
                slower.append(describe(sig))
        if side:
            parts = []
            if "stats_ms" in side:
                parts.append(f"stats pass {side['stats_ms']:.4f} ms, conv "
                             f"{res[2] - side['stats_ms']:.4f} ms (kernel less stats)")
            if "yardstick_ms" in side and name == "group_norm_silu":
                parts.append(f"yardstick, F.group_norm + F.silu (two calls, not library_ms): "
                             f"{side['yardstick_ms']:.4f} ms")
            elif "yardstick_ms" in side:
                tool = {"gn_silu_conv3x3": "cuDNN conv", "ln_matmul": "F.linear"}.get(
                    name, "cuBLAS matmul")
                parts.append(f"yardstick, the product alone ({tool}): "
                             f"{side['yardstick_ms']:.4f} ms")
            if "parent_ms" in side and "sibling_ms" not in side:
                b_ms, o_ms = bound_times(name, args)
                parts.append(f"bound {max(b_ms, o_ms):.4f} ms (3xTF32 at the TF32 rate; on the "
                             f"FMA units {fma_bound_ms(name, args):.4f} ms); the shared core (the "
                             f"parent design) {side['parent_ms']:.4f} ms "
                             f"({side['parent_ms'] / res[2]:.2f}x this kernel)")
            if "sibling_ms" in side:
                b_ms, o_ms = bound_times(name, args)
                parts.append(f"bound {max(b_ms, o_ms):.4f} ms; bf16 {SIBLINGS[name]} at this shape "
                             f"{side['sibling_ms']:.4f} ms (this kernel "
                             f"{res[2] / side['sibling_ms']:.2f}x it); the shared core (the "
                             f"parent design) {side['parent_ms']:.4f} ms "
                             f"({side['parent_ms'] / res[2]:.2f}x this kernel)")
            log("       " + "; ".join(parts))
        # (a plain conv's eps is the GroupNorm it folds, the UNet's transformers' 1e-6 too)
        if offset_check and sig[-1] == 1e-6 and name != "conv2d":
            part = vae.setdefault(name, dict.fromkeys(("ms", "plain", "bound", "yardstick"), 0.0))
            for key, ms in (("ms", res[2]), ("plain", res[3]),
                            ("bound", max(bound_times(name, args))),
                            ("yardstick", side.get("yardstick_ms", 0.0))):
                part[key] += n * ms

    # one shape per kernel in f32 (the smallest recorded), TF32 off; the plain
    # conv takes bf16 only (nn sends it nothing else)
    for name in [n for n in names if n != "conv2d"] if f32_pass else ():
        sigs = sorted((s for s in first if s[0] == name),
                      key=lambda s: sum(math.prod(a[0]) for a in s[1:] if isinstance(a, tuple)))
        args = first[sigs[0]]
        if name in ("gn_silu_conv3x3_q", "ln_matmul_q", "geglu_matmul_q"):
            args = exact_f32_args(name, args)
        else:
            args = tuple(a.float() if isinstance(a, torch.Tensor) and a.is_floating_point()
                         else a for a in args)
        _, r, _, _ = check_kernel(name, args, F32_TOL, f"f32 {describe(signature(name, args))}",
                                  failures)
        stats[name]["f32_rel_err"] = r

    # GroupNorm cancellation: the largest VAE (eps 1e-6) shape, inputs offset by +10
    for name in ("gn_silu_conv3x3", "group_norm_silu") if offset_check else ():
        big = max((s for s in first if s[0] == name and s[-1] == 1e-6),
                  key=lambda s: math.prod(s[1][0]))
        for dt in (torch.bfloat16, torch.float32):
            args = list(first[big])
            args[0] = args[0].float() + 10.0
            args = tuple(a.to(dt) if isinstance(a, torch.Tensor) else a for a in args)
            tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
            check_kernel(name, args, tol, f"{dt} +10 offset {describe(big)}", failures)

    for name, st in stats.items():
        lib = "" if st["library_ms"] is None else f", library call {st['library_ms']:.3f} ms"
        side = ""
        if st["stats_ms"]:
            side += (f"; stats pass {st['stats_ms']:.3f} ms, conv "
                     f"{st['ms'] - st['stats_ms']:.3f} ms")
        if st["yardstick_ms"]:
            what = "F.group_norm + F.silu" if name == "group_norm_silu" else "product alone"
            side += f"; yardstick ({what}) {st['yardstick_ms']:.3f} ms"
        if st["parent_ms"] and not st["sibling_ms"]:
            side += (f"; FMA bound {st['fma_ms']:.3f} ms, shared core (parent design) "
                     f"{st['parent_ms']:.3f} ms")
        if st["sibling_ms"]:
            side += (f"; bf16 sibling at the same shapes {st['sibling_ms']:.3f} ms, shared core "
                     f"(parent design) {st['parent_ms']:.3f} ms")
        log(f"  {name}: {st['shapes']} shapes, one forward: "
            f"kernel {st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms, bound "
            f"{st['bound_ms']:.3f} ms{lib}{side}")
        if name == "conv2d":
            log(f"    shapes slower on the kernel than on the f32-copy path: {slower or 'none'}")
            st["slower_than_replaced"] = slower
        if name in vae:
            v = vae[name]
            log(f"    of which the UNet forward {st['ms'] - v['ms']:.3f} ms and the VAE decode "
                f"{v['ms']:.3f} ms (plain {v['plain']:.3f}, bound {v['bound']:.3f}, yardstick "
                f"{v['yardstick']:.3f})")
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return stats


# The batches the VAE decodes besides 1: a t5 batch-2 request, a large
# request of three candidates at batch 1 and at batch 2
DECODE_BATCHES = (2, 3, 6)


def phase_k6_batches(first, stats, batches=DECODE_BATCHES):
    """K6 at the VAE decoder's norm_out (the recorded batch-1 call's x, each
    further sample offset by 0.5) at ``batches``: one launch, against the
    plain version, timed beside its bound and F.group_norm + F.silu. The
    plan's mode is printed; at 33.5 MB and more the grid's shared memory
    cannot hold x, so each block holds its last rows and reads the others
    twice (re-read mode: the t5 decoder's at batch 2 and up, the 48k
    decoder's 67 MB a sample at every batch). Kept out of the per-forward
    sums."""
    import torch
    from audioldm2_torch.ops import _build

    name = "group_norm_silu"
    sig = max((s for s in first if s[0] == name and s[-1] == 1e-6),
              key=lambda s: math.prod(s[1][0]))
    x, *rest = first[sig]
    failures = []
    for batch in batches:
        ones = [1] * (x.dim() - 1)
        shift = 0.5 * torch.arange(batch, device=x.device, dtype=torch.float32)
        xb = (x.float().repeat(batch, *ones) + shift.view(-1, *ones)).to(x.dtype)
        args = (xb, *rest)
        d, r, k_ms, p_ms = check_kernel(name, args, BF16_TOL, f"bf16 VAE decode norm_out, batch "
                                        f"{batch} {describe(signature(name, args))}", failures)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], d)
        b_ms, o_ms = bound_times(name, args)
        side = side_times(name, args)
        mode = "on the CPU"
        if xb.is_cuda:
            c = xb.shape[-1]
            plan = _build.group_norm_silu_plan(batch, xb.numel() // (batch * c), c, "bf16",
                                               _build.sm_count(xb.device.index or 0))
            mode = ("resident" if plan.resident
                    else f"re-read, {plan.rows_held} of {plan.rows} rows a block held")
        log(f"       {mode}; bound {max(b_ms, o_ms):.4f} ms (kernel {k_ms / max(b_ms, o_ms):.2f}x "
            f"it); yardstick, F.group_norm + F.silu (two calls, not library_ms): "
            f"{side.get('yardstick_ms', float('nan')):.4f} ms")
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")


def phase_ragged(stats, device):
    """K2 and K3 in bf16 at shapes their tiles do not divide: T no multiple
    of K2's 64-row q and K/V tiles (D = 32 and 64), K2 on the strided q, k,
    v views of one fused [B, T, 3C] projection (what the UNet hands it), and
    for K3 M no multiple of its row block with N no multiple of its N tile,
    with and without a bias, and one shape (C, N no multiples of 8) that
    goes to the shared core; K1 at the halo edges (T = 1, F = 1, 2, 3),
    with a GroupNorm group straddling the concat split and with Cout no
    multiple of its N tile; K4 with F no multiple of its 64-deep K tile and
    M and N no multiples of its tiles. Errors join the kernels' records; the
    times are printed and belong to no forward."""
    import torch

    failures = []
    g = torch.Generator(device=device).manual_seed(31)
    bf16 = torch.bfloat16

    def rnd(*shape, scale=1.0, offset=0.0, dt=bf16):
        return (torch.randn(shape, generator=g, device=device) * scale + offset).to(dt)

    cases = []
    for b, t, h, d in ((2, 200, 5, 32), (1, 100, 3, 64)):
        cases.append(("flash_self_attention", f"ragged {(b, t, h, d)}",
                      (rnd(b, t, h, d), rnd(b, t, h, d), rnd(b, t, h, d), d ** -0.5)))

    def qkv_views(b, t, h, d):
        qkv = rnd(b, t, 3 * h * d)
        views = tuple(x.reshape(b, t, h, d) for x in torch.chunk(qkv, 3, dim=-1))
        if any(v.is_contiguous() for v in views):
            raise AssertionError("the fused projection's chunks should be strided views")
        return views

    cases.append(("flash_self_attention", "strided views of one [2, 200, 768]",
                  (*qkv_views(2, 200, 8, 32), 32 ** -0.5)))
    for m, c, n, with_bias in ((100, 384, 200, True), (100, 384, 200, False),
                               (100, 100, 36, True)):
        cases.append(("ln_matmul", f"ragged M, C, N = {(m, c, n)}, bias {with_bias}",
                      (rnd(1, m, c, offset=3.0), rnd(c, dt=torch.float32),
                       rnd(c, dt=torch.float32), rnd(c, n, scale=c ** -0.5),
                       rnd(n, dt=torch.float32) if with_bias else None, 1e-5)))
    for b, t, f, c1, c2, cout, tag in ((1, 1, 24, 64, 0, 64, "T = 1"),
                                       (2, 40, 1, 64, 0, 128, "F = 1"),
                                       (1, 96, 2, 128, 0, 128, "F = 2"),
                                       (1, 50, 3, 64, 32, 96, "F = 3, a group straddling the "
                                                               "concat split"),
                                       (1, 33, 7, 256, 0, 200, "Cout no multiple of its tile")):
        cin = c1 + c2
        cases.append(("gn_silu_conv3x3", f"{tag}: {(b, t, f, c1, c2, cout)}",
                      (rnd(b, t, f, c1, offset=1.0), rnd(b, t, f, c2) if c2 else None,
                       rnd(cin, offset=1.0), rnd(cin), rnd(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                       rnd(cout), 32, 1e-5)))
    for m, f, n in ((130, 200, 96), (100, 1032, 136)):
        cases.append(("geglu_matmul", f"ragged M, F, N = {(m, f, n)}",
                      (rnd(m, 2 * f), rnd(f, n, scale=f ** -0.5), rnd(n), rnd(m, n))))
    for name, tag, args in cases:
        d_abs, _, _, _ = check_kernel(name, args, BF16_TOL, f"bf16 {name} {tag}", failures)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], d_abs)
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    # what reading the fused projection in place saves: K2 on the views
    # against K2 after the three copies that made them contiguous
    k2 = _wrappers()["flash_self_attention"][0]
    shape = (6, 1024, 8, 32)
    views = qkv_views(*shape)
    scale = shape[-1] ** -0.5
    with torch.inference_mode():
        in_place = cuda_ms(lambda: k2(*views, scale))
        copied = cuda_ms(lambda: k2(*(v.contiguous() for v in views), scale))
    log(f"  K2 {shape} on the fused projection's views: in place {in_place:.4f} ms, "
        f"after three copies {copied:.4f} ms")


# The tensor-parallel slice of the multi path: the ranks of one UNet replica
TP = 2


def _cut_cols(t, parts: int, r: int):
    """Rank r's columns of t [..., N] whose N is ``parts`` equal blocks,
    each cut over TP ([q_r | k_r | v_r], [a_r | gate_r])."""
    import torch

    blocks = torch.chunk(t, parts, dim=-1)
    return torch.cat([torch.chunk(b, TP, dim=-1)[r] for b in blocks], dim=-1).contiguous()


def tp_rank_args(name, args):
    """A t5 UNet call's arguments as tp rank 0 of the multi path gets them
    (parallel.mesh.shard_params): K2 its heads; K3 its columns of the fused
    QKV (N = 3C), of attn2's q (N = C) and of the GEGLU projection (N =
    8C, [a_0 | gate_0]); K4 its [a_0 | gate_0] of h and rows of w in the
    f32-residual mode, with the bias and the residual (which the other
    ranks replace by zeros). The int8 forward's, as its quantization cuts
    them (models.unet.quantize_st_linears: the whole weights' int8 values
    and scales): K3q the same columns of wq, ws and the bias; K4q K4's cut
    with the whole ws; K5, the t5 UNet's to_out projections, its columns of
    x and rows of wq with the whole ws, no bias (added after the sum over
    tp) and the f32 output."""
    import torch

    r = 0
    if name == "flash_self_attention":
        q, k, v, scale = args
        h = q.shape[2] // TP
        return tuple(t[:, :, r * h:(r + 1) * h].contiguous() for t in (q, k, v)) + (scale,)
    if name == "ln_matmul":
        x, gamma, beta, w, b, eps = args
        parts = {3: 3, 1: 1, 8: 2}[w.shape[1] // w.shape[0]]
        return (x, gamma, beta, _cut_cols(w, parts, r),
                None if b is None else _cut_cols(b, parts, r), eps)
    if name == "geglu_matmul":
        h, w, b, res = args
        f = w.shape[0] // TP
        return _cut_cols(h, 2, r), w[r * f:(r + 1) * f].contiguous(), b, res.float()
    if name == "ln_matmul_q":
        x, gamma, beta, wq, ws, b, eps = args
        parts = {3: 3, 1: 1, 8: 2}[wq.shape[1] // wq.shape[0]]
        return (x, gamma, beta, _cut_cols(wq, parts, r), _cut_cols(ws, parts, r),
                None if b is None else _cut_cols(b, parts, r), eps)
    if name == "geglu_matmul_q":
        h, wq, ws, b, res = args
        f = wq.shape[0] // TP
        return _cut_cols(h, 2, r), wq[r * f:(r + 1) * f].contiguous(), ws, b, res.float()
    if name == "int8_matmul":
        x, wq, ws = args[:3]
        k = wq.shape[0] // TP
        return (_cut_cols(x, 1, r), wq[r * k:(r + 1) * k].contiguous(), ws, None,
                torch.float32)
    raise ValueError(f"{name} is not split under tp")


# The kernels a tp rank calls at its slices in bf16 and in the int8 serving
# mode, and those whose tp mode writes its f32 sum unrounded (held to F32_TOL)
TP_BF16 = ("flash_self_attention", "ln_matmul", "geglu_matmul")
TP_INT8 = ("ln_matmul_q", "geglu_matmul_q", "int8_matmul")
TP_F32_OUT = {"geglu_matmul": "f32-residual ", "geglu_matmul_q": "f32-residual ",
              "int8_matmul": "f32-output "}


def phase_tp_shapes(first, counts, stats, names=TP_BF16, tp1_too: bool = False):
    """The kernels at the shapes one rank of the multi path's tp 2 UNet
    gives them (the t5 UNet forward's recorded calls cut as tp_rank_args
    cuts them; each rank launches as many calls as the unsharded UNet),
    against their plain versions, timed beside the tp 1 rows: K2, K3 and
    K4 or, on the int8 forward's calls, K3q, K4q and K5 (``names``). K4 and K4q in
    their f32-residual mode and K5 in its f32-output mode are held to
    F32_TOL (both versions sum the same products in f32, unrounded). A bf16
    call that reaches the shared GEMM core fails the phase (the f32 modes
    raise where their plan declines). With ``tp1_too`` the uncut calls are
    checked and timed too (the int8 t5 forward has no tp 1 rows in phase
    3). The errors join the kernels' records; returns {name: per-rank
    stats} and {name: tp 1 stats}, which belong to no tp 1 forward."""
    import torch

    failures, on_core = [], {}
    tp_stats, tp1_stats = {}, {}
    with shared_core_bf16_counted(on_core):
        for sig, args in first.items():
            name = sig[0]
            if name not in names:
                continue
            if tp1_too:
                st1 = tp1_stats.setdefault(name, new_stats())
                res = check_kernel(name, args, BF16_TOL,
                                   f"tp 1 {describe(sig)} x{counts[sig]}", failures)
                add_call(st1, name, args, counts[sig], *res)
            rank_args = tp_rank_args(name, args)
            f32_out = name in TP_F32_OUT
            st = tp_stats.setdefault(name, new_stats())
            res = check_kernel(name, rank_args, F32_TOL if f32_out else BF16_TOL,
                               f"tp {TP} rank 0 {TP_F32_OUT.get(name, '')}"
                               f"{describe(signature(name, rank_args))} x{counts[sig]}", failures)
            add_call(st, name, rank_args, counts[sig], *res)
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], res[0])
    if on_core:
        failures.append(f"bf16 calls on the shared GEMM core {on_core}")
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    for name, st in tp_stats.items():
        lib = "" if st["library_ms"] is None else f", library call {st['library_ms']:.3f} ms"
        tp1 = tp1_stats.get(name, stats[name])
        log(f"  {name} at tp {TP} (one rank): {st['shapes']} shapes, one forward: kernel "
            f"{st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms, bound {st['bound_ms']:.3f} ms"
            f"{lib}; at tp 1 kernel {tp1['ms']:.3f} ms, bound {tp1['bound_ms']:.3f} ms "
            f"(the UNet's share of it)")
    return tp_stats, tp1_stats


def phase_variants(large_first, device):
    """K7 and K8 against their plain versions: the A/B tool's four shapes in
    bf16 (one call each: these make the record's times and bound), one f32
    shape, the q, k, v of the large UNet's T = 1024 K2 calls, and one input
    scaled so that logits pass +-100 (K8 clamps there, by design)."""
    import torch
    from audioldm2_torch.tools.ab_attn_variants import SHAPES

    names = ("v6bd_attention", "v7_attention")
    stats = {k: new_stats() for k in names}
    failures = []
    g = torch.Generator(device=device).manual_seed(21)

    def qkv(shape, dt, q_scale=1.0):
        q, k, v = (torch.randn(shape, generator=g, device=device) for _ in range(3))
        return (q * q_scale).to(dt), k.to(dt), v.to(dt), shape[-1] ** -0.5

    cases = [(f"bf16 A/B {label} {(b, t, h, d)}", qkv((b, t, h, d), torch.bfloat16), True)
             for label, b, t, h, d in SHAPES]
    cases.append(("f32 (2, 256, 8, 32)", qkv((2, 256, 8, 32), torch.float32), False))
    cases += [(f"bf16 large UNet K2 call {describe(sig)}", args, False)
              for sig, args in large_first.items()
              if sig[0] == "flash_self_attention" and sig[1][0][1] == 1024]
    cases.append(("bf16 (6, 1024, 8, 32), logits past +-100",
                  qkv((6, 1024, 8, 32), torch.bfloat16, q_scale=40.0), False))
    for tag, args, timed in cases:
        tol = BF16_TOL if args[0].dtype == torch.bfloat16 else F32_TOL
        for name in names:
            res = check_kernel(name, args, tol, f"{name} {tag}", failures)
            if timed:
                add_call(stats[name], name, args, 1, *res)
            else:
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], res[0])
    for name, st in stats.items():
        log(f"  {name}: the four A/B shapes, one call each: kernel {st['ms']:.3f} ms, plain "
            f"{st['plain_ms']:.3f} ms, bound {st['bound_ms']:.3f} ms, sdpa "
            f"{st['library_ms']:.3f} ms")
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return stats


def unet_eps(cfg, unet_f32, cond, device, dt, plain: bool = False):
    """One UNet forward (the conditioning's CFG batch, t = 981) in compute
    dtype ``dt`` with the config's per-call transforms (int8 ones
    included), through the kernels or, with ``plain``, through every
    kernel's plain version."""
    import dataclasses

    import torch
    from audioldm2_torch.diffusion.latent_diffusion import prepare_unet
    from audioldm2_torch.models import unet

    g = torch.Generator(device=device).manual_seed(12)
    ctxs, masks, y = cond
    batch = _cond_batch(cond)
    x = torch.randn((batch, cfg.latent_t_size, cfg.latent_f_size, cfg.latent_channels),
                    generator=g, device=device)
    t = torch.full((batch,), 981, dtype=torch.int32, device=device)
    dcfg = dataclasses.replace(cfg, compute_dtype="float32" if dt == torch.float32
                               else "bfloat16")
    c = [ctx.to(dt) for ctx in ctxs]
    with torch.inference_mode(), (patched_dispatch("plain") if plain else contextlib.nullcontext()):
        p, kv = prepare_unet({"unet": unet_f32}, dcfg, c)
        eps = unet.apply_unet(p, cfg.unet, x.to(dt), t, c, masks,
                              y=None if y is None else y.to(dt), cross_kv=kv).float()
    if eps.is_cuda:
        torch.cuda.synchronize()
    if not bool(torch.isfinite(eps).all()):
        raise AssertionError(f"UNet forward ({'plain' if plain else 'kernels'}, {dt}) "
                             "is not finite")
    return eps


def unet_check(tag, kernel, plain, ref, tol):
    """Log both paths against the f32 all-plain reference, and hold the
    kernel path to the all-plain path in the same dtype."""
    for path, y in (("kernels", kernel), ("plain", plain)):
        d, r = rel_err(y, ref)
        log(f"  {tag} {path} against plain f32: max_abs_err {d:.3e} rel {r:.3e}")
    d, r = rel_err(kernel, plain)
    log(f"  {tag} eps {tuple(ref.shape)}: kernels against all-plain max_abs_err {d:.3e} "
        f"rel {r:.3e} (tol {tol:g}); |eps| max {plain.abs().max().item():.3e}")
    if r > tol:
        raise AssertionError(f"UNet forward {tag}: kernels disagree with the plain path "
                             f"({r:.3e} > {tol:g})")


def build(tag, cfg, device):
    """build_model on the card with every leaf drawn non-zero (seed 0)."""
    import torch
    import audioldm2_torch as at

    log(f"== requests on path {tag}: build_model({cfg.name!r}, "
        f"weight_quant={cfg.weight_quant!r})")
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
    return model


def _on_device(tree, device):
    """The tree with its numpy leaves moved to ``device`` as tensors."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, device) for v in tree)
    return torch.from_numpy(tree).to(device) if isinstance(tree, np.ndarray) else tree


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _rss_gib():
    """(the process's peak host RSS from resource.getrusage, its current RSS
    from /proc/self/status) in GiB."""
    import resource

    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, now / 2**20  # KiB


def write_checkpoint(tag, model, ckpt_dir: str):
    """The model's drawn tree (the nested AudioMAE encoder included), in the
    reference's key layout, torch.save'd as {"state_dict": ...}. Fails if
    the disk is short. Returns (path, the tree written)."""
    import shutil

    import torch
    from audioldm2_torch.tools import reference_layout

    cfg = model.cfg
    full = model.ldm.params
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    need = nbytes(t for _, t in _paths(full))
    free = shutil.disk_usage(ckpt_dir).free
    def n_params(pred):
        return sum(t.numel() for k, t in _paths(full) if pred(k)) / 1e6

    def cond_clap_audio(k):  # the conditioner CLAP's, not the reranker's (which reads them)
        return k.startswith("/cond/") and re.search("/clap/audio_(branch|projection)/", k)

    log(f"  checkpoint: {need / 1e9:.3f} GB of leaves; {free / 1e9:.1f} GB free in {ckpt_dir}")
    log("  read by no request of this path (as in the JAX package): the nested AudioMAE encoder "
        f"{n_params(lambda k: '/crossattn_audiomae_pooled/' in k):.3f} M (read once by the mae "
        "path's check on the loaded model), the CLAP heads text_transform and audio_transform "
        f"{n_params(lambda k: '_transform/' in k):.3f} M, the text-mode conditioner CLAP's audio "
        f"tower and projection {n_params(cond_clap_audio):.3f} M parameters")
    if free < need * 1.1 + 2**30:
        raise RuntimeError(f"path {tag}: {free / 1e9:.1f} GB free in {ckpt_dir}, the checkpoint "
                           f"needs {need / 1e9:.1f} GB (set TMPDIR to a larger disk)")
    path = os.path.join(ckpt_dir, f"{cfg.name}.pth")
    rss0 = _rss_gib()
    t0 = time.perf_counter()
    reference_layout.save_pth(path, reference_layout.reference_state_dict(full, cfg))
    save_s = time.perf_counter() - t0
    rss1 = _rss_gib()
    log(f"  torch.save: {os.path.getsize(path) / 1e9:.3f} GB in {save_s:.2f} s; host RSS "
        f"{rss0[1]:.2f} GiB before, {rss1[1]:.2f} GiB after, peak {rss0[0]:.2f} GiB before, "
        f"{rss1[0]:.2f} GiB after (resource.getrusage)")
    torch.cuda.synchronize()
    return path, full


@contextlib.contextmanager
def load_timed(times):
    """Time torch.load, the whole load_checkpoint_params (load plus
    conversion) and from_jax_tree (the transfer to the device; outermost
    call only: it recurses) inside build_model(ckpt_path)."""
    import torch
    from audioldm2_torch import params as params_m, pipeline

    saved = (torch.load, pipeline.load_checkpoint_params, params_m.from_jax_tree)
    depth = {}

    def timed(key, fn, sync=False):
        def call(*args, **kw):
            depth[key] = depth.get(key, 0) + 1
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                if sync:
                    torch.cuda.synchronize()
            finally:
                depth[key] -= 1
            if not depth[key]:
                times[key] = times.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    torch.load = timed("torch_load_s", saved[0])
    pipeline.load_checkpoint_params = timed("load_and_convert_s", saved[1])
    params_m.from_jax_tree = timed("to_device_s", saved[2], sync=True)
    try:
        yield times
    finally:
        torch.load, pipeline.load_checkpoint_params, params_m.from_jax_tree = saved


def load_checkpoint(tag, path: str, cfg, device, weight_quant=None):
    """build_model(ckpt_path=path) on the card, its wall split into
    torch.load, conversion and transfer to the device, with the host's peak
    RSS and the device memory after the build."""
    import torch
    import audioldm2_torch as at

    log(f"== requests on path {tag}: build_model(ckpt_path={os.path.basename(path)!r}, "
        f"config={cfg.name!r}, weight_quant={weight_quant!r})")
    torch.cuda.empty_cache()
    times, rss0 = {}, _rss_gib()
    t0 = time.perf_counter()
    with load_timed(times):
        model = at.build_model(ckpt_path=path, config=cfg, device=device,
                               weight_quant=weight_quant)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(model.ldm.params))
    log(f"  build_model(ckpt_path): {wall:.2f} s = torch.load {times['torch_load_s']:.2f} s + "
        f"conversion {times['load_and_convert_s'] - times['torch_load_s']:.2f} s + transfer to "
        f"the device {times['to_device_s']:.2f} s + the rest "
        f"{wall - times['load_and_convert_s'] - times['to_device_s']:.2f} s; "
        f"{n_bytes / 1e9:.3f} GB of parameters on {torch.cuda.get_device_name(0)}; device memory "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB; host RSS "
        f"{rss0[1]:.2f} GiB before, peak {_rss_gib()[0]:.2f} GiB after (resource.getrusage; "
        f"{rss0[0]:.2f} before); {nvidia_smi_line()}")
    for leaf in _leaves(model.ldm.params):
        if leaf.device.type != torch.device(device).type:
            raise AssertionError(f"a loaded parameter lies on {leaf.device}, not {device}")
    return model


def hold_equal(loaded, want) -> int:
    """Every leaf of the loaded tree torch.equal to the one written, and
    contiguous; returns the leaf count."""
    import torch

    got, exp = dict(_paths(loaded)), dict(_paths(want))
    if sorted(got) != sorted(exp):
        raise AssertionError(f"loaded tree paths differ from the written tree's: "
                             f"{sorted(set(got) ^ set(exp))[:10]}")
    bad = [k for k in exp if not (torch.equal(got[k], exp[k]) and got[k].is_contiguous())]
    if bad:
        raise AssertionError(f"{len(bad)} loaded leaves differ from the written ones or are not "
                             f"contiguous: {bad[:10]}")
    log(f"  every one of the {len(exp)} loaded leaves equals the written one (torch.equal) and is "
        "contiguous")
    return len(exp)


def one_request(model, call, expected, bsz: int, duration: float, label: str):
    """call(bsz) -> waveform, with the launch counts set to 0 just before and
    read just after; checks the output, the conditioning, that no CUDA
    tensor reached a plain version, that no bf16 call reached the shared
    core, the counts, that no split-K workspace was allocated and that the
    UNet graph replayed every step but the first (``unet_graph_counts``).
    Returns (wall, counts, {stage: wall}) with the sequence generator's and
    the vocoder's walls and the graph's captures and replays."""
    import numpy as np
    import torch
    from audioldm2_torch import ops

    cond, on_core, work = {}, {}, {}
    timings_before = model.last_timings
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_versions_forbidden(), conditioning_recorded(cond), \
            shared_core_bf16_counted(on_core), workspaces_counted(work):
        wav = call(bsz)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  request {label}, batch {bsz}, {duration} s: wall {wall:.3f} s, real-time factor "
        f"{duration * bsz / wall:.3f}x, peak memory {peak:.2f} GiB, timings "
        f"{json.dumps({k: round(v, 4) for k, v in model.last_timings.items()})}")
    log(f"    launches {counts}; split-K workspaces allocated {work['workspaces']}")
    if on_core:
        raise AssertionError(f"K1 (bf16, f32), K4, K1q, K3q, K5 or K4q (bf16) calls on the shared "
                             f"core instead of their kernels: {on_core}")
    if work["workspaces"]:
        raise AssertionError(f"{work['workspaces']} split-K workspaces allocated in a request; "
                             "no request should allocate one")
    want_shape = (bsz, 1, int(duration * model.cfg.preprocessing.sampling_rate))
    if wav.shape != want_shape:
        raise AssertionError(f"waveform shape {wav.shape}, expected {want_shape}")
    if not np.isfinite(wav).all() or not np.abs(wav).max() > 0 or np.abs(wav).max() > 1.0:
        raise AssertionError("waveform is not finite, all zero, or out of [-1, 1]")
    log(f"    waveform {wav.shape} rms {float(np.sqrt(np.mean(wav ** 2))):.4f} "
        f"max {float(np.abs(wav).max()):.4f}")
    for tokens in cond.get("gpt2", []):
        if tokens.shape[0] != bsz or not bool(torch.isfinite(tokens).all()):
            raise AssertionError(f"GPT-2 tokens {tuple(tokens.shape)} not finite or mis-sized")
    for emb in cond.get("clap", []):
        dev = (torch.linalg.vector_norm(emb.float(), dim=-1) - 1.0).abs().max().item()
        if dev > 1e-4:
            raise AssertionError(f"CLAP text embedding norm is off 1 by {dev:.3e}")
    for emb in cond.get("clap_audio", []):
        dev = (torch.linalg.vector_norm(emb.float(), dim=-1) - 1.0).abs().max().item()
        if dev > 1e-4:
            raise AssertionError(f"CLAP audio embedding norm is off 1 by {dev:.3e}")
    if cond.get("gpt2"):
        log(f"    GPT-2 tokens {[tuple(t.shape) for t in cond['gpt2']]} finite; CLAP "
            f"embeddings {[tuple(e.shape) for e in cond['clap']]} of unit norm")
    stages = {k: sum(cond[k]) for k in ("gpt2_s", "vocoder_s") if cond.get(k)}
    voc_ops = sum(cond.get("vocoder_s_ops", []))
    log(f"    walls: sequence generator {stages.get('gpt2_s', 0.0):.3f} s, vocoder "
        f"{stages.get('vocoder_s', 0.0):.3f} s ({voc_ops / 1e12:.3f} TFLOP, "
        f"{voc_ops / 1e12 / max(stages.get('vocoder_s', 0.0), 1e-9):.1f} TF/s)")
    for cands, b, n, kept in cond.get("rerank", []):
        if n <= 1:
            continue
        sim = model.last_similarities
        if sim is None or sim.shape != (b * n,) or not np.isfinite(sim).all() or \
                np.abs(sim).max() > 1.0 + 1e-5:
            raise AssertionError(f"rerank similarities {sim} not finite, mis-sized or outside "
                                 "[-1, 1]")
        picks = [i + int(np.argmax(sim[i::b])) * b for i in range(b)]
        if not np.array_equal(kept, cands[picks]):
            raise AssertionError(f"the kept candidates are not the argmax picks {picks}")
        log(f"    rerank of {b * n} candidates: similarities "
            f"{' '.join(f'{v:.4f}' for v in sim)}, kept {picks} (the argmax of each prompt's); "
            f"CLAP audio embeddings {[tuple(e.shape) for e in cond['clap_audio']]} of unit "
            f"norm; rerank_s {model.last_timings['rerank_s']:.4f}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    stages.update(unet_graph_counts(model, timings_before))
    return wall, counts, stages


def unet_graph_counts(model, timings_before) -> dict:
    """The UNet graph's captures and replays of the request whose
    ``last_timings`` replaced ``timings_before`` (none where the call left
    them as they were); on the card each sampler step but the eager first
    must be a replay."""
    import torch

    t = model.last_timings
    if t is timings_before or "unet_graph_replays" not in t:
        return {}
    got = {k: t[k] for k in ("unet_graph_captures", "unet_graph_replays")}
    steps = t.get("sampler_steps", 0)
    log(f"    UNet graph: {got['unet_graph_captures']} captures, {got['unet_graph_replays']} "
        f"replays of {steps} sampler steps")
    if torch.device(model.device).type == "cuda" and got["unet_graph_replays"] < steps - 1:
        raise AssertionError(f"{got['unet_graph_replays']} UNet graph replays in a request of "
                             f"{steps} steps: each step but the eager first should replay")
    return got


PROMPTS = [("A dog barking in the distance.", 1), ("Rain on a tin roof.", 1),
           ("A violin melody in a large hall.", 1), ("Waves crashing on rocks.", 2)]
# Depth, so that the whole run keeps well inside its time on a slow host:
# the t5 path one batch-1 and one batch-2 request; the 48k and tts paths one
# and one; the full, sr, mae, full8 and large paths one batch-1 request
# (full8's kernels are the full path's int8 siblings at the same shapes, the
# large path's batch-1 request at 3 candidates runs its UNet at CFG batch 6,
# above a batch-2 request's 4, and the golden path serves audioldm2-full
# again in f32, bf16 and int8)
PROMPTS_T5 = PROMPTS[:1] + PROMPTS[3:]
PROMPTS_SHORT = PROMPTS[2:]
PROMPTS_ONE = PROMPTS[2:3]
TRANSCRIPTION = "The quick brown fox jumps over the lazy dog, twice."


def phase_requests(tag, model, request, expected, steps: int, duration: float, label: str,
                   prompts=None):
    """A short warm-up request (allocator, cuDNN plans, lazy module state),
    then the batch-1 requests and any batch-2 request of ``prompts``
    (PROMPTS_T5 by default) through ``request(prompt, batchsize, steps,
    duration)``; returns the launch counts of the first request and the
    timings."""
    request("warm up", 1, 10, 2.5)
    launches, walls, stage_walls = None, {1: [], 2: []}, {}
    for prompt, bsz in prompts or PROMPTS_T5:
        wall, counts, stages = one_request(model, lambda b: request(prompt, b, steps, duration),
                                           expected, bsz, duration, f"{label}, {steps} steps")
        launches = launches or counts
        walls[bsz].append(wall)
        for k, v in stages.items():
            stage_walls.setdefault(k, []).append(round(v, 4))
    p50 = sorted(walls[1])[len(walls[1]) // 2]
    s_audio = duration * 2 / walls[2][0] if walls[2] else None
    graph = {k: stage_walls[k] for k in ("unet_graph_captures", "unet_graph_replays")
             if k in stage_walls}
    log(f"  path {tag} end to end ({duration} s clips, {steps} steps): p50 latency at batch 1 "
        f"{p50:.3f} s over {len(walls[1])} requests"
        + (f"; {s_audio:.3f} s-audio/s at batch 2" if s_audio else "; no batch-2 request")
        + (f"; UNet graph captures {graph['unet_graph_captures']}, replays "
           f"{graph['unet_graph_replays']} a request" if graph else ""))
    return launches, {"p50_s": p50, "s_audio_per_s": s_audio, "batch1_s": walls[1],
                      "batch2_s": walls[2], **stage_walls}


def write_wav(path: str, sr: int, seconds: float) -> str:
    import numpy as np
    from scipy.io import wavfile

    wavfile.write(path, sr, (chirp(sr, seconds, seed=5) * 32767).astype(np.int16))
    return path


def phase_ab(device):
    """The A/B entry point once, with the launch counts set to 0 just before
    and read just after; K7 and K8 must have launched. Returns (counts,
    per-shape times)."""
    import torch
    from audioldm2_torch import ops
    from audioldm2_torch.tools import ab_attn_variants

    log("== path ab: python -m audioldm2_torch.tools.ab_attn_variants (bf16)")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rows = ab_attn_variants.run(reps=10, device=device, log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"    launches {counts}")
    if not (counts["v6bd_attention"] and counts["v7_attention"]):
        raise AssertionError(f"the A/B entry point did not launch K7 and K8: {counts}")
    return counts, {r["label"]: {"ms": r["ms"], "max_abs_err": r["max_abs_err"]} for r in rows}


def phase_5(t5_cfg, full_cfg, large_cfg, k48_cfg, tts_cfg, device, steps: int, duration: float):
    """The requests of every path; returns {path: launch counts of its first
    request} and {path: timings}."""
    import audioldm2_torch as at
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate as expect

    log("== phase 5: requests")
    launches, e2e = {}, {}
    launches["ab"], e2e["ab"] = phase_ab(device)

    def t2a(model, guidance=3.5, n=1, **kw):
        def request(prompt, bsz, n_steps, dur):
            return at.text_to_audio(model, prompt, seed=42, ddim_steps=n_steps, duration=dur,
                                    batchsize=bsz, guidance_scale=guidance,
                                    n_candidate_gen_per_text=n, **kw)
        return request

    model = build("t5", t5_cfg, device)
    launches["t5"], e2e["t5"] = phase_requests(
        "t5", model, t2a(model), expect(model.cfg, steps), steps, duration,
        "text_to_audio ddim, guidance 3.5")
    for sampler in ("plms", "ddpm"):
        wall, launches[f"t5_{sampler}"], _ = one_request(
            model, lambda b: t2a(model, sampler=sampler)("A bell tolling twice.", b, steps,
                                                         duration),
            expect(model.cfg, steps, sampler), 1, duration,
            f"text_to_audio {sampler}, {steps if sampler == 'plms' else 'all 1000'} steps")
        e2e[f"t5_{sampler}"] = {"wall_s": wall}
    launches["multi_dp1"], e2e["multi_dp1"] = phase_multi_dp1(model, steps, duration)
    # the train path takes the same drawn weights last: it updates them
    launches["train"], e2e["train"] = phase_train(model, device)
    del model

    # the full and full8 paths serve from a checkpoint file of the drawn weights
    with tempfile.TemporaryDirectory() as ckpt_dir:
        drawn = build("full (drawn, to be written)", full_cfg, device)
        path, written = write_checkpoint("full", drawn, ckpt_dir)
        del drawn
        model = load_checkpoint("full", path, full_cfg, device)
        hold_equal(model.ldm.params, written)
        del written
        launches["full"], e2e["full"] = phase_requests(
            "full", model, t2a(model), expect(model.cfg, steps), steps, duration,
            "text_to_audio ddim, guidance 3.5", PROMPTS_ONE)
        e2e["full"]["loaded_audiomae_s"] = phase_mae_loaded(model, device)
        log("== requests on path sr: the same model through super_resolution_and_inpainting")
        with tempfile.TemporaryDirectory() as tmp:
            wav_path = write_wav(os.path.join(tmp, "in.wav"),
                                 full_cfg.preprocessing.sampling_rate, duration)

            def sr_request(prompt, bsz, n_steps, dur):
                return at.super_resolution_and_inpainting(
                    model, prompt, original_audio_file_path=wav_path, seed=42,
                    ddim_steps=n_steps, duration=dur, batchsize=bsz, guidance_scale=2.5,
                    n_candidate_gen_per_text=1)

            launches["sr"], e2e["sr"] = phase_requests(
                "sr", model, sr_request, expect(model.cfg, steps, encode=True), steps,
                duration, "super_resolution_and_inpainting, guidance 2.5", PROMPTS_ONE)
        del model

        model = load_checkpoint("full8", path, full_cfg, device, weight_quant="int8")
        launches["full8"], e2e["full8"] = phase_requests(
            "full8", model, t2a(model), expect(model.cfg, steps), steps, duration,
            "text_to_audio ddim, guidance 3.5", PROMPTS_ONE)
        del model
    log(f"  checkpoint {os.path.basename(path)} deleted")

    model = build("large", large_cfg, device)
    launches["large"], e2e["large"] = phase_requests(
        "large", model, t2a(model, n=3), expect(model.cfg, steps), steps, duration,
        "text_to_audio ddim, guidance 3.5, 3 candidates reranked by CLAP", PROMPTS_ONE)
    del model

    model = build("48k", k48_cfg, device)
    three, one = t2a(model, n=3), t2a(model)

    def k48_request(prompt, bsz, n_steps, dur):  # 3 candidates at batch 1, 1 at batch 2
        return (three if bsz == 1 else one)(prompt, bsz, n_steps, dur)

    launches["48k"], e2e["48k"] = phase_requests(
        "48k", model, k48_request, expect(model.cfg, steps), steps, duration,
        "text_to_audio ddim, guidance 3.5, 3 candidates reranked by CLAP at batch 1, 1 at "
        "batch 2", PROMPTS_SHORT)
    del model
    launches["clapaudio"], e2e["clapaudio"] = phase_clapaudio(k48_cfg, device, steps, duration,
                                                              launches["48k"])

    model = build("tts", tts_cfg, device)
    launches["tts"], e2e["tts"] = phase_requests(
        "tts", model, t2a(model, transcription=TRANSCRIPTION), expect(model.cfg, steps), steps,
        duration, f"text_to_audio ddim, guidance 3.5, transcription {TRANSCRIPTION!r}",
        PROMPTS_SHORT)
    del model
    launches["mae"], e2e["mae"] = phase_mae(full_cfg, device, steps, duration)
    launches["towers"], e2e["towers"] = phase_towers(t5_cfg, device, steps, duration, t2a)
    return launches, e2e


# The audio-in paths (clapaudio, mae, towers). Each CLAP tower, and the
# AudioMAE conditioner on the full path's loaded weights, runs on the card
# in f32 with TF32 off and on CPU copies of the same leaves and inputs:
# max|card - cpu| / max|cpu| <= AUDIO_IN_TOL.
AUDIO_IN_TOL = 1e-4
TOWER_PROMPTS = ["A dog barking in the distance.", "Rain on a tin roof."]
TOWER_PAIRS = (("PANN-14", "bert"), ("PANN-10", "bart"), ("PANN-14", "transformer"))


def synced_s(fn, reps: int = 3):
    """(fn()'s first result, the median wall in seconds of ``reps`` more
    calls), the device synchronized around each call."""
    import torch

    out = fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, sorted(walls)[len(walls) // 2]


def card_against_cpu(tag, fn, params, inputs):
    """fn(params, *inputs) on the card and on CPU copies of the same leaves
    and inputs, in f32 with TF32 off; fails if the card's output is not
    finite or is off the CPU's by more than AUDIO_IN_TOL. Returns (the
    card's output, its median wall in seconds)."""
    import torch
    from audioldm2_torch.params import map_tree

    with torch.inference_mode():
        got, wall = synced_s(lambda: fn(params, *inputs))
        want = fn(map_tree(lambda t: t.cpu(), params), *(t.cpu() for t in inputs))
    d, r = rel_err(got.cpu(), want)
    log(f"  {tag}: output {tuple(got.shape)}, card against CPU (same leaves, f32) max_abs_err "
        f"{d:.3e} rel {r:.3e} (tol {AUDIO_IN_TOL:g}); {wall * 1e3:.2f} ms on the card")
    if not bool(torch.isfinite(got).all()) or r > AUDIO_IN_TOL:
        raise AssertionError(f"{tag}: not finite, or off the CPU's output by {r:.3e}")
    return got, wall


def audio_request(model, make_batch, steps: int, duration: float):
    """request(bsz, n_steps, dur) of an audio-in path: make_batch(bsz) (the
    pipeline's make_batch with a waveform), then model.ldm.generate at
    guidance 3.5 and seed 42, as the JAX package's tests drive its audio
    modes; [bsz, 1, N] float32, the stages in model.last_timings."""
    import torch
    from audioldm2_torch import pipeline
    from audioldm2_torch.utils import profiling

    def request(bsz, n_steps=steps, dur=duration):
        with profiling.request(model.device) as req:
            t0 = time.perf_counter()
            batch = make_batch(bsz)
            t1 = time.perf_counter()
            gen = torch.Generator(device=model.device).manual_seed(42)
            wav, _ = model.ldm.generate(batch, gen, n_gen=1, guidance=3.5, ddim_steps=n_steps,
                                        latent_t_size=int(dur * model.cfg.latent_t_per_second))
            t2 = time.perf_counter()
        pipeline._record_timings(model, req, dur, bsz, batch_s=t1 - t0, generate_s=t2 - t1)
        return wav[:, None, :int(dur * model.cfg.preprocessing.sampling_rate)]
    return request


def _audiomae_spec(cfg):
    """The nested audiomae_pooled spec of cfg's sequence generator."""
    return next(ns for ns in cfg.conditioners[0].nested if ns.kind == "audiomae_pooled")


def phase_clapaudio(k48_cfg, device, steps: int, duration: float, want_counts):
    """audioldm_48k with its CLAP conditioner in embed_mode="audio": a 10 s
    48 kHz clip through make_batch("", waveform=), HTSAT-base timed on it,
    one batch-1 request whose launches must equal the 48k path's."""
    import torch
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate
    from audioldm2_torch.models import clap
    from audioldm2_torch.tools.golden_parity import variant_config

    cfg = variant_config(k48_cfg, "clapaudio")
    spec = cfg.conditioners[0]
    model = build("clapaudio (audioldm_48k, CLAP in embed_mode='audio')", cfg, device)
    wav = chirp(cfg.preprocessing.sampling_rate, 10.0, seed=11)[None]
    batch = model.make_batch("", waveform=wav)
    clip = batch["clap_waveform_48k"]
    if tuple(clip.shape) != (1, spec.clap.clip_samples):
        raise AssertionError(f"clap_waveform_48k {tuple(clip.shape)}, expected (1, 480000)")
    p = model.ldm.params["cond"][spec.name]["clap"]
    with torch.inference_mode():
        emb, htsat_s = synced_s(lambda: clap.audio_embedding(p, spec.clap, clip))
    dev = (torch.linalg.vector_norm(emb, dim=-1) - 1.0).abs().max().item()
    if tuple(emb.shape) != (1, spec.clap.embed_dim) or dev > 1e-4:
        raise AssertionError(f"CLAP audio embedding {tuple(emb.shape)}, norm off 1 by {dev:.3e}")
    log(f"  clap_waveform_48k {tuple(clip.shape)}; CLAP audio embedding (HTSAT-base, one 10 s "
        f"clip, projection) {tuple(emb.shape)} of unit norm (off by {dev:.2e}): "
        f"{htsat_s * 1e3:.2f} ms")
    request = audio_request(model, lambda b: model.make_batch("", batchsize=b, waveform=wav),
                            steps, duration)
    request(1, 10, 2.5)  # warm up
    wall, counts, _ = one_request(model, request, kernel_launches_per_generate(cfg, steps), 1,
                                  duration, f"make_batch(waveform=) + generate, {steps} steps, "
                                  "guidance 3.5")
    if counts != want_counts:
        raise AssertionError(f"clapaudio launches {counts} != the 48k path's {want_counts}")
    log(f"  path clapaudio: batch-1 wall {wall:.3f} s; launches equal the 48k path's")
    return counts, {"batch1_s": wall, "htsat_s": htsat_s}


def phase_mae_loaded(model, device):
    """The nested AudioMAE conditioner of the full path's loaded model, once
    on a 10 s 16 kHz clip: its 8 pooled tokens on the card against the
    same call on the CPU on the same leaves."""
    from audioldm2_torch.models import conditioners

    spec = _audiomae_spec(model.cfg)
    sg = model.cfg.conditioners[0].name
    p = model.ldm.params["cond"][sg]["cond"][spec.name]
    n = sum(t.numel() for t in _leaves(p))
    batch = model.make_batch("", waveform=chirp(16000, 10.0, seed=12)[None])
    tokens, wall = card_against_cpu(
        f"mae: the loaded nested AudioMAE ({n / 1e6:.3f} M parameters from the checkpoint), "
        "batch 1", lambda q, fb: conditioners.encode(q, spec, {"ta_kaldi_fbank": fb})[1][0],
        p, (batch["ta_kaldi_fbank"],))
    if tuple(tokens.shape) != (1, 8, 768):
        raise AssertionError(f"AudioMAE tokens {tuple(tokens.shape)}, expected (1, 8, 768)")
    return wall


def phase_mae(full_cfg, device, steps: int, duration: float):
    """audioldm2-full's UNet conditioned by (the TTA generator's nested
    audiomae_pooled(8, 8) spec, the t5 spec): the 8 pooled tokens x 768
    fill the 768-wide slot. AudioMAE timed at batch 1 and 2, then one
    batch-1 request on a 10 s 16 kHz clip."""
    import torch
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate
    from audioldm2_torch.models import conditioners
    from audioldm2_torch.tools.golden_parity import variant_config

    cfg = variant_config(full_cfg, "mae")
    spec = cfg.conditioners[0]
    model = build("mae (audioldm2-full, conditioners AudioMAE + T5)", cfg, device)
    wav = chirp(cfg.preprocessing.sampling_rate, 10.0, seed=12)[None]
    p = model.ldm.params["cond"][spec.name]
    walls = {}
    for b in (1, 2):
        batch = model.make_batch("", batchsize=b, waveform=wav)
        with torch.inference_mode():
            (_, (tokens, _)), walls[f"audiomae_b{b}_s"] = synced_s(
                lambda: conditioners.encode(p, spec, batch))
        if tuple(tokens.shape) != (b, 8, 768) or not bool(torch.isfinite(tokens).all()):
            raise AssertionError(f"AudioMAE tokens {tuple(tokens.shape)} not finite or mis-sized")
        log(f"  AudioMAE (ViT-B/16, 1024 x 128 fbank, pooled to 8 tokens) at batch {b}: "
            f"{walls[f'audiomae_b{b}_s'] * 1e3:.2f} ms")
    request = audio_request(model, lambda b: model.make_batch("", batchsize=b, waveform=wav),
                            steps, duration)
    request(1, 10, 2.5)  # warm up
    walls["batch1_s"], launches, _ = one_request(
        model, request, kernel_launches_per_generate(cfg, steps), 1, duration,
        f"make_batch(waveform=) + generate, {steps} steps, guidance 3.5")
    return launches, walls


def phase_towers(t5_cfg, device, steps: int, duration: float, t2a):
    """PANN-14, PANN-10, bert, bart and the CLIP-BPE transformer at their
    published widths, batch 2, each held against the CPU; then one
    text_to_audio request at 3 candidates on the t5 model reranked by a
    PANN-14 + transformer CLAP."""
    import dataclasses

    import numpy as np
    import torch
    from audioldm2_torch.config import CLAPConfig
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate
    from audioldm2_torch.models import clap
    from audioldm2_torch.params import Init
    from audioldm2_torch.utils import text as text_utils

    log("== path towers: the CLAP towers at published width, batch 2, card against CPU")
    g = torch.Generator(device=device).manual_seed(13)
    wav = torch.from_numpy(np.stack([chirp(48000, 10.0, seed=s) for s in (13, 14)])).to(device)
    walls = {}
    for amodel, tmodel in TOWER_PAIRS:
        cfg = CLAPConfig(amodel=amodel, tmodel=tmodel)
        p = clap.init_clap(Init(g, device, nonzero=True), cfg)
        if amodel not in walls:
            _, walls[amodel] = card_against_cpu(
                f"{amodel} audio embedding of two 10 s 48 kHz clips",
                lambda q, w: clap.audio_embedding(q, cfg, w), p, (wav,))
        ids, mask = (torch.as_tensor(a, device=device)
                     for a in text_utils.clap_tokenizer(cfg)(TOWER_PROMPTS))
        _, walls[tmodel] = card_against_cpu(
            f"{tmodel} text embedding of two prompts ({ids.shape[1]} tokens)",
            lambda q, i, m: clap.text_embedding(q, cfg, i, m), p, (ids, mask))
        del p
    cfg = dataclasses.replace(t5_cfg, reranker_clap=CLAPConfig(amodel="PANN-14",
                                                               tmodel="transformer"))
    model = build("towers (audioldm_16k_crossattn_t5, PANN-14 + transformer reranker)", cfg,
                  device)
    wall, counts, _ = one_request(
        model, lambda b: t2a(model, n=3)(TOWER_PROMPTS[0], b, steps, duration),
        kernel_launches_per_generate(cfg, steps), 1, duration,
        f"text_to_audio ddim, {steps} steps, 3 candidates reranked by PANN-14 + transformer")
    if model.last_similarities is None or model.last_similarities.shape != (3,):
        raise AssertionError("the PANN-14 + transformer rerank did not score 3 candidates")
    return counts, {**{f"{k}_s": v for k, v in walls.items()}, "batch1_s": wall,
                    "rerank_s": model.last_timings["rerank_s"]}


# The train path: make_full_train_step at full width in f32 (the step's own
# precision, as in JAX), TRAIN_BATCH clips of 10.24 s, TRAIN_STEPS AdamW
# steps at TRAIN_LR on one batch with the same draws every step. One
# step's loss through the kernels and through the plain versions agree
# within TRAIN_LOSS_TOL (relative), and each UNet leaf's gradient within
# TRAIN_GRAD_TOL (||g_kernel - g_plain|| / ||g_plain||).
TRAIN_BATCH = 4
TRAIN_STEPS = 8
TRAIN_LR = 1e-4
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_CLIPS = 8
# The step through the kernels against the all-plain step: TRAIN_AB_STEPS
# steps of each after the checked ones, timed by the median of all but
# the first, with the peak memory of each
TRAIN_AB_STEPS = 6
# The kernels with a gradient (ops.autograd), those of the f32 train step
TRAIN_KERNELS = ("gn_silu_conv3x3", "flash_self_attention", "ln_matmul", "geglu_matmul",
                 "group_norm_silu")


def train_batch(cfg, tmp: str):
    """TRAIN_CLIPS synthetic 16 kHz wavs (9 to 12.5 s: cropped and padded
    to 10.24 s) and their JSON manifest, read by utils.data.AudioDataset
    (seed 0); returns its first batch of TRAIN_BATCH and the host seconds."""
    import numpy as np
    from audioldm2_torch.utils.data import AudioDataset, DatasetConfig

    sr = cfg.preprocessing.sampling_rate
    entries = [{"wav": write_wav(os.path.join(tmp, f"clip{i}.wav"), sr, 9.0 + 0.5 * i),
                "caption": PROMPTS[i % len(PROMPTS)][0]} for i in range(TRAIN_CLIPS)]
    meta = os.path.join(tmp, "train.json")
    with open(meta, "w") as f:
        json.dump({"data": entries}, f)
    t0 = time.perf_counter()
    dataset = AudioDataset(DatasetConfig(metadata_paths=[meta], sampling_rate=sr), cfg, seed=0)
    batch = next(dataset.batches(TRAIN_BATCH))
    seconds = time.perf_counter() - t0
    frames = round(10.24 * sr / cfg.preprocessing.hop_length)
    want = {"fbank": (TRAIN_BATCH, frames, cfg.preprocessing.n_mel_channels, 1),
            "ta_kaldi_fbank": (TRAIN_BATCH, 1024, 128)}
    for key, shape in want.items():
        if batch[key].shape != shape or not np.isfinite(batch[key]).all():
            raise AssertionError(f"train batch {key} {batch[key].shape} is not a finite {shape}")
    log(f"  data: {TRAIN_CLIPS} wavs, AudioDataset at 10.24 s, batch {TRAIN_BATCH}: fbank "
        f"{batch['fbank'].shape}, ta_kaldi_fbank {batch['ta_kaldi_fbank'].shape}, t5_ids "
        f"{batch['t5_ids'].shape}; {seconds:.2f} s on the host")
    return batch


def _split_by_eps(first, counts):
    """The recorded calls of one train forward split into the UNet's and
    the VAE encode's (whose GroupNorms have eps 1e-6)."""
    parts = ({}, {}), ({}, {})
    for sig, args in first.items():
        f, c = parts[sig[-1] == 1e-6 and sig[0] in ("gn_silu_conv3x3", "group_norm_silu")]
        f[sig], c[sig] = args, counts[sig]
    return parts


def phase_train(model, device):
    """The train path on ``model`` (its weights are updated): the kernels
    at the step's f32 shapes against their plain versions with their
    yardsticks; one step's loss and gradients through the kernels against
    the plain path; then TRAIN_STEPS steps of make_full_train_step with an
    EMA update after each, the launch counts and backward recomputes of the
    first step held to the config's, every UNet leaf's gradient finite,
    the losses finite and falling, the EMA against its ramp formula, and
    the step's wall, forward, backward and optimizer device times and peak
    memory; then the step through the kernels against the all-plain step,
    timed and measured alike. Returns (launch counts of the first step,
    timings)."""
    import numpy as np
    import torch
    from audioldm2_torch import ops
    from audioldm2_torch.diffusion.schedule import DiffusionSchedule
    from audioldm2_torch.models import unet, vae
    from audioldm2_torch.ops.nn import full_f32
    from audioldm2_torch.parallel import ema, train

    cfg, params = model.cfg, model.ldm.params
    log(f"== path train: make_full_train_step on {cfg.name}, f32, batch {TRAIN_BATCH}, AdamW lr "
        f"{TRAIN_LR:g}, {TRAIN_STEPS} steps on one batch; {nvidia_smi_line()}")
    with tempfile.TemporaryDirectory() as tmp:
        batch = train_batch(cfg, tmp)
    g = torch.Generator(device=device).manual_seed(0)
    ds = cfg.vae.downsample_factor
    shape = (TRAIN_BATCH, batch["fbank"].shape[1] // ds, batch["fbank"].shape[2] // ds,
             cfg.vae.embed_dim)
    d = cfg.diffusion
    schedule = DiffusionSchedule.create(d.timesteps, d.beta_schedule, d.linear_start,
                                        d.linear_end)
    draws = {"posterior_noise": torch.randn(shape, generator=g, device=device),
             "t": torch.randint(0, schedule.num_timesteps, (TRAIN_BATCH,), generator=g,
                                device=device),
             "noise": torch.randn(shape, generator=g, device=device)}
    consts = train.schedule_consts(schedule, device)

    def loss_of(**kw):
        return train.full_diffusion_loss(params, cfg, consts, batch, **draws,
                                         train_unet_only=True, **kw)

    log("  -- the kernels at the step's f32 shapes (the UNet at batch "
        f"{TRAIN_BATCH}, the VAE encode of {TRAIN_BATCH} mels), against their plain versions")
    first, counts = {}, {}

    def record(name, args):
        sig = signature(name, args)
        counts[sig] = counts.get(sig, 0) + 1
        first.setdefault(sig, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                    for a in args))

    with torch.inference_mode(), full_f32(), patched_dispatch("record", record):
        loss_of()
    (unet_first, unet_counts), (enc_first, enc_counts) = _split_by_eps(first, counts)
    log(f"  UNet forward, batch {TRAIN_BATCH}, f32:")
    stats = phase_kernels(unet_first, unet_counts, offset_check=False, f32_pass=False)
    log(f"  VAE encode, batch {TRAIN_BATCH}, f32:")
    enc_stats = phase_kernels(enc_first, enc_counts, offset_check=False, f32_pass=False)
    del first, unet_first, enc_first

    log("  -- one step's loss and UNet gradients, kernels against the plain path")
    paths = [p for p, _ in _paths(params["unet"])]
    leaves = [leaf.requires_grad_(True) for _, leaf in _paths(params["unet"])]
    got = {}
    for mode in ("kernels", "plain"):
        with full_f32(), (patched_dispatch("plain") if mode == "plain"
                          else contextlib.nullcontext()):
            loss = loss_of()
            got[mode] = (loss.item(), torch.autograd.grad(loss, leaves))
        del loss
    (l_k, g_k), (l_p, g_p) = got["kernels"], got["plain"]
    loss_rel = abs(l_k - l_p) / abs(l_p)
    rels = sorted(((torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item(), p)
                  for p, a, b in zip(paths, g_k, g_p))
    finite = all(bool(torch.isfinite(a).all()) for a in g_k)
    del got, g_k, g_p
    log(f"  loss kernels {l_k:.6f}, plain {l_p:.6f}: rel {loss_rel:.3e} (tol {TRAIN_LOSS_TOL:g}); "
        f"gradients of {len(rels)} UNet leaves, ||g_kernel - g_plain|| / ||g_plain||: median "
        f"{rels[len(rels) // 2][0]:.3e}, worst {rels[-1][0]:.3e} at {rels[-1][1]} "
        f"(tol {TRAIN_GRAD_TOL:g}); all finite {finite}")
    if not finite or loss_rel > TRAIN_LOSS_TOL or rels[-1][0] > TRAIN_GRAD_TOL:
        raise AssertionError("train step: kernels disagree with the plain path")

    log(f"  -- {TRAIN_STEPS} steps of make_full_train_step, an EMA update after each")
    per_fwd = unet.kernel_launches_per_forward(cfg.unet, compute_dtype="float32")
    per_enc = vae.kernel_launches_per_encode(cfg.vae)
    expected = {k: per_fwd[k] + per_enc[k] for k in ops.KERNEL_NAMES}
    want_recomputes = {k: per_fwd[k] for k in TRAIN_KERNELS}
    optimizer = train.AdamW(TRAIN_LR)
    opt_state = optimizer.init(params["unet"])
    step = train.make_full_train_step(cfg, optimizer)
    probe = "/out_conv/w"
    shadow = ema.init(params["unet"])
    probe_start = dict(_paths(shadow.params))[probe].clone()
    probe_values = []
    events = {}
    saved_loss = train.full_diffusion_loss

    def event(key):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events[key] = e

    def timed_loss(*a, **kw):
        event("forward")
        loss = saved_loss(*a, **kw)
        event("backward")
        return loss

    saved_step = opt_state.step

    def timed_step(*a, **kw):
        event("optimizer")
        return saved_step(*a, **kw)

    def timed():
        """One step: its loss and its device times from CUDA events."""
        nonlocal params, opt_state
        event("start")
        params, opt_state, loss = step(params, opt_state, batch, **draws)
        event("end")
        torch.cuda.synchronize()
        return loss, {k: events[a].elapsed_time(events[b]) for k, (a, b) in {
            "step_ms": ("start", "end"), "forward_ms": ("forward", "backward"),
            "backward_ms": ("backward", "optimizer"), "optimizer_ms": ("optimizer", "end"),
        }.items()}

    def median(times):
        return {k: float(np.median([t[k] for t in times])) for k in times[0]}

    losses, times, recomputes = [], [], {}
    on_core, work = {}, {}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    train.full_diffusion_loss, opt_state.step = timed_loss, timed_step
    try:
        for i in range(TRAIN_STEPS):
            first_step = i == 0
            if first_step:
                ops.reset_launch_counts()
            with plain_versions_forbidden(recomputes if first_step else None), \
                    shared_core_bf16_counted(on_core), workspaces_counted(work):
                loss, t = timed()
            if first_step:
                launches = ops.launch_counts()
                missing = [p for p, leaf in _paths(params["unet"]) if leaf.grad is None
                           or not bool(torch.isfinite(leaf.grad).all())]
                if missing:
                    raise AssertionError(f"{len(missing)} UNet leaves with no finite gradient: "
                                         f"{missing[:5]}")
            shadow = ema.update(shadow, params["unet"])
            probe_values.append(dict(_paths(params["unet"]))[probe].detach().clone())
            losses.append(loss.item())
            times.append(t)
            log(f"  step {i + 1}: loss {losses[-1]:.6f}; " + ", ".join(
                f"{k} {v:.2f}" for k, v in t.items()))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  -- the step through the kernels against the all-plain step, {TRAIN_AB_STEPS} "
            f"steps of each (plain first), median of steps 2-{TRAIN_AB_STEPS}")
        ab = {}
        for mode in ("plain", "kernels"):
            torch.cuda.synchronize()
            ab_held = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            with patched_dispatch("plain") if mode == "plain" else contextlib.nullcontext():
                steps = [timed() for _ in range(TRAIN_AB_STEPS)]
            ab_peak = torch.cuda.max_memory_allocated() / 2**30
            ab[mode] = {**median([t for _, t in steps[1:]]), "peak_gib": ab_peak,
                        "step_gib": ab_peak - ab_held}
            log(f"  {mode}: losses {' '.join(f'{l.item():.5f}' for l, _ in steps)}; "
                + ", ".join(f"{k} {v:.2f}" for k, v in ab[mode].items() if k.endswith("_ms"))
                + f"; peak memory {ab_peak:.2f} GiB, {ab_peak - ab_held:.2f} above the "
                f"{ab_held:.2f} held before the first step")
            if not all(bool(torch.isfinite(l)) for l, _ in steps):
                raise AssertionError(f"{mode} steps: a loss is not finite")
    finally:
        train.full_diffusion_loss, opt_state.step = saved_loss, saved_step
    log(f"  kernels / plain: step {ab['kernels']['step_ms'] / ab['plain']['step_ms']:.3f}x, "
        f"forward {ab['kernels']['forward_ms'] / ab['plain']['forward_ms']:.3f}x, backward "
        f"{ab['kernels']['backward_ms'] / ab['plain']['backward_ms']:.3f}x, memory above the held "
        f"{ab['kernels']['step_gib'] / ab['plain']['step_gib']:.3f}x; {nvidia_smi_line()}")
    n_params = sum(t.numel() for t in _leaves(params)) / 1e6
    n_unet = sum(t.numel() for t in _leaves(params["unet"])) / 1e6
    log(f"  first step's launches {launches}; backward recomputes of the plain versions "
        f"{recomputes}; split-K workspaces (f32 K3 and K4 on the shared core) "
        f"{work['workspaces'] // TRAIN_STEPS} a step")
    if {k: launches[k] for k in expected} != expected:
        raise AssertionError(f"train step launches {launches} != UNet forward + VAE encode "
                             f"{expected}")
    if recomputes != want_recomputes:
        raise AssertionError(f"backward recomputes {recomputes} != the UNet forward's launches "
                             f"{want_recomputes}")
    if on_core:
        raise AssertionError(f"f32 K1 calls on the shared core in the train step: {on_core}")
    if not np.isfinite(losses).all() or not min(losses[-4:]) < losses[0]:
        raise AssertionError(f"train losses not finite or not falling: {losses}")
    # the EMA of the probe leaf against the ramp formula on the host
    s_host = probe_start.cpu().numpy()
    for n, p in enumerate(probe_values, start=1):
        keep = np.float32(1.0) - np.float32(ema.decay_at(n))
        s_host = s_host - keep * (s_host - p.cpu().numpy())
    got_ema = dict(_paths(shadow.params))[probe].cpu().numpy()
    ema_err = float(np.abs(got_ema - s_host).max() / np.abs(s_host).max())
    log(f"  EMA of {probe} after {shadow.updates} updates against the ramp formula on the host: "
        f"rel {ema_err:.3e}")
    if shadow.updates != TRAIN_STEPS or ema_err > 1e-6:
        raise AssertionError(f"EMA off its ramp formula ({ema_err:.3e})")
    summary = median(times[1:])
    log(f"  losses {' '.join(f'{v:.5f}' for v in losses)} (min of the last four < the first)")
    log(f"  step wall (CUDA events), median of steps 2-{TRAIN_STEPS}: "
        + ", ".join(f"{k} {v:.2f}" for k, v in summary.items())
        + f"; first step {times[0]['step_ms']:.2f} ms; peak memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated; {held:.2f} held before the first step, the whole "
        f"script's included); {n_params:.1f} M parameters, {n_unet:.1f} M "
        f"trained (f32: {4 * n_params / 1e3:.2f} GB, gradients {4 * n_unet / 1e3:.2f} GB, AdamW "
        f"moments {8 * n_unet / 1e3:.2f} GB, EMA shadow {4 * n_unet / 1e3:.2f} GB); "
        f"{nvidia_smi_line()}")
    for name, st in enc_stats.items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], st["max_abs_err"])
    return launches, {"losses": losses, "peak_gib": peak, **summary, "ab": ab,
                      "max_abs_err": {k: v["max_abs_err"] for k, v in stats.items()}}


# ---------------------------------------------------------------------------
# Phase 6: the entry points and the last single-device modules (cli, edit,
# encoder, griffinlim, native, profile, app)
# ---------------------------------------------------------------------------

# Griffin-Lim on the card against the CPU, f32, the same injected phase:
# max|card - cpu| / max|cpu| after one round and after GL_ROUNDS. Each round
# feeds the last one's phase, so the transforms' f32 summation-order
# differences grow with the rounds (the port against JAX on the CPU: 2.0e-6
# after 1 round, 2.6e-5 after 20, 4.0e-4 after 30, tests/test_torch_stft_inverse.py).
GL_ROUNDS = 30
GL_ONE_ROUND_TOL = 1e-4
GL_TOL = 2e-3
# The native resamplers (double accumulators, FMA contraction under
# -march=native) against the numpy phase-bank matmul (f32): the JAX
# package's tests/test_resample.py bound; normalize_wav's mean in double
# against numpy's f32 pairwise sum.
NATIVE_RESAMPLE_TOL = 1e-6
NATIVE_NORMALIZE_TOL = 1e-7
EDIT_PROMPT = "A violin melody in a large hall."
EDIT_CHECK_STEPS = 5  # the f32 trajectory held against the all-plain one
PROFILE_STEPS = 20
PROFILE_TOP = 25
CLI_TIMEOUT_S = 600
# Trace names of the kernels (the CUDA functions' names, demangled)
TRACE_LABELS = (("gn_stats_kernel", "K1/K1q statistics pass"),
                ("gn_silu_conv_kernel", "K1 (conv)"),
                ("flash_attn_bf16_kernel", "K2 (bf16 flash core)"),
                ("flash_attn_f32_kernel", "K2 (f32)"),
                ("row_block_matmul_bf16_kernel", "K3/K4 (row block)"),
                ("group_norm_silu_kernel", "K6"),
                ("gemm_prologue_kernel", "shared GEMM core"),
                ("splitk_reduce_kernel", "split-K reduce"))


def trace_label(name: str) -> str:
    for key, label in TRACE_LABELS:
        if key in name:
            return label
    return "-"


def phase_native():
    """The host C++ library built from the port's copy of the source; the
    resampler 48k -> 16k and 16k -> 48k on 10 s and normalize_wav against
    the numpy path, both timed (host walls)."""
    import numpy as np
    from audioldm2_torch.utils import audio_io, native

    log("== path native: the host C++ audio library (audioldm2_torch/csrc/host)")
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the host audio library did not build: {native.build_error()}")
    log(f"  built and loaded {native.library_path().name} in {time.perf_counter() - t0:.2f} s "
        f"(g++ {' '.join(native.CXX_FLAGS)})")

    def walls(fn, reps=5):
        out = fn()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return out, sorted(times)[reps // 2]

    out = {}
    for a, b in ((48000, 16000), (16000, 48000)):
        x = chirp(a, 10.0, seed=a)
        kernel, orig, new, width = audio_io.sinc_interp_hann_kernel(a, b)
        got, t_nat = walls(lambda: native.resample_sinc(x, kernel, orig, new, width))
        want, t_np = walls(lambda: audio_io._resample_sinc_np(x, kernel, orig, new, width))
        err = float(np.abs(got - want).max())
        log(f"  resample {a} -> {b} Hz, 10 s ({x.shape[0]} -> {got.shape[0]} samples): native "
            f"{t_nat * 1e3:.2f} ms, numpy {t_np * 1e3:.2f} ms (host walls, median of 5); "
            f"max_abs_err {err:.3e} (tol {NATIVE_RESAMPLE_TOL:g})")
        if got.shape != want.shape or err > NATIVE_RESAMPLE_TOL:
            raise AssertionError(f"native resample {a} -> {b} off the numpy path by {err:.3e}")
        out[f"resample_{a}_{b}"] = {"native_ms": t_nat * 1e3, "numpy_ms": t_np * 1e3,
                                    "max_abs_err": err}
    x = 0.3 * chirp(16000, 10.0, seed=3) + 0.01
    got, t_nat = walls(lambda: native.normalize_wav(x))

    def numpy_normalize():
        y = x - np.mean(x)
        return (0.5 * y / (np.max(np.abs(y)) + 1e-8)).astype(np.float32)

    want, t_np = walls(numpy_normalize)
    err = float(np.abs(got - want).max())
    log(f"  normalize_wav, 10 s at 16 kHz: native {t_nat * 1e3:.3f} ms, numpy {t_np * 1e3:.3f} ms; "
        f"max_abs_err {err:.3e} (tol {NATIVE_NORMALIZE_TOL:g})")
    if err > NATIVE_NORMALIZE_TOL:
        raise AssertionError(f"native normalize_wav off the numpy path by {err:.3e}")
    out["normalize"] = {"native_ms": t_nat * 1e3, "numpy_ms": t_np * 1e3, "max_abs_err": err}
    return out


def phase_griffinlim(device):
    """griffin_lim on the STFT magnitude of a 10 s 16 kHz chirp (1024 / 160
    / 1024), the initial phase injected, card against CPU in f32."""
    import numpy as np
    import torch
    from audioldm2_torch.ops import stft

    log(f"== path griffinlim: {GL_ROUNDS} Griffin-Lim rounds on a 10 s 16 kHz chirp "
        "(1024 / 160 / 1024), card against CPU, f32")
    f, h, w = 1024, 160, 1024
    wav = torch.from_numpy(chirp(16000, 10.0, seed=9)[None])
    mag, _ = stft.stft_full(wav, torch.from_numpy(stft.stft_basis(f, w)), f, h)
    phase = torch.from_numpy(np.random.default_rng(9).uniform(
        -np.pi, np.pi, tuple(mag.shape)).astype(np.float32))
    def run(dev, rounds):
        t0 = time.perf_counter()
        y = stft.griffin_lim(mag.to(dev), f, h, w, n_iters=rounds, phase=phase.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        return y.cpu(), time.perf_counter() - t0

    run(device, 1)  # warm-up (cuDNN plans)
    out = {}
    for rounds, tol in ((1, GL_ONE_ROUND_TOL), (GL_ROUNDS, GL_TOL)):
        got, t_card = run(device, rounds)
        want, t_cpu = run("cpu", rounds)
        d, r = rel_err(got, want)
        log(f"  {rounds} round(s), magnitude {tuple(mag.shape)} -> waveform {tuple(got.shape)}: "
            f"card {t_card:.3f} s, CPU {t_cpu:.3f} s (walls); card against CPU max_abs_err "
            f"{d:.3e} rel {r:.3e} (tol {tol:g})")
        if not bool(torch.isfinite(got).all()) or r > tol:
            raise AssertionError(f"griffin_lim ({rounds} rounds): card off the CPU by {r:.3e}")
        out[f"rounds_{rounds}"] = {"card_s": t_card, "cpu_s": t_cpu, "rel_err": r}
    return out


def phase_encoder(t5_cfg, device):
    """The EncoderUNet classifier at the t5 UNet's widths (in_channels 8,
    out_channels 10; no shipped config instantiates it) on the t5 latent
    [2, 256, 16, 8], kernels against the all-plain path in bf16 and f32,
    its launches against kernel_launches_per_encoder_forward."""
    import dataclasses

    import torch
    from audioldm2_torch import ops
    from audioldm2_torch.models import unet
    from audioldm2_torch.params import Init, cast_floating

    ucfg = dataclasses.replace(t5_cfg.unet, in_channels=t5_cfg.latent_channels, out_channels=10)
    shape = (2, t5_cfg.latent_t_size, t5_cfg.latent_f_size, t5_cfg.latent_channels)
    log(f"== path encoder: EncoderUNet classifier (model_channels {ucfg.model_channels}, "
        f"channel_mult {ucfg.channel_mult}, attention_resolutions {ucfg.attention_resolutions}, "
        f"num_head_channels {ucfg.num_head_channels}, 8 -> 10), latent {list(shape)}; no "
        "shipped config instantiates it")
    g = torch.Generator(device=device).manual_seed(15)
    p32 = unet.init_encoder_unet(Init(g, device, nonzero=True), ucfg)
    x = torch.randn(shape, generator=g, device=device)
    t = torch.tensor([981, 17], dtype=torch.int32, device=device)
    want_counts = unet.kernel_launches_per_encoder_forward(ucfg)
    counts, out = None, {}
    for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        p = cast_floating(p32, dt)

        def fwd():
            return unet.apply_encoder_unet(p, ucfg, x.to(dt), t)

        with torch.inference_mode():
            with patched_dispatch("plain"):
                want = fwd().float()
                plain_ms = cuda_ms(fwd, target_ms=100.0, max_reps=10)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with plain_versions_forbidden():
                got = fwd().float()
            torch.cuda.synchronize()
            counts = counts or ops.launch_counts()
            kern_ms = cuda_ms(fwd, target_ms=100.0, max_reps=10)
        d, r = rel_err(got, want)
        log(f"  {dt}: logits {tuple(got.shape)}, kernels against all-plain max_abs_err {d:.3e} "
            f"rel {r:.3e} (tol {tol:g}); kernels {kern_ms:.3f} ms, all-plain {plain_ms:.3f} ms")
        if not bool(torch.isfinite(got).all()) or r > tol:
            raise AssertionError(f"EncoderUNet {dt}: kernels disagree with the plain path")
        out[str(dt).split(".")[-1]] = {"ms": kern_ms, "plain_ms": plain_ms, "rel_err": r}
    log(f"    launches (bf16 forward) {counts}")
    if counts != want_counts:
        raise AssertionError(f"EncoderUNet launches {counts} != {want_counts}")
    return counts, out


def edit_request(model, wav_path: str, t_enc: int, steps: int, duration: float):
    """request(bsz) of the edit path: the wav read and turned into the
    log-mel as the sr path does, the f32 VAE encode, stochastic_encode to
    DDIM-subset step t_enc of ``steps``, ddim_decode under EDIT_PROMPT at
    guidance 3.5 (CFG batch 2), the VAE decode and the vocoder."""
    import torch
    import audioldm2_torch as at
    from audioldm2_torch import pipeline
    from audioldm2_torch.utils import profiling

    cfg = model.cfg
    pre = cfg.preprocessing
    frames = int(duration * cfg.latent_t_per_second * cfg.vae.downsample_factor)

    def request(bsz):
        with profiling.request(model.device) as req:
            gen = torch.Generator(device=model.device).manual_seed(42)
            t0 = time.perf_counter()
            wav_in = at.read_wav_file(wav_path, frames * pre.hop_length,
                                      target_sr=pre.sampling_rate)
            mel = model.mel.fbank(wav_in, target_length=frames)[..., None].repeat(bsz, 1, 1, 1)
            z0 = model.ldm.encode_mel(gen, mel)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            wav, _ = model.ldm.edit(model.make_batch(EDIT_PROMPT, batchsize=bsz), gen, z0, t_enc,
                                    ddim_steps=steps, guidance=3.5)
            t2 = time.perf_counter()
        pipeline._record_timings(model, req, duration, bsz, encode_s=t1 - t0, edit_s=t2 - t1)
        return wav[:, None, :int(duration * pre.sampling_rate)]
    return request


def edit_trajectory_check(model, wav_path: str, steps: int, duration: float):
    """At t_enc = EDIT_CHECK_STEPS in f32 on injected noise: the latent after
    stochastic_encode and ddim_decode through the kernels against the
    all-plain one, within F32_TOL."""
    import dataclasses

    import torch
    import audioldm2_torch as at
    from audioldm2_torch.diffusion import ddim
    from audioldm2_torch.diffusion.latent_diffusion import guided_eps_fn

    cfg32 = dataclasses.replace(model.cfg, compute_dtype="float32")
    pre = cfg32.preprocessing
    frames = int(duration * cfg32.latent_t_per_second * cfg32.vae.downsample_factor)
    g = torch.Generator(device=model.device).manual_seed(5)
    with torch.inference_mode():
        wav_in = at.read_wav_file(wav_path, frames * pre.hop_length, target_sr=pre.sampling_rate)
        z0 = model.ldm.encode_mel(g, model.mel.fbank(wav_in, target_length=frames)[..., None])
        noise = torch.randn(z0.shape, generator=g, device=z0.device)
        batch = model.make_batch(EDIT_PROMPT, batchsize=1)

        def trajectory():
            eps_fn, _ = guided_eps_fn(model.ldm.params, cfg32, batch, 1, 3.5)
            z_t = ddim.stochastic_encode(z0, EDIT_CHECK_STEPS, model.ldm.schedule, steps,
                                         noise=noise)
            return ddim.ddim_decode(eps_fn, z_t, model.ldm.schedule, EDIT_CHECK_STEPS, steps)

        got = trajectory()
        with patched_dispatch("plain"):
            want = trajectory()
    torch.cuda.synchronize()
    d, r = rel_err(got, want)
    moved = rel_err(want, z0)[1]
    log(f"  edit trajectory, t_enc = {EDIT_CHECK_STEPS} of {steps}, f32, injected noise: latent "
        f"{tuple(got.shape)} kernels against all-plain max_abs_err {d:.3e} rel {r:.3e} (tol "
        f"{F32_TOL:g}); the steps moved the latent by {moved:.3e} of its peak")
    if not bool(torch.isfinite(got).all()) or r > F32_TOL:
        raise AssertionError(f"edit trajectory: kernels disagree with the plain path ({r:.3e})")
    return r


def phase_edit(model, wav_path: str, steps: int, duration: float):
    """The edit path on the t5 model: one batch-1 request (stochastic_encode
    to t_enc = steps / 2, ddim_decode, decode) with its launches equal to
    t_enc UNet forwards plus one VAE encode and one decode, then the f32
    trajectory check."""
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate

    t_enc = steps // 2
    log(f"== path edit: audioldm_16k_crossattn_t5, a 10 s 16 kHz chirp encoded (log-mel, f32 VAE "
        f"encode), stochastic_encode to t_enc = {t_enc} of {steps}, ddim_decode under "
        f"{EDIT_PROMPT!r} at guidance 3.5")
    request = edit_request(model, wav_path, t_enc, steps, duration)
    request(1)  # warm-up
    wall, counts, _ = one_request(model, request,
                                  kernel_launches_per_generate(model.cfg, t_enc, encode=True), 1,
                                  duration, f"edit, t_enc {t_enc} of {steps}")
    rel = edit_trajectory_check(model, wav_path, steps, duration)
    return counts, {"wall_s": wall, "t_enc": t_enc, "f32_trajectory_rel_err": rel,
                    **{k: v for k, v in model.last_timings.items()}}


def phase_profile(model, device, duration: float):
    """One batch-1 request of PROFILE_STEPS DDIM steps (CFG batch 2) with the
    request checks, then the same request inside utils.profiling.trace: the
    op table, the device's busy share, the UNet's device time (the sampler's
    "unet" ranges) and its TF/s (ops.flops)."""
    import audioldm2_torch as at
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate
    from audioldm2_torch.ops import flops
    from audioldm2_torch.utils import profiling

    cfg = model.cfg
    log(f"== path profile: torch.profiler over one batch-1 request of {PROFILE_STEPS} DDIM steps "
        f"(CFG batch 2, {duration} s) on audioldm_16k_crossattn_t5")

    def request(b):
        return at.text_to_audio(model, "Rain on a tin roof.", seed=42, ddim_steps=PROFILE_STEPS,
                                duration=duration, batchsize=b, n_candidate_gen_per_text=1)

    request(1)  # warm-up
    wall, counts, _ = one_request(model, request, kernel_launches_per_generate(cfg, PROFILE_STEPS),
                                  1, duration, f"text_to_audio ddim, {PROFILE_STEPS} steps "
                                  "(profiler off)")
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        with profiling.trace(log_dir):
            wav = request(1)
        traced_s = time.perf_counter() - t0
        table = profiling.op_table(log_dir, PROFILE_TOP)
        busy_ms, window_ms = profiling.busy_share(log_dir)
        unet_ms, unet_ranges = profiling.range_device_ms(log_dir, "unet")
        trace_mb = sum(os.path.getsize(os.path.join(log_dir, n))
                       for n in os.listdir(log_dir)) / 2**20
    if wav.shape != (1, 1, int(duration * cfg.preprocessing.sampling_rate)):
        raise AssertionError(f"profiled request returned {wav.shape}")
    log(f"  traced request: wall {traced_s:.3f} s with the profiler's stop and export, trace "
        f"{trace_mb:.1f} MB; top {len(table)} device ops by total time over the request:")
    for name, ms in table:
        log(f"    {ms:10.3f} ms  {trace_label(name):24s} {name[:110]}")
    if not table or busy_ms <= 0:
        raise AssertionError("the trace holds no device op")
    log(f"  device busy share: {busy_ms:.3f} ms of device ops (their union) over the {window_ms:.3f}"
        f" ms traced window = {busy_ms / window_ms:.4f} (profiler on); over the untraced request's "
        f"wall {wall * 1e3:.3f} ms = {busy_ms / (wall * 1e3):.4f}")
    step_flops = flops.unet_step_flops(cfg, 2, cfg.latent_t_size)
    if unet_ranges != PROFILE_STEPS or unet_ms <= 0:
        raise AssertionError(f"the trace holds {unet_ranges} 'unet' ranges with {unet_ms} ms of "
                             f"device time; expected {PROFILE_STEPS}")
    per_step = unet_ms / PROFILE_STEPS
    tflops = step_flops / per_step / 1e9
    log(f"  UNet in the trace: {unet_ranges} forwards, {unet_ms:.3f} ms of device time, "
        f"{per_step:.3f} ms a step; {step_flops / 1e12:.4f} TFLOP a step (ops.flops."
        f"unet_step_flops, CFG batch 2) -> {tflops:.1f} TF/s, {tflops / 989:.4f} of 989 TF/s "
        f"(bf16 dense peak); {nvidia_smi_line()}")
    return counts, {"busy_ms": busy_ms, "window_ms": window_ms, "busy_share": busy_ms / window_ms,
                    "busy_share_untraced_wall": busy_ms / (wall * 1e3),
                    "unet_ms_per_step": per_step, "unet_step_tflop": step_flops / 1e12,
                    "unet_tflops": tflops, "traced_wall_s": traced_s, "wall_s": wall,
                    "top": [[n, ms] for n, ms in table[:10]]}


def phase_app(t5_cfg, device, duration: float):
    """audioldm2_torch.app.text2audio once with model_name
    "audioldm_crossattn_flant5" (the t5 preset), 3 candidates, the app's 200
    steps; the model cache builds once and a second get_model returns it."""
    import dataclasses

    import numpy as np
    from audioldm2_torch import app, pipeline
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate

    name = "audioldm_crossattn_flant5"
    log(f"== path app: audioldm2_torch.app.text2audio(model_name={name!r}, n_candidates=3), "
        "200 DDIM steps")
    builds, rendered = [], []
    real_build, real_render = pipeline.build_model, app.render_outputs

    def counting_build(*a, **kw):
        builds.append(kw.get("model_name"))
        return real_build(*a, **kw)

    def recording_render(sr, waveform):
        rendered.append((sr, waveform))
        return real_render(sr, waveform)

    pipeline.build_model, app.render_outputs = counting_build, recording_render
    try:
        t0 = time.perf_counter()
        model = app.get_model(name)
        log(f"  get_model (build): {time.perf_counter() - t0:.2f} s")
        if model.cfg != dataclasses.replace(t5_cfg, name=name):
            raise AssertionError(f"{name} did not resolve to the t5 preset")
        out = []

        def request(b):
            out.append(app.text2audio("A cat is meowing for attention.", duration=duration,
                                      guidance_scale=3.5, random_seed=45, n_candidates=3,
                                      model_name=name))
            return rendered[-1][1]

        wall, counts, _ = one_request(model, request, kernel_launches_per_generate(model.cfg, 200),
                                      1, duration, "app.text2audio, 200 steps, 3 candidates")
        again = app.get_model(name)
    finally:
        pipeline.build_model, app.render_outputs = real_build, real_render
    if again is not model or builds != [name]:
        raise AssertionError(f"the app's model cache built {builds}, and the second get_model "
                             f"returned {'the same' if again is model else 'another'} object")
    art = out[0]
    if isinstance(art, tuple):
        sr, pcm = art
        n = int(duration * 16000)
        if sr != 16000 or pcm.dtype != np.int16 or pcm.shape != (n,) or not np.abs(pcm).max():
            raise AssertionError(f"render_outputs gave ({sr}, {pcm.dtype} {pcm.shape})")
        log(f"  rendered: ({sr}, int16 {pcm.shape}) audio (no ffmpeg for a video)")
    else:
        if not (isinstance(art, str) and os.path.getsize(art) > 0):
            raise AssertionError(f"render_outputs gave {art!r}")
        log(f"  rendered: video {art} ({os.path.getsize(art)} bytes)")
    log(f"  the second get_model({name!r}) returned the same object; build_model ran once")
    app.MODELS.model = None  # free the card for the next path
    return counts, {"wall_s": wall, **model.last_timings}


def phase_cli(steps: int, duration: float, tmp: str):
    """python -m audioldm2_torch in a subprocess (-d auto, the kernels of
    _build/ already built): one generation request on
    audioldm_16k_crossattn_t5 at the CLI defaults (10 s, guidance 3.5, n = 3
    with the CLAP rerank), one --mode sr_inpainting -f request on a 10 s
    48 kHz chirp (resampled to 16 kHz by the native library). Each wav:
    16 kHz, 160000 samples, finite, non-zero, within [-1, 1]."""
    import numpy as np
    from scipy.io import wavfile

    log(f"== path cli: python -m audioldm2_torch (-d auto), {T5_MODEL}, {steps} steps, n = 3")
    in48 = write_wav(os.path.join(tmp, "chirp48k.wav"), 48000, duration)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    prompt = "A dog barking in the distance"
    runs = {"generation": ["-t", prompt],
            "sr_inpainting": ["--mode", "sr_inpainting", "-f", in48, "-t", prompt]}
    out = {}
    for mode, extra in runs.items():
        save = os.path.join(tmp, f"cli_{mode}")
        cmd = [sys.executable, "-m", "audioldm2_torch", *extra, "--model_name", T5_MODEL,
               "--ddim_steps", str(steps), "-dur", str(duration), "-s", save]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"CLI {mode} exited {res.returncode}:\n{res.stderr[-3000:]}")
        line = next((ln for ln in res.stdout.splitlines() if ln.startswith("audioldm2_torch:")),
                    "")
        if f"{T5_MODEL} on cuda" not in line:
            raise AssertionError(f"CLI {mode} did not report running on the card: {line!r}")
        wavs = [os.path.join(d, n) for d, _, names in os.walk(save) for n in names]
        if len(wavs) != 1 or os.path.basename(wavs[0]) != f"{prompt}.wav":
            raise AssertionError(f"CLI {mode} wrote {wavs}")
        sr, data = wavfile.read(wavs[0])
        x = data.astype(np.float32) / 32768.0
        if sr != 16000 or x.shape != (int(duration * 16000),) or not np.isfinite(x).all() or \
                not np.abs(x).max() > 0 or np.abs(x).max() > 1.0:
            raise AssertionError(f"CLI {mode} wav: rate {sr}, shape {x.shape}, peak "
                                 f"{np.abs(x).max()}")
        log(f"  {mode}: subprocess wall {wall:.2f} s (process start, model build, kernels "
            f"loaded, request, wav written); {line}; wrote {os.path.relpath(wavs[0], tmp)} "
            f"({sr} Hz, {x.shape[0]} samples, rms {float(np.sqrt(np.mean(x ** 2))):.4f})")
        out[mode] = {"wall_s": wall}
    return out


def phase_6(t5_cfg, device, steps: int, duration: float):
    """The paths of the entry points and the last single-device modules;
    returns ({path: launch counts}, {path: timings})."""
    import torch

    log("== phase 6: the entry points and the last single-device modules")
    launches, e2e = {}, {}
    e2e["native"] = phase_native()
    e2e["griffinlim"] = phase_griffinlim(device)
    launches["encoder"], e2e["encoder"] = phase_encoder(t5_cfg, device)
    model = build("edit and profile", t5_cfg, device)
    with tempfile.TemporaryDirectory() as tmp:
        wav16 = write_wav(os.path.join(tmp, "chirp16k.wav"), 16000, duration)
        launches["edit"], e2e["edit"] = phase_edit(model, wav16, steps, duration)
        launches["profile"], e2e["profile"] = phase_profile(model, device, duration)
        del model
        torch.cuda.empty_cache()
        launches["app"], e2e["app"] = phase_app(t5_cfg, device, duration)
        torch.cuda.empty_cache()
        e2e["cli"] = phase_cli(steps, duration, tmp)
    return launches, e2e


# The multi path: one request through ShardedGenerator on a one-process
# mesh (bit-identical to model.ldm.generate under cudnn.deterministic),
# then dryrun_infer(2) and train.dryrun(2) as two ranks on one card over
# gloo (NCCL refuses two ranks on one device)
MULTI_PROMPT = PROMPTS[0][0]
MULTI_SEED = 42
MULTI_K6_SHAPE = (2, 1024, 64, 128)  # the t5 VAE decoder's norm_out at batch 2: re-read mode
MULTI_TIMEOUT_S = 600.0


def phase_multi_dp1(model, steps: int, duration: float):
    """ShardedGenerator at dp 1 x tp 1 on the t5 path's model, one request,
    against model.ldm.generate on the same prompt and seed, both under
    cudnn.deterministic: the waveforms must be equal bit for bit. The
    request's launches (reset just before, read just after) must equal the
    config's count, no CUDA tensor may reach a plain version and no bf16
    call the shared core."""
    import numpy as np
    import torch
    from audioldm2_torch import ops
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate
    from audioldm2_torch.parallel.serve import ShardedGenerator

    log(f"== path multi, dp 1 x tp 1: ShardedGenerator against model.ldm.generate, one "
        f"{duration} s request of {steps} steps, cudnn.deterministic ({nvidia_smi_line()})")
    latent_t = int(duration * model.cfg.latent_t_per_second)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gen = ShardedGenerator(model)
        on_core, work = {}, {}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with plain_versions_forbidden(), shared_core_bf16_counted(on_core), \
                workspaces_counted(work):
            got = gen.generate([MULTI_PROMPT], MULTI_SEED, duration=duration, ddim_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        want, _ = model.ldm.generate(
            model.make_batch(MULTI_PROMPT, batchsize=1),
            torch.Generator(device=model.device).manual_seed(MULTI_SEED), latent_t,
            ddim_steps=steps)
        ldm_wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = prev
    expected = kernel_launches_per_generate(model.cfg, steps)
    log(f"  ShardedGenerator wall {wall:.3f} s, model.ldm.generate wall {ldm_wall:.3f} s; "
        f"waveform {got.shape}, max |a - b| {float(np.abs(got - want).max()):.3e}")
    log(f"    launches {counts}")
    if on_core or work["workspaces"]:
        raise AssertionError(f"shared-core calls {on_core} or {work['workspaces']} split-K "
                             "workspaces in the multi request")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    if got.shape != want.shape or not np.isfinite(got).all() or not np.array_equal(got, want):
        raise AssertionError("ShardedGenerator at dp 1 x tp 1 is not model.ldm.generate bit for "
                             "bit")
    return counts, {"wall_s": wall, "ldm_generate_wall_s": ldm_wall, "bit_identical": True}


def multi_rank_check(gen, mesh):
    """Run in each rank of the multi path's dryrun_infer(2), after its
    generate: one full-width UNet forward at the 10 s latent and CFG batch
    2 on the rank's tp slices (bf16, kernels; in the int8 serving mode the
    rank's int8 slices, quantized from the whole weights), counting the
    calls that reach the shared GEMM core and the split-K workspaces; K6 at
    MULTI_K6_SHAPE in both
    processes at once (each its own per-(device, stream) barrier words)
    against its plain version; on rank 0 the tp 1 forward on the whole
    UNet, and its all-plain bf16 and f32 forwards (the phase-4 floor)."""
    import torch
    import torch.distributed as dist
    from audioldm2_torch.ops import groupnorm_kernel
    from audioldm2_torch.parallel import collectives

    torch.backends.cudnn.allow_tf32 = False  # as in the main process: an f32 oracle
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, dev = gen.model.cfg, mesh.device
    bf16, f32 = torch.bfloat16, torch.float32
    cond = _ctx_inputs(cfg, dev, torch.Generator(device=dev).manual_seed(7))
    out, on_core, work = {}, {}, {}
    t0 = time.perf_counter()
    with collectives.tensor_parallel(mesh), shared_core_bf16_counted(on_core), \
            workspaces_counted(work):
        eps = unet_eps(cfg, gen.params["unet"], cond, dev, bf16)
    out["tp_forward_s"] = time.perf_counter() - t0
    out["on_core"], out["workspaces"] = on_core, work["workspaces"]
    g = torch.Generator(device=dev).manual_seed(13)
    c = MULTI_K6_SHAPE[-1]
    x = torch.randn(MULTI_K6_SHAPE, generator=g, device=dev).to(bf16)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    dist.barrier()
    with torch.inference_mode():
        k6 = groupnorm_kernel.group_norm_silu(x, gamma, beta, 32, 1e-6)
        k6_plain = groupnorm_kernel.group_norm_silu_plain(x, gamma, beta, 32, 1e-6)
    out["k6_rel_err"] = rel_err(k6, k6_plain)[1]
    if mesh.rank == 0:
        whole = gen.model.ldm.params["unet"]
        tp1 = unet_eps(cfg, whole, cond, dev, bf16)
        plain = unet_eps(cfg, whole, cond, dev, bf16, plain=True)
        ref = unet_eps(cfg, whole, cond, dev, f32, plain=True)
        out.update(floor=rel_err(plain, ref)[1], tp_vs_tp1=rel_err(eps, tp1),
                   tp1_vs_plain=rel_err(tp1, plain), eps_shape=tuple(eps.shape),
                   eps_max=float(tp1.abs().max()))
    return out


def multi_infer(cfg, device):
    """dryrun_infer(2) at tp 2 on ``cfg`` (the t5 family at full width, one
    1.25 s request of 2 DDIM steps) with multi_rank_check in its ranks. Each
    rank's launches of the generate must equal the config's count (a tp
    rank launches every kernel the unsharded generate does, at narrower
    shapes), and in the int8 serving mode K1q, K3q, K4q and K5 must each
    launch; the rank's tp forward must put no call on the shared core and
    allocate no split-K workspace; the tp 2 eps must lie within
    max(BF16_TOL, FLOOR_FACTOR x the bf16 floor) of the tp 1 eps. Returns
    the launches summed over the ranks and the timings."""
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate
    from audioldm2_torch.parallel import serve

    t0 = time.perf_counter()
    records = serve.dryrun_infer(2, device=device, backend="gloo", check=multi_rank_check,
                                 cfg=cfg, timeout=MULTI_TIMEOUT_S)
    infer_s = time.perf_counter() - t0
    expected = kernel_launches_per_generate(cfg, 2)
    int8 = ("gn_silu_conv3x3_q", "ln_matmul_q", "geglu_matmul_q", "int8_matmul")
    if cfg.weight_quant == "int8" and not all(expected[k] for k in int8):
        raise AssertionError(f"the int8 config launches no {int8}: {expected}")
    total = dict.fromkeys(expected, 0)
    e2e = {"dryrun_infer_s": infer_s, "ranks": []}
    for r in records:
        chk = r["check"]
        log(f"  rank {r['rank']} mesh {r['mesh']} (dp x tp), {r['n_sharded']} tp-sharded leaves: "
            f"build {r['build_s']:.3f} s, generate wall {r['wall_s']:.3f} s, peak device memory "
            f"{r.get('max_memory_gib', float('nan')):.3f} GiB, tp 2 UNet forward "
            f"{chk['tp_forward_s']:.3f} s, K6 {MULTI_K6_SHAPE} against plain rel "
            f"{chk['k6_rel_err']:.3e}")
        log(f"    launches {r['launches']}")
        if r["launches"] != expected:
            raise AssertionError(f"rank {r['rank']}: launches {r['launches']} != {expected}")
        if chk["on_core"] or chk["workspaces"]:
            raise AssertionError(f"rank {r['rank']}: shared-core calls {chk['on_core']} or "
                                 f"{chk['workspaces']} split-K workspaces in the tp forward")
        if chk["k6_rel_err"] > BF16_TOL:
            raise AssertionError(f"rank {r['rank']}: K6 off its plain version by "
                                 f"{chk['k6_rel_err']:.3e}")
        for k, v in r["launches"].items():
            total[k] += v
        e2e["ranks"].append({k: r.get(k) for k in ("rank", "wall_s", "build_s",
                                                   "max_memory_gib")})
    chk = records[0]["check"]
    tol = max(BF16_TOL, FLOOR_FACTOR * chk["floor"])
    d, rel = chk["tp_vs_tp1"]
    log(f"  tp 2 UNet eps {chk['eps_shape']} against tp 1: max_abs_err {d:.3e} rel {rel:.3e} "
        f"(tol {tol:.3e} = max({BF16_TOL:g}, {FLOOR_FACTOR:g} x the bf16 floor "
        f"{chk['floor']:.3e})); tp 1 kernels against all-plain rel {chk['tp1_vs_plain'][1]:.3e}; "
        f"|eps| max {chk['eps_max']:.3e}")
    if rel > tol:
        raise AssertionError(f"tp 2 eps off tp 1 by {rel:.3e} > {tol:.3e}")
    e2e.update(tp_vs_tp1_rel=rel, tol=tol, floor=chk["floor"])
    return total, e2e


def phase_multi(t5_cfg, device):
    """multi_infer on the t5 family in bf16 and in the int8 serving mode,
    then train.dryrun(2) at dp 2 and at tp 2; all as two ranks on one card
    over gloo. Returns the launches summed over the ranks of each dry run
    ({"multi": bf16 and train-free, "multi8": int8}) and the timings."""
    import dataclasses

    from audioldm2_torch.parallel import train

    log(f"== path multi: dryrun_infer(2) at tp 2 in bf16 and int8, and train.dryrun(2) at dp 2 "
        f"and tp 2, two ranks on one card over gloo ({nvidia_smi_line()})")
    total, e2e = multi_infer(t5_cfg, device)
    log(f"  -- the int8 serving mode (weight_quant=\"int8\"): K1q, K3q, K4q (f32-residual "
        f"mode) and K5 (f32-output mode) on each rank's int8 slices ({nvidia_smi_line()})")
    total8, e2e["int8"] = multi_infer(dataclasses.replace(t5_cfg, weight_quant="int8"), device)
    t0 = time.perf_counter()
    for rec in train.dryrun(2, tp=(1, 2), device=device, backend="gloo",
                            timeout=MULTI_TIMEOUT_S):
        log(f"  train dry run {rec['mesh']} (dp x tp): loss {rec['loss']:.6f}, single process "
            f"{rec['ref_loss']:.6f}, worst updated leaf {rec['worst_leaf']} {rec['leaf_rel']:.3e} "
            f"relative (tol {train.DRYRUN_TOL:g})")
        e2e[f"train_{rec['mesh'][0]}x{rec['mesh'][1]}"] = {
            "loss": rec["loss"], "ref_loss": rec["ref_loss"], "leaf_rel": rec["leaf_rel"]}
    e2e["train_dryrun_s"] = time.perf_counter() - t0
    log(f"  multi path: dryrun_infer {e2e['dryrun_infer_s']:.3f} s (bf16), "
        f"{e2e['int8']['dryrun_infer_s']:.3f} s (int8), train dry runs "
        f"{e2e['train_dryrun_s']:.3f} s (walls, ranks' start and build included)")
    return {"multi": total, "multi8": total8}, e2e


def _leaves(tree):
    import torch

    return (leaf for _, leaf in _paths(tree) if isinstance(leaf, torch.Tensor))


# the golden cases that also run in the int8 serving mode
GOLDEN_INT8_CASES = ("full", "full_int8")
# the golden cases whose f32 request runs the two UNet controls (an encoding
# case runs the encode's control instead)
GOLDEN_UNET_CONTROL_CASES = ("t5_headline", "full", "large", "k48", "tts")


@contextlib.contextmanager
def tf32_allowed(allow: bool):
    """TF32 for cuBLAS's matmuls and cuDNN's convs on (``allow``) or off
    inside the block."""
    import torch

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def tf32_weights(tree):
    """``tree`` with each f32 leaf of two or more dimensions rounded to TF32
    (10 mantissa bits, to nearest even): the weight operand that a K1, K3 or
    K4 quietly multiplying in 1xTF32 would read."""
    import torch

    if isinstance(tree, dict):
        return {k: tf32_weights(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tf32_weights(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32 and tree.dim() >= 2:
        i = tree.contiguous().view(torch.int32)
        return ((i + ((i >> 13) & 1) + 0xFFF) & ~0x1FFF).view(torch.float32)
    return tree


def golden_request(model, name: str, golden, expected, stages: bool):
    """golden_parity.run on ``model`` with the launch counts set to 0 just
    before its request (the encode and the generate) and read just after,
    under the request checks of phase 5 (no CUDA tensor in a plain version,
    no call on the shared core, no split-K workspace in bf16; f32's are
    counted); the counts must equal ``expected``. Returns the distances and
    the counts."""
    import torch
    from audioldm2_torch import ops
    from audioldm2_torch.tools import golden_parity as gp

    on_core, work, counts = {}, {}, {}

    @contextlib.contextmanager
    def counted():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with plain_versions_forbidden(), shared_core_bf16_counted(on_core), \
                workspaces_counted(work):
            yield
        torch.cuda.synchronize()
        counts.update(ops.launch_counts())

    d = gp.run(model, name, golden, around_request=counted, stages=stages)
    d["workspaces"] = work["workspaces"]
    # f32 K3 and K4 run on the shared GEMM core, whose split-K allocates a
    # workspace (as in the train step); a served bf16 or int8 request allocates none
    bf16 = model.cfg.compute_dtype == "bfloat16"
    if on_core or (bf16 and work["workspaces"]):
        raise AssertionError(f"golden {name}: shared-core calls {on_core} or "
                             f"{work['workspaces']} split-K workspaces")
    if counts != expected:
        missing = [k for k, v in expected.items() if v and not counts[k]]
        raise AssertionError(f"golden {name}: launch counts {counts} != expected {expected} "
                             f"(never launched: {missing})")
    return d, counts


def golden_expected_launches(cfg, case):
    """The kernel launches of one request of a golden case: the sampler's
    UNet forwards (``t_enc`` on edit), one VAE decode and, on sr and edit,
    the f32 VAE encode."""
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate

    steps = case.t_enc if case.mode == "edit" else case.steps
    return kernel_launches_per_generate(cfg, steps, case.sampler, encode=case.mode != "generate")


def _golden_line(tag: str, d) -> str:
    keys = ("mel_in_max", "fbank_max", "z0_rel", "z_t_rel", "seq_rel", "ctx0_rel", "ctx1_rel",
            "y_rel", "eps0_rel", "eps0_unet_rel", "latent_rel", "mel_mae", "mel_max", "wav_mae",
            "decode_mel_mae", "vocoder_wav_mae", "scores_max", "int8_leaves", "workspaces")
    parts = [f"{k} {d[k]}" if isinstance(d[k], int) else f"{k} {d[k]:.3e}"
             for k in keys if k in d]
    if "same_pick" in d:
        parts.append(f"pick {d['pick']} (same: {d['same_pick']})")
    return f"    {tag}: request {d['generate_s']:.3f} s; " + ", ".join(parts)


def golden_order(golden):
    """The golden's cases, those on one tree (the stored tree digest) next
    to each other, so that each tree is drawn once; the stored order
    otherwise."""
    trees = {}
    for name, g in golden.items():
        trees.setdefault(g["meta"]["tree_digest"], []).append(name)
    return [name for names in trees.values() for name in names]


def phase_golden(device):
    """Every case of the full-width golden (audioldm2_torch.tools.
    golden_parity; made by the JAX package on the CPU in f32): the tree
    drawn with numpy to the stored digest once for the cases that share it,
    then each case's request (generate, PLMS, sr with the stored mask and
    draws, the edit's encode and decode, the audio-in batches) in f32 (TF32
    off) through the kernels, held to the case's mel MAE limit
    (golden_parity.f32_limit), the encode's limit (z0_limit) and the same
    pick, with every kernel the config predicts launching as often as it
    predicts (the encode's f32 K1 and K6 among them on sr and edit) and, on
    full_int8, the served int8 UNet tree's digest JAX's; on the five
    text-to-audio cases two controls (the UNet's weights rounded to TF32;
    TF32 on for cuBLAS and cuDNN) and on sr and edit one (the VAE's weights
    rounded to TF32, the encode alone) that must fail those limits; then in
    bf16, and full and full_int8 in the int8 serving mode, under
    cudnn.deterministic, each held to FLOOR_FACTOR x its floor (the
    all-plain request's mel MAE in the same mode). Returns the launches of
    each request and the distances, with the phase's wall."""
    import dataclasses

    import torch
    from audioldm2_torch import params as params_m
    from audioldm2_torch.pipeline import AudioLDM2
    from audioldm2_torch.tools import golden_parity as gp

    t_phase = time.perf_counter()
    log(f"== path golden: the port against the JAX package's full-width golden "
        f"({os.path.relpath(gp.GOLDEN, REPO)}) ({nvidia_smi_line()})")
    golden = gp.load()
    launches, e2e = {}, {}
    base, tree_digest = None, None
    for name in golden_order(golden):
        case, meta = gp.CASES[name], golden[name]["meta"]
        cfg = gp.case_config(case)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if meta["tree_digest"] != tree_digest:
            del base
            torch.cuda.empty_cache()
            tree = params_m.draw_tree(cfg, meta["tree_seed"])
            draw_s = time.perf_counter() - t0
            base = gp.build(name, device, golden, tree=tree)
            tree_digest = meta["tree_digest"]
            del tree
            drawn = f"draw_tree {draw_s:.2f} s, digest and build " \
                    f"{time.perf_counter() - t0 - draw_s:.2f} s (digest equal to the golden's)"
        else:  # the tree already drawn, held to this case's config digest
            if gp.config_digest(dataclasses.replace(cfg, weight_quant=None)) \
                    != meta["config_digest"]:
                raise AssertionError(f"golden {name}: the port's config is not the golden's")
            drawn = "the tree of the case before"
        model = AudioLDM2(cfg, base.ldm.params, device)
        torch.cuda.synchronize()
        log(f"  -- {name}: {case.family}{f' ({case.variant})' if case.variant else ''}, "
            f"{case.mode}, {case.sampler}, {case.steps} steps"
            f"{f' (t_enc {case.t_enc})' if case.mode == 'edit' else ''}, batch "
            f"{case.batchsize}, n = {case.n_gen}, latent {meta['latent_t']}"
            f"{', int8 weights' if case.weight_quant else ''}: {drawn}")
        res = {}
        d, counts = golden_request(model, name, golden, golden_expected_launches(cfg, case),
                                   stages=True)
        limit = gp.f32_limit(name, d.get("int8_ulp_mel_mae"))
        log(_golden_line("f32", d))
        log(f"      launches {counts}")
        log(f"      f32 mel MAE {d['mel_mae']:.3e} against the case's limit {limit:g}"
            + (f"; z0_rel {d['z0_rel']:.3e} against {gp.z0_limit(name):g}" if "z0_rel" in d
               else "")
            + (f"; the int8 UNet's {d['int8_leaves']} int8 leaves and digest JAX's"
               if "int8_leaves" in d else ""))
        if not gp.f32_ok(d):
            raise AssertionError(f"golden {name} f32: mel MAE {d['mel_mae']:.3e} (limit "
                                 f"{limit:g}), z0_rel {d.get('z0_rel')} or pick "
                                 f"{d.get('pick')} differs")
        res["f32"] = d
        launches[f"golden_{name}"] = counts
        controls = []
        if name in GOLDEN_UNET_CONTROL_CASES:
            # what a K1, K3 or K4 quietly in 1xTF32 would read, and TF32 on
            # for cuBLAS and cuDNN (the plain ops that do not turn it off)
            tf32_unet = AudioLDM2(cfg, {**model.ldm.params,
                                        "unet": tf32_weights(model.ldm.params["unet"])}, device)
            controls = [("tf32_weights", tf32_unet, False), ("tf32_on", model, True)]
            if not torch.cuda.is_available():  # a rehearsal on the CPU, which has no TF32
                controls.pop()
        for tag, ctl, allow in controls:
            with tf32_allowed(allow):
                c = gp.run(ctl, name, golden, stages=False)
            log(_golden_line(f"control {tag}", c))
            log(f"      control {tag} mel MAE {c['mel_mae']:.3e}: "
                f"{c['mel_mae'] / limit:.2f} x the case's limit, "
                f"{c['mel_mae'] / gp.MEL_MAE_TOL:.2f} x the bar")
            if gp.f32_ok(c):
                raise AssertionError(f"golden {name}: the {tag} control passes the f32 limit "
                                     f"{limit:g} (mel MAE {c['mel_mae']:.3e})")
            res[f"control_{tag}"] = c
        if case.mode != "generate":
            # the f32 K1 of the encode quietly in 1xTF32 would read these
            tf32_vae = AudioLDM2(cfg, {**model.ldm.params,
                                       "vae": tf32_weights(model.ldm.params["vae"])}, device)
            z0_rel = gp.encode_distance(tf32_vae, name, golden)
            log(f"    control tf32_vae_weights: z0_rel {z0_rel:.3e}, "
                f"{z0_rel / gp.z0_limit(name):.2f} x the case's limit {gp.z0_limit(name):g}")
            if not z0_rel >= gp.z0_limit(name):
                raise AssertionError(f"golden {name}: the TF32 encode control passes the z0 "
                                     f"limit {gp.z0_limit(name):g} ({z0_rel:.3e})")
            res["control_tf32_vae_weights_z0_rel"] = z0_rel
            del tf32_vae
        del controls
        modes = [("bf16", dataclasses.replace(cfg, compute_dtype="bfloat16", weight_quant=None))]
        if name in GOLDEN_INT8_CASES:
            modes.append(("int8", dataclasses.replace(cfg, compute_dtype="bfloat16",
                                                       weight_quant="int8")))
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for tag, mcfg in modes:
                m = AudioLDM2(mcfg, model.ldm.params, device)
                d, counts = golden_request(m, name, golden, golden_expected_launches(mcfg, case),
                                           stages=False)
                with patched_dispatch("plain"):
                    floor = gp.run(m, name, golden, stages=False)
                bound = FLOOR_FACTOR * floor["mel_mae"]
                log(_golden_line(tag, d))
                log(_golden_line(f"{tag} all-plain (the floor)", floor))
                log(f"      {tag} mel MAE {d['mel_mae']:.3e} against {FLOOR_FACTOR:g} x "
                    f"the floor {floor['mel_mae']:.3e} = {bound:.3e}; launches {counts}")
                if not d["mel_mae"] <= bound:
                    raise AssertionError(f"golden {name} {tag}: mel MAE {d['mel_mae']:.3e} > "
                                         f"{bound:.3e}")
                res[tag] = d
                res[f"{tag}_floor"] = floor
                res[f"{tag}_bound"] = bound
                launches[f"golden_{name}_{tag}"] = counts
        finally:
            torch.backends.cudnn.deterministic = prev
        e2e[name] = res
        del model
    del base
    e2e["phase_s"] = time.perf_counter() - t_phase
    log(f"  path golden: {len(golden)} cases in {e2e['phase_s']:.1f} s")
    return launches, e2e


def run(t5_cfg, full_cfg, large_cfg, k48_cfg, tts_cfg, device, steps: int, duration: float):
    """Phases 2-5 at the configs' widths on ``device``; returns the
    per-kernel stats of phase 3 and the launch counts of the first request
    of each path."""
    import dataclasses

    import torch
    from audioldm2_torch.models import unet
    from audioldm2_torch.models.vae import init_vae
    from audioldm2_torch.params import Init, cast_floating

    phase_rounding(device)
    g = torch.Generator(device=device).manual_seed(7)
    ini = Init(g, device, nonzero=True)
    t5_unet = unet.init_unet(ini, t5_cfg.unet)
    vae_f32 = init_vae(ini, t5_cfg.vae)
    vae_p = cast_floating(vae_f32, torch.bfloat16)
    t5_cond = _ctx_inputs(t5_cfg, device, g)
    full8_cfg = dataclasses.replace(full_cfg, weight_quant="int8")

    full_unet = unet.init_unet(ini, full_cfg.unet)
    full_cond = _ctx_inputs(full_cfg, device, g)

    log("== phase 3: kernels against their plain versions")
    log("  -- t5 path: K1-K4, K6 (UNet forward + VAE decode)")
    t5_first, t5_counts = discover_calls(t5_cfg, t5_unet, vae_p, t5_cond, device)
    stats = phase_kernels(t5_first, t5_counts, offset_check=True)
    log("  -- K6 at the VAE decoder's norm_out, batches " + ", ".join(map(str, DECODE_BATCHES)))
    phase_k6_batches(t5_first, stats)
    log(f"  -- multi path: K2, K3, K4 at one tp {TP} rank's shapes of the t5 UNet (K4 in its "
        "f32-residual mode)")
    tp_stats, _ = phase_tp_shapes(*discover_calls(t5_cfg, t5_unet, None, t5_cond, device),
                                  stats)
    del vae_p, t5_first
    log("  -- K1-K4 at ragged and halo shapes, K2 on strided q, k, v")
    phase_ragged(stats, device)
    log("  -- sr path: K1 and K6 in f32 (one full-width VAE encode of a chirp's log-mel)")
    mel = encoder_mel(full_cfg, device, duration)
    enc_stats = phase_kernels(*discover_encode_calls(full_cfg, vae_f32, mel),
                              offset_check=False, f32_pass=False)
    for name, st in enc_stats.items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], st["max_abs_err"])
    log("  -- full8 path: the int8 kernels (UNet forward; its K2 shapes are the t5 path's)")
    first, counts = discover_calls(full8_cfg, full_unet, None, full_cond, device)
    int8 = {s: a for s, a in first.items() if s[0] not in stats}
    stats.update(phase_kernels(int8, counts, offset_check=False))
    del first, int8
    log(f"  -- multi8 path: K3q, K4q (f32-residual mode) and K5 (f32-output mode) at one tp {TP} "
        "rank's shapes of the t5 int8 UNet, beside the uncut calls")
    t5_8cfg = dataclasses.replace(t5_cfg, weight_quant="int8")
    tp8_stats, tp18_stats = phase_tp_shapes(
        *discover_calls(t5_8cfg, t5_unet, None, t5_cond, device), stats, TP_INT8, tp1_too=True)
    log("  -- large path: K1-K4, K6 on the large-1150k UNet at CFG batch 6 (K2 also on the "
        "None slot's attn2)")
    large_unet = unet.init_unet(ini, large_cfg.unet)
    large_cond = _ctx_inputs(large_cfg, device, g, batch=6)
    large_first, large_counts = discover_calls(large_cfg, large_unet, None, large_cond, device)
    large_stats = phase_kernels(large_first, large_counts, offset_check=False, f32_pass=False)
    merge_errors(stats, large_stats)
    log("  -- 48k path: K1-K4, K6 on the 48k UNet at CFG batch 2 (FiLM y, K2 also on the None "
        "slot's attn2) and its VAE decode at batch 1 (1024 x 256 mel, four levels)")
    k48_unet = unet.init_unet(ini, k48_cfg.unet)
    k48_vae_f32 = init_vae(ini, k48_cfg.vae)
    k48_cond = _ctx_inputs(k48_cfg, device, g)
    k48_first, k48_counts = discover_calls(k48_cfg, k48_unet,
                                           cast_floating(k48_vae_f32, torch.bfloat16), k48_cond,
                                           device)
    k48_stats = phase_kernels(k48_first, k48_counts, offset_check=True, f32_pass=False)
    log("  -- K6 at the 48k VAE decoder's norm_out, batches 1, 2, 3")
    phase_k6_batches(k48_first, k48_stats, (1, 2, 3))
    del k48_first
    log("  -- 48k sr path: K1 and K6 in f32 (one full-width VAE encode of a 48 kHz chirp's "
        "256-bin log-mel)")
    k48_mel = encoder_mel(k48_cfg, device, duration)
    k48_enc = phase_kernels(*discover_encode_calls(k48_cfg, k48_vae_f32, k48_mel),
                            offset_check=False, f32_pass=False)
    for part in (k48_stats, k48_enc):
        merge_errors(stats, part)
    log("  -- K7 (v6bd) and K8 (v7), the A/B entry point's kernels")
    stats.update(phase_variants(large_first, device))
    del large_first

    log("== phase 4: full-width UNet forward, kernels against the all-plain path")
    bf16, f32 = torch.bfloat16, torch.float32
    t5_args = (t5_cfg, t5_unet, t5_cond, device)
    ref = unet_eps(*t5_args, f32, plain=True)
    unet_check("t5 bf16", unet_eps(*t5_args, bf16), unet_eps(*t5_args, bf16, plain=True), ref,
               BF16_TOL)
    unet_check("t5 f32", unet_eps(*t5_args, f32), ref, ref, F32_TOL)
    del t5_unet
    # int8: the f32 reference is the all-plain int8 forward in f32 (bf16-rounded
    # activations, f32 everything else)
    full8_args = (full8_cfg, full_unet, full_cond, device)
    eps_int8 = unet_eps(*full8_args, bf16)
    plain8, ref8 = unet_eps(*full8_args, bf16, plain=True), unet_eps(*full8_args, f32, plain=True)
    floor = rel_err(plain8, ref8)[1]
    log(f"  audioldm2-full int8: bf16 rounding alone (all-plain bf16 against all-plain f32) "
        f"moves eps by {floor:.3e}; the kernels are held to max({BF16_TOL:g}, "
        f"{FLOOR_FACTOR:g} x that)")
    unet_check("audioldm2-full int8 (bf16 activations)", eps_int8, plain8, ref8,
               max(BF16_TOL, FLOOR_FACTOR * floor))
    full_args = (full_cfg, full_unet, full_cond, device)
    eps_bf16 = unet_eps(*full_args, bf16)
    for tag, y in (("bf16", eps_bf16), ("int8", eps_int8)):
        d, r = rel_err(y, unet_eps(*full_args, f32, plain=True))
        log(f"  (information) audioldm2-full {tag} kernels against plain f32 (no int8): "
            f"max_abs_err {d:.3e} rel {r:.3e}")
    d, r = rel_err(eps_int8, eps_bf16)
    log(f"  (information) audioldm2-full int8 eps against bf16 eps: max_abs_err {d:.3e} "
        f"rel {r:.3e}")
    del full_unet, eps_bf16, eps_int8
    large_args = (large_cfg, large_unet, large_cond, device)
    ref_l = unet_eps(*large_args, f32, plain=True)
    plain_l = unet_eps(*large_args, bf16, plain=True)
    floor_l = rel_err(plain_l, ref_l)[1]
    log(f"  large-1150k, CFG batch 6: bf16 rounding alone moves eps by {floor_l:.3e}; the "
        f"kernels are held to max({BF16_TOL:g}, {FLOOR_FACTOR:g} x that)")
    unet_check("large-1150k bf16", unet_eps(*large_args, bf16), plain_l, ref_l,
               max(BF16_TOL, FLOOR_FACTOR * floor_l))
    unet_check("large-1150k f32", unet_eps(*large_args, f32), ref_l, ref_l, F32_TOL)
    del large_unet, ref_l, plain_l
    k48_args = (k48_cfg, k48_unet, k48_cond, device)
    ref_k = unet_eps(*k48_args, f32, plain=True)
    plain_k = unet_eps(*k48_args, bf16, plain=True)
    floor_k = rel_err(plain_k, ref_k)[1]
    log(f"  48k, CFG batch 2 (FiLM): bf16 rounding alone moves eps by {floor_k:.3e}; the kernels "
        f"are held to max({BF16_TOL:g}, {FLOOR_FACTOR:g} x that)")
    unet_check("48k bf16", unet_eps(*k48_args, bf16), plain_k, ref_k,
               max(BF16_TOL, FLOOR_FACTOR * floor_k))
    unet_check("48k f32", unet_eps(*k48_args, f32), ref_k, ref_k, F32_TOL)
    del k48_unet, ref_k, plain_k
    encode_check(full_cfg, vae_f32, mel)
    encode_check(k48_cfg, k48_vae_f32, k48_mel)
    del vae_f32, mel, k48_vae_f32, k48_mel

    launches, e2e = phase_5(t5_cfg, full_cfg, large_cfg, k48_cfg, tts_cfg, device, steps,
                            duration)
    more_launches, more_e2e = phase_6(t5_cfg, device, steps, duration)
    launches.update(more_launches)
    e2e.update(more_e2e)
    multi_launches, e2e["multi"] = phase_multi(t5_cfg, device)
    launches.update(multi_launches)
    golden_launches, e2e["golden"] = phase_golden(device)
    launches.update(golden_launches)
    keys = ("ms", "plain_ms", "bound_ms", "max_abs_err", "shapes")
    e2e["multi"]["tp_rank_kernels"] = {name: {k: st[k] for k in keys}
                                       for name, st in tp_stats.items()}
    e2e["multi"]["int8"]["tp_rank_kernels"] = {
        name: {**{k: st[k] for k in keys}, "tp1": {k: tp18_stats[name][k] for k in keys}}
        for name, st in tp8_stats.items()}
    for name, err in e2e["train"]["max_abs_err"].items():  # the f32 train-step shapes'
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    return stats, launches, e2e


def merge_errors(stats, part):
    """Fold another path's phase-3 stats into the record's: the largest
    error, and the plain conv shapes slower than the f32 copies."""
    for name, st in part.items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], st["max_abs_err"])
        if "slower_than_replaced" in st:
            stats[name]["slower_than_replaced"] = (stats[name].get("slower_than_replaced", [])
                                                   + st["slower_than_replaced"])


def encode_check(cfg, vae_f32, mel):
    """One full-width f32 VAE encode (moments), kernels against the
    all-plain path, and the time of both."""
    import torch
    from audioldm2_torch.models import vae
    from audioldm2_torch.ops.nn import full_f32

    log(f"== phase 4: full-width f32 VAE encode ({cfg.name}), kernels against the all-plain "
        "path")

    def encode():
        return torch.cat(vae.encode_moments(vae_f32, cfg.vae, mel), dim=-1)

    with torch.inference_mode(), full_f32():
        got = encode()
        with patched_dispatch("plain"):
            want = encode()
            plain_ms = cuda_ms(encode, target_ms=200.0, max_reps=5)
        kern_ms = cuda_ms(encode, target_ms=200.0, max_reps=5)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("VAE encode is not finite")
    d, r = rel_err(got, want)
    log(f"  encode mel {tuple(mel.shape)} -> moments {tuple(got.shape)}: kernels against "
        f"all-plain max_abs_err {d:.3e} rel {r:.3e} (tol {F32_TOL:g}); kernels {kern_ms:.3f} ms, "
        f"all-plain {plain_ms:.3f} ms")
    if r > F32_TOL:
        raise AssertionError(f"VAE encode: kernels disagree with the plain path ({r:.3e})")


def kernel_record(stats, launches):
    """The kernels' JSON record; fails if a kernel never launched on a path."""
    missing = [n for n in KERNELS if not any(c[n] for c in launches.values())]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: {missing}")
    return {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": sum(c[name] for c in launches.values()),
         "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
         "bound_ms": st["bound_ms"],
         "bound_by": "operations" if st["ops_ms"] >= st["bytes_ms"] else "bytes",
         "library_ms": st["library_ms"],
         **({"slower_than_replaced": st["slower_than_replaced"]}
            if "slower_than_replaced" in st else {})}
        for name, st in ((n, stats[n]) for n in KERNELS)
    ]}


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
    stats, launches, e2e = run(*(at.default_audioldm_config(name) for name in
                                 (T5_MODEL, FULL_MODEL, LARGE_MODEL, K48_MODEL, TTS_MODEL)),
                               "cuda", args.steps, 10.0)
    log(f"end to end: {json.dumps(e2e)}")
    record = kernel_record(stats, launches)
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
