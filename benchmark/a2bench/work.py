"""The work of a request, counted from its shapes: the FLOPs of a UNet
step, a VAE decode and a vocoder pass, and the bytes of a UNet forward.

The FLOP functions are a frozen copy of ``audioldm2_torch/ops/flops.py``
(checked there against the JAX package's for all seven families), read
from the reference's configuration classes. Convention: one multiply-add
is 2 FLOPs; norms, elementwise ops and softmax are not counted (under 1%
at these shapes).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from a2bench.reference.config import ModelConfig, UNetConfig, VAEConfig, VocoderConfig


def conv2d_flops(b, h_out, w_out, kh, kw, cin, cout) -> float:
    return 2.0 * b * h_out * w_out * kh * kw * cin * cout


def linear_flops(b_tokens, cin, cout) -> float:
    return 2.0 * b_tokens * cin * cout


def attention_flops(b, heads, t_q, t_k, head_dim) -> float:
    """QK^T + weights@V (projections counted separately)."""
    return 2.0 * b * heads * t_q * t_k * head_dim * 2


def _st_flops(
    b: int,
    s: int,
    c: int,
    depth: int,
    context_len: Optional[int],
    context_dim: Optional[int],
    heads: int,
    count_kv: bool,
) -> float:
    """One SpatialTransformer: GN -> 1x1 conv in -> depth x (self-attn,
    cross-attn, GEGLU FF) -> 1x1 conv out (+ residual).

    ``context_len=None`` means a context-free slot — its attn2 is another
    self-attention over s tokens. ``count_kv=False`` excludes the cross K/V
    projections (precompute_cross_kv hoists them out of the sampling loop,
    so per-step MFU must not charge them)."""
    head_dim = c // heads
    f = conv2d_flops(b, 1, s, 1, 1, c, c) * 2  # proj_in + proj_out over s pixels
    for _ in range(depth):
        # attn1 (self): q,k,v + out projections, attention over s x s
        f += linear_flops(b * s, c, 3 * c) + linear_flops(b * s, c, c)
        f += attention_flops(b, heads, s, s, head_dim)
        # attn2: cross (s x L) or context-free self (s x s)
        t_k = context_len if context_len is not None else s
        d_ctx = context_dim if context_dim is not None else c
        f += linear_flops(b * s, c, c)  # to_q
        if context_len is None:
            f += linear_flops(b * s, c, 2 * c)  # self K/V always in-step
        elif count_kv:
            f += linear_flops(b * t_k, d_ctx, 2 * c)
        f += attention_flops(b, heads, s, t_k, head_dim)
        f += linear_flops(b * s, c, c)  # to_out
        # GEGLU FF: [c -> 8c] then [4c -> c]
        f += linear_flops(b * s, c, 8 * c) + linear_flops(b * s, 4 * c, c)
    return f


def _resblock_flops(b, h, w, cin, cout, emb_dim) -> float:
    f = conv2d_flops(b, h, w, 3, 3, cin, cout)  # in conv
    f += linear_flops(b, emb_dim, cout)  # time-emb projection
    f += conv2d_flops(b, h, w, 3, 3, cout, cout)  # out conv
    if cin != cout:
        f += conv2d_flops(b, h, w, 1, 1, cin, cout)  # skip 1x1
    return f


def unet_forward_flops(
    cfg: UNetConfig,
    batch: int,
    latent_t: int,
    latent_f: int,
    context_lens: Sequence[Optional[int]] = (),
    count_cross_kv: bool = False,
) -> float:
    """One UNet forward at [batch, latent_t, latent_f, in_channels].

    Mirrors the walk of ``models/unet.py:init_unet/apply_unet`` exactly
    (same channel bookkeeping, same attention placement).
    ``context_lens[i]``: token count of context slot i (None for the
    config's context-free ``None`` slots)."""
    mc = cfg.model_channels
    emb = cfg.emb_dim
    lens = list(context_lens) + [None] * (len(cfg.context_dims) - len(context_lens))

    def sts(b, h, w, c):
        heads = c // cfg.num_head_channels
        s = h * w
        f = _st_flops(b, s, c, cfg.transformer_depth, None, None, heads, False)
        for cd, cl in zip(cfg.context_dims, lens):
            f += _st_flops(
                b, s, c, cfg.transformer_depth,
                cl if cd is not None else None, cd, heads, count_cross_kv,
            )
        return f

    t, w = latent_t, latent_f
    ds = 1
    ch = mc
    chans = [mc]
    total = conv2d_flops(batch, t, w, 3, 3, cfg.in_channels, mc)  # stem
    # time embedding MLP (tiny)
    total += linear_flops(batch, mc, cfg.time_embed_dim)
    total += linear_flops(batch, cfg.time_embed_dim, cfg.time_embed_dim)
    if cfg.extra_film_condition_dim is not None:
        total += linear_flops(batch, cfg.extra_film_condition_dim, cfg.time_embed_dim)

    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            total += _resblock_flops(batch, t, w, ch, mult * mc, emb)
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                total += sts(batch, t, w, ch)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            t, w = t // 2, w // 2
            total += conv2d_flops(batch, t, w, 3, 3, ch, ch)
            chans.append(ch)
            ds *= 2

    total += _resblock_flops(batch, t, w, ch, ch, emb)
    total += sts(batch, t, w, ch)
    total += _resblock_flops(batch, t, w, ch, ch, emb)

    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            total += _resblock_flops(batch, t, w, ch + ich, mult * mc, emb)
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                total += sts(batch, t, w, ch)
            if level and i == cfg.num_res_blocks:
                t, w = t * 2, w * 2
                total += conv2d_flops(batch, t, w, 3, 3, ch, ch)
                ds //= 2

    total += conv2d_flops(batch, latent_t, latent_f, 3, 3, mc, cfg.out_channels)
    return total


def default_context_lens(cfg: ModelConfig) -> list:
    """Token count per UNet context slot, in conditioner order (crossattn
    conditioners only — the slot order contract of DiffusionWrapper,
    reference ddpm.py:1027-1032)."""
    lens = []
    for spec in cfg.conditioners:
        if "crossattn" not in spec.name:
            continue
        if spec.kind == "sequence_gen" and spec.sequence_gen is not None:
            lens.append(spec.sequence_gen.sequence_gen_length)
        elif spec.kind == "flan_t5" and spec.flan_t5 is not None:
            lens.append(spec.flan_t5.max_length)
        elif spec.kind == "phoneme":
            lens.append(310)
        elif spec.kind == "audiomae_pooled":
            lens.append(8)
        else:
            lens.append(128)
    return lens


def _vae_resblock_flops(b, h, w, cin, cout) -> float:
    f = conv2d_flops(b, h, w, 3, 3, cin, cout)
    f += conv2d_flops(b, h, w, 3, 3, cout, cout)
    if cin != cout:
        f += conv2d_flops(b, h, w, 1, 1, cin, cout)
    return f


def vae_decode_flops(cfg: VAEConfig, b: int, latent_t: int, latent_f: int) -> float:
    """One AutoencoderKL decode ``[b, latent_t, latent_f, embed_dim] -> mel``
    — mirrors ``models/vae.py:apply_decoder`` (post_quant 1x1, conv_in, mid
    resblocks + attn, the up ladder with nearest-upsample convs, conv_out)."""
    ch, mults = cfg.ch, cfg.ch_mult
    t, w = latent_t, latent_f
    block_in = ch * mults[-1]
    f = conv2d_flops(b, t, w, 1, 1, cfg.embed_dim, cfg.z_channels)  # post_quant
    f += conv2d_flops(b, t, w, 3, 3, cfg.z_channels, block_in)  # conv_in
    # mid: resblock, attn (qkv + out 1x1 convs, s^2 attention), resblock
    f += 2 * _vae_resblock_flops(b, t, w, block_in, block_in)
    s = t * w
    f += 4 * conv2d_flops(b, t, w, 1, 1, block_in, block_in)  # q,k,v,proj_out
    f += attention_flops(b, 1, s, s, block_in)
    for i in reversed(range(len(mults))):
        block_out = ch * mults[i]
        for _ in range(cfg.num_res_blocks + 1):
            f += _vae_resblock_flops(b, t, w, block_in, block_out)
            block_in = block_out
        if i != 0:
            if (i - 1) in cfg.downsample_time_stride4_levels:
                t, w = t * 4, w * 2
                f += conv2d_flops(b, t, w, 5, 5, block_in, block_in)
            else:
                t, w = t * 2, w * 2
                f += conv2d_flops(b, t, w, 3, 3, block_in, block_in)
    f += conv2d_flops(b, t, w, 3, 3, block_in, cfg.out_ch)  # conv_out
    return f


def conv1d_flops(b, t_out, k, cin, cout) -> float:
    return 2.0 * b * t_out * k * cin * cout


def vocoder_flops(cfg: VocoderConfig, b: int, t_mel: int) -> float:
    """One HiFi-GAN forward ``[b, t_mel, num_mels] -> wav`` — mirrors
    ``models/vocoder.py:apply_vocoder`` (conv_pre, per-stage ConvTranspose1d
    + MRF resblock sum, conv_post). A ConvTranspose1d costs
    2*b*t_in*k*cin*cout (each input sample scatters to k outputs)."""
    ch0 = cfg.upsample_initial_channel
    t = t_mel
    f = conv1d_flops(b, t, 7, cfg.num_mels, ch0)
    c = ch0
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cout = ch0 // (2 ** (i + 1))
        f += 2.0 * b * t * k * c * cout  # transposed conv: t_in taps
        t, c = t * u, cout
        for ks, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            convs_per_dil = 2 if cfg.resblock == "1" else 1
            f += convs_per_dil * len(dils) * conv1d_flops(b, t, ks, c, c)
    f += conv1d_flops(b, t, 7, c, 1)  # conv_post
    return f


def unet_step_flops(
    cfg: ModelConfig, batch_size: int, latent_t: int
) -> float:
    """One CFG denoising step: a single UNet forward over the stacked
    (uncond || cond) batch — ``batch_size`` is that CFG batch (2 x n_gen x
    user batch). Cross K/V projections are excluded (hoisted out of the
    sampling loop by precompute_cross_kv)."""
    return unet_forward_flops(
        cfg.unet,
        batch_size,
        latent_t,
        cfg.latent_f_size,
        context_lens=default_context_lens(cfg),
        count_cross_kv=False,
    )


# Published peaks of one NVIDIA H100 SXM (dense bf16, HBM3), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def unet_forward_bytes(cfg: ModelConfig, unet_values: int, batch: int, latent_t: int,
                       weight_bytes: int = 2) -> float:
    """Bytes one UNet forward has to move at the least: every weight read
    once (``unet_values`` values of ``weight_bytes``), the bf16 latent read
    and the bf16 eps written once, each cross-attention context's bf16 K/V
    read once."""
    latent = batch * latent_t * cfg.latent_f_size * cfg.latent_channels * 2
    ctx = 0
    for dim, length in zip(cfg.unet.context_dims, default_context_lens(cfg)):
        if dim is not None:
            ctx += batch * length * dim * 2
    return unet_values * weight_bytes + 2 * latent + ctx


def unet_least_s(cfg: ModelConfig, unet_values: int, batch: int, latent_t: int) -> float:
    """The least time of one UNet forward on the card: its FLOPs at the bf16
    peak or its bytes at the HBM peak, whichever is longer."""
    return max(unet_step_flops(cfg, batch, latent_t) / PEAK_BF16_FLOPS,
               unet_forward_bytes(cfg, unet_values, batch, latent_t) / PEAK_HBM_BYTES_PER_S)


def request_flops(cfg: ModelConfig, clips: int, cfg_batch: int, steps: int,
                  latent_t: int) -> float:
    """Model FLOPs of one text-to-audio request of ``clips`` candidates: its
    UNet steps over the CFG batch, one VAE decode and one vocoder pass of
    each candidate."""
    mel_frames = latent_t * 2 ** (len(cfg.vae.ch_mult) - 1)
    return (steps * unet_step_flops(cfg, cfg_batch, latent_t)
            + vae_decode_flops(cfg.vae, clips, latent_t, cfg.latent_f_size)
            + vocoder_flops(cfg.vocoder, clips, mel_frames))


def latent_frames(cfg: ModelConfig, mix) -> int:
    """Latent frames of a request of the mix: its duration rounded up to the
    duration bucket, at the configuration's latent frame rate."""
    duration, bucket = mix["duration"], mix["duration_bucket"]
    if bucket:
        duration = max(math.ceil(round(duration / bucket, 6)), 1) * bucket
    return int(duration * cfg.latent_t_per_second)
