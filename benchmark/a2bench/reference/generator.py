"""The generation stages of the reference: UNet, VAE decoder, HiFi-GAN
vocoder, and the DDIM sampler with classifier-free guidance.

A frozen copy of the plain paths of ``audioldm2_torch/models/unet.py``,
``models/vae.py``, ``models/vocoder.py``, ``diffusion/schedule.py`` and
``diffusion/ddim.py``: the same equations in float32, with no fused
projections, no precomputed cross K/V and no kernel. The DDIM trajectory
draws x_T and each step's noise from a ``torch.Generator`` in the program's
order (x_T, then one draw per step with sigma != 0), so a generator seeded
as the program seeds its own gives the same draws on the same device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from a2bench.reference import nn
from a2bench.reference.config import UNetConfig, VAEConfig, VocoderConfig

GN_EPS_RES = 1e-5
GN_EPS_ST = 1e-6
LN_EPS = 1e-5
VAE_GN_EPS = 1e-6
LRELU_SLOPE = 0.1


# --- UNet --------------------------------------------------------------------


def _resblock(p, x, emb):
    h = nn.conv2d(p["in_conv"], nn.group_norm_silu(p["in_norm"], x, eps=GN_EPS_RES))
    skip = nn.conv2d(p["skip"], x) if "skip" in p else x
    h = h + nn.linear(p["emb"], nn.silu(emb))[:, None, None, :]
    h = nn.conv2d(p["out_conv"], nn.group_norm_silu(p["out_norm"], h, eps=GN_EPS_RES))
    return skip + h


def _attention(p, p_norm, x, context, mask, num_heads):
    xn = nn.layer_norm(p_norm, x, LN_EPS)
    src = xn if context is None else context
    q = nn.split_heads(nn.linear(p["to_q"], xn), num_heads)
    k = nn.split_heads(nn.linear(p["to_k"], src), num_heads)
    v = nn.split_heads(nn.linear(p["to_v"], src), num_heads)
    out = nn.attention(q, k, v, mask=mask if context is not None else None)
    return nn.linear(p["to_out"], nn.merge_heads(out))


def _st_block(p, x, context, mask, num_heads):
    x = x + _attention(p["attn1"], p["norm1"], x, None, None, num_heads)
    x = x + _attention(p["attn2"], p["norm2"], x, context, mask, num_heads)
    h = nn.linear(p["ff"]["proj_in"], nn.layer_norm(p["norm3"], x, LN_EPS))
    a, gate = torch.chunk(h, 2, dim=-1)
    return x + nn.linear(p["ff"]["proj_out"], a * nn.gelu(gate))


def _spatial_transformer(p, x, context, mask, num_heads):
    b, t, f, c = x.shape
    h = nn.group_norm(p["norm"], x, eps=GN_EPS_ST)
    h = nn.conv2d(p["proj_in"], h).reshape(b, t * f, c)
    for blk in p["blocks"]:
        h = _st_block(blk, h, context, mask, num_heads)
    return x + nn.conv2d(p["proj_out"], h.reshape(b, t, f, c))


def _run_sts(blk, h, contexts, masks, cfg: UNetConfig):
    num_heads = h.shape[-1] // cfg.num_head_channels
    h = _spatial_transformer(blk["self_st"], h, None, None, num_heads)
    for i, st in enumerate(blk["cross_sts"]):
        ctx = contexts[i] if i < len(contexts) else None
        msk = masks[i] if i < len(masks) else None
        h = _spatial_transformer(st, h, ctx, msk, num_heads)
    return h


def apply_unet(params, cfg: UNetConfig, x: torch.Tensor, timesteps: torch.Tensor,
               contexts: Sequence[Optional[torch.Tensor]] = (),
               masks: Sequence[Optional[torch.Tensor]] = (),
               y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, T, F, C]; timesteps: [B]; contexts[i]: [B, L_i, D_i]; masks[i]:
    [B, L_i] (1 = attend); y: [B, film_dim]. Returns eps [B, T, F, C]."""
    t_emb = nn.timestep_embedding(timesteps, cfg.model_channels)
    emb = nn.linear(params["time_embed"]["lin1"], t_emb)
    emb = nn.linear(params["time_embed"]["lin2"], nn.silu(emb))
    if cfg.extra_film_condition_dim is not None:
        emb = torch.cat([emb, nn.linear(params["film_emb"], y)], dim=-1)
    hs = []
    h = x.float()
    for blk in params["input_blocks"]:
        if "conv" in blk:
            h = nn.conv2d(blk["conv"], h)
        elif "downsample" in blk:
            h = nn.conv2d(blk["downsample"], h, stride=(2, 2), padding=1)
        else:
            h = _resblock(blk["res"], h, emb)
            if "self_st" in blk:
                h = _run_sts(blk, h, contexts, masks, cfg)
        hs.append(h)
    mid = params["middle_block"]
    h = _resblock(mid["res1"], h, emb)
    h = _run_sts(mid, h, contexts, masks, cfg)
    h = _resblock(mid["res2"], h, emb)
    for blk in params["output_blocks"]:
        h = _resblock(blk["res"], torch.cat([h, hs.pop()], dim=-1), emb)
        if "self_st" in blk:
            h = _run_sts(blk, h, contexts, masks, cfg)
        if "upsample" in blk:
            h = nn.conv2d(blk["upsample"], nn.nearest_upsample_2d(h))
    h = nn.group_norm_silu(params["out_norm"], h, eps=GN_EPS_RES)
    return nn.conv2d(params["out_conv"], h)


# --- VAE decoder -------------------------------------------------------------


def _vae_resblock(p, x):
    h = nn.conv2d(p["conv1"], nn.group_norm_silu(p["norm1"], x, eps=VAE_GN_EPS))
    h = nn.conv2d(p["conv2"], nn.group_norm_silu(p["norm2"], h, eps=VAE_GN_EPS))
    if "nin_shortcut" in p:
        x = nn.conv2d(p["nin_shortcut"], x)
    return x + h


def _vae_attnblock(p, x):
    b, h, w, c = x.shape
    hn = nn.group_norm(p["norm"], x, eps=VAE_GN_EPS)
    q, k, v = (nn.conv2d(p[n], hn).reshape(b, h * w, 1, c) for n in ("q", "k", "v"))
    out = nn.attention(q, k, v).reshape(b, h, w, c)
    return x + nn.conv2d(p["proj_out"], out)


def vae_decode(p, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """z: [B, t, f, embed_dim] (already divided by scale_factor) -> mel
    [B, T, M, 1]."""
    h = nn.conv2d(p["post_quant_conv"], z.float())
    d = p["decoder"]
    h = nn.conv2d(d["conv_in"], h)
    h = _vae_resblock(d["mid"]["block_1"], h)
    h = _vae_attnblock(d["mid"]["attn_1"], h)
    h = _vae_resblock(d["mid"]["block_2"], h)
    for i in reversed(range(len(d["up"]))):
        level = d["up"][i]
        for rb in level["block"]:
            h = _vae_resblock(rb, h)
        if "upsample" in level:
            h = nn.conv2d(level["upsample"], nn.nearest_upsample_2d(h))
        elif "upsample_ts4" in level:
            h = nn.conv2d(level["upsample_ts4"], nn.nearest_upsample_2d(h, 4, 2), padding=2)
    h = nn.group_norm_silu(d["norm_out"], h, eps=VAE_GN_EPS)
    return nn.conv2d(d["conv_out"], h)


# --- vocoder -----------------------------------------------------------------


def _padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _voc_resblock(p, x, kernel_size: int, dilations, two_convs: bool):
    convs2 = p["convs2"] if two_convs else [None] * len(dilations)
    convs1 = p["convs1"] if two_convs else p["convs"]
    for c1, c2, d in zip(convs1, convs2, dilations):
        xt = nn.conv1d(c1, nn.leaky_relu(x, LRELU_SLOPE), padding=_padding(kernel_size, d),
                       dilation=d)
        if c2 is not None:
            xt = nn.conv1d(c2, nn.leaky_relu(xt, LRELU_SLOPE), padding=_padding(kernel_size, 1))
        x = xt + x
    return x


def vocoder(p, cfg: VocoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, T_mel, num_mels] -> waveform [B, T_mel * prod(rates)]."""
    x = nn.conv1d(p["conv_pre"], mel.float(), padding=3)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = nn.conv_transpose1d(p["ups"][i], nn.leaky_relu(x, LRELU_SLOPE), stride=u,
                                padding=(k - u) // 2)
        acc = None
        for j, (ks, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilation_sizes)):
            y = _voc_resblock(p["resblocks"][i * nk + j], x, ks, dils, cfg.resblock == "1")
            acc = y if acc is None else acc + y
        x = acc / nk
    x = nn.conv1d(p["conv_post"], nn.leaky_relu(x, 0.01), padding=3)
    return torch.tanh(x)[..., 0]


# --- DDIM --------------------------------------------------------------------


def ddim_params(timesteps: int, linear_start: float, linear_end: float, num_steps: int,
                eta: float):
    """(ts, alphas, alphas_prev, sigmas), each [S], float32: the linear beta
    schedule's cumulative alphas at the uniform subset with the +1 shift."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                        dtype=np.float64) ** 2
    acum = np.cumprod(1.0 - betas).astype(np.float32).astype(np.float64)
    if num_steps < 1 or timesteps % num_steps:
        raise ValueError(f"{num_steps} DDIM steps do not divide {timesteps}")
    ts = np.arange(0, timesteps, timesteps // num_steps) + 1
    alphas = acum[ts]
    alphas_prev = np.concatenate([[acum[0]], acum[ts[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return (ts.astype(np.int32), alphas.astype(np.float32), alphas_prev.astype(np.float32),
            sigmas.astype(np.float32))


def ddim_draws(shape, rows, schedule, generator: torch.Generator, device):
    """(x_T, [noise of each step or None]) at the rows ``rows`` of a batch of
    ``shape``, drawn whole from ``generator`` in the sampler's order."""
    x_T = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)[rows]
    noise = []
    for sigma in schedule[3][::-1]:
        noise.append(torch.randn(shape, generator=generator, device=device,
                                 dtype=torch.float32)[rows] if sigma != 0 else None)
    return x_T, noise


def ddim_sample(eps_fn, x_T: torch.Tensor, noise, schedule) -> torch.Tensor:
    """The DDIM trajectory from x_T in float32 (descending t)."""
    ts, alphas, alphas_prev, sigmas = schedule
    one = np.float32(1.0)
    img = x_T.float()
    rows = zip(ts[::-1], alphas[::-1], alphas_prev[::-1], sigmas[::-1], noise)
    for t, a_t, a_prev, sigma, n in rows:
        tb = torch.full((img.shape[0],), int(t), dtype=torch.int32, device=img.device)
        e_t = eps_fn(img, tb)
        pred_x0 = (img - float(np.sqrt(one - a_t)) * e_t) / float(np.sqrt(a_t))
        dir_coef = np.sqrt(np.maximum(one - a_prev - sigma * sigma, np.float32(0.0)))
        img = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t
        if sigma != 0:
            img = img + float(sigma) * n
    return img


def guided_eps_fn(unet_params, cfg: UNetConfig, contexts, masks, y, guidance: float):
    """eps over a [B] latent from one UNet call over the stacked
    (uncond || cond) [2B] batch: e_u + guidance * (e_c - e_u)."""
    def eps(x, t):
        e = apply_unet(unet_params, cfg, torch.cat([x, x]), torch.cat([t, t]), contexts,
                       masks, y)
        e_u, e_c = torch.chunk(e, 2, dim=0)
        return e_u + guidance * (e_c - e_u)

    return eps


def pad_latent_time(z: torch.Tensor, frames: int) -> torch.Tensor:
    """Zero-pad or cut the latent's time axis to ``frames``."""
    t = z.shape[1]
    return F.pad(z, (0, 0, 0, 0, 0, frames - t)) if t < frames else z[:, :frames]
