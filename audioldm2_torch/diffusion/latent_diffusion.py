"""Latent diffusion orchestration: conditioning -> DDIM -> VAE -> vocoder.

Port of ``audioldm2_tpu/diffusion/latent_diffusion.py`` for the t5 slice.
Conditioning runs once per call; the UNet, VAE and vocoder weights are cast
to the config's compute dtype (bf16 for the shipped configs) as the JAX
package's cast_tree does, while the latents and the sampler math stay
float32. Cross-attention K/V and the fused self-attention QKV weights are
built once per call, outside the step loop.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from audioldm2_tpu.config import ModelConfig
from audioldm2_tpu.diffusion.schedule import DiffusionSchedule
from audioldm2_torch.diffusion import ddim
from audioldm2_torch.models import conditioners, unet, vae, vocoder
from audioldm2_torch.params import cast_floating


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x] * n, dim=0) if n > 1 else x


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def encode_conditioning(params, cfg: ModelConfig, batch, n_gen: int, guidance: float):
    """(contexts, masks) per cross-attention slot, stacked (uncond || cond *
    n_gen) for a [2 * B * n_gen] CFG batch, or the cond inputs alone when
    guidance == 1; plus B * n_gen and whether CFG is on. Every ported
    conditioner is a cross-attention one (no FiLM ``y`` yet)."""
    cond = []
    for s in cfg.conditioners:
        _, (ctx, mask) = conditioners.encode(params["cond"][s.name], s, batch)
        cond.append((_tile(ctx, n_gen), _tile(mask, n_gen)))
    bsz = cond[0][0].shape[0]
    if guidance == 1.0:
        return [c for c, _ in cond], [m for _, m in cond], bsz, False
    contexts, masks = [], []
    for s, (ctx, mask) in zip(cfg.conditioners, cond):
        _, (u_ctx, u_mask) = conditioners.unconditional(params["cond"][s.name], s, batch, bsz)
        contexts.append(torch.cat([u_ctx, ctx]))
        masks.append(torch.cat([u_mask, mask]))
    return contexts, masks, bsz, True


def _generate_impl(params, batch, cfg: ModelConfig, schedule: DiffusionSchedule,
                   latent_t_size: int, n_gen: int, guidance: float, ddim_steps: int,
                   ddim_eta: float, generator: Optional[torch.Generator],
                   x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
    if cfg.weight_quant is not None:
        raise NotImplementedError(
            "weight_quant is not ported to audioldm2_torch yet (ROADMAP queue 2: int8 kernels)"
        )
    contexts, masks, bsz, cfg_on = encode_conditioning(params, cfg, batch, n_gen, guidance)
    device = contexts[0].device
    shape = (bsz, latent_t_size, cfg.latent_f_size, cfg.latent_channels)
    cdtype = compute_dtype(cfg)

    unet_p = cast_floating(params["unet"], cdtype)
    contexts_c = [c.to(cdtype) for c in contexts]
    cross_kv = unet.precompute_cross_kv(unet_p, cfg.unet, contexts_c)
    unet_p = unet.fuse_self_qkv(unet_p)

    def model_fn(x, t):
        eps = unet.apply_unet(unet_p, cfg.unet, x.to(cdtype), t, context_list=contexts_c,
                              context_mask_list=masks, cross_kv=cross_kv)
        return eps.float()

    eps_fn = ddim.cfg_eps_fn(model_fn, guidance) if cfg_on else model_fn
    z = ddim.ddim_sample(eps_fn, shape, schedule, num_steps=ddim_steps, eta=ddim_eta,
                         x_T=x_T, generator=generator, device=device, noise=noise)
    z = z / params["scale_factor"]
    mel = vae.decode(cast_floating(params["vae"], cdtype), cfg.vae, z.to(cdtype))
    wav = vocoder.apply_vocoder(cast_floating(params["vocoder"], cdtype), cfg.vocoder, mel[..., 0])
    return wav.float(), mel.float()


class LatentDiffusionModel:
    """Holds the config, the parameter tree and the diffusion schedule."""

    def __init__(self, cfg: ModelConfig, params: Dict):
        self.cfg = cfg
        self.params = params
        d = cfg.diffusion
        self.schedule = DiffusionSchedule.create(d.timesteps, d.beta_schedule,
                                                 d.linear_start, d.linear_end)

    @torch.inference_mode()
    def generate(self, batch: Dict, generator: Optional[torch.Generator], latent_t_size: int,
                 n_gen: int = 1, guidance: float = 3.5, ddim_steps: int = 200,
                 ddim_eta: float = 1.0, x_T: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None):
        """DDIM generation (the only sampler ported so far; PLMS, DDPM, the
        inpainting mask and EMA weights are ROADMAP queue 1 items 13-14).

        Returns (waveform [B*n_gen, N], mel [B*n_gen, T, M, 1]) as float32
        numpy arrays. ``x_T`` fixes the initial latent [B*n_gen, T, F, C];
        ``noise`` fixes the per-step DDIM noise (see ddim.ddim_sample)."""
        wav, mel = _generate_impl(self.params, batch, self.cfg, self.schedule, latent_t_size,
                                  n_gen, float(guidance), int(ddim_steps), float(ddim_eta),
                                  generator, x_T=x_T, noise=noise)
        return wav.cpu().numpy(), mel.cpu().numpy()


def kernel_launches_per_generate(cfg: ModelConfig, ddim_steps: int) -> Dict[str, int]:
    """Kernel launches of one generate call on CUDA: ``ddim_steps`` UNet
    forwards (one batched CFG call per step) and one VAE decode. The T5
    encoder runs no kernel (masked, biased attention; RMSNorm matmuls)."""
    per_step = unet.kernel_launches_per_forward(cfg.unet)
    dec = vae.kernel_launches_per_decode(cfg.vae)
    return {k: ddim_steps * per_step[k] + dec[k] for k in per_step}

