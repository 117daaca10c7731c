"""Ancestral DDPM sampler, in PyTorch.

Port of ``audioldm2_tpu/diffusion/ddpm_ancestral.py:30-87``: all
``schedule.num_timesteps`` steps in descending t, one model call each. A
step predicts x_0 from eps, takes the mean of the posterior q(x_{t-1} |
x_t, x_0) and adds exp(log_var / 2) noise except at t = 0. The inpainting
mask is blended *after* the step (DDIM and PLMS blend before the model
call). The eps function is the same CFG-combined one as the other
samplers'.
"""

from __future__ import annotations

from typing import Optional

import torch

from audioldm2_torch.diffusion.schedule import DiffusionSchedule
from audioldm2_torch.diffusion.ddim import EpsFn, MaskBlend, check_steps, initial_latent
from audioldm2_torch.utils import profiling


def ddpm_sample(
    eps_fn: EpsFn,
    shape,
    schedule: DiffusionSchedule,
    x_T: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    clip_denoised: bool = False,
    generator: Optional[torch.Generator] = None,
    device="cpu",
    noise: Optional[torch.Tensor] = None,
    mask_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the full ancestral trajectory in float32; returns x_0 latents.

    mask: [B, T, F, 1], 1 = keep the q-sampled x0. noise: optional
    [num_timesteps, *shape] posterior noise, mask_noise: optional
    [num_timesteps, *x0.shape] q-sample noise of the blend, both in loop
    order (t descending) and drawn from ``generator`` when None."""
    n_steps = schedule.num_timesteps
    check_steps(n_steps, noise=noise, mask_noise=mask_noise)
    with profiling.span("sampler"):
        img = initial_latent(shape, x_T, generator, device)
        dev = img.device

        def table(a):
            return torch.as_tensor(a, device=dev)

        sqrt_recip = table(schedule.sqrt_recip_alphas_cumprod)
        sqrt_recipm1 = table(schedule.sqrt_recipm1_alphas_cumprod)
        coef1 = table(schedule.posterior_mean_coef1)
        coef2 = table(schedule.posterior_mean_coef2)
        log_var = table(schedule.posterior_log_variance_clipped)
        blend = MaskBlend(schedule, mask, x0, mask_noise, generator, dev)
        b = img.shape[0]
        for i, t in enumerate(range(n_steps - 1, -1, -1)):
            with profiling.step("sampler.step"):
                e_t = eps_fn(img, torch.full((b,), t, dtype=torch.int32, device=dev))
                x_recon = sqrt_recip[t] * img - sqrt_recipm1[t] * e_t
                if clip_denoised:
                    x_recon = torch.clamp(x_recon, -1.0, 1.0)
                img = coef1[t] * x_recon + coef2[t] * img
                if t > 0:
                    n = noise[i].to(img) if noise is not None else torch.randn(
                        img.shape, generator=generator, device=dev, dtype=torch.float32)
                    img = img + torch.exp(0.5 * log_var[t]) * n
                img = blend(img, t, i)
        return img
