"""DDIM sampler with classifier-free guidance, in PyTorch.

Port of ``audioldm2_tpu/diffusion/ddim.py``: the same (t, alpha,
alpha_prev, sigma) rows from ``schedule.make_ddim_params``, walked in
descending t as a Python loop. Guidance is one batched model call with the
unconditional half first and the conditional half second.

Randomness comes from an explicit ``torch.Generator``. JAX's threefry and
torch's Philox never give the same numbers, so ``x_T`` and the per-step
``noise`` can be injected to feed both packages identical values.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from audioldm2_tpu.diffusion.schedule import DiffusionSchedule, make_ddim_params

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def cfg_eps_fn(model_fn: EpsFn, guidance_scale: float) -> EpsFn:
    """Wrap a model over a [2B] uncond||cond batch into a guided eps over
    [B]: e = e_u + s * (e_c - e_u)."""

    def eps(x, t):
        e = model_fn(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0))
        e_u, e_c = torch.chunk(e, 2, dim=0)
        return e_u + guidance_scale * (e_c - e_u)

    return eps


def q_sample(sqrt_acum, sqrt_1macum, x0, t, noise):
    """Forward diffusion q(x_t | x_0)."""
    return sqrt_acum[t] * x0 + sqrt_1macum[t] * noise


def ddim_sample(
    eps_fn: EpsFn,
    shape,
    schedule: DiffusionSchedule,
    num_steps: int = 200,
    eta: float = 1.0,
    x_T: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    t_start: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    device="cpu",
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the DDIM trajectory in float32; returns x_0 latents [B, ...].

    mask: [B, T, F, 1], 1 = keep the q-sampled x0 (inpainting blend).
    t_start: run only the first ``t_start`` subset steps (descending).
    noise: optional [n_steps, *shape] per-step noise for the sigma term, in
    loop order; drawn from ``generator`` when None."""
    ts, alphas, alphas_prev, sigmas = make_ddim_params(schedule, num_steps, eta)
    if t_start is not None:
        ts, alphas, alphas_prev, sigmas = (a[:t_start] for a in (ts, alphas, alphas_prev, sigmas))
    rows = list(zip(ts[::-1], alphas[::-1], alphas_prev[::-1], sigmas[::-1]))
    if noise is not None and noise.shape[0] != len(rows):
        raise ValueError(f"noise has {noise.shape[0]} steps, the trajectory {len(rows)}")

    img = (x_T.float() if x_T is not None
           else torch.randn(shape, generator=generator, device=device, dtype=torch.float32))
    sqrt_acum = torch.as_tensor(schedule.sqrt_alphas_cumprod, device=img.device)
    sqrt_1macum = torch.as_tensor(schedule.sqrt_one_minus_alphas_cumprod, device=img.device)
    b = img.shape[0]
    one = np.float32(1.0)
    for i, (t, a_t, a_prev, sigma) in enumerate(rows):
        if mask is not None:
            qn = torch.randn(x0.shape, generator=generator, device=img.device, dtype=torch.float32)
            img = q_sample(sqrt_acum, sqrt_1macum, x0, int(t), qn) * mask + (1.0 - mask) * img
        tb = torch.full((b,), int(t), dtype=torch.int32, device=img.device)
        e_t = eps_fn(img, tb)
        # coefficients in float32, as the JAX scan computes them
        pred_x0 = (img - float(np.sqrt(one - a_t)) * e_t) / float(np.sqrt(a_t))
        dir_coef = np.sqrt(np.maximum(one - a_prev - sigma * sigma, np.float32(0.0)))
        img = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t
        if sigma != 0:
            n = noise[i].to(img) if noise is not None else torch.randn(
                img.shape, generator=generator, device=img.device, dtype=torch.float32)
            img = img + float(sigma) * n
    return img
