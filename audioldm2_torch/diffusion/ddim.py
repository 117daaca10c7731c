"""DDIM sampler with classifier-free guidance, in PyTorch.

Port of ``audioldm2_tpu/diffusion/ddim.py``: the same (t, alpha,
alpha_prev, sigma) rows from ``schedule.make_ddim_params``, walked in
descending t as a Python loop. Guidance is one batched model call with the
unconditional half first and the conditional half second.

``stochastic_encode`` and ``ddim_decode`` are the audio-to-audio editing
pair (JAX ``ddim.py:136-186``): diffuse a clean latent to a DDIM-subset
step, then denoise it deterministically under new conditioning.

Randomness comes from an explicit ``torch.Generator``. JAX's threefry and
torch's Philox never give the same numbers, so ``x_T``, the per-step
``noise`` and the inpainting blend's ``mask_noise`` can be injected to feed
both packages identical values (here and in ``plms``/``ddpm_ancestral``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from audioldm2_torch.diffusion.schedule import DiffusionSchedule, make_ddim_params

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


def check_steps(n_steps: int, **injected) -> None:
    """Every injected per-step noise tensor has one entry per loop step."""
    for name, arr in injected.items():
        if arr is not None and arr.shape[0] != n_steps:
            raise ValueError(f"{name} has {arr.shape[0]} steps, the trajectory {n_steps}")


def initial_latent(shape, x_T: Optional[torch.Tensor], generator, device) -> torch.Tensor:
    """x_T in float32, or a draw from ``generator``."""
    if x_T is not None:
        return x_T.float()
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


class MaskBlend:
    """The inpainting blend img <- q_sample(x0, t) * mask + (1 - mask) * img
    (mask 1 = keep the original). Step i's q-sample noise is mask_noise[i],
    or a draw from ``generator``. Without a mask it returns img unchanged."""

    def __init__(self, schedule: DiffusionSchedule, mask, x0, mask_noise, generator, device):
        self.mask, self.x0, self.mask_noise, self.generator = mask, x0, mask_noise, generator
        if mask is not None:
            self.sqrt_acum = torch.as_tensor(schedule.sqrt_alphas_cumprod, device=device)
            self.sqrt_1macum = torch.as_tensor(schedule.sqrt_one_minus_alphas_cumprod,
                                               device=device)

    def __call__(self, img: torch.Tensor, t: int, i: int) -> torch.Tensor:
        if self.mask is None:
            return img
        if self.mask_noise is not None:
            qn = self.mask_noise[i].to(img)
        else:
            qn = torch.randn(self.x0.shape, generator=self.generator, device=img.device,
                             dtype=torch.float32)
        orig = q_sample(self.sqrt_acum, self.sqrt_1macum, self.x0, t, qn)
        return orig * self.mask + (1.0 - self.mask) * img


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
    mask_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the DDIM trajectory in float32; returns x_0 latents [B, ...].

    mask: [B, T, F, 1], 1 = keep the q-sampled x0 (inpainting blend, before
    the model call). t_start: run only the first ``t_start`` subset steps
    (descending). noise: optional [n_steps, *shape] per-step noise for the
    sigma term, mask_noise: optional [n_steps, *x0.shape] q-sample noise of
    the blend, both in loop order and drawn from ``generator`` when None."""
    ts, alphas, alphas_prev, sigmas = make_ddim_params(schedule, num_steps, eta)
    if t_start is not None:
        ts, alphas, alphas_prev, sigmas = (a[:t_start] for a in (ts, alphas, alphas_prev, sigmas))
    rows = list(zip(ts[::-1], alphas[::-1], alphas_prev[::-1], sigmas[::-1]))
    check_steps(len(rows), noise=noise, mask_noise=mask_noise)

    img = initial_latent(shape, x_T, generator, device)
    blend = MaskBlend(schedule, mask, x0, mask_noise, generator, img.device)
    b = img.shape[0]
    one = np.float32(1.0)
    for i, (t, a_t, a_prev, sigma) in enumerate(rows):
        img = blend(img, int(t), i)
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


def stochastic_encode(x0: torch.Tensor, t_index: int, schedule: DiffusionSchedule,
                      num_steps: int = 200, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      use_original_steps: bool = False) -> torch.Tensor:
    """Diffuse a clean latent forward to DDIM-subset step ``t_index``:
    sqrt(a) * x0 + sqrt(1 - a) * noise, with a the subset's alpha (eta 0)
    or, under ``use_original_steps``, the raw schedule's at DDPM timestep
    ``t_index``. ``noise`` is injected, or drawn from ``generator``."""
    t_index = int(t_index)
    if use_original_steps:
        sqrt_a = schedule.sqrt_alphas_cumprod.astype(np.float32)[t_index]
        sqrt_1ma = schedule.sqrt_one_minus_alphas_cumprod.astype(np.float32)[t_index]
    else:
        _, alphas, _, _ = make_ddim_params(schedule, num_steps, eta=0.0)
        # f32 square roots of the f32 subset alphas, as the JAX package takes them
        sqrt_a = np.sqrt(alphas)[t_index]
        sqrt_1ma = np.sqrt(np.float32(1.0) - alphas)[t_index]
    if noise is None:
        if generator is None:
            raise ValueError("stochastic_encode: pass noise or a generator to draw it from")
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    return float(sqrt_a) * x0 + float(sqrt_1ma) * noise.to(x0)


def ddim_decode(eps_fn: EpsFn, x_latent: torch.Tensor, schedule: DiffusionSchedule,
                t_start: int, num_steps: int = 200) -> torch.Tensor:
    """Denoise a :func:`stochastic_encode`-d latent from DDIM-subset step
    ``t_start`` down to x_0: ``ddim_sample`` at eta 0 over the first
    ``t_start`` subset steps, descending, from ``x_latent``. Deterministic:
    it draws nothing, so it takes no generator and refuses a missing
    latent (JAX ``ddim.py:90``)."""
    if x_latent is None:
        raise ValueError("ddim_decode needs the encoded latent x_latent")
    return ddim_sample(eps_fn, x_latent.shape, schedule, num_steps=num_steps, eta=0.0,
                       x_T=x_latent, t_start=int(t_start), device=x_latent.device)
