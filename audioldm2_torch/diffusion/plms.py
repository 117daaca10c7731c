"""PLMS (pseudo linear multi-step) sampler, in PyTorch.

Port of ``audioldm2_tpu/diffusion/plms.py:25-102``: eta 0 DDIM rows from
``schedule.make_ddim_params``, walked in descending t. The first step
evaluates eps twice (pseudo improved Euler: again at the DDIM update's x
and t_next), so ``num_steps`` steps make ``num_steps + 1`` model calls;
later steps combine the new eps with the last one to three (Adams-Bashforth
orders 2-4). The inpainting blend comes before the model call, as in DDIM.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from audioldm2_torch.diffusion.schedule import DiffusionSchedule, make_ddim_params
from audioldm2_torch.diffusion.ddim import EpsFn, MaskBlend, check_steps, initial_latent


def plms_sample(
    eps_fn: EpsFn,
    shape,
    schedule: DiffusionSchedule,
    num_steps: int = 200,
    x_T: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device="cpu",
    mask_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the PLMS trajectory in float32; returns x_0 latents [B, ...].

    mask: [B, T, F, 1], 1 = keep the q-sampled x0. mask_noise: optional
    [num_steps, *x0.shape] q-sample noise of the blend in loop order, drawn
    from ``generator`` when None."""
    ts, alphas, alphas_prev, _ = make_ddim_params(schedule, num_steps, eta=0.0)
    ts, alphas, alphas_prev = ts[::-1], alphas[::-1], alphas_prev[::-1]
    ts_next = np.concatenate([ts[1:], np.zeros(1, np.int32)])
    check_steps(len(ts), mask_noise=mask_noise)

    img = initial_latent(shape, x_T, generator, device)
    blend = MaskBlend(schedule, mask, x0, mask_noise, generator, img.device)
    b = img.shape[0]
    one = np.float32(1.0)

    def x_prev(x, e, a_t, a_prev):
        pred_x0 = (x - float(np.sqrt(one - a_t)) * e) / float(np.sqrt(a_t))
        dir_coef = np.sqrt(np.maximum(one - a_prev, np.float32(0.0)))
        return float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e

    old_eps = []  # the last three eps, oldest first
    for i, (t, t_next, a_t, a_prev) in enumerate(zip(ts, ts_next, alphas, alphas_prev)):
        img = blend(img, int(t), i)
        e_t = eps_fn(img, torch.full((b,), int(t), dtype=torch.int32, device=img.device))
        if i == 0:
            e_next = eps_fn(x_prev(img, e_t, a_t, a_prev),
                            torch.full((b,), int(t_next), dtype=torch.int32, device=img.device))
            e_prime = (e_t + e_next) / 2.0
        elif i == 1:
            e_prime = (3.0 * e_t - old_eps[-1]) / 2.0
        elif i == 2:
            e_prime = (23.0 * e_t - 16.0 * old_eps[-1] + 5.0 * old_eps[-2]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * old_eps[-1] + 37.0 * old_eps[-2]
                       - 9.0 * old_eps[-3]) / 24.0
        img = x_prev(img, e_prime, a_t, a_prev)
        old_eps = (old_eps + [e_t])[-3:]
    return img
