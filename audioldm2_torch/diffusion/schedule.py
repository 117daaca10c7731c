"""Diffusion schedules (host-side numpy float64 -> device constants).

The port's own copy of ``audioldm2_tpu/diffusion/schedule.py`` (a test holds
its arrays equal to the JAX package's).

Reproduces the reference's schedule math exactly (reference
``latent_diffusion/modules/diffusionmodules/util.py:20-95`` and
``models/ddpm.py:201-303``): the beta schedule is linear in sqrt-space and
computed in float64, DDIM timesteps are the uniform subset shifted by +1,
and DDIM sigmas follow Song et al. (2020) eq. 16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed DDPM quantities, float32 numpy (device-constant-ready)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    # posterior q(x_{t-1} | x_t, x_0) for ancestral sampling
    # (reference ddpm.py:259-303; v_posterior = 0)
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    posterior_log_variance_clipped: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @staticmethod
    def create(
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 0.0015,
        linear_end: float = 0.0195,
    ) -> "DiffusionSchedule":
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start, linear_end)
        alphas = 1.0 - betas
        acum = np.cumprod(alphas)
        acum_prev = np.append(1.0, acum[:-1])
        posterior_variance = betas * (1.0 - acum_prev) / (1.0 - acum)
        return DiffusionSchedule(
            betas=betas.astype(np.float32),
            alphas_cumprod=acum.astype(np.float32),
            alphas_cumprod_prev=acum_prev.astype(np.float32),
            sqrt_alphas_cumprod=np.sqrt(acum).astype(np.float32),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acum).astype(np.float32),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acum).astype(np.float32),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acum - 1.0).astype(np.float32),
            posterior_mean_coef1=(
                betas * np.sqrt(acum_prev) / (1.0 - acum)
            ).astype(np.float32),
            posterior_mean_coef2=(
                (1.0 - acum_prev) * np.sqrt(alphas) / (1.0 - acum)
            ).astype(np.float32),
            posterior_log_variance_clipped=np.log(
                np.maximum(posterior_variance, 1e-20)
            ).astype(np.float32),
        )


def make_ddim_timesteps(num_ddim_steps: int, num_ddpm_steps: int) -> np.ndarray:
    """Uniform subset with the +1 shift (reference util.py:55-75).

    num_ddim_steps must divide num_ddpm_steps: for non-divisors the uniform
    range yields an extra step whose +1 shift indexes past the schedule (the
    reference crashes with the same inputs, just less legibly)."""
    if num_ddim_steps < 1 or num_ddpm_steps % num_ddim_steps != 0:
        raise ValueError(
            f"ddim_steps={num_ddim_steps} must evenly divide the DDPM "
            f"schedule length {num_ddpm_steps} (e.g. 10/20/50/100/200/500)"
        )
    c = num_ddpm_steps // num_ddim_steps
    steps = np.asarray(list(range(0, num_ddpm_steps, c)))
    return steps + 1


def make_ddim_params(
    schedule: DiffusionSchedule, num_ddim_steps: int, eta: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (timesteps, alphas, alphas_prev, sigmas), each [S]
    (reference util.py:78-95; ddim.py:33-91)."""
    ts = make_ddim_timesteps(num_ddim_steps, schedule.num_timesteps)
    acum = schedule.alphas_cumprod.astype(np.float64)
    alphas = acum[ts]
    alphas_prev = np.concatenate([[acum[0]], acum[ts[:-1]]])
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
    )
    return (
        ts.astype(np.int32),
        alphas.astype(np.float32),
        alphas_prev.astype(np.float32),
        sigmas.astype(np.float32),
    )
