"""The latent-diffusion training step, the CLAP contrastive loss, and the
AdamW optimizer they are paired with.

Port of ``audioldm2_tpu/parallel/train.py`` (the reference's eps-prediction
loss, ``ddpm.py:1044-1076``) on one device: ``diffusion_loss`` and
``make_train_step`` for a UNet on given latents; ``full_diffusion_loss``
and ``make_full_train_step`` for the whole path (mel -> f32 VAE posterior
-> conditioning -> eps MSE), computed in the f32 of the parameter tree as
the JAX package computes it (no cast to the compute dtype, no int8, TF32
off). Inside the loss the self-attention QKV weights are fused
(``unet.fuse_self_qkv``, a differentiable concat), so on the card the step
runs K1 (f32, 3xTF32), K2, K3, K4 and K6 under autograd
(``ops.autograd``); the cross K/V are built from the context inside the
graph.

Random draws come from an explicit ``torch.Generator``: the posterior
noise, then t, then the eps noise. Each can be passed instead (``t=``,
``noise=``, ``posterior_noise=``), which the parity tests do with JAX's
own draws.

The optimizer state is a ``torch.optim.AdamW`` over the trained leaves,
made by :meth:`AdamW.init` with optax.adamw's defaults. A step keeps the
JAX signature ``step(params, opt_state, batch, ...) -> (params, opt_state,
loss)``, but updates the leaves of ``params`` in place and returns the
same tree and optimizer.

The dp x tp shardings of the JAX package (``parallel/mesh.py``,
``train.dryrun``) are not ported.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from audioldm2_torch.config import ModelConfig, UNetConfig
from audioldm2_torch.diffusion.schedule import DiffusionSchedule
from audioldm2_torch.models import unet as unet_m
from audioldm2_torch.ops.nn import full_f32
from audioldm2_torch.params import map_tree


@dataclass(frozen=True)
class AdamW:
    """optax.adamw's hyper-parameters and defaults (weight decay 1e-4, not
    torch's 1e-2). torch's AdamW decays the parameter by lr * wd before
    its Adam step, which is optax's update."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> torch.optim.AdamW:
        """The optimizer over the floating leaves of ``params``, which are
        marked to require grad."""
        leaves = []
        map_tree(leaves.append, params)
        leaves = [t.requires_grad_(True) for t in leaves if t.is_floating_point()]
        return torch.optim.AdamW(leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
                                 eps=self.eps, weight_decay=self.weight_decay)


def schedule_consts(schedule: DiffusionSchedule, device) -> Dict:
    return {
        "num_timesteps": schedule.num_timesteps,
        "sqrt_alphas_cumprod": torch.from_numpy(schedule.sqrt_alphas_cumprod).to(device),
        "sqrt_one_minus_alphas_cumprod": torch.from_numpy(
            schedule.sqrt_one_minus_alphas_cumprod).to(device),
    }


def _noised(consts, x0, generator, t, noise):
    """(t, eps noise, x_t): t and the noise drawn from ``generator`` unless
    given."""
    b = x0.shape[0]
    if t is None:
        t = torch.randint(0, consts["num_timesteps"], (b,), generator=generator,
                          device=x0.device)
    t = torch.as_tensor(t, device=x0.device).long()
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    noise = torch.as_tensor(noise, device=x0.device, dtype=x0.dtype)
    a = consts["sqrt_alphas_cumprod"][t][:, None, None, None]
    s = consts["sqrt_one_minus_alphas_cumprod"][t][:, None, None, None]
    return t, noise, a * x0 + s * noise


def diffusion_loss(params, cfg: UNetConfig, schedule_consts, batch, generator=None, *,
                   t=None, noise=None):
    """eps-parameterization MSE on batch["latent"] [B, T, F, C] with the
    optional batch["context"] and batch["context_mask"] (reference
    ddpm.py:1044-1076)."""
    x0 = batch["latent"]
    ctx, mask = batch.get("context"), batch.get("context_mask")
    t, noise, x_noisy = _noised(schedule_consts, x0, generator, t, noise)
    eps = unet_m.apply_unet(unet_m.fuse_self_qkv(params), cfg, x_noisy, t,
                            [ctx] if ctx is not None else [],
                            [mask] if mask is not None else [])
    return torch.mean(torch.square(eps - noise))


def _minimize(opt_state: torch.optim.Optimizer, loss_fn):
    """One optimizer step on loss_fn(): forward and backward in full f32."""
    opt_state.zero_grad(set_to_none=True)
    with full_f32():
        loss = loss_fn()
        loss.backward()
    opt_state.step()
    return loss.detach()


def make_train_step(cfg: UNetConfig, schedule: DiffusionSchedule, optimizer: AdamW):
    """step(params, opt_state, batch, generator=None, *, t=None, noise=None)
    -> (params, opt_state, loss), with opt_state = optimizer.init(params)."""
    consts = {}

    def train_step(params, opt_state, batch, generator=None, *, t=None, noise=None):
        dev = batch["latent"].device
        if dev not in consts:
            consts[dev] = schedule_consts(schedule, dev)
        loss = _minimize(opt_state, lambda: diffusion_loss(params, cfg, consts[dev], batch,
                                                           generator, t=t, noise=noise))
        return params, opt_state, loss

    return train_step


def _batch_on_device(batch, device) -> Dict:
    """The batch's arrays (numpy, as the dataset makes them, or tensors)
    as tensors on ``device``; other entries (the texts) as they are."""
    return {k: torch.as_tensor(v, device=device) if isinstance(v, (np.ndarray, torch.Tensor))
            else v for k, v in batch.items()}


def full_diffusion_loss(params, cfg: ModelConfig, schedule_consts, batch, generator=None, *,
                        t=None, noise=None, posterior_noise=None, train_unet_only: bool = False):
    """batch: the mel "fbank" [B, T, M, 1] and the tokenized conditioner
    arrays (``utils.data.AudioDataset`` or ``AudioLDM2.make_batch``).
    ``train_unet_only`` runs the VAE encode and the conditioning under
    torch.no_grad()."""
    from audioldm2_torch.diffusion.latent_diffusion import encode_conditioning
    from audioldm2_torch.models import vae as vae_m

    batch = _batch_on_device(batch, params["scale_factor"].device)
    with torch.no_grad() if train_unet_only else contextlib.nullcontext():
        mean, logvar = vae_m.encode_moments(params["vae"], cfg.vae, batch["fbank"].float())
        z = vae_m.sample_posterior(mean, logvar, generator=generator, noise=posterior_noise)
        (y, contexts, masks), _, _ = encode_conditioning(params, cfg, batch, 1, 1.0)
    x0 = params["scale_factor"] * z
    t, noise, x_noisy = _noised(schedule_consts, x0, generator, t, noise)
    eps = unet_m.apply_unet(unet_m.fuse_self_qkv(params["unet"]), cfg.unet, x_noisy, t,
                            contexts, masks, y=y)
    return torch.mean(torch.square(eps - noise))


def make_full_train_step(cfg: ModelConfig, optimizer: AdamW, train_unet_only: bool = True):
    """step(params, opt_state, batch, generator=None, *, t=None, noise=None,
    posterior_noise=None) -> (params, opt_state, loss). With
    ``train_unet_only`` (the reference freezes the first stage and the
    conditioners, ddpm.py:766-771) opt_state = optimizer.init(params["unet"]),
    else optimizer.init(params)."""
    d = cfg.diffusion
    schedule = DiffusionSchedule.create(d.timesteps, d.beta_schedule, d.linear_start,
                                        d.linear_end)
    consts = {}

    def train_step(params, opt_state, batch, generator=None, *, t=None, noise=None,
                   posterior_noise=None):
        dev = params["scale_factor"].device
        if dev not in consts:
            consts[dev] = schedule_consts(schedule, dev)
        loss = _minimize(opt_state, lambda: full_diffusion_loss(
            params, cfg, consts[dev], batch, generator, t=t, noise=noise,
            posterior_noise=posterior_noise, train_unet_only=train_unet_only))
        return params, opt_state, loss

    return train_step


def clap_contrastive_loss(audio_emb: torch.Tensor, text_emb: torch.Tensor, logit_scale,
                          group=None) -> torch.Tensor:
    """audio_emb, text_emb: [B_local, D], L2-normalized; returns the
    symmetric cross-entropy of the [B, B] similarities (reference
    clap/open_clip/loss.py:9-121). With a process ``group`` the embeddings
    are all-gathered with gradients (``torch.distributed.nn``), so every
    rank computes the full [B_global, B_global] loss, as the reference's
    gather_features with local_loss=False; the gather's backward sums the
    ranks' gradients, which data-parallel training then averages."""
    if group is not None:
        from torch.distributed.nn.functional import all_gather

        audio_emb = torch.cat(all_gather(audio_emb, group=group))
        text_emb = torch.cat(all_gather(text_emb, group=group))
    logits = logit_scale * audio_emb @ text_emb.t()
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2.0
