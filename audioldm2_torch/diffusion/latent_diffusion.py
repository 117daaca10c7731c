"""Latent diffusion orchestration: conditioning -> sampler -> VAE ->
vocoder, and the VAE encode of the sr/inpainting path.

Port of ``audioldm2_tpu/diffusion/latent_diffusion.py``. Conditioning runs
once per call in float32; the UNet, VAE and vocoder weights are cast to the
config's compute dtype (bf16 for the shipped configs) as the JAX package's
cast_tree does, while the latents and the sampler math stay float32.
Cross-attention K/V, the fused self-attention QKV weights and, in the int8
serving mode, the quantized UNet weights are built once per call, outside
the step loop. The samplers are DDIM, PLMS and ancestral DDPM, each with the
inpainting mask blend; the VAE encoder runs on the uncast f32 weights.
``LatentDiffusionModel.edit`` is the audio-to-audio pair of
``ddim.stochastic_encode`` and ``ddim.ddim_decode`` on an encoded latent.
On a dp x tp mesh (``parallel.serve.ShardedGenerator``) each rank runs
``_generate_impl`` on its rows and its tp slices of the UNet and T5, with
the whole batch's draws (``ddim_draws``) cut to its rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from audioldm2_torch.config import ModelConfig
from audioldm2_torch.diffusion.schedule import DiffusionSchedule
from audioldm2_torch.diffusion import ddim, ddpm_ancestral, plms
from audioldm2_torch.models import conditioners, unet, vae, vocoder
from audioldm2_torch.ops.nn import full_f32
from audioldm2_torch.params import cast_floating
from audioldm2_torch.utils import profiling

SAMPLERS = ("ddim", "plms", "ddpm")


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x] * n, dim=0) if n > 1 else x


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def assemble_unet_inputs(outputs):
    """[(kind, value)] per conditioner -> (y, context_list, mask_list):
    "film" embeddings concatenate on the feature axis into the UNet's y,
    "crossattn" (ctx, mask) pairs fill the context slots in order."""
    y = None
    contexts, masks = [], []
    for kind, value in outputs:
        if kind == "film":
            emb = value[:, 0] if value.dim() == 3 else value  # [B, 1, D] -> [B, D]
            y = emb if y is None else torch.cat([y, emb], dim=-1)
        elif kind == "crossattn":
            contexts.append(value[0])
            masks.append(value[1])
        else:
            raise ValueError(f"unknown conditioning kind {kind!r}")
    return y, contexts, masks


def encode_conditioning(params, cfg: ModelConfig, batch, n_gen: int, guidance: float):
    """Encode every conditioner; returns ((y, contexts, masks), B * n_gen):
    the UNet inputs stacked (uncond || cond * n_gen) for a [2 * B * n_gen]
    CFG batch, or the cond inputs alone when guidance == 1."""
    with profiling.span("conditioning"):
        cond = [conditioners.encode(params["cond"][s.name], s, batch) for s in cfg.conditioners]
        kind, v = cond[0]
        bsz = (v[0] if kind == "crossattn" else v).shape[0] * n_gen

        def tile(kind, v):
            return (kind, (_tile(v[0], n_gen), _tile(v[1], n_gen)) if kind == "crossattn"
                    else _tile(v, n_gen))

        cond = [tile(*c) for c in cond]
        if guidance == 1.0:
            return assemble_unet_inputs(cond), bsz
        stacked = []
        for s, (kind, vc) in zip(cfg.conditioners, cond):
            kind_u, vu = conditioners.unconditional(params["cond"][s.name], s, batch, bsz)
            assert kind_u == kind
            if kind == "crossattn":
                stacked.append((kind, (torch.cat([vu[0], vc[0]]), torch.cat([vu[1], vc[1]]))))
            else:
                squeeze = (lambda e: e[:, 0] if e.dim() == 3 else e)  # noqa: E731
                stacked.append((kind, torch.cat([squeeze(vu), squeeze(vc)])))
        return assemble_unet_inputs(stacked), bsz


def served_unet(unet_p, cfg: ModelConfig):
    """The UNet tree a request runs, from the one cast to the compute
    dtype: the fused self-attention QKV, then (``weight_quant="int8"``) the
    int8 ST linears and ResBlock convs, whose scales come from the cast
    weights and stay f32. Under tp (inside
    ``parallel.collectives.tensor_parallel``, on the rank's slices) the
    int8 leaves are the whole weights' quantization cut to the rank's
    slices (``unet.quantize_st_linears``: one all-reduce a call)."""
    unet_p = unet.fuse_self_qkv(unet_p)
    if cfg.weight_quant == "int8":
        unet_p = unet.quantize_resblock_convs(unet.quantize_st_linears(unet_p))
    return unet_p


def prepare_unet(params, cfg: ModelConfig, contexts_c):
    """The per-call UNet transforms, in the JAX package's order: the cast
    to the compute dtype, the cross K/V, then :func:`served_unet`."""
    with profiling.span("prepare_unet"):
        unet_p = cast_floating(params["unet"], compute_dtype(cfg))
        cross_kv = unet.precompute_cross_kv(unet_p, cfg.unet, contexts_c)
        return served_unet(unet_p, cfg), cross_kv


def guided_eps_fn(params, cfg: ModelConfig, batch, n_gen: int, guidance: float):
    """The conditioning encoded once and the per-call UNet transforms done
    once; returns (eps_fn over a [B * n_gen] latent, B * n_gen). With
    guidance != 1 each eps call is one UNet forward over the stacked
    [2 * B * n_gen] CFG batch.

    Spans (``utils.profiling``): the encoding runs in a ``"conditioning"``
    span and the transforms in a ``"prepare_unet"`` one; each UNet call
    sits in a ``record_function("unet")`` range, inside the sampler's
    ``"sampler.step"`` range of its step. A trace reads the ranges (the
    benchmark's ``unet_roofline`` counts the ``"unet"`` ones, its
    ``step_idle_ms`` the device's idle time inside the steps); inside a
    request the spans' device times go to ``model.last_timings``
    (``conditioning_device_s``, ``prepare_unet_device_s``)."""
    (y, contexts, masks), bsz = encode_conditioning(params, cfg, batch, n_gen, guidance)
    return conditioned_eps_fn(params, cfg, y, contexts, masks, guidance), bsz


def conditioned_eps_fn(params, cfg: ModelConfig, y, contexts, masks, guidance: float):
    """eps_fn on given UNet inputs (``encode_conditioning``'s, stacked
    uncond || cond when ``guidance`` != 1), the per-call UNet transforms
    done once."""
    cdtype = compute_dtype(cfg)
    contexts_c = [c.to(cdtype) for c in contexts]
    y_c = y.to(cdtype) if y is not None else None
    unet_p, cross_kv = prepare_unet(params, cfg, contexts_c)

    def model_fn(x, t):
        with torch.profiler.record_function("unet"):
            eps = unet.apply_unet(unet_p, cfg.unet, x.to(cdtype), t, context_list=contexts_c,
                                  context_mask_list=masks, y=y_c, cross_kv=cross_kv)
        return eps.float()

    return ddim.cfg_eps_fn(model_fn, guidance) if guidance != 1.0 else model_fn


def decode_latent(params, cfg: ModelConfig, z: torch.Tensor):
    """x_0 latents (scale_factor * z) -> (waveform [B, N], mel [B, T, M, 1]),
    float32: the VAE decode and the vocoder in the compute dtype."""
    cdtype = compute_dtype(cfg)
    with profiling.span("vae.decode"):
        z = z / params["scale_factor"]
        mel = vae.decode(cast_floating(params["vae"], cdtype), cfg.vae, z.to(cdtype))
    with profiling.span("vocoder"):
        wav = vocoder.apply_vocoder(cast_floating(params["vocoder"], cdtype), cfg.vocoder,
                                    mel[..., 0])
        return wav.float(), mel.float()


def ddim_draws(schedule: DiffusionSchedule, shape, ddim_steps: int, ddim_eta: float,
               generator: torch.Generator, device):
    """(x_T, noise [ddim_steps, *shape]): the initial latent and the per-step
    DDIM noise drawn from ``generator`` in the order ``ddim.ddim_sample``
    draws them (x_T, then each step with sigma != 0 in loop order; zeros
    where sigma is 0). Generating on a mesh draws the whole batch's on
    every rank and gives each dp rank its rows, so the waveforms do not
    depend on dp, and at dp 1 they equal ``generate``'s for the same
    generator state."""
    from audioldm2_torch.diffusion.schedule import make_ddim_params

    sigmas = make_ddim_params(schedule, ddim_steps, ddim_eta)[3][::-1]
    x_T = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    noise = torch.stack([
        torch.randn(shape, generator=generator, device=device, dtype=torch.float32) if s != 0
        else torch.zeros(shape, device=device) for s in sigmas])
    return x_T, noise


def _generate_impl(params, batch, cfg: ModelConfig, schedule: DiffusionSchedule,
                   latent_t_size: int, n_gen: int, guidance: float, ddim_steps: int,
                   ddim_eta: float, generator: Optional[torch.Generator], use_mask: bool,
                   sampler: str, x_T: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   mask_noise: Optional[torch.Tensor] = None):
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} (ddim|plms|ddpm)")
    eps_fn, bsz = guided_eps_fn(params, cfg, batch, n_gen, guidance)
    device = params["scale_factor"].device
    shape = (bsz, latent_t_size, cfg.latent_f_size, cfg.latent_channels)
    inpaint = {}
    if use_mask:
        inpaint = dict(mask=_tile(batch["inpaint_mask"].float(), n_gen),
                       x0=_tile(batch["inpaint_x0"].float(), n_gen), mask_noise=mask_noise)
    common = dict(x_T=x_T, generator=generator, device=device, **inpaint)
    if sampler == "plms":
        z = plms.plms_sample(eps_fn, shape, schedule, num_steps=ddim_steps, **common)
    elif sampler == "ddpm":
        z = ddpm_ancestral.ddpm_sample(eps_fn, shape, schedule, noise=noise, **common)
    else:
        z = ddim.ddim_sample(eps_fn, shape, schedule, num_steps=ddim_steps, eta=ddim_eta,
                             noise=noise, **common)
    return decode_latent(params, cfg, z)


class LatentDiffusionModel:
    """Holds the config, the parameter tree and the diffusion schedule."""

    def __init__(self, cfg: ModelConfig, params: Dict):
        self.cfg = cfg
        self.params = params
        d = cfg.diffusion
        self.schedule = DiffusionSchedule.create(d.timesteps, d.beta_schedule,
                                                 d.linear_start, d.linear_end)

    @torch.inference_mode()
    def encode_mel(self, generator: Optional[torch.Generator], mel: torch.Tensor,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, T, M, 1] -> scale_factor * z, the posterior sample of the
        f32 VAE encoder (uncast weights, no TF32). ``noise`` fixes the
        posterior draw [B, T/f, M/f, embed_dim]; else it comes from
        ``generator``."""
        with profiling.span("vae.encode"), full_f32():
            mean, logvar = vae.encode_moments(self.params["vae"], self.cfg.vae, mel.float())
            z = vae.sample_posterior(mean, logvar, generator=generator, noise=noise)
            return self.params["scale_factor"] * z

    @torch.inference_mode()
    def generate(self, batch: Dict, generator: Optional[torch.Generator], latent_t_size: int,
                 n_gen: int = 1, guidance: float = 3.5, ddim_steps: int = 200,
                 ddim_eta: float = 1.0, use_mask: bool = False, sampler: str = "ddim",
                 x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 mask_noise: Optional[torch.Tensor] = None, use_ema: bool = False):
        """Returns (waveform [B*n_gen, N], mel [B*n_gen, T, M, 1]) as float32
        numpy arrays.

        ``sampler``: "ddim" (eta ``ddim_eta``), "plms" (``ddim_steps`` steps,
        eta 0) or "ddpm" (all schedule steps). ``use_mask``: blend
        ``batch["inpaint_x0"]`` where ``batch["inpaint_mask"]`` is 1 (both
        [B, T, F, *], tiled n_gen times). ``use_ema``: denoise with
        ``params["unet_ema"]``, which must be present. ``x_T`` fixes the
        initial latent [B*n_gen, T, F, C]; ``noise`` the per-step sampler
        noise and ``mask_noise`` the blend's q-sample noise (see the
        samplers)."""
        params = self.params
        if use_ema:
            if "unet_ema" not in params:
                raise ValueError("use_ema=True but the parameter tree has no 'unet_ema' "
                                 "(the checkpoint carried no model_ema.* shadow weights)")
            params = {**params, "unet": params["unet_ema"]}
        wav, mel = _generate_impl(params, batch, self.cfg, self.schedule, latent_t_size,
                                  n_gen, float(guidance), int(ddim_steps), float(ddim_eta),
                                  generator, bool(use_mask), str(sampler), x_T=x_T, noise=noise,
                                  mask_noise=mask_noise)
        with profiling.span("to_host"):
            return wav.cpu().numpy(), mel.cpu().numpy()

    @torch.inference_mode()
    def edit(self, batch: Dict, generator: Optional[torch.Generator], z0: torch.Tensor,
             t_enc: int, ddim_steps: int = 200, guidance: float = 3.5,
             noise: Optional[torch.Tensor] = None):
        """Audio-to-audio editing: diffuse the encoded latent ``z0`` [B, T,
        F, C] (``encode_mel``'s output) to DDIM-subset step ``t_enc`` of
        ``ddim_steps`` (``ddim.stochastic_encode``; ``noise`` injected or
        drawn from ``generator``), denoise it over the first ``t_enc``
        subset steps under ``batch``'s conditioning at ``guidance``
        (``ddim.ddim_decode``), then decode. Returns (waveform [B, N], mel
        [B, T, M, 1]) as float32 numpy arrays; ``t_enc`` UNet forwards."""
        z0 = z0.float()
        eps_fn, bsz = guided_eps_fn(self.params, self.cfg, batch, 1, float(guidance))
        if bsz != z0.shape[0]:
            raise ValueError(f"edit: the batch conditions {bsz} latents, z0 has {z0.shape[0]}")
        z_t = ddim.stochastic_encode(z0, t_enc, self.schedule, ddim_steps, noise=noise,
                                     generator=generator)
        z = ddim.ddim_decode(eps_fn, z_t, self.schedule, t_enc, ddim_steps)
        wav, mel = decode_latent(self.params, self.cfg, z)
        with profiling.span("to_host"):
            return wav.cpu().numpy(), mel.cpu().numpy()


def unet_forwards(cfg: ModelConfig, ddim_steps: int, sampler: str = "ddim") -> int:
    """UNet calls of one trajectory: one per DDIM step, one more for PLMS's
    first step, one per schedule step for DDPM."""
    if sampler == "plms":
        return ddim_steps + 1
    if sampler == "ddpm":
        return cfg.diffusion.timesteps
    return ddim_steps


def kernel_launches_per_generate(cfg: ModelConfig, ddim_steps: int, sampler: str = "ddim",
                                 encode: bool = False) -> Dict[str, int]:
    """Kernel launches of one generate call on CUDA: the sampler's UNet
    forwards (one batched CFG call each; int8 kernels in the int8 serving
    mode), one VAE decode (never quantized) and, with ``encode`` (the
    sr/inpainting path), one VAE encode. The conditioners run no kernel:
    T5, RoBERTa, BERT, BART, the CLIP transformer and GPT-2 attention is
    masked (and T5's biased), HTSAT's biased, AudioMAE's goes to
    ``scaled_dot_product_attention``, and their matmuls and convs are plain
    f32 products."""
    per_step = unet.kernel_launches_per_forward(cfg.unet, cfg.weight_quant)
    n = unet_forwards(cfg, ddim_steps, sampler)
    dec = vae.kernel_launches_per_decode(cfg.vae)
    enc = vae.kernel_launches_per_encode(cfg.vae) if encode else dict.fromkeys(per_step, 0)
    return {k: n * per_step[k] + dec[k] + enc[k] for k in per_step}
