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

On a dp x tp mesh (``parallel.mesh``), ``make_train_step(..., mesh=)``
is JAX's sharded step with the collectives written out: each rank holds its
tp slices of the UNet (``mesh.shard_params``) and its dp rows of the batch,
the forward and backward run under ``collectives.tensor_parallel`` (whose
"f" and "g" keep the gradients of the replicated leaves whole on every tp
rank), and the gradients are averaged over dp before the optimizer step.
:func:`dryrun` runs one such step on a tiny UNet in ``n`` ranks and holds
it against the single-process step.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from audioldm2_torch.config import ModelConfig, UNetConfig
from audioldm2_torch.diffusion.schedule import DiffusionSchedule
from audioldm2_torch.models import unet as unet_m
from audioldm2_torch.ops.nn import full_f32
from audioldm2_torch.parallel import collectives
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


def _minimize(opt_state: torch.optim.Optimizer, loss_fn, mesh=None):
    """One optimizer step on loss_fn(): forward and backward in full f32.
    On a ``mesh`` the forward and backward run on its tp slices, and the
    gradients and the returned loss are averaged over dp."""
    opt_state.zero_grad(set_to_none=True)
    with full_f32(), collectives.tensor_parallel(mesh):
        loss = loss_fn()
        loss.backward()
    loss = loss.detach()
    if mesh is not None and mesh.dp > 1:
        grads = [p.grad for group in opt_state.param_groups for p in group["params"]]
        collectives.mean_over_dp(grads + [loss], mesh)
    opt_state.step()
    return loss


def make_train_step(cfg: UNetConfig, schedule: DiffusionSchedule, optimizer: AdamW,
                    mesh=None):
    """step(params, opt_state, batch, generator=None, *, t=None, noise=None)
    -> (params, opt_state, loss), with opt_state = optimizer.init(params).
    On a ``mesh``: params are the rank's slices (``mesh.shard_params(...,
    prefix=("unet",))``), batch, t and noise its dp rows, and the loss the
    mean over dp."""
    consts = {}

    def train_step(params, opt_state, batch, generator=None, *, t=None, noise=None):
        dev = batch["latent"].device
        if dev not in consts:
            consts[dev] = schedule_consts(schedule, dev)
        loss = _minimize(opt_state, lambda: diffusion_loss(params, cfg, consts[dev], batch,
                                                           generator, t=t, noise=noise), mesh)
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
        (y, contexts, masks), _ = encode_conditioning(params, cfg, batch, 1, 1.0)
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


# ---------------------------------------------------------------------------
# The sharded dry run (JAX train.py:66-110)
# ---------------------------------------------------------------------------

DRYRUN_TOL = 1e-5  # loss (absolute) and every updated leaf (relative, in norm)
# Adam divides each gradient element by its magnitude plus eps, so at
# optax's eps 1e-8 its first step is lr * sign(g). The biases and the time
# embedding's projections that feed a GroupNorm have an exact gradient of
# zero and a computed one of rounding noise (1e-11), whose signs no two
# summation orders share; the dry run steps at eps 1e-3, as the train
# tests hold the step to optax's (an element's step is then about
# lr * g / 1e-3, continuous in g).
DRYRUN_ADAM_EPS = 1e-3


def dryrun_unet_config() -> UNetConfig:
    """JAX's dry-run UNet: ch 32, mult (1, 2), one attention level, heads of
    16, a 32-wide context."""
    return UNetConfig(in_channels=4, out_channels=4, model_channels=32, num_res_blocks=1,
                      attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16,
                      context_dims=(32,))


def dryrun_step(mesh) -> dict:
    """One sharded AdamW step (lr 1e-4, eps DRYRUN_ADAM_EPS) of the dry-run UNet on this rank's
    mesh: weights drawn from seed 0 (every leaf non-zero), a global batch
    of 2 * dp latents [16, 8, 4] with a 6-token context and the step's t
    and noise drawn from seed 1, each rank's dp rows of them. Rank 0 also
    takes the single-process step on the whole batch and draws; every rank
    gathers the updated slices, and the record holds the loss of both and
    the worst leaf's relative difference (rank 0's)."""
    from audioldm2_torch.parallel import mesh as mesh_lib
    from audioldm2_torch.params import Init

    dev = mesh.device
    cfg = dryrun_unet_config()
    schedule = DiffusionSchedule.create()
    optimizer = AdamW(1e-4, eps=DRYRUN_ADAM_EPS)
    whole = unet_m.init_unet(Init(torch.Generator(device=dev).manual_seed(0), dev, nonzero=True),
                             cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    b = 2 * mesh.dp
    batch = {"latent": torch.randn((b, 16, 8, 4), generator=g, device=dev),
             "context": torch.randn((b, 6, 32), generator=g, device=dev),
             "context_mask": torch.ones((b, 6), device=dev)}
    t = torch.randint(0, schedule.num_timesteps, (b,), generator=g, device=dev)
    noise = torch.randn((b, 16, 8, 4), generator=g, device=dev)

    params = map_tree(lambda x: x.detach().clone(),
                      mesh_lib.shard_params(whole, mesh, prefix=("unet",)))
    opt_state = optimizer.init(params)
    rows = {k: mesh_lib.batch_sharding(mesh, v) for k, v in batch.items()}
    step = make_train_step(cfg, schedule, optimizer, mesh=mesh)
    params, _, loss = step(params, opt_state, rows, t=mesh_lib.batch_sharding(mesh, t),
                           noise=mesh_lib.batch_sharding(mesh, noise))
    got = mesh_lib.gather_params(map_tree(lambda x: x.detach(), params), mesh, prefix=("unet",))
    out = {"rank": mesh.rank, "mesh": (mesh.dp, mesh.tp), "loss": float(loss),
           "n_sharded": mesh_lib.sharded_leaf_count({"unet": whole})}
    if mesh.rank == 0:
        ref = map_tree(lambda x: x.detach().clone(), whole)
        ref_state = optimizer.init(ref)
        ref, _, ref_loss = make_train_step(cfg, schedule, optimizer)(ref, ref_state, batch, t=t,
                                                                     noise=noise)
        worst, where = 0.0, None
        flat_ref = dict(mesh_lib.leaves_with_paths(ref))
        for path, leaf in mesh_lib.leaves_with_paths(got):
            want = flat_ref[path].detach()
            rel = float((leaf - want).norm() / want.norm().clamp_min(1e-30))
            if rel > worst:
                worst, where = rel, ".".join(map(str, path))
        out.update(ref_loss=float(ref_loss), leaf_rel=worst, worst_leaf=where,
                   n_leaves=len(flat_ref))
    return out


def _dryrun_rank(rank: int, world: int, tps, device, backend: str):
    from audioldm2_torch.parallel.mesh import make_mesh

    return [dryrun_step(make_mesh(world, tp=tp, backend=backend, device=device)) for tp in tps]


def dryrun(n_devices: int, tp=None, *, device: Optional[str] = None,
           backend: Optional[str] = None, timeout: float = 600.0) -> list:
    """``n_devices`` ranks (``parallel.launch.spawn``), one sharded AdamW
    step of the dry-run UNet on the dp x tp mesh (``tp``: 2 when n is even,
    as JAX's; or a sequence of tp values, each layout run in turn in the
    same ranks), at batch 2 * dp, the tp collectives autograd-aware and the
    gradients averaged over dp. Asserts what JAX's asserts (a finite loss)
    and more: the loss within DRYRUN_TOL of the single-process step on the
    same global batch and draws, and every updated leaf within DRYRUN_TOL
    relative (in norm). ``device``: "cuda" (default) or "cpu"; ``backend``:
    "nccl" on cards, "gloo" on the CPU by default. Returns rank 0's record
    of each layout."""
    from audioldm2_torch.parallel import launch

    if tp is None:
        tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    tps = (tp,) if isinstance(tp, int) else tuple(tp)
    device = device or "cuda"
    backend = backend or ("nccl" if device.startswith("cuda") else "gloo")
    ranks = launch.spawn(_dryrun_rank, n_devices, (tps, device, backend), backend=backend,
                         timeout=timeout)
    records = ranks[0]
    for i, rec in enumerate(records):
        losses = [r[i]["loss"] for r in ranks]
        assert np.isfinite(rec["loss"]), rec
        assert max(losses) == min(losses), f"the ranks' losses differ: {losses}"
        assert rec["mesh"][1] == 1 or rec["n_sharded"] > 0, rec
        assert abs(rec["loss"] - rec["ref_loss"]) <= DRYRUN_TOL, rec
        assert rec["leaf_rel"] <= DRYRUN_TOL, rec
        print(f"dryrun ok: mesh {rec['mesh']} (dp x tp), one train step, loss={rec['loss']:.6f} "
              f"(single process {rec['ref_loss']:.6f}), worst leaf {rec['worst_leaf']} "
              f"{rec['leaf_rel']:.2e} relative")
    return records
