"""Batch serving over a dp x tp mesh: one process per rank.

Port of ``audioldm2_tpu/parallel/serve.py``. A batch of prompts times
candidates splits over ``dp``: each dp rank generates its rows of the
``len(texts) * n_gen`` waveforms, with the CFG stacking (uncond || cond)
inside the rank, and the waveforms are gathered over dp so that every rank
returns all of them. ``tp > 1`` also splits the UNet's and the FLAN-T5
encoder's attention and FF weights Megatron-style (``parallel.mesh``), so
one prompt's UNet step spreads over tp ranks. In the int8 serving mode
(``weight_quant="int8"``) each rank quantizes its slices once a call as the
whole weights' quantization would cut them, as JAX quantizes the global
arrays inside its jitted generate: int8 column slices with their scales
(the fused QKV, attn2's to_q, the GEGLU proj_in: K3q at N / tp), int8 row
slices with the whole weight's scales (to_out: K5, the FF's proj_out: K4q,
each in its f32 mode, summed over tp and rounded once), the ResBlock convs
whole (K1q).

The initial latent and the per-step noise do not depend on dp: every rank
draws the whole batch's from the same seed, as JAX draws one global x_T and
shards it, and keeps its rows (``latent_diffusion.ddim_draws``). The
sharded waveforms are then the unsharded ones for that seed, and on a
one-rank mesh they are ``model.ldm.generate``'s for the same generator.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from audioldm2_torch.parallel import collectives
from audioldm2_torch.parallel.mesh import Mesh, make_mesh, shard_params, sharded_leaf_count


class ShardedGenerator:
    """Wraps an AudioLDM2 model (``pipeline.build_model``; its weights on
    the rank's device) for dp (x tp) batch serving on this rank's mesh."""

    def __init__(self, model, mesh: Optional[Mesh] = None, tp: Optional[int] = None):
        self.model = model
        self.mesh = mesh or make_mesh(tp=tp or 1, device=model.device)
        self.dp, self.tp = self.mesh.dp, self.mesh.tp
        if self.tp > 1:
            self.n_sharded = sharded_leaf_count(model.ldm.params)
            if self.n_sharded == 0:
                # The rules match by key name; a rename would silently run
                # tp > 1 replicated. Fail loudly.
                raise RuntimeError(
                    "tp>1 requested but the sharding rules (parallel/mesh.param_spec) matched "
                    "0 tensors — the param-tree key names drifted from the spec table")
            self.params = shard_params(model.ldm.params, self.mesh)
        else:
            self.n_sharded = 0
            self.params = model.ldm.params

    def _batch(self, texts):
        """make_batch per prompt, concatenated (the ``*uncond*`` entries
        once), as JAX's generate builds it."""
        parts = [self.model.make_batch(text, batchsize=1) for text in texts]
        return {k: parts[0][k] if "uncond" in k else torch.cat([p[k] for p in parts])
                for k in parts[0]}

    @torch.inference_mode()
    def generate(self, texts, key, duration: float = 10.0, n_gen: int = 1,
                 guidance: float = 3.5, ddim_steps: int = 200,
                 x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """texts: list of prompts; ``key``: the seed (or a torch.Generator
        seeded alike on every rank) of the whole batch's x_T and per-step
        noise, which ``x_T`` [len(texts) * n_gen, T, F, C] and ``noise``
        [ddim_steps, *x_T.shape] replace where given. DDIM at eta 1.
        Returns the waveform [len(texts) * n_gen, N] (float32 numpy) on
        every rank."""
        from audioldm2_torch.diffusion import latent_diffusion as ld

        b = len(texts)
        assert (b * n_gen) % self.dp == 0, (
            f"batch*n_gen ({b * n_gen}) must divide over dp={self.dp}")
        model, mesh = self.model, self.mesh
        cfg, ldm = model.cfg, model.ldm
        dev = model.device
        latent_t = int(duration * cfg.latent_t_per_second)
        shape = (b * n_gen, latent_t, cfg.latent_f_size, cfg.latent_channels)
        if x_T is None or noise is None:
            gen = key if isinstance(key, torch.Generator) else (
                torch.Generator(device=dev).manual_seed(int(key)))
            drawn_x, drawn_noise = ld.ddim_draws(ldm.schedule, shape, int(ddim_steps), 1.0, gen,
                                                 dev)
            x_T = drawn_x if x_T is None else x_T
            noise = drawn_noise if noise is None else noise
        rows = b * n_gen // self.dp
        lo = mesh.dp_rank * rows
        if self.dp == 1:  # the request as it is: n_gen candidates of each prompt
            batch, local_n = self._batch(texts), n_gen
        else:  # row j of the tiled batch is prompt j % b
            batch, local_n = self._batch([texts[j % b] for j in range(lo, lo + rows)]), 1
        x_local = x_T[lo:lo + rows].to(dev)
        noise_local = noise[:, lo:lo + rows].to(dev)
        with collectives.tensor_parallel(mesh):
            wav, _ = ld._generate_impl(self.params, batch, cfg, ldm.schedule, latent_t, local_n,
                                       float(guidance), int(ddim_steps), 1.0, None, False,
                                       "ddim", x_T=x_local, noise=noise_local)
        return collectives.all_gather_dp(wav, mesh).cpu().numpy()


def _dryrun_rank(rank: int, world: int, ddim_steps: int, duration: float, device,
                 backend: str, check, cfg) -> dict:
    """One rank of :func:`dryrun_infer`: the t5 family at full width (or
    ``cfg``) drawn from seed 0 with every leaf non-zero (the same weights
    on every rank), sharded, one generate."""
    from audioldm2_torch import ops
    from audioldm2_torch.config import default_audioldm_config
    from audioldm2_torch.pipeline import build_model

    mesh = make_mesh(world, backend=backend, device=device)  # tp 2 when world is even
    cfg = cfg or default_audioldm_config("audioldm_16k_crossattn_t5")
    t0 = time.perf_counter()
    model = build_model(config=cfg, device=mesh.device, seed=0, nonzero_init=True)
    gen = ShardedGenerator(model, mesh=mesh)
    build_s = time.perf_counter() - t0
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    wav = gen.generate(["a dog barking"] * gen.dp, 1, duration=duration, n_gen=1,
                       ddim_steps=ddim_steps)
    sync()
    wall = time.perf_counter() - t0
    out = {"rank": rank, "mesh": (gen.dp, gen.tp), "n_sharded": gen.n_sharded,
           "launches": ops.launch_counts(), "wall_s": wall, "build_s": build_s,
           "wav_shape": tuple(wav.shape), "finite": bool(np.isfinite(wav).all()),
           "latent_t": int(duration * cfg.latent_t_per_second),
           "n_samples": int(duration * cfg.preprocessing.sampling_rate)}
    if mesh.device.type == "cuda":
        out["max_memory_gib"] = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30
    if check is not None:
        out["check"] = check(gen, mesh)
    return out


def dryrun_infer(n_devices: int, ddim_steps: int = 2, duration: float = 1.25, *,
                 device: Optional[str] = None, backend: Optional[str] = None, check=None,
                 cfg=None, timeout: float = 900.0):
    """Production-geometry sharded inference dry run: ``n_devices`` ranks
    (``parallel.launch.spawn``) each build the t5 family at full width (UNet
    ch 128 mult (1, 2, 3, 5), FLAN-T5-large, the full VAE and vocoder),
    shard it dp x tp (tp 2 when n is even, as JAX's) and run one short
    generate end to end (conditioning, CFG DDIM, VAE decode, vocoder).
    Asserts the tp rules split a nonzero number of tensors, that every rank
    returns one waveform per dp rank, at least ``duration`` long, and
    finite. ``device``: "cuda" (the default; rank r on card r % count) or
    "cpu"; ``backend``: "nccl" on cards, "gloo" on the CPU by default
    (ranks sharing a card need "gloo"). ``check(gen, mesh)``, a picklable
    function, runs in every rank after the generate; its results come back
    under "check". Returns each rank's record (its launches, wall, device
    memory). ``cfg`` replaces the t5 family's config (a rehearsal's tiny
    one)."""
    from audioldm2_torch.parallel import launch

    device = device or "cuda"
    backend = backend or ("nccl" if device.startswith("cuda") else "gloo")
    records = launch.spawn(_dryrun_rank, n_devices,
                           (ddim_steps, duration, device, backend, check, cfg),
                           backend=backend, timeout=timeout)
    for r in records:
        dp, tp_ = r["mesh"]
        assert tp_ == 1 or r["n_sharded"] > 0, r
        assert r["wav_shape"][0] == dp and r["wav_shape"][1] >= r["n_samples"], r
        assert r["finite"], r
    r = records[0]
    print(f"infer dryrun ok: mesh {r['mesh']} (dp x tp), {r['n_sharded']} tp-sharded params, "
          f"{'flagship geometry (ch128, T5-large, ' if cfg is None else 'the given config ('}"
          f"latent_T={r['latent_t']}), {ddim_steps}-step CFG DDIM -> VAE -> vocoder, wav "
          f"{r['wav_shape']}")
    return records
