"""The check of ``correct``: what the timed path produced, against the plain
reference at the timed sizes.

For a request the window finished (:class:`a2bench.program.Capture`) and
rows of its batch drawn from the run's seed, each number compares one
stage's output with the reference's:

- ``cond_rel``: the UNet's conditioning (FLAN-T5 and the GPT-2 sequence
  generator's tokens on audioldm2-full, the CLAP text embedding as FiLM on
  audioldm_48k; on a speech configuration the GPT-2 tokens generated from
  CLAP and the phoneme encoder of the transcription), every row of the
  uncond || cond stack, against the reference's encoding of the caption
  and transcription: the widest relative L2 gap over the tensors; a mask
  that differs reads inf;
- ``latent_rel``: the sampled rows' latents after the CFG DDIM loop,
  against the reference's own float32 loop from its own conditioning and
  the same draws (x_T and each step's noise from a generator seeded with
  the request's seed, in the program's order): the relative L2 gap;
- ``mel_rms``: the VAE's log-mel of every row against the reference's
  decode of the program's latents, the RMS of the difference;
- ``wav_rms``: the vocoder's waveforms of every row against the reference's
  vocoder on the program's mel, the RMS of the difference (full scale 1);
- with candidates to rerank, ``sim_abs``: the widest gap between the
  program's similarities and the reference's CLAP on the program's
  candidates, and ``pick_mismatch``: prompts whose kept candidate is not
  the reference's pick, where the reference's best leads the kept one by
  more than the ``sim_abs`` limit;
- ``returned_mismatch``: returned clips that are not, bit for bit, the
  decoded candidate they stand for.

The reference reads the program's latents, mel and candidates only to
judge the stage after them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from a2bench import weights, work
from a2bench.reference import conditioning, generator, nn, rerank
from a2bench.reference.config import ModelConfig

def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double().expand_as(a)
    den = torch.linalg.vector_norm(b).item()
    num = torch.linalg.vector_norm(a - b).item()
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def rms_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The RMS of a - b, in float64."""
    return (a.double() - b.double()).square().mean().sqrt().item()



class Reference:
    """The reference on the benchmark's weights: float32 copies of the
    subtrees it reads, made when first needed."""

    def __init__(self, cfg: ModelConfig, tree: Dict, device):
        self.cfg, self.tree, self.device = cfg, tree, device
        self._f32: Dict[str, Dict] = {}
        self._cond: Dict[tuple, tuple] = {}
        self._latents: Dict[tuple, torch.Tensor] = {}

    def sub(self, key: str):
        if key not in self._f32:
            self._f32[key] = weights.cast(self.tree[key], torch.float32)
        return self._f32[key]

    @torch.inference_mode()
    def cond(self, caption: str, transcription: str = "", mode: str = "f32"):
        """The conditioning of one prompt (computed once for each caption,
        transcription and precision)."""
        key = (caption, transcription, mode)
        if key not in self._cond:
            with nn.precision(mode):
                self._cond[key] = conditioning.conditioning(
                    {"cond": self.sub("cond")}, self.cfg, caption, transcription, self.device)
        return self._cond[key]

    @torch.inference_mode()
    def latents(self, caption: str, transcription: str, seed: int, mix: Dict,
                rows: Sequence[int], mode: str = "f32") -> torch.Tensor:
        """The reference's latents (scale_factor * z) of ``rows`` of the
        request's batch: its own conditioning and DDIM loop on the program's
        draws (computed once for each prompt, seed, rows and precision)."""
        key = (caption, transcription, int(seed), tuple(rows), mode)
        if key not in self._latents:
            self._latents[key] = self._loop(caption, transcription, seed, mix, rows, mode)
        return self._latents[key]

    def _loop(self, caption: str, transcription: str, seed: int, mix: Dict,
              rows: Sequence[int], mode: str):
        cfg = self.cfg
        bsz = mix["batchsize"] * mix["n_candidate_gen_per_text"]
        shape = (bsz, work.latent_frames(cfg, mix), cfg.latent_f_size, cfg.latent_channels)
        sched = generator.ddim_params(cfg.diffusion.timesteps, cfg.diffusion.linear_start,
                                      cfg.diffusion.linear_end, mix["ddim_steps"], 1.0)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        idx = torch.as_tensor(list(rows), device=self.device)
        x_T, noise = generator.ddim_draws(shape, idx, sched, gen, self.device)
        y, contexts, masks = self.cond(caption, transcription, mode)
        r = len(rows)

        def stack(t):  # [2, ...] -> [2r, ...]: uncond rows, then cond rows
            return None if t is None else torch.cat([t[:1].expand(r, *t.shape[1:]),
                                                      t[1:].expand(r, *t.shape[1:])])

        with nn.precision(mode):
            eps = generator.guided_eps_fn(self.sub("unet"), cfg.unet,
                                          [stack(c) for c in contexts],
                                          [stack(m) for m in masks], stack(y),
                                          mix["guidance_scale"])
            return generator.ddim_sample(eps, x_T, noise, sched)

    @torch.inference_mode()
    def mel(self, latent: torch.Tensor, mode: str = "f32") -> torch.Tensor:
        with nn.precision(mode):
            z = latent.float() / self.tree["scale_factor"].float()
            return generator.vae_decode(self.sub("vae"), self.cfg.vae, z)

    @torch.inference_mode()
    def wav(self, mel: torch.Tensor, mode: str = "f32") -> torch.Tensor:
        with nn.precision(mode):
            return generator.vocoder(self.sub("vocoder"), self.cfg.vocoder, mel[..., 0].float())

    @torch.inference_mode()
    def sims(self, caption: str, wav: torch.Tensor, mode: str = "f32") -> torch.Tensor:
        clap_cfg = self.cfg.reranker_clap
        ids, mask = conditioning.tokenize("roberta-base", [caption] * wav.shape[0],
                                          clap_cfg.text_max_length)
        ids, mask = (torch.as_tensor(a, device=self.device) for a in (ids, mask))
        with nn.precision(mode):
            return rerank.similarities(self.sub("reranker_clap"), clap_cfg,
                                       self.cfg.preprocessing.sampling_rate, wav, ids, mask)


def cond_gap(program_cond, ref_cond) -> float:
    """The widest relative gap over the conditioning tensors, every row of
    the program's stack against the reference's uncond and cond rows."""
    (y, contexts, masks), bsz = program_cond
    ry, rcontexts, rmasks = ref_cond

    def rows(t):
        return torch.cat([t[:1].expand(bsz, *t.shape[1:]), t[1:].expand(bsz, *t.shape[1:])])

    if (y is None) != (ry is None) or len(contexts) != len(rcontexts):
        return math.inf
    gaps = [] if y is None else [rel_gap(y.float(), rows(ry))]
    for c, m, rc, rm in zip(contexts, masks, rcontexts, rmasks):
        if not torch.equal(m.float(), rows(rm).float()):
            return math.inf
        gaps.append(rel_gap(c.float(), rows(rc)))
    return max(gaps)


def returned_rows(cap, mix: Dict, sampling_rate: int) -> List[int]:
    """For each returned clip, the candidate row of the decoded batch it is,
    bit for bit (-1 where none is)."""
    b, n = mix["batchsize"], mix["n_candidate_gen_per_text"]
    n_samples = int(mix["duration"] * sampling_rate)
    wav = cap.wav.float().cpu().numpy()[:, :n_samples]
    out = []
    for i in range(b):
        got = np.asarray(cap.returned[i, 0])
        match = [i + j * b for j in range(n) if np.array_equal(got, wav[i + j * b])]
        out.append(match[0] if match else -1)
    return out


def numbers(ref: Reference, cap, mix: Dict, rows: Sequence[int],
            limits: Dict) -> Dict[str, float]:
    """Every number of one capture against the float32 reference."""
    rows = list(rows)
    sr = ref.cfg.preprocessing.sampling_rate
    out = {"cond_rel": cond_gap(cap.cond, ref.cond(cap.caption, cap.transcription))}
    out["latent_rel"] = rel_gap(cap.latent[rows], ref.latents(cap.caption, cap.transcription,
                                                              cap.seed, mix, rows))
    out["mel_rms"] = rms_gap(cap.mel, ref.mel(cap.latent))
    out["wav_rms"] = rms_gap(cap.wav, ref.wav(cap.mel))
    kept = returned_rows(cap, mix, sr)
    out["returned_mismatch"] = float(sum(k < 0 for k in kept))
    if mix["n_candidate_gen_per_text"] > 1:
        ref_sims = ref.sims(cap.caption, cap.wav.float()).double().cpu().numpy()
        prog_sims = np.asarray(cap.sims, np.float64) if cap.sims is not None else None
        out["sim_abs"] = (math.inf if prog_sims is None or prog_sims.shape != ref_sims.shape
                          else float(np.max(np.abs(prog_sims - ref_sims))))
        out["pick_mismatch"] = float(pick_mismatches(kept, ref_sims, mix, limits["sim_abs"]))
    return out


def pick_mismatches(kept: List[int], ref_sims: np.ndarray, mix: Dict, tie: float) -> int:
    """Prompts whose kept candidate is not the reference's best, where the
    best leads the kept one by more than ``tie``."""
    b = mix["batchsize"]
    bad = 0
    for i, k in enumerate(kept):
        cands = ref_sims[i::b]
        best = int(np.argmax(cands))
        if k < 0 or (k != i + best * b and cands[best] - ref_sims[k] > tie):
            bad += 1
    return bad


def control_numbers(ref: Reference, cap, mix: Dict, rows: Sequence[int]) -> Dict[str, float]:
    """The control's numbers: the reference in the program's place, each
    stage at the precision below the configuration's, against the float32
    reference: the conditioning and the rerank in TF32 (the program runs
    them in float32 with TF32 off), the DDIM loop's UNet, the VAE decode and
    the vocoder in float8 (the program runs them in bf16)."""
    rows = list(rows)
    f32_cond = ref.cond(cap.caption, cap.transcription)
    tf32_cond = ref.cond(cap.caption, cap.transcription, "tf32")
    bsz = mix["batchsize"] * mix["n_candidate_gen_per_text"]
    ty, tcontexts, tmasks = tf32_cond
    stacked = ((None if ty is None else torch.cat([ty[:1].expand(bsz, -1),
                                                   ty[1:].expand(bsz, -1)]),
                [torch.cat([c[:1].expand(bsz, *c.shape[1:]), c[1:].expand(bsz, *c.shape[1:])])
                 for c in tcontexts],
                [torch.cat([m[:1].expand(bsz, -1), m[1:].expand(bsz, -1)]) for m in tmasks]),
               bsz)
    out = {"cond_rel": cond_gap(stacked, f32_cond)}
    prompt = (cap.caption, cap.transcription, cap.seed, mix, rows)
    out["latent_rel"] = rel_gap(ref.latents(*prompt, "fp8"), ref.latents(*prompt))
    out["mel_rms"] = rms_gap(ref.mel(cap.latent, "fp8"), ref.mel(cap.latent))
    out["wav_rms"] = rms_gap(ref.wav(cap.mel, "fp8"), ref.wav(cap.mel))
    if mix["n_candidate_gen_per_text"] > 1:
        out["sim_abs"] = float((ref.sims(cap.caption, cap.wav.float(), "tf32")
                                - ref.sims(cap.caption, cap.wav.float())).abs().max())
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell limits at or under its limit (a missing or NaN
    number fails)."""
    return all(k in values and values[k] <= limit for k, limit in limits.items())


def sample(rng: np.random.Generator, n_requests: int, mix: Dict):
    """(request index, rows) of the check, drawn from ``rng``: the batch of
    B x n candidates cut into ``mix["check"]["rows"]`` equal strata in
    order, one row from each, so that no half of the batch goes unchecked."""
    k = int(rng.integers(n_requests))
    bsz = mix["batchsize"] * mix["n_candidate_gen_per_text"]
    n = mix["check"]["rows"]
    edges = [round(i * bsz / n) for i in range(n + 1)]
    rows = [int(rng.integers(edges[i], edges[i + 1])) for i in range(n)]
    return k, rows
