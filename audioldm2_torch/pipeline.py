"""Public pipeline API of the port: build_model / text_to_audio.

Port of the t5 slice of ``audioldm2_tpu/pipeline.py``. Host side:
tokenization through the JAX package's jax-free ``utils.text`` (so both
packages see the same ids, hash fallback included), batch assembly and
timing. Device side: conditioning -> CFG DDIM -> VAE decode -> vocoder
in ``diffusion.latent_diffusion``.

No checkpoint is loaded yet: ``build_model`` draws random weights on the
device from ``seed``, or takes an existing parameter tree (the JAX
package's numpy tree or the port's own).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from audioldm2_tpu.config import ModelConfig, default_audioldm_config
from audioldm2_tpu.utils import text as text_utils
from audioldm2_torch import params as params_m
from audioldm2_torch.diffusion.latent_diffusion import LatentDiffusionModel
from audioldm2_torch.models import conditioners


def _t5_max_length(cfg: ModelConfig) -> int:
    """T5 tokenization length from the config (nested specs included)."""

    def walk(specs):
        for s in specs:
            if s.kind == "flan_t5" and s.flan_t5 is not None:
                return s.flan_t5.max_length
            got = walk(s.nested)
            if got:
                return got
        return None

    return walk(cfg.conditioners) or 128


def round_up_duration(duration: float, bucket: float = 2.5) -> float:
    """Snap a duration up to the bucket grid (default 2.5 s); the generated
    waveform is trimmed back to the requested duration."""
    n = math.ceil(round(duration / bucket, 6))
    return float(max(n, 1) * bucket)


class AudioLDM2:
    """Top-level model handle returned by :func:`build_model`."""

    def __init__(self, cfg: ModelConfig, params: Dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.ldm = LatentDiffusionModel(cfg, params)
        self.t5_tok = text_utils.t5_tokenizer(_t5_max_length(cfg))
        self.last_timings: Dict[str, float] = {}

    def make_batch(self, text: str, batchsize: int = 1) -> Dict[str, torch.Tensor]:
        """Tokenize the prompt (and "" for the unconditional branch) to
        fixed-shape tensors on the model's device."""
        ids, mask = self.t5_tok([text] * batchsize)
        uids, umask = self.t5_tok([""])
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in dict(t5_ids=ids, t5_mask=mask, t5_uncond_ids=uids,
                                 t5_uncond_mask=umask).items()}


def build_model(config=None, device="cuda", model_name: str = "audioldm_16k_crossattn_t5",
                seed: int = 0, params=None, nonzero_init: bool = False) -> AudioLDM2:
    """Build the model on ``device`` (default CUDA, which must be present).

    ``params``: an existing tree (the JAX package's numpy tree or the
    port's); when None, weights are drawn on the device from ``seed``.
    ``nonzero_init`` also draws the leaves the reference initializes to
    zero (see ``params.Init``)."""
    cfg = config if isinstance(config, ModelConfig) else default_audioldm_config(model_name)
    for spec in cfg.conditioners:  # only the t5 family runs so far
        conditioners.check_kind(spec)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model(device='cuda'): no CUDA device is available")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        params = params_m.init_params(cfg, gen, device, nonzero=nonzero_init)
    else:
        params = params_m.from_jax_tree(params, device)
    return AudioLDM2(cfg, params, device)


def text_to_audio(model: AudioLDM2, text: str, transcription: str = "", seed: int = 42,
                  ddim_steps: int = 200, duration: float = 10, batchsize: int = 1,
                  guidance_scale: float = 3.5, n_candidate_gen_per_text: int = 1,
                  duration_bucket: Optional[float] = 2.5):
    """Generate [batchsize, 1, N] float32 waveforms in [-1, 1] (numpy) with
    the DDIM sampler (eta 1, as the JAX package's generate).

    ``n_candidate_gen_per_text > 1`` needs the CLAP reranker, which is not
    ported yet, and raises rather than returning an unranked candidate."""
    if n_candidate_gen_per_text != 1:
        raise NotImplementedError(
            "n_candidate_gen_per_text > 1 needs CLAP reranking, which is not ported to "
            "audioldm2_torch yet (ROADMAP queue 1 item 9)"
        )
    if transcription:
        raise NotImplementedError("transcriptions need the TTS family (ROADMAP queue 1 item 12)")
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    t0 = time.perf_counter()
    batch = model.make_batch(text, batchsize=batchsize)
    t1 = time.perf_counter()
    gen_duration = round_up_duration(duration, duration_bucket) if duration_bucket else duration
    latent_t_size = int(gen_duration * model.cfg.latent_t_per_second)
    wav, _ = model.ldm.generate(batch, gen, latent_t_size=latent_t_size, n_gen=1,
                                guidance=guidance_scale, ddim_steps=ddim_steps)
    t2 = time.perf_counter()
    total = t2 - t0
    model.last_timings = {"tokenize_s": t1 - t0, "generate_s": t2 - t1, "total_s": total,
                          "x_realtime": duration * batchsize / total if total > 0 else 0.0}
    n_samples = int(duration * model.cfg.preprocessing.sampling_rate)
    return wav[:, None, :n_samples]
