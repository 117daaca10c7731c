"""The system under test: ``audioldm2_torch``, driven through its public
pipeline, with probes at three stage boundaries.

The only module of the benchmark that imports the program. A
:class:`Program` builds the served model (``pipeline.AudioLDM2``) on
weights the benchmark made, runs one request through
``pipeline.text_to_audio`` (:meth:`Program.request`), and wraps three
functions of the program, without changing what they compute, to keep
what the timed path produced for the check of ``correct`` and to mark the
stages for a trace (``record_function`` ranges named ``a2bench.*``):

- ``latent_diffusion.encode_conditioning``: the UNet's inputs (y,
  contexts, masks), stacked (uncond || cond);
- ``latent_diffusion.decode_latent``: the sampler's latents, and the VAE's
  mel and the vocoder's waveforms of every candidate;
- ``pipeline.rerank_and_select``: the rerank's similarities.

A fourth, ``ddim.cfg_eps_fn``, only stamps the host clock as each sampler
step's launches return (``Capture.steps``) and calls ``on_step`` (a traced
run stops its profiler after a number of them); where the program has no
such function, nothing is stamped or counted.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Capture:
    """What one request's timed path produced, as the program returned it."""

    caption: str
    seed: int
    transcription: str = ""
    cond: Optional[tuple] = None  # ((y, contexts, masks), bsz)
    latent: Optional[torch.Tensor] = None  # scale_factor * z, [B * n, T, F, C]
    mel: Optional[torch.Tensor] = None  # [B * n, T_mel, M, 1]
    wav: Optional[torch.Tensor] = None  # [B * n, N]
    sims: Optional[np.ndarray] = None  # the rerank's, [B * n]
    returned: Optional[np.ndarray] = None  # text_to_audio's output, [B, 1, N]
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    steps: List[float] = dataclasses.field(default_factory=list)  # host clock, each step's end
    start: float = 0.0
    end: float = 0.0


class Program:
    """The served model and the probes around it. ``current`` is the
    Capture that the running request fills; None leaves the probes
    pass-through."""

    def __init__(self, cfg, tree, device: str = "cuda"):
        from audioldm2_torch import pipeline
        from audioldm2_torch.diffusion import latent_diffusion as ld

        self.pipeline, self.ld = pipeline, ld
        self.model = pipeline.AudioLDM2(cfg, tree, device)
        self.current: Optional[Capture] = None
        self.on_step: Optional[Callable[[], None]] = None
        self._originals = {}
        self._install()

    def _wrap(self, module, name: str, wrapper_factory):
        original = getattr(module, name)
        self._originals[(module, name)] = original
        setattr(module, name, wrapper_factory(original))

    def _install(self):
        def conditioning(original):
            def probe(*args, **kwargs):
                with torch.profiler.record_function("a2bench.conditioning"):
                    out = original(*args, **kwargs)
                if self.current is not None:
                    self.current.cond = out
                return out
            return probe

        def decode(original):
            def probe(params, cfg, z):
                with torch.profiler.record_function("a2bench.decode"):
                    wav, mel = original(params, cfg, z)
                if self.current is not None:
                    self.current.latent, self.current.mel, self.current.wav = z, mel, wav
                return wav, mel
            return probe

        def rerank(original):
            def probe(model, *args, **kwargs):
                with torch.profiler.record_function("a2bench.rerank"):
                    out = original(model, *args, **kwargs)
                if self.current is not None and model.last_similarities is not None:
                    self.current.sims = np.array(model.last_similarities, copy=True)
                return out
            return probe

        def guided(original):
            def probe(*args, **kwargs):
                eps_fn = original(*args, **kwargs)

                def counted(x, t):
                    e = eps_fn(x, t)
                    if self.current is not None:
                        self.current.steps.append(time.perf_counter())
                    if self.on_step is not None:
                        self.on_step()
                    return e
                return counted
            return probe

        self._wrap(self.ld, "encode_conditioning", conditioning)
        self._wrap(self.ld, "decode_latent", decode)
        self._wrap(self.pipeline, "rerank_and_select", rerank)
        if hasattr(self.ld, "ddim") and hasattr(self.ld.ddim, "cfg_eps_fn"):
            self._wrap(self.ld.ddim, "cfg_eps_fn", guided)

    def close(self):
        """Put the program's functions back and drop the model."""
        for (module, name), original in self._originals.items():
            setattr(module, name, original)
        self._originals.clear()
        self.model = None

    def request(self, mix: Dict, caption: str, seed: int, transcription: str = "",
                steps: Optional[int] = None, keep: bool = True) -> Capture:
        """One text-to-audio request at the mix's sizes; returns its Capture
        (``start`` and ``end`` on the host clock, the output already on the
        host, so the device has finished). ``transcription`` is what a
        speech configuration speaks ("" is the call without one).
        ``keep=False`` keeps no tensor."""
        cap = Capture(caption=caption, seed=int(seed), transcription=transcription)
        self.current = cap if keep else None
        self.model.last_similarities = None
        cap.start = time.perf_counter()
        with torch.profiler.record_function("a2bench.request"):
            out = self.pipeline.text_to_audio(
                self.model, caption, transcription=transcription, seed=int(seed),
                ddim_steps=int(steps or mix["ddim_steps"]), duration=mix["duration"],
                batchsize=mix["batchsize"], guidance_scale=mix["guidance_scale"],
                n_candidate_gen_per_text=mix["n_candidate_gen_per_text"],
                duration_bucket=mix["duration_bucket"])
        cap.end = time.perf_counter()
        self.current = None
        cap.returned = out
        cap.timings = dict(self.model.last_timings)
        return cap


def config(model_name: str):
    """The program's configuration of ``model_name``."""
    from audioldm2_torch.config import default_audioldm_config

    return default_audioldm_config(model_name)


def loaded_modules() -> List[str]:
    """Top-level names of every module loaded in this process."""
    import sys

    return sorted({name.split(".", 1)[0] for name in list(sys.modules)})
