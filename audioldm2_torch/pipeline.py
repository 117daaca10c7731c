"""Public pipeline API of the port: build_model / text_to_audio /
super_resolution_and_inpainting.

Port of ``audioldm2_tpu/pipeline.py`` for all seven checkpoint families:
the t5 family (audioldm_16k_crossattn_t5), audioldm2-full (and
audioldm2-music-665k), audioldm2-full-large-1150k, audioldm_48k (a FiLM-only
UNet, the 48 kHz VAE and vocoder) and the speech families
(audioldm2-speech-gigaspeech, -ljspeech: a phoneme encoder and a 512-token
sequence generator), each in bf16 or in the int8 serving mode
(``weight_quant="int8"`` or ``AUDIOLDM2_WEIGHT_QUANT=int8``). Host side:
tokenization through the port's ``utils.text`` (the JAX package's
tokenizers and phoneme pipeline, so both packages see the same ids, hash
and grapheme fallbacks included), wav reading through its
``utils.audio_io``, batch assembly and timing. Device side: conditioning ->
CFG sampler (DDIM, PLMS or DDPM) -> VAE decode -> vocoder in
``diffusion.latent_diffusion``; for sr/inpainting also the log-mel
(``ops.stft``) and the f32 VAE encode; with ``n_candidate_gen_per_text >
1`` the CLAP rerank (``models.clap.rerank_score``) of the candidates.

No checkpoint is loaded yet: ``build_model`` draws random weights on the
device from ``seed``, or takes an existing parameter tree (the JAX
package's numpy tree or the port's own). The public functions take the
JAX package's parameters, in its order.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
import sys
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from audioldm2_torch import config as config_m
from audioldm2_torch import params as params_m
from audioldm2_torch.config import CLAPConfig, ModelConfig, default_audioldm_config
from audioldm2_torch.diffusion.latent_diffusion import LatentDiffusionModel
from audioldm2_torch.models import clap, conditioners
from audioldm2_torch.ops.stft import MelSpectrogram
from audioldm2_torch.utils import text as text_utils
from audioldm2_torch.utils.audio_io import read_wav_file


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


def _first_clap_cfg(cfg: ModelConfig) -> CLAPConfig:
    """CLAP config of the first clap conditioner (nested included), which
    decides the tokenizer of the ``clap_ids`` batch entries."""

    def walk(specs):
        for s in specs:
            if s.kind == "clap" and s.clap is not None:
                return s.clap
            got = walk(s.nested)
            if got is not None:
                return got
        return None

    return walk(cfg.conditioners) or cfg.reranker_clap or CLAPConfig()


def _has_kind(specs, kind: str) -> bool:
    """Whether a conditioner of ``kind`` is in ``specs`` (nested included)."""
    return any(s.kind == kind or _has_kind(s.nested, kind) for s in specs)


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
        self.t5_tok = (text_utils.t5_tokenizer(_t5_max_length(cfg))
                       if any(s.kind in ("flan_t5", "sequence_gen") for s in cfg.conditioners)
                       else None)
        self.clap_tok = text_utils.clap_tokenizer(_first_clap_cfg(cfg))
        self.reranker_tok = (text_utils.clap_tokenizer(cfg.reranker_clap)
                             if cfg.reranker_clap is not None else None)
        self.phonemes = _has_kind(cfg.conditioners, "phoneme")
        pre = cfg.preprocessing
        self.mel = MelSpectrogram(
            filter_length=pre.filter_length, hop_length=pre.hop_length,
            win_length=pre.win_length, n_mel_channels=pre.n_mel_channels,
            sampling_rate=pre.sampling_rate, mel_fmin=pre.mel_fmin, mel_fmax=pre.mel_fmax,
            device=self.device,
        )
        self.last_timings: Dict[str, float] = {}
        self.last_similarities: Optional[np.ndarray] = None  # the last rerank's, [B * n]

    def make_batch(self, text: str, transcription: str = "",
                   batchsize: int = 1) -> Dict[str, torch.Tensor]:
        """Tokenize the prompt (and "" for the unconditional branch) with the
        T5 tokenizer, where a conditioner needs it, and the CLAP tokenizer,
        and, where a phoneme conditioner reads them, the transcription's VITS
        phoneme ids ([batchsize, 310], "" when there is none), to
        fixed-shape tensors on the model's device. A family without a
        phoneme conditioner ignores the transcription, as in JAX."""
        texts = [text] * batchsize
        arrays = {}
        for name, tok in (("t5", self.t5_tok), ("clap", self.clap_tok)):
            if tok is None:
                continue
            ids, mask = tok(texts)
            uids, umask = tok([""])
            arrays.update({f"{name}_ids": ids, f"{name}_mask": mask,
                           f"{name}_uncond_ids": uids, f"{name}_uncond_mask": umask})
        if self.phonemes:
            phonemes = text_utils.text_to_phonemes(transcription) if transcription else ""
            arrays["phoneme_idx"] = text_utils.phoneme_ids([phonemes] * batchsize)
        return {k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()}


def seed_everything(seed: int, device="cuda") -> torch.Generator:
    """Seed ``random``, numpy and torch with ``seed`` and return a
    ``torch.Generator`` seeded with it on ``device`` (the card unless the
    caller asks for the CPU). The port's counterpart of the JAX package's
    ``seed_everything``, which returns a PRNG key: device randomness flows
    from the returned generator."""
    random.seed(seed)
    np.random.seed(seed % 2 ** 32)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(int(seed))


def build_model(ckpt_path: Optional[str] = None, config=None, device=None,
                model_name: str = "audioldm2-full", weight_quant: Optional[str] = None, *,
                seed: int = 0, params=None, nonzero_init: bool = False) -> AudioLDM2:
    """Build the model on ``device`` (None: the card, which must be
    present); the first five parameters are the JAX package's.

    ``ckpt_path``: None draws random weights; a path that does not exist
    warns and draws random weights, as the JAX package does; an existing
    file raises ``NotImplementedError`` (checkpoint loading is not ported).
    ``params``: an existing tree (the JAX package's numpy tree or the
    port's); when None, weights are drawn on the device from ``seed``
    (on the ``"meta"`` device, shapes only, with no memory).
    ``config``: the port's ``ModelConfig`` or any dataclass with its fields
    (the JAX package's), rebuilt by ``config.coerce``; None builds
    ``default_audioldm_config(model_name)``.
    ``nonzero_init`` also draws the leaves the reference initializes to
    zero (see ``params.Init``). ``weight_quant="int8"`` (or the
    environment variable ``AUDIOLDM2_WEIGHT_QUANT=int8``) selects the int8
    serving mode: the UNet's transformer linears and ResBlock convs run
    int8 weights through the int8 kernels."""
    if ckpt_path is not None and os.path.exists(ckpt_path):
        raise NotImplementedError(
            f"build_model({ckpt_path!r}): checkpoint loading is not ported to audioldm2_torch "
            "yet (ROADMAP queue 1 item 17)")
    if ckpt_path is not None:
        print(f"WARNING: checkpoint {ckpt_path} not found; using random init")
    cfg = default_audioldm_config(model_name) if config is None else config_m.coerce(config)
    weight_quant = weight_quant or os.environ.get("AUDIOLDM2_WEIGHT_QUANT") or None
    if weight_quant:
        cfg = dataclasses.replace(cfg, weight_quant=weight_quant)
    if cfg.weight_quant not in (None, "int8"):
        raise ValueError(f"weight_quant {cfg.weight_quant!r}: only 'int8' is supported")
    for spec in cfg.conditioners:
        conditioners.check_kind(spec)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"build_model(device={str(device)!r}): no CUDA device is available")
    if params is None:
        gen = torch.Generator(device=device if device.type != "meta" else "cpu")
        params = params_m.init_params(cfg, gen.manual_seed(int(seed)), device,
                                      nonzero=nonzero_init)
    else:
        params = params_m.from_jax_tree(params, device)
    return AudioLDM2(cfg, params, device)


def _record_timings(model: AudioLDM2, duration: float, batchsize: int, **stages) -> None:
    total = sum(stages.values())
    model.last_timings = {**stages, "total_s": total,
                          "x_realtime": duration * batchsize / total if total > 0 else 0.0}


def text_to_audio(model: AudioLDM2, text: str, transcription: str = "", seed: int = 42,
                  ddim_steps: int = 200, duration: float = 10, batchsize: int = 1,
                  guidance_scale: float = 3.5, n_candidate_gen_per_text: int = 3,
                  latent_t_per_second: float = 25.6, config=None, sampler: str = "ddim",
                  duration_bucket: Optional[float] = 2.5, use_ema: bool = False):
    """Generate [batchsize, 1, N] float32 waveforms in [-1, 1] (numpy).

    ``sampler``: "ddim" (eta 1, as the JAX package's generate), "plms"
    (``ddim_steps`` steps) or "ddpm" (the full ancestral schedule).
    ``use_ema`` denoises with the EMA UNet weights (``params["unet_ema"]``).
    ``n_candidate_gen_per_text`` candidates are generated per prompt (CFG
    batch 2 * batchsize * n) and the CLAP reranker keeps the best of each
    prompt's (:func:`rerank_and_select`). ``transcription`` is the speech
    families' text to speak (ignored by the others, as in the JAX package).
    ``latent_t_per_second`` and ``config`` are accepted and ignored, as in
    the JAX package: the latent length comes from ``model.cfg``."""
    n = int(n_candidate_gen_per_text)
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    t0 = time.perf_counter()
    batch = model.make_batch(text, transcription=transcription, batchsize=batchsize)
    t1 = time.perf_counter()
    gen_duration = round_up_duration(duration, duration_bucket) if duration_bucket else duration
    latent_t_size = int(gen_duration * model.cfg.latent_t_per_second)
    wav, _ = model.ldm.generate(batch, gen, latent_t_size=latent_t_size, n_gen=n,
                                guidance=guidance_scale, ddim_steps=ddim_steps, sampler=sampler,
                                use_ema=use_ema)
    t2 = time.perf_counter()
    wav = rerank_and_select(model, wav, text, batchsize, n)
    t3 = time.perf_counter()
    _record_timings(model, duration, batchsize, tokenize_s=t1 - t0, generate_s=t2 - t1,
                    rerank_s=t3 - t2)
    n_samples = int(duration * model.cfg.preprocessing.sampling_rate)
    return wav[:, None, :n_samples]


def rerank_and_select(model: AudioLDM2, wav: np.ndarray, text: str, batchsize: int,
                      n_gen: int) -> np.ndarray:
    """Keep, for each prompt, the candidate whose CLAP audio embedding is
    closest to the prompt's text embedding (candidate ``i + j * batchsize``
    belongs to prompt ``i``). The similarities print to stderr. With no
    reranker weights it warns and returns each prompt's first candidate."""
    if n_gen <= 1:
        return wav
    reranker = model.ldm.params.get("reranker_clap")
    if reranker is None:
        warnings.warn(
            "n_candidate_gen_per_text > 1 but no CLAP reranker weights are loaded "
            "(cfg.reranker_clap is None): returning candidate #1 un-reranked.", stacklevel=2)
        return wav[:batchsize]
    ids, mask = model.reranker_tok([text] * wav.shape[0])
    dev = model.device
    sim = clap.rerank_score(
        reranker, model.cfg.reranker_clap, model.cfg.preprocessing.sampling_rate,
        torch.as_tensor(np.asarray(wav), device=dev), torch.as_tensor(ids, device=dev),
        torch.as_tensor(mask, device=dev)).cpu().numpy()
    model.last_similarities = sim
    best = [i + int(np.argmax(sim[i::batchsize])) * batchsize for i in range(batchsize)]
    print("Similarity between generated audio and text:", file=sys.stderr)
    print(" ".join("{:.4f}".format(float(v)) for v in sim), file=sys.stderr)
    if float(np.max(sim) - np.min(sim)) == 0.0:
        print("WARNING: all candidate similarities identical — the CLAP embedding path is "
              "degenerate (argmax is arbitrary)", file=sys.stderr)
    print("Choose the following indexes as the output:", best, file=sys.stderr)
    return wav[best]


def latent_inpaint_mask(shape, time_ratio: Tuple[float, float],
                        freq_ratio: Tuple[float, float]) -> torch.Tensor:
    """[B, h, w, 1] ones with the latent frames int(h * t0):int(h * t1) and
    the latent bins int(w * f0):int(w * f1) set to 0 (0 = regenerate)."""
    b, h, w = shape[:3]
    mask = torch.ones((b, h, w, 1))
    mask[:, int(h * time_ratio[0]):int(h * time_ratio[1])] = 0.0
    mask[:, :, int(w * freq_ratio[0]):int(w * freq_ratio[1])] = 0.0
    return mask


def super_resolution_and_inpainting(
    model: AudioLDM2, text: str, transcription: str = "",
    original_audio_file_path: Optional[str] = None, seed: int = 42, ddim_steps: int = 200,
    duration: float = 10, batchsize: int = 1, guidance_scale: float = 2.5,
    n_candidate_gen_per_text: int = 3,
    time_mask_ratio_start_and_end: Tuple[float, float] = (0.40, 0.60),
    freq_mask_ratio_start_and_end: Tuple[float, float] = (1.0, 1.0),
    latent_t_per_second: float = 25.6, config=None, sampler: str = "ddim",
):
    """Regenerate the masked part of a recording: [batchsize, 1, N] float32
    waveforms in [-1, 1] (numpy).

    The wav is read (mono, resampled, normalized) to the mel frames of
    ``duration``, turned into the log-mel fbank, encoded by the f32 VAE, and
    generated with the latent mask (time span ``time_mask_ratio_start_and_end``
    and frequency span ``freq_mask_ratio_start_and_end`` regenerated, the
    rest blended from the q-sampled encoding at every step), with
    ``n_candidate_gen_per_text`` candidates per prompt reranked by CLAP.
    ``transcription`` as in :func:`text_to_audio`. ``latent_t_per_second``
    and ``config`` are accepted and ignored, as in the JAX package: the mel
    length comes from ``model.cfg``."""
    n = int(n_candidate_gen_per_text)
    cfg = model.cfg
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    t0 = time.perf_counter()
    sr = cfg.preprocessing.sampling_rate
    # mel frames = latent frames per second x the VAE's downsampling
    target_frames = int(duration * cfg.latent_t_per_second * cfg.vae.downsample_factor)
    wav_in = read_wav_file(original_audio_file_path,
                           target_frames * cfg.preprocessing.hop_length, target_sr=sr)
    fbank = model.mel.fbank(wav_in, target_length=target_frames)  # [1, T, M]
    mel_in = fbank[..., None].repeat(batchsize, 1, 1, 1)
    batch = model.make_batch(text, transcription=transcription, batchsize=batchsize)
    z0 = model.ldm.encode_mel(gen, mel_in)
    batch["inpaint_mask"] = latent_inpaint_mask(
        z0.shape, time_mask_ratio_start_and_end, freq_mask_ratio_start_and_end).to(z0.device)
    batch["inpaint_x0"] = z0
    if z0.is_cuda:  # prepare_s covers the encode, not only its enqueue
        torch.cuda.synchronize(z0.device)
    t1 = time.perf_counter()
    wav, _ = model.ldm.generate(batch, gen, latent_t_size=z0.shape[1], n_gen=n,
                                guidance=guidance_scale, ddim_steps=ddim_steps, use_mask=True,
                                sampler=sampler)
    t2 = time.perf_counter()
    wav = rerank_and_select(model, wav, text, batchsize, n)
    t3 = time.perf_counter()
    _record_timings(model, duration, batchsize, prepare_s=t1 - t0, generate_s=t2 - t1,
                    rerank_s=t3 - t2)
    return wav[:, None, :int(duration * sr)]
