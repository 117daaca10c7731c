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
``AudioLDM2.make_batch(waveform=, fbank=)`` carries audio in: the kaldi
fbank of the AudioMAE conditioner and the clip of a CLAP conditioner in
audio embedding mode.

Weights: ``build_model(ckpt_path)`` reads a reference monolithic ``.pth``
through the port's converter (``convert.py``, ``convert_cond.py``,
``convert_htsat.py``: the JAX package's tree, bit for bit); ``params=``
takes an existing tree (the JAX package's numpy tree, an ``.npz`` read by
``utils.checkpoint.load_npz``, or the port's own); otherwise weights are
drawn on the device from ``seed``. The public functions take the JAX
package's parameters, in its order.
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
from audioldm2_torch.ops.stft import KaldiFbank, MelSpectrogram
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
        self.kaldi = KaldiFbank(device=self.device)
        self.last_timings: Dict[str, float] = {}
        self.last_similarities: Optional[np.ndarray] = None  # the last rerank's, [B * n]

    def make_batch(self, text: str, transcription: str = "", batchsize: int = 1,
                   waveform: Optional[np.ndarray] = None,
                   fbank: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """The batch of one request, as tensors on the model's device: the
        prompt's (and ""'s, for the unconditional branch) T5 tokens, where a
        conditioner needs them, and CLAP tokens; where a phoneme conditioner
        reads them, the transcription's VITS phoneme ids ([batchsize, 310],
        "" when there is none; a family without one ignores the
        transcription, as in JAX); ``ta_kaldi_fbank`` [batchsize, 1024, 128],
        AudioMAE's input, the normalized kaldi fbank of ``waveform`` (zeros
        without one); where a CLAP conditioner embeds audio,
        ``clap_waveform_48k`` [batchsize, clip_samples], ``waveform`` (at
        the model's rate) resampled to the CLAP rate and fit to one clip
        (zeros without one); ``fbank`` as given, in f32. A one-row
        ``waveform`` ([N] or [1, N]) is tiled to ``batchsize`` for both
        audio keys (JAX tiles it for the CLAP clip only)."""
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
        wav = None
        if waveform is not None:
            wav = np.asarray(waveform, np.float32).reshape(-1, np.shape(waveform)[-1])
            if wav.shape[0] == 1 and batchsize > 1:
                wav = np.tile(wav, (batchsize, 1))
        clap_cfg = _first_clap_cfg(self.cfg)
        if any(s.kind == "clap" and s.clap.embed_mode == "audio" for s in self.cfg.conditioners):
            arrays["clap_waveform_48k"] = (
                np.zeros((batchsize, clap_cfg.clip_samples), np.float32) if wav is None else
                clap.prepare_clap_audio(wav, self.cfg.preprocessing.sampling_rate, clap_cfg))
        if fbank is not None:
            arrays["fbank"] = np.asarray(fbank, np.float32)
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()}
        batch["ta_kaldi_fbank"] = (
            torch.zeros((batchsize, 1024, 128), device=self.device) if wav is None
            else self.kaldi.normalized(wav, target_length=1024))
        return batch


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


def load_checkpoint_params(ckpt_path: str, cfg: ModelConfig) -> Dict:
    """Convert a reference ``.pth`` monolithic checkpoint (its state dict,
    bare or under ``"state_dict"``) into the parameter tree, numpy leaves
    that share memory with the loaded tensors.

    ``weights_only=True`` is torch.load's default since torch 2.6, so this
    reads what the JAX package's ``torch.load(ckpt_path, map_location="cpu")``
    reads on the same torch: tensors and plain containers, no pickled code."""
    from audioldm2_torch import convert

    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    return convert_state_dict(convert.state_dict_to_numpy(sd), cfg)


def convert_state_dict(sd: Dict[str, np.ndarray], cfg: ModelConfig) -> Dict:
    """A reference monolithic state dict (numpy values, the key layout of
    ``LatentDiffusion.state_dict()``, reference pipeline.py:172-174) -> the
    parameter tree: UNet, VAE, vocoder, ``scale_factor``, each conditioner,
    the reranker CLAP when ``clap.model.*`` keys are present and
    ``unet_ema`` from the ``model_ema.*`` shadows (left out, with a warning,
    when they are incomplete). The port's copy of the JAX package's
    ``convert_state_dict``."""
    from audioldm2_torch import convert, convert_cond

    params: Dict = {
        "unet": convert.convert_unet(sd, cfg.unet, prefix="model.diffusion_model."),
        "vae": convert.convert_vae(sd, cfg.vae, prefix="first_stage_model."),
        "vocoder": convert.convert_vocoder(sd, cfg.vocoder, prefix="first_stage_model.vocoder."),
        "scale_factor": np.asarray(sd.get("scale_factor", 1.0), np.float32),
        "cond": {},
    }
    for idx, spec in enumerate(cfg.conditioners):
        prefix = f"cond_stage_models.{idx}."
        if spec.kind == "flan_t5":
            params["cond"][spec.name] = {
                "t5": convert.convert_t5_encoder(sd, spec.flan_t5, prefix + "model.")}
        else:
            params["cond"][spec.name] = convert_cond.convert_conditioner(sd, spec, prefix)
    if cfg.reranker_clap is not None and any(k.startswith("clap.model.") for k in sd):
        # the DDPM-level reranker CLAP (reference ddpm.py:114-120)
        params["reranker_clap"] = convert.convert_clap(sd, "clap.model.")
    if any(k.startswith("model_ema.") for k in sd):
        # LitEma's shadows (reference ddpm.py:131-134) as a second UNet tree,
        # read by generate(use_ema=True)
        try:
            ema_sd = convert.expand_ema_keys(sd)
            params["unet_ema"] = convert.convert_unet(ema_sd, cfg.unet,
                                                      prefix="model.diffusion_model.")
        except KeyError as e:
            warnings.warn(
                f"model_ema.* keys present but incomplete ({e}); EMA "
                "inference disabled for this checkpoint.", stacklevel=2,
            )
    return params


def build_model(ckpt_path: Optional[str] = None, config=None, device=None,
                model_name: str = "audioldm2-full", weight_quant: Optional[str] = None, *,
                seed: int = 0, params=None, nonzero_init: bool = False) -> AudioLDM2:
    """Build the model on ``device`` (None: the card, which must be
    present); the first five parameters are the JAX package's.

    ``ckpt_path``: a reference ``.pth`` (:func:`load_checkpoint_params`;
    a file that does not load or convert raises); a path that does not
    exist warns and draws random weights, as the JAX package does.
    ``params``: an existing tree (the JAX package's numpy tree, an ``.npz``
    read by ``utils.checkpoint.load_npz``, or the port's); passing it with
    ``ckpt_path`` raises ``ValueError``. With neither, weights are drawn on
    the device from ``seed`` (on the ``"meta"`` device, shapes only, with
    no memory). A loaded tree moves to the device leaf by leaf.
    ``config``: the port's ``ModelConfig`` or any dataclass with its fields
    (the JAX package's), rebuilt by ``config.coerce``; None builds
    ``default_audioldm_config(model_name)``.
    ``nonzero_init`` also draws the leaves the reference initializes to
    zero (see ``params.Init``). ``weight_quant="int8"`` (or the
    environment variable ``AUDIOLDM2_WEIGHT_QUANT=int8``) selects the int8
    serving mode: the UNet's transformer linears and ResBlock convs run
    int8 weights through the int8 kernels."""
    if ckpt_path is not None and params is not None:
        raise ValueError("build_model: pass ckpt_path or params, not both (they would give "
                         "two parameter trees)")
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
    if ckpt_path is not None and os.path.exists(ckpt_path):
        params = load_checkpoint_params(ckpt_path, cfg)
    elif ckpt_path is not None:
        print(f"WARNING: checkpoint {ckpt_path} not found; using random init")
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
