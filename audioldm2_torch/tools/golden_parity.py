"""Hold the port's requests to the JAX package's at full published width.

    python -m audioldm2_torch.tools.golden_parity [--device cuda|cpu] [--case NAME ...]

``audioldm2_torch/assets/golden_fullwidth.npz`` holds one request per case
of :data:`CASES`, made by the JAX package on the CPU in f32
(``tests/torch_golden.py``) on the weights :func:`params.draw_tree` gives
for seed 0: the batch's token ids, each conditioning output the UNet reads,
``x_T``, the final latent, the mel, the waveform, on a reranked case the
CLAP scores and the pick, and every draw JAX made: on the sr and edit cases
the input mel, the posterior noise and the encoded latent, the inpainting
mask and each step's q-sample noise (sr), the encode noise and the noised
latent (edit); on the audio-in cases the kaldi fbank; on the int8 case the
digest of the quantized UNet tree. The input waveforms are made here with
numpy (:func:`case_waves`), for both packages. :func:`check` rebuilds the
tree with numpy alone (raising if its :func:`params.tree_digest` is not the
stored one), builds the port's model on ``device``, checks that its
``make_batch`` gives the stored ids (raising if not) and runs the case's
request (:func:`run`: ``ldm.generate`` from the stored ``x_T`` at eta 0,
DDIM or PLMS; the sr request on the stored mask and draws; the edit
request's ``encode_mel`` and ``ldm.edit``), returning each stage's distance
to the golden. The module imports no JAX. The command runs each case in
f32 (TF32 off on the card), prints one JSON line a case with ``ok``
(:func:`f32_ok`: the mel MAE under :func:`f32_limit`, the encode under
:func:`z0_limit`, the golden's pick); it exits 1 if a case is not ok. Other
modes (bf16, the int8 serving mode) go through :func:`check`, whose caller
sets their bound.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                      "golden_fullwidth.npz")
TREE_SEED = 0
ETA = 0.0
# the round's bar for the port in f32 against the JAX package
MEL_MAE_TOL = 1e-3
# the bar for the f32 VAE encode (max|d| / max|golden| of the encoded latent)
Z0_REL_TOL = 1e-4
# An int8 request rounds each int8 product's activation to bf16 (the JAX
# package's Pallas kernels and the port's kernels alike), so moving x_T by
# one ulp moves its mel by about 1e-3 (the golden's int8_ulp_mel_mae, JAX's
# own request against itself: 1.10e-3 on full_int8), where an f32 request
# moves by about 1e-6. The port's int8 request in f32 is held to this
# factor x that spread (full_int8 on the CPU: 1.16e-3, 1.05x), in place of
# an F32_MEL_MAE_LIMIT entry: no bar under the spread can hold.
INT8_SPREAD_FACTOR = 2.0
MODES = ("generate", "sr", "edit")
# the sr request's latent mask, as super_resolution_and_inpainting's defaults
SR_TIME_MASK = (0.40, 0.60)
SR_FREQ_MASK = (1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Case:
    family: str
    steps: int
    n_gen: int
    prompt: str
    transcription: str = ""
    duration: float = 10.0  # latent 256 (16 kHz) / 128 (48 kHz): a 10.24 s waveform
    guidance: float = 3.5
    xt_seed: int = 0
    mode: str = "generate"  # one of MODES
    sampler: str = "ddim"  # "ddim" or "plms"
    batchsize: int = 1
    variant: Optional[str] = None  # None, "mae" or "clapaudio": see variant_config
    weight_quant: Optional[str] = None
    t_enc: int = 0  # edit: the DDIM-subset step the latent is noised to
    wave_seed: int = 0  # the chirps' noise (case_waves)


CASES: Dict[str, Case] = {
    # bench.py's headline geometry
    "t5_headline": Case("audioldm_16k_crossattn_t5", 200, 1, "A dog barking in the distance.",
                        xt_seed=1),
    # CLAP + FLAN-T5 + GPT-2 (8 tokens) + the nested AudioMAE
    "full": Case("audioldm2-full", 10, 1, "Rain on a tin roof.", xt_seed=2),
    # depth-2 transformers and the context-free third slot
    "large": Case("audioldm2-full-large-1150k", 10, 1, "A violin melody in a large hall.",
                  xt_seed=3),
    # FiLM, the four-level VAE, the 48 kHz vocoder and the CLAP rerank
    "k48": Case("audioldm_48k", 10, 3, "Waves crashing on rocks.", xt_seed=4),
    # the phoneme encoder and the 512-token GPT-2
    "tts": Case("audioldm2-speech-gigaspeech", 10, 1, "A man speaking clearly.",
                transcription="The quick brown fox jumps over the lazy dog, twice.",
                xt_seed=5),
    # bench.py's sr request: its 440 Hz sine read from a wav file, the f32
    # VAE encode, the 40-60% time mask blended at every step
    "sr_large": Case("audioldm2-full-large-1150k", 10, 1, "A piano playing a gentle melody.",
                     guidance=2.5, xt_seed=6, mode="sr"),
    # two chirps encoded (the VAE encode at batch 2), noised to step 10 of
    # 20 and denoised under a new prompt
    "edit_t5": Case("audioldm_16k_crossattn_t5", 20, 1, "A cat meowing loudly.", xt_seed=7,
                    mode="edit", batchsize=2, t_enc=10, wave_seed=7),
    "plms_t5": Case("audioldm_16k_crossattn_t5", 10, 1, "Birds chirping in a forest.",
                    xt_seed=8, sampler="plms"),
    # audioldm2-full's UNet on AudioMAE + T5 at CFG batch 4: two 16 kHz chirps
    "mae_full": Case("audioldm2-full", 10, 1, "", xt_seed=9, batchsize=2, variant="mae",
                     wave_seed=9),
    # audioldm_48k with CLAP embedding a 10 s 48 kHz chirp as the FiLM y
    "clapaudio_48k": Case("audioldm_48k", 10, 1, "", xt_seed=10, variant="clapaudio",
                          wave_seed=10),
    # the int8 UNet tree (quantized in f32) served in f32
    "full_int8": Case("audioldm2-full", 10, 1, "Rain on a tin roof.", xt_seed=11,
                      weight_quant="int8"),
}
# Each case's f32 limit on the mel MAE: 4x the port's reading on the CPU
# (tests/test_torch_golden.py::test_port_matches_the_golden_at_full_width:
# 2.31e-5, 3.07e-5, 4.67e-5, 2.94e-6, 2.08e-6; sr_large 1.83e-5, edit_t5
# 1.89e-5, plms_t5 2.98e-5, mae_full 2.04e-6, clapaudio_48k 2.76e-6),
# rounded up. The H100 read 0.46-1.70x those (chip_smoke.py's golden path),
# so an f32 request keeps 2.3x room or more, while a bar of MEL_MAE_TOL
# alone sits 20-480x above them.
F32_MEL_MAE_LIMIT = {"t5_headline": 9.3e-5, "full": 1.3e-4, "large": 1.9e-4, "k48": 1.2e-5,
                     "tts": 8.4e-6, "sr_large": 7.4e-5, "edit_t5": 7.6e-5, "plms_t5": 1.2e-4,
                     "mae_full": 8.2e-6, "clapaudio_48k": 1.2e-5}
# Each encoding case's limit on z0_rel, set the same way (the CPU's
# readings: sr_large 2.60e-6, edit_t5 1.28e-5; the H100's 3.21e-6, 6.65e-6)
Z0_REL_LIMIT = {"sr_large": 1.1e-5, "edit_t5": 5.2e-5}
# families whose configs are another case's, field for field but the name
SHARED_CONFIGS = {"audioldm2-music-665k": "audioldm2-full",
                  "audioldm2-speech-ljspeech": "audioldm2-speech-gigaspeech"}


def f32_limit(case_name: str, int8_spread: Optional[float] = None) -> float:
    """The mel MAE an f32 request of the case must stay under: its
    F32_MEL_MAE_LIMIT, never above the bar: MEL_MAE_TOL, or for an int8
    request INT8_SPREAD_FACTOR x ``int8_spread``, the golden's
    ``int8_ulp_mel_mae`` (a case without a reading, as the tests' tiny
    goldens, gets the bar)."""
    bar = MEL_MAE_TOL if int8_spread is None else INT8_SPREAD_FACTOR * int8_spread
    return min(bar, F32_MEL_MAE_LIMIT.get(case_name, bar))


def z0_limit(case_name: str) -> float:
    """The encode's ``z0_rel`` an f32 request must stay under: its
    Z0_REL_LIMIT, never above Z0_REL_TOL."""
    return min(Z0_REL_TOL, Z0_REL_LIMIT.get(case_name, Z0_REL_TOL))


def f32_ok(d: Dict) -> bool:
    """Whether an f32 request's distances (:func:`run`'s) pass: the mel MAE
    under :func:`f32_limit`, the encode (where there is one) under
    :func:`z0_limit` and the golden's pick."""
    return (d["mel_mae"] < f32_limit(d["case"], d.get("int8_ulp_mel_mae"))
            and d.get("same_pick", True)
            and d.get("z0_rel", 0.0) < z0_limit(d["case"]))


def stored_case(meta: Dict) -> Case:
    """The Case a golden entry was made for, from its metadata (a field it
    does not hold has its default)."""
    return Case(**{f.name: meta.get(f.name, f.default) for f in dataclasses.fields(Case)})


def variant_config(cfg, variant: Optional[str]):
    """``cfg`` (the JAX package's or the port's) for a case's variant:
    ``"mae"``, the conditioners (the sequence generator's nested
    audiomae_pooled spec, the rest as they are), so AudioMAE's pooled
    tokens fill the GPT-2 slot; ``"clapaudio"``, each CLAP conditioner in
    ``embed_mode="audio"``."""
    if variant is None:
        return cfg
    if variant == "mae":
        mae = next(ns for ns in cfg.conditioners[0].nested if ns.kind == "audiomae_pooled")
        return dataclasses.replace(cfg, conditioners=(mae,) + tuple(cfg.conditioners[1:]))
    if variant == "clapaudio":
        return dataclasses.replace(cfg, conditioners=tuple(
            dataclasses.replace(s, clap=dataclasses.replace(s.clap, embed_mode="audio"))
            if s.kind == "clap" else s for s in cfg.conditioners))
    raise ValueError(f"unknown variant {variant!r}")


def case_config(case: Case, compute_dtype: str = "float32", weight_quant: Optional[str] = None):
    """The case's family and variant at its published width in
    ``compute_dtype``, with ``weight_quant`` or else the case's."""
    from audioldm2_torch.config import default_audioldm_config

    return dataclasses.replace(variant_config(default_audioldm_config(case.family), case.variant),
                               compute_dtype=compute_dtype,
                               weight_quant=weight_quant or case.weight_quant)


def chirp(sr: int, seconds: float, seed: int = 0) -> np.ndarray:
    """A linear chirp over most of the band plus noise, peak 0.5, float32
    numpy [N]."""
    t = np.arange(int(sr * seconds)) / sr
    f0, f1 = 0.01 * sr, 0.45 * sr
    x = np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * seconds)))
    x = x + 0.1 * np.random.default_rng(seed).standard_normal(t.shape)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def sine(sr: int, seconds: float, freq: float = 440.0, amp: float = 0.3) -> np.ndarray:
    """bench.py's sr input: ``amp * sin(2 pi freq t)``, float32 numpy [N]."""
    t = np.linspace(0, seconds, int(sr * seconds), dtype=np.float32)
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def case_waves(case: Case, sr: int) -> Optional[np.ndarray]:
    """The case's input waveforms at ``sr``, [rows, N] float32: the sr
    case's sine (one row, written to a wav file and read back by the
    request), a chirp per batch row (seeds ``wave_seed``, +1, ...) on the
    edit and audio-in cases; None on a text-only case."""
    if case.mode == "sr":
        return sine(sr, case.duration)[None]
    if case.mode == "edit" or case.variant is not None:
        return np.stack([chirp(sr, case.duration, case.wave_seed + i)
                         for i in range(case.batchsize)])
    return None


def mel_frames(cfg, case: Case) -> int:
    return latent_t_size(cfg, case) * cfg.vae.downsample_factor


def encode_input(model, case: Case) -> np.ndarray:
    """The port's input mel [batchsize, T, M, 1] of an sr or edit case, as
    ``super_resolution_and_inpainting`` makes it (the sine through a wav
    file, tiled to the batch) or, on edit, the fbank of each chirp."""
    from audioldm2_torch.utils.audio_io import read_wav_file, save_wave

    cfg = model.cfg
    sr, frames = cfg.preprocessing.sampling_rate, mel_frames(cfg, case)
    waves = case_waves(case, sr)
    if case.mode == "sr":
        with tempfile.TemporaryDirectory() as tmp:
            path = save_wave(waves[:, None], tmp, name="input", samplerate=sr)[0]
            waves = read_wav_file(path, frames * cfg.preprocessing.hop_length, target_sr=sr)
        fb = _np(model.mel.fbank(waves, target_length=frames))
        return np.tile(fb[..., None], (case.batchsize, 1, 1, 1))
    return _np(model.mel.fbank(waves, target_length=frames))[..., None]


def config_digest(cfg) -> str:
    """SHA-256 of every config field but ``name``, as sorted JSON: equal for
    the JAX package's and the port's configs of one family, and for two
    families that share a config."""
    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "name"}
    return hashlib.sha256(json.dumps(fields, sort_keys=True, default=str).encode()).hexdigest()


def latent_t_size(cfg, case: Case) -> int:
    return int(case.duration * cfg.latent_t_per_second)


def x_T(cfg, case: Case) -> np.ndarray:
    """The case's initial latent [batchsize * n_gen, T, F, C], a numpy
    normal draw."""
    shape = (case.batchsize * case.n_gen, latent_t_size(cfg, case), cfg.latent_f_size,
             cfg.latent_channels)
    return np.random.default_rng(case.xt_seed).standard_normal(shape, dtype=np.float32)


def batch_ids(batch) -> Dict[str, np.ndarray]:
    """The token ids and masks of a batch (``*_ids``, ``*_mask``,
    ``phoneme_idx``), as int64 numpy arrays."""
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).astype(np.int64)
            for k, v in batch.items() if k.endswith(("_ids", "_mask")) or k == "phoneme_idx"}


def context_length(mask) -> int:
    """Tokens up to the last one any row's mask keeps: the part of a
    cross-attention context the UNet reads."""
    keep = np.nonzero(np.asarray(mask).any(axis=0))[0]
    return int(keep[-1]) + 1 if keep.size else 0


def load(path: Optional[str] = None) -> Dict[str, Dict]:
    """case -> {"meta": dict, quantity: array} from the golden file
    (default :data:`GOLDEN`)."""
    out: Dict[str, Dict] = {}
    with np.load(path or GOLDEN, allow_pickle=False) as z:
        for key in z.files:
            case, name = key.split("/", 1)
            out.setdefault(case, {})[name] = z[key]
    for d in out.values():
        d["meta"] = json.loads(str(d["meta"]))
    return out


def rel(got, want) -> float:
    """max|got - want| / max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@contextlib.contextmanager
def recorded(module, name: str, out: list, arg: Optional[int] = None):
    """Append what each call of ``module.name`` returns (or its positional
    argument ``arg``) to ``out`` while inside."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        got = fn(*args, **kw)
        out.append(got if arg is None else args[arg])
        return got

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def build(case_name: str, device, golden: Dict, compute_dtype: str = "float32",
          weight_quant: Optional[str] = None, tree=None, cfg=None):
    """The case's model on ``device`` from :func:`params.draw_tree`'s tree
    (or ``tree``, already drawn), which must have the stored digest; ``cfg``
    (default: the family's published config; the case's variant applied
    either way) must have the stored config digest. ``weight_quant``
    defaults to the case's."""
    from audioldm2_torch import config as config_m, params as params_m
    from audioldm2_torch.pipeline import build_model

    meta = golden[case_name]["meta"]
    case = stored_case(meta)
    if cfg is None:
        cfg = case_config(case, compute_dtype, weight_quant)
    else:
        cfg = dataclasses.replace(variant_config(config_m.coerce(cfg), case.variant),
                                  compute_dtype=compute_dtype,
                                  weight_quant=weight_quant or case.weight_quant)
    if config_digest(dataclasses.replace(cfg, compute_dtype="float32", weight_quant=None)) \
            != meta["config_digest"]:
        raise ValueError(f"{case_name}: the port's {cfg.name} config is not the golden's")
    if tree is None:
        tree = params_m.draw_tree(cfg, meta["tree_seed"])
    digest = params_m.tree_digest(tree)
    if digest != meta["tree_digest"]:
        raise ValueError(f"{case_name}: the drawn tree's digest {digest} is not the golden's "
                         f"{meta['tree_digest']}")
    return build_model(config=cfg, params=tree, device=device)


def int8_unet(params, cfg):
    """(:func:`params.tree_digest`, count of int8 leaves) of the UNet tree
    an int8 request serves (``latent_diffusion.served_unet`` of the cast
    weights), keyed by the JAX package's leaf paths."""
    from audioldm2_torch.diffusion import latent_diffusion as ld
    from audioldm2_torch.params import cast_floating, tree_digest, tree_paths

    with torch.inference_mode():
        q = ld.served_unet(cast_floating(params["unet"], ld.compute_dtype(cfg)), cfg)
    return tree_digest(q), sum(1 for _, a in tree_paths(q) if a.dtype == torch.int8)


def request_batch(model, case: Case, g: Dict):
    """The case's batch from the port's ``make_batch`` (an audio-in case's
    waveforms through it), raising if its ids are not the golden's."""
    waves = (case_waves(case, model.cfg.preprocessing.sampling_rate)
             if case.variant is not None else None)
    batch = model.make_batch(case.prompt, transcription=case.transcription,
                             batchsize=case.batchsize, waveform=waves)
    for k, v in batch_ids(batch).items():
        want = g.get("ids/" + k)
        if want is None or want.shape != v.shape or not np.array_equal(want, v):
            raise ValueError(f"{case.prompt!r}: make_batch's {k} is not the golden's (tokenizer "
                             "fallback or phonemizer differs)")
    return batch


def encode(model, g: Dict) -> torch.Tensor:
    """``model``'s ``encode_mel`` of a golden case's input mel with its
    posterior noise."""
    dev = model.device
    return model.ldm.encode_mel(None, torch.from_numpy(g["mel_in"]).to(dev),
                                noise=torch.from_numpy(g["posterior_noise"]).to(dev))


def encode_distance(model, case_name: str, golden: Dict) -> float:
    """``z0_rel`` of :func:`encode` alone."""
    return rel(_np(encode(model, golden[case_name])), golden[case_name]["z0"])


def run(model, case_name: str, golden: Dict, around_request: Callable = contextlib.nullcontext,
        stages: bool = True) -> Dict:
    """One request of the case on ``model`` against the golden: the ids
    (raising if they differ), then (inside ``around_request()``) the case's
    mode: ``ldm.generate`` from the stored x_T at eta 0 with the case's
    sampler; ``sr``, ``encode_mel`` of the golden's input mel with its
    posterior noise, the inpainting mask (raising if it is not the
    golden's) and ``ldm.generate`` with the mask blend's stored noise;
    ``edit``, the same encode, then ``ldm.edit`` with the stored encode
    noise. An int8 case in f32 first raises if the served UNet tree's digest
    or int8 leaf count is not JAX's (``int8_leaves``). Returns the
    distances: the port's input mel (``mel_in_max``) and kaldi fbank
    (``fbank_max``), both max |d|; the encoded and the noised latents
    (``z0_rel``, ``z_t_rel``); the GPT-2 sequence (``seq_rel``; where there
    is one), each context slot (``ctx{i}_rel``), the FiLM y (``y_rel``),
    the final latent (``latent_rel``), all max|d| / max|golden|;
    ``mel_mae``, ``mel_max`` (max |d|), ``wav_mae``; the scores
    (``scores_max``) and ``same_pick`` on a reranked case; with ``stages``,
    each stage on the golden's own input (``eps0_rel``: the first step's
    guided eps at x_T where stored, and ``eps0_unet_rel`` the same on the
    golden's conditioning, the UNet alone; ``decode_mel_mae``: the VAE
    decode of the golden latent; ``vocoder_wav_mae``: the vocoder on the
    golden mel). Conditioning runs no kernel, so it is compared outside the
    request's count."""
    from audioldm2_torch import pipeline
    from audioldm2_torch.diffusion import ddim as ddim_m, latent_diffusion as ld
    from audioldm2_torch.diffusion.schedule import make_ddim_params

    g = golden[case_name]
    meta = g["meta"]
    case = stored_case(meta)
    if case.mode not in MODES:
        raise ValueError(f"{case_name}: unknown mode {case.mode!r}")
    cfg = model.cfg
    dev = model.device
    d: Dict = {"case": case_name, "family": case.family, "mode": case.mode,
               "sampler": case.sampler, "dtype": cfg.compute_dtype,
               "weight_quant": cfg.weight_quant, "steps": case.steps, "n_gen": case.n_gen,
               "batchsize": case.batchsize}
    if cfg.weight_quant == "int8" and cfg.compute_dtype == "float32" \
            and "unet_int8_digest" in meta:
        digest, n8 = int8_unet(model.ldm.params, cfg)
        if (digest, n8) != (meta["unet_int8_digest"], meta["unet_int8_leaves"]):
            raise ValueError(f"{case_name}: the port's int8 UNet tree ({n8} int8 leaves, digest "
                             f"{digest}) is not JAX's ({meta['unet_int8_leaves']}, "
                             f"{meta['unet_int8_digest']})")
        d["int8_leaves"] = n8
        d["int8_ulp_mel_mae"] = meta["int8_ulp_mel_mae"]
    batch = request_batch(model, case, g)
    if "ta_kaldi_fbank" in g:
        d["fbank_max"] = float(np.abs(_np(batch["ta_kaldi_fbank"]) - g["ta_kaldi_fbank"]).max())
    if case.mode in ("sr", "edit"):
        d["mel_in_max"] = float(np.abs(encode_input(model, case) - g["mel_in"]).max())
    lt = latent_t_size(cfg, case)
    xt = torch.from_numpy(g["x_T"]).to(dev) if "x_T" in g else None
    conds, latents, z_ts = [], [], []
    t0 = time.perf_counter()
    with around_request(), recorded(ld, "encode_conditioning", conds), \
            recorded(ld, "decode_latent", latents, arg=2), \
            recorded(ddim_m, "stochastic_encode", z_ts):
        if case.mode == "generate":
            wav, mel = model.ldm.generate(batch, None, lt, n_gen=case.n_gen,
                                          guidance=case.guidance, ddim_steps=case.steps,
                                          ddim_eta=ETA, sampler=case.sampler, x_T=xt)
        else:
            z0 = encode(model, g)
            if case.mode == "sr":
                mask = pipeline.latent_inpaint_mask(z0.shape, SR_TIME_MASK, SR_FREQ_MASK)
                if not np.array_equal(mask.numpy(), g["mask"]):
                    raise ValueError(f"{case_name}: the inpainting mask is not the golden's")
                batch.update(inpaint_mask=mask.to(dev), inpaint_x0=z0)
                wav, mel = model.ldm.generate(
                    batch, None, lt, n_gen=case.n_gen, guidance=case.guidance,
                    ddim_steps=case.steps, ddim_eta=ETA, use_mask=True, sampler=case.sampler,
                    x_T=xt, mask_noise=torch.from_numpy(g["mask_noise"]).to(dev))
            else:
                wav, mel = model.ldm.edit(batch, None, z0, case.t_enc, ddim_steps=case.steps,
                                          guidance=case.guidance,
                                          noise=torch.from_numpy(g["encode_noise"]).to(dev))
    d["generate_s"] = round(time.perf_counter() - t0, 3)
    if case.mode != "generate":
        d["z0_rel"] = rel(_np(z0), g["z0"])
    if case.mode == "edit":
        d["z_t_rel"] = rel(_np(z_ts[0]), g["z_t"])
    (y, contexts, masks), _ = conds[0]
    # every conditioner but CLAP's (FiLM) fills the next context slot; the
    # generated sequence (its slot's cond rows) is compared first, so that a
    # drift in the token loop is named as such
    slots = [s.kind for s in cfg.conditioners if s.kind != "clap"]
    rows = case.batchsize * case.n_gen
    if "sequence_gen" in slots:
        i = slots.index("sequence_gen")
        d["seq_rel"] = rel(_np(contexts[i])[-rows:], g[f"ctx{i}"][-rows:])
    for i, (c, m) in enumerate(zip(contexts, masks)):
        if not np.array_equal(_np(m), g[f"mask{i}"]):
            raise ValueError(f"{case_name}: the context mask of slot {i} is not the golden's")
        want = g[f"ctx{i}"]
        d[f"ctx{i}_rel"] = rel(_np(c)[:, :want.shape[1]], want)
    if y is not None:
        d["y_rel"] = rel(_np(y), g["y"])
    d["latent_rel"] = rel(_np(latents[0])[g["latent_rows"]], g["latent"])
    dm = np.abs(mel - g["mel"])
    d["mel_mae"] = float(dm.mean())
    d["mel_max"] = float(dm.max())
    d["mel_mean_abs"] = float(np.abs(g["mel"]).mean())
    if case.n_gen > 1:
        wav_kept = pipeline.rerank_and_select(model, wav, case.prompt, 1, case.n_gen)
        sim = model.last_similarities
        d["scores"] = [float(s) for s in sim]
        d["scores_max"] = float(np.abs(sim - g["scores"]).max())
        d["pick"] = int(np.argmax(sim))
        d["same_pick"] = d["pick"] == int(g["pick"])
        d["wav_mae"] = float(np.abs(wav_kept[0] - g["wav"][0]).mean())
    else:
        d["wav_mae"] = float(np.abs(wav - g["wav"]).mean())
    if stages:
        with torch.inference_mode():
            p = model.ldm.params
            if "eps0" in g:
                eps_fn, _ = ld.guided_eps_fn(p, cfg, batch, case.n_gen, case.guidance)
                t0_ = int(make_ddim_params(model.ldm.schedule, case.steps, ETA)[0][-1])
                tb = torch.full((xt.shape[0],), t0_, dtype=torch.int32, device=dev)
                d["eps0_rel"] = rel(_np(eps_fn(xt, tb)), g["eps0"])
                # the UNet alone: the same eps on the golden's own conditioning
                n_slots = sum(1 for k in g if k.startswith("ctx"))
                ctx = [torch.from_numpy(g[f"ctx{i}"]).to(dev) for i in range(n_slots)]
                masks = [torch.from_numpy(g[f"mask{i}"][:, :c.shape[1]]).to(dev)
                         for i, c in enumerate(ctx)]
                y_g = torch.from_numpy(g["y"]).to(dev) if "y" in g else None
                eps_g = ld.conditioned_eps_fn(p, cfg, y_g, ctx, masks, case.guidance)
                d["eps0_unet_rel"] = rel(_np(eps_g(xt, tb)), g["eps0"])
            rows = g["latent_rows"]
            _, mel_d = ld.decode_latent(p, cfg, torch.from_numpy(g["latent"]).to(dev))
            d["decode_mel_mae"] = float(np.abs(_np(mel_d) - g["mel"][rows]).mean())
            from audioldm2_torch.models import vocoder
            from audioldm2_torch.params import cast_floating
            voc = cast_floating(p["vocoder"], ld.compute_dtype(cfg))
            mel_g = torch.from_numpy(g["mel"][g["wav_rows"]][..., 0]).to(dev)
            w = vocoder.apply_vocoder(voc, cfg.vocoder, mel_g.to(ld.compute_dtype(cfg)))
            d["vocoder_wav_mae"] = float(np.abs(_np(w) - g["wav"]).mean())
    return d


def check(case_name: str, device="cuda", compute_dtype: str = "float32",
          weight_quant: Optional[str] = None, golden: Optional[Dict] = None,
          stages: bool = True, cfg=None) -> Dict:
    """Rebuild the case's tree (the digest must match), build the port's
    model on ``device`` and return :func:`run`'s distances for the case's
    mode."""
    golden = load() if golden is None else golden
    model = build(case_name, device, golden, compute_dtype, weight_quant, cfg=cfg)
    return run(model, case_name, golden, stages=stages)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--case", nargs="*", default=None, help="default: every stored case")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    golden = load()
    bad = 0
    for name in args.case or list(golden):
        d = check(name, args.device, golden=golden)
        d["mel_mae_limit"] = f32_limit(name, d.get("int8_ulp_mel_mae"))
        if "z0_rel" in d:
            d["z0_rel_limit"] = z0_limit(name)
        d["ok"] = f32_ok(d)
        bad += not d["ok"]
        print(json.dumps(d), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
