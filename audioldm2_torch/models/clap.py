"""CLAP text and audio embeddings and the rerank scorer, in PyTorch.

Port of ``audioldm2_tpu/models/clap.py``: a text tower (RoBERTa, BERT,
BART or the CLIP transformer) and an audio tower (HTSAT, ``models/htsat.py``,
or PANN CNN14 / CNN10, ``models/pann.py``), each projected through a
two-layer MLP into the joint space and L2-normalized ([B, 1, D] text
embeddings, [B, D] audio embeddings); the contrastive heads
(``text_transform``, ``audio_transform``, the two logit scales) are drawn
so that the tree matches the JAX ``init_clap``, and nothing reads them.
:func:`rerank_score` is the JAX ``_rerank_score``: the sinc resample to the
CLAP rate as one strided conv over the phase bank, the repeat-pad clip
fit, both embeddings and their cosine similarity, in f32 with TF32 off.
:func:`audio_embedding_long` embeds audio longer than one clip window by
window.

Towers are looked up by ``CLAPConfig.tmodel`` / ``amodel`` in
:data:`TEXT_TOWERS` and :data:`AUDIO_TOWERS` (the JAX registries);
``register_text_tower`` / ``register_audio_tower`` add variants, as the
JAX registries' do.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audioldm2_torch.config import CLAPConfig
from audioldm2_torch.models import clip_text, htsat, pann, roberta
from audioldm2_torch.ops import nn
from audioldm2_torch.ops.nn import full_f32
from audioldm2_torch.params import Init
from audioldm2_torch.utils.audio_io import resample, sinc_interp_hann_kernel

# name: (config factory, width feeding the projection)
TEXT_TOWERS: Dict[str, Tuple[Callable[[], object], int]] = {
    "roberta": (roberta.RobertaConfig, 768),
    "bert": (lambda: roberta.RobertaConfig(vocab_size=30522, max_position_embeddings=512,
                                           type_vocab_size=2, pad_token_id=0), 768),
    "bart": (lambda: roberta.RobertaConfig(max_position_embeddings=1026), 768),
    "transformer": (clip_text.CLIPTextConfig, 512),
}
AUDIO_TOWERS: Dict[str, Tuple[Callable[[], object], int]] = {
    "HTSAT-tiny": (lambda: htsat.HTSATConfig(embed_dim=96, depths=(2, 2, 6, 2)), 768),
    "HTSAT-base": (htsat.HTSATConfig, 1024),
    "HTSAT-large": (lambda: htsat.HTSATConfig(embed_dim=256), 2048),
    "PANN-14": (pann.PANNConfig, 2048),
    "PANN-10": (lambda: pann.PANNConfig(variant="cnn10", embed_dim=1024), 1024),
}


def register_text_tower(name: str, cfg_factory, width: int) -> None:
    TEXT_TOWERS[name] = (cfg_factory, width)


def register_audio_tower(name: str, cfg_factory, width: int) -> None:
    AUDIO_TOWERS[name] = (cfg_factory, width)


def text_tower(cfg: CLAPConfig):
    factory, width = TEXT_TOWERS[cfg.tmodel]
    return factory(), width


def audio_tower(cfg: CLAPConfig):
    factory, width = AUDIO_TOWERS[cfg.amodel]
    return factory(), width


def _is_pann(cfg: CLAPConfig) -> bool:
    return not cfg.amodel.startswith("HTSAT")


def init_clap(ini: Init, cfg: CLAPConfig):
    """The JAX ``init_clap`` tree: both towers, both projections, the heads."""
    tcfg, twidth = text_tower(cfg)
    acfg, awidth = audio_tower(cfg)
    d = cfg.embed_dim
    text_branch = (clip_text.init_clip_text(ini, tcfg) if cfg.tmodel == "transformer"
                   else roberta.init_roberta(ini, tcfg))
    return {
        "text_branch": text_branch,
        "text_projection": {"lin1": ini.linear(twidth, d), "lin2": ini.linear(d, d)},
        "text_transform": {"lin1": ini.linear(d, d), "lin2": ini.linear(d, d)},
        "audio_transform": {"lin1": ini.linear(d, d), "lin2": ini.linear(d, d)},
        "logit_scale_a": torch.tensor(float(np.log(1 / 0.07)), device=ini.device),
        "logit_scale_t": torch.tensor(float(np.log(1 / 0.07)), device=ini.device),
        "audio_projection": {"lin1": ini.linear(awidth, d), "lin2": ini.linear(d, d)},
        "audio_branch": (pann.init_pann(ini, acfg) if _is_pann(cfg)
                         else htsat.init_htsat(ini, acfg)),
    }


def _project(p, x):
    return nn.linear(p["lin2"], torch.relu(nn.linear(p["lin1"], x)))


def _normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def text_embedding(params, cfg: CLAPConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor) -> torch.Tensor:
    """Text tower -> its pooling (RoBERTa's and BERT's pooler, BART's mean
    over positions, the transformer's EOT features) -> MLP projection -> L2
    norm; [B, 1, embed_dim]."""
    tcfg, _ = text_tower(cfg)
    p = params["text_branch"]
    if cfg.tmodel == "transformer":
        pooled = clip_text.apply_clip_text(p, tcfg, input_ids)
    elif cfg.tmodel == "bart":
        pooled = roberta.apply_bart_encoder(p, tcfg, input_ids, attention_mask).mean(dim=1)
    else:
        _, pooled = roberta.apply_roberta(p, tcfg, input_ids, attention_mask,
                                          bert_style=cfg.tmodel == "bert")
    return _normalize(_project(params["text_projection"], pooled))[:, None, :]


def audio_embedding(params, cfg: CLAPConfig, waveform_48k: torch.Tensor) -> torch.Tensor:
    """Audio tower embedding -> MLP projection -> L2 norm. waveform: [B, N]
    at the CLAP rate; returns [B, embed_dim]."""
    acfg, _ = audio_tower(cfg)
    if _is_pann(cfg):
        feats = pann.encode(params["audio_branch"], waveform_48k, acfg)["embedding"]
    else:
        feats = htsat.encode(params["audio_branch"], waveform_48k, acfg)
    return _normalize(_project(params["audio_projection"], feats))


def cos_similarity(audio_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine similarity of the embeddings, [B]."""
    a = audio_emb.reshape(audio_emb.shape[0], -1)
    t = text_emb.reshape(text_emb.shape[0], -1)
    return (_normalize(a) * _normalize(t)).sum(dim=-1)


def _fit_clip(wav48: torch.Tensor, clip: int) -> torch.Tensor:
    """The "repeatpad" clip fit of [B, N]: tile a short clip as many whole
    times as fits and zero-pad the rest; cut a long one."""
    n = wav48.shape[-1]
    if n < clip:
        wav48 = wav48.repeat(1, max(1, clip // n))
        return F.pad(wav48, (0, clip - wav48.shape[-1]))
    return wav48[:, :clip]


def prepare_clap_audio(wav: np.ndarray, orig_sr: int, cfg: CLAPConfig) -> np.ndarray:
    """Host-side waveform prep: resample to the CLAP rate and fit to one
    clip. wav: [B, N] (or [B, 1, N]) -> [B, clip_samples] float32."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 3:
        wav = wav[:, 0]
    wav48 = wav if orig_sr == cfg.sampling_rate else resample(wav, orig_sr, cfg.sampling_rate)
    wav48 = torch.from_numpy(np.asarray(wav48, np.float32))
    return _fit_clip(wav48, cfg.clip_samples).contiguous().numpy()


def resample_sinc(wav: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """The reference's sinc_interp_hann resample on the device: the
    [n_phase, K] phase bank applied as one strided conv1d (f32, TF32 off).
    wav: [B, N] -> [B, ceil(N * new / orig)]."""
    if orig_sr == target_sr:
        return wav
    kernel, orig, new, width = sinc_interp_hann_kernel(orig_sr, target_sr)
    n_in = wav.shape[-1]
    n_out = -(-n_in * new // orig)
    n_frames = -(-n_out // new)
    pad_r = (n_frames - 1) * orig + kernel.shape[1] - width - n_in
    x = F.pad(wav.float()[:, None, :], (width, max(0, pad_r)))
    bank = torch.from_numpy(kernel).to(wav.device)[:, None, :]
    with full_f32():
        out = F.conv1d(x, bank, stride=orig)  # [B, n_phase, n_frames]
    return out.transpose(1, 2).reshape(wav.shape[0], -1)[:, :n_out]


def prepare_clap_audio_device(wav: torch.Tensor, orig_sr: int, cfg: CLAPConfig) -> torch.Tensor:
    """:func:`prepare_clap_audio` on the device: resample and clip fit."""
    return _fit_clip(resample_sinc(wav, orig_sr, cfg.sampling_rate), cfg.clip_samples)


@torch.inference_mode()
def rerank_score(params, cfg: CLAPConfig, orig_sr: int, wav: torch.Tensor,
                 ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Cosine similarity [B] of each waveform (at ``orig_sr``) with its
    prompt's tokens: resample, clip fit, audio and text embeddings, in f32
    with TF32 off (the reranker's weights stay f32)."""
    with full_f32():
        a = audio_embedding(params, cfg, prepare_clap_audio_device(wav.float(), orig_sr, cfg))
        t = text_embedding(params, cfg, ids, mask)[:, 0]
        return cos_similarity(a, t)


def cos_similarity_waveform_text(params, cfg: CLAPConfig, wav, text: str, tokenizer,
                                 sampling_rate: int) -> np.ndarray:
    """The rerank scorer on host inputs: each row of ``wav`` ([B, N] or
    [B, 1, N] at ``sampling_rate``) against ``text``; numpy [B]."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 3:
        wav = wav[:, 0]
    ids, mask = tokenizer([text] * wav.shape[0])
    dev = params["audio_projection"]["lin1"]["w"].device
    return rerank_score(params, cfg, int(sampling_rate), torch.from_numpy(wav).to(dev),
                        torch.as_tensor(ids, device=dev),
                        torch.as_tensor(mask, device=dev)).cpu().numpy()


def sliding_windows(wav: np.ndarray, clip_samples: int, hopsize: int) -> np.ndarray:
    """[N] -> [n_windows, clip_samples]: a short clip tiled whole times and
    zero-padded to one window; a long one in windows every ``hopsize``
    samples plus the last ``clip_samples``."""
    n = wav.shape[-1]
    k = clip_samples // max(n, 1)
    if k > 1:
        wav = np.tile(wav, k)
        n = wav.shape[-1]
    if n <= clip_samples:
        out = np.zeros((1, clip_samples), wav.dtype)
        out[0, :n] = wav
        return out
    starts = range(0, n - clip_samples, min(hopsize, n))
    return np.stack([wav[p:p + clip_samples] for p in starts] + [wav[-clip_samples:]])


def audio_embedding_long(params, cfg: CLAPConfig, wav, hopsize: int = 240000) -> torch.Tensor:
    """The audio embedding [n_windows, embed_dim] of each
    :func:`sliding_windows` window of ``wav`` ([N] at the CLAP rate)."""
    wins = sliding_windows(np.asarray(wav, np.float32), cfg.clip_samples, hopsize)
    dev = params["audio_projection"]["lin1"]["w"].device
    return audio_embedding(params, cfg, torch.from_numpy(wins).to(dev))
