"""The reference's configuration classes, read from a configuration file.

A frozen copy of the fields of ``audioldm2_torch/config.py`` that the
reference reads, with the same names and meanings, built from the nested
dict a file under ``benchmark/configs/`` holds (``from_dict``). RoBERTa
(``roberta-base``) and HTSAT-base are the only CLAP towers here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class PreprocessingConfig:
    sampling_rate: int = 16000
    max_wav_value: float = 32768.0
    duration: float = 10.24
    filter_length: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    n_mel_channels: int = 64
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0


@dataclass(frozen=True)
class VAEConfig:
    embed_dim: int = 8
    z_channels: int = 8
    in_channels: int = 1
    out_ch: int = 1
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    double_z: bool = True
    mel_bins: int = 64
    downsample_time_stride4_levels: Tuple[int, ...] = ()


@dataclass(frozen=True)
class VocoderConfig:
    num_mels: int = 64
    upsample_rates: Tuple[int, ...] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 4, 4)
    upsample_initial_channel: int = 1024
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    sampling_rate: int = 16000
    resblock: str = "1"


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 8
    model_channels: int = 128
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 4, 2)
    channel_mult: Tuple[int, ...] = (1, 2, 3, 5)
    num_head_channels: int = 32
    transformer_depth: int = 1
    context_dims: Tuple[Optional[int], ...] = (768, 1024)
    extra_film_condition_dim: Optional[int] = None
    extra_sa_layer: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4

    @property
    def emb_dim(self) -> int:
        d = self.time_embed_dim
        return d * 2 if self.extra_film_condition_dim is not None else d


@dataclass(frozen=True)
class CLAPConfig:
    embed_mode: str = "text"
    amodel: str = "HTSAT-base"
    tmodel: str = "roberta"
    sampling_rate: int = 48000
    embed_dim: int = 512
    audio_window: int = 1024
    audio_hop: int = 480
    audio_mels: int = 64
    audio_fmin: float = 50.0
    audio_fmax: float = 14000.0
    clip_samples: int = 480000
    text_model: str = "roberta-base"
    text_width: int = 768
    text_max_length: int = 512


@dataclass(frozen=True)
class FlanT5Config:
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    vocab_size: int = 32128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    max_length: int = 128
    gated_act: bool = True


@dataclass(frozen=True)
class PhonemeEncoderConfig:
    vocab_size: int = 183
    pad_token_id: int = 0
    pad_length: int = 310
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    window_size: int = 4


@dataclass(frozen=True)
class AudioMAEConfig:
    img_size: Tuple[int, int] = (1024, 128)
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    contextual_depth: int = 8
    eval_time_pooling: int = 8
    eval_freq_pooling: int = 8
    time_pooling_factors: Tuple[int, ...] = (1, 2, 4, 8)
    freq_pooling_factors: Tuple[int, ...] = (1, 2, 4, 8)
    tf_separated: bool = False
    regularization: bool = False


@dataclass(frozen=True)
class GPT2Config:
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_positions: int = 1024
    layer_norm_epsilon: float = 1e-5


@dataclass(frozen=True)
class SequenceGenConfig:
    sequence_gen_length: int = 8
    sequence_input_keys: Tuple[str, ...] = ("film_clap_cond1", "crossattn_flan_t5")
    sequence_input_embed_dims: Tuple[int, ...] = (512, 1024)
    gpt2: GPT2Config = field(default_factory=GPT2Config)
    max_context: int = 1024


@dataclass(frozen=True)
class ConditionerSpec:
    name: str
    kind: str
    cond_stage_key: str = "text"
    clap: Optional[CLAPConfig] = None
    flan_t5: Optional[FlanT5Config] = None
    phoneme: Optional[PhonemeEncoderConfig] = None
    audiomae: Optional[AudioMAEConfig] = None
    sequence_gen: Optional[SequenceGenConfig] = None
    nested: Tuple["ConditionerSpec", ...] = ()


@dataclass(frozen=True)
class DiffusionConfig:
    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    parameterization: str = "eps"


@dataclass(frozen=True)
class ModelConfig:
    name: str = "audioldm2-full"
    compute_dtype: str = "bfloat16"
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    unet: UNetConfig = field(default_factory=UNetConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    conditioners: Tuple[ConditionerSpec, ...] = ()
    latent_t_size: int = 256
    latent_f_size: int = 16
    latent_channels: int = 8
    latent_t_per_second: float = 25.6
    guidance_scale: float = 3.5
    ddim_steps: int = 200
    n_candidates: int = 3
    reranker_clap: Optional[CLAPConfig] = field(default_factory=CLAPConfig)
    weight_quant: Optional[str] = None


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 12, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    num_classes: int = 527
    mel_bins: int = 64
    sample_rate: int = 48000
    n_fft: int = 1024
    hop_size: int = 480
    fmin: float = 50.0
    fmax: float = 14000.0

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @property
    def grid(self) -> int:
        return self.spec_size // self.patch_stride


def text_tower(cfg: CLAPConfig):
    """(tower config, width feeding the projection) of the CLAP text tower."""
    if cfg.tmodel != "roberta":
        raise ValueError(f"CLAP text tower {cfg.tmodel!r} is not in the reference")
    return RobertaConfig(), 768


def audio_tower(cfg: CLAPConfig):
    """(tower config, width feeding the projection) of the CLAP audio tower."""
    if cfg.amodel != "HTSAT-base":
        raise ValueError(f"CLAP audio tower {cfg.amodel!r} is not in the reference")
    return HTSATConfig(), 1024


def _build(cls, value: Any):
    """``value`` (a nested dict of plain values) as an instance of ``cls``,
    lists as tuples, nested config fields as their classes."""
    if value is None:
        return None
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for name, v in value.items():
        if name not in hints:
            raise ValueError(f"{cls.__name__} has no field {name!r}")
        kwargs[name] = _field_value(cls, name, v)
    return cls(**kwargs)


_NESTED = {
    ("ModelConfig", "preprocessing"): PreprocessingConfig,
    ("ModelConfig", "vae"): VAEConfig,
    ("ModelConfig", "vocoder"): VocoderConfig,
    ("ModelConfig", "unet"): UNetConfig,
    ("ModelConfig", "diffusion"): DiffusionConfig,
    ("ModelConfig", "reranker_clap"): CLAPConfig,
    ("ConditionerSpec", "clap"): CLAPConfig,
    ("ConditionerSpec", "flan_t5"): FlanT5Config,
    ("ConditionerSpec", "phoneme"): PhonemeEncoderConfig,
    ("ConditionerSpec", "audiomae"): AudioMAEConfig,
    ("ConditionerSpec", "sequence_gen"): SequenceGenConfig,
    ("SequenceGenConfig", "gpt2"): GPT2Config,
}


def _tuple(v):
    return tuple(_tuple(x) for x in v) if isinstance(v, (list, tuple)) else v


def _field_value(cls, name: str, v):
    nested = _NESTED.get((cls.__name__, name))
    if nested is not None:
        return _build(nested, v)
    if (cls.__name__, name) in (("ModelConfig", "conditioners"), ("ConditionerSpec", "nested")):
        return tuple(_build(ConditionerSpec, s) for s in v)
    return _tuple(v)


def from_dict(d: Dict) -> ModelConfig:
    """The ModelConfig of a configuration file's ``"config"`` object."""
    return _build(ModelConfig, d)


def to_dict(cfg) -> Dict:
    """A config as plain nested dicts and lists (JSON's view of it)."""
    def plain(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return v
    return plain(cfg)
