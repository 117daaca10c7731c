"""Typed configuration system of the port.

The port's own copy of ``audioldm2_tpu/config.py`` (same classes, fields,
defaults and presets; a test holds ``default_audioldm_config`` equal field
for field for every checkpoint name), plus :func:`coerce`, which rebuilds
any dataclass config with the same field names (such as the JAX
package's) into these classes.

The reference builds every sub-model through reflection over nested dicts with
dotted ``target`` class paths (reference ``audioldm2/utils.py:103-114,221-703``).
Here the same seven checkpoint families are described by plain frozen
dataclasses and a typed conditioner registry: the conditioner *name* still
encodes its UNet wiring (``film`` / ``crossattn`` / ``concat`` / ``noncond``
substring contract, reference ``ddpm.py:1833-1865``) and its *order* defines
the UNet cross-attention context-slot order (reference ``ddpm.py:647,1027-1032``).

Checkpoint families and their mutations mirror reference
``utils.py:116-192`` (``-large-`` -> context [768,1024,None] + depth 2;
``-speech-`` -> phoneme conditioning with 512-token GPT-2 sequence;
``48k`` -> FiLM-only CLAP conditioning; ``t5`` -> single T5 cross-attention).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

CHECKPOINT_NAMES = (
    "audioldm2-full",
    "audioldm2-full-large-1150k",
    "audioldm2-music-665k",
    "audioldm_48k",
    "audioldm_16k_crossattn_t5",
    "audioldm2-speech-gigaspeech",
    "audioldm2-speech-ljspeech",
)


# ---------------------------------------------------------------------------
# Audio frontend
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PreprocessingConfig:
    """Mirrors reference ``preprocessing`` block (utils.py:262-270, 432-448)."""

    sampling_rate: int = 16000
    max_wav_value: float = 32768.0
    duration: float = 10.24
    filter_length: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    n_mel_channels: int = 64
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0


# ---------------------------------------------------------------------------
# First stage (VAE) + vocoder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VAEConfig:
    """KL-VAE over mel spectrograms (reference autoencoder.py:18-128,
    modules/diffusionmodules/model.py:419-686)."""

    embed_dim: int = 8  # latent channels after quant_conv
    z_channels: int = 8
    in_channels: int = 1
    out_ch: int = 1
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    double_z: bool = True
    mel_bins: int = 64
    # levels using anisotropic (4x time, 2x freq) striding — reference
    # model.py:60-115 DownsampleTimeStride4/UpsampleTimeStride4
    downsample_time_stride4_levels: Tuple[int, ...] = ()

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@dataclass(frozen=True)
class VocoderConfig:
    """HiFi-GAN generator (reference hifigan/models.py:112-174,
    utilities/model.py:6-75)."""

    num_mels: int = 64
    upsample_rates: Tuple[int, ...] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 4, 4)
    upsample_initial_channel: int = 1024
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    sampling_rate: int = 16000
    # "1": dual-conv MRF blocks (shipped checkpoints); "2": single-conv
    # blocks of the v2 Generator (reference hifigan/models_v2.py:112-152)
    resblock: str = "1"


VOCODER_16K = VocoderConfig()
VOCODER_48K = VocoderConfig(
    num_mels=256,
    upsample_rates=(6, 5, 4, 2, 2),
    upsample_kernel_sizes=(12, 10, 8, 4, 4),
    upsample_initial_channel=1536,
    resblock_kernel_sizes=(3, 7, 11, 15),
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5), (1, 3, 5)),
    sampling_rate=48000,
)


# ---------------------------------------------------------------------------
# Score network (UNet)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UNetConfig:
    """2-D latent UNet (reference openaimodel.py:476-885).

    ``context_dims`` entries may be ``None`` — that slot gets a context-free
    (self-attention) SpatialTransformer; an extra leading context-free
    transformer always runs first (``extra_sa_layer``, openaimodel.py:488).
    """

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
        # FiLM embedding is concatenated with the time embedding, doubling the
        # embedding width everywhere (reference openaimodel.py:550-557,869-870).
        d = self.time_embed_dim
        return d * 2 if self.extra_film_condition_dim is not None else d


# ---------------------------------------------------------------------------
# Conditioners
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CLAPConfig:
    """CLAP text/audio embedder (reference encoders/modules.py:546-745 +
    clap/ subtree). Tower variants are config-selectable via ``amodel`` /
    ``tmodel`` — the typed analogue of the reference JSON model-config
    registry (clap/open_clip/factory.py:23-50); see
    ``models/clap.py:AUDIO_TOWERS/TEXT_TOWERS``."""

    embed_mode: str = "text"  # "text" | "audio"
    amodel: str = "HTSAT-base"  # HTSAT-tiny|HTSAT-base|HTSAT-large|PANN-14|PANN-10
    tmodel: str = "roberta"  # roberta | bert | bart | transformer
    sampling_rate: int = 48000
    embed_dim: int = 512
    # HTSAT-base (reference clap/open_clip/model_configs/HTSAT-base.json)
    audio_window: int = 1024
    audio_hop: int = 480
    audio_mels: int = 64
    audio_fmin: float = 50.0
    audio_fmax: float = 14000.0
    clip_samples: int = 480000
    # text tower
    text_model: str = "roberta-base"
    text_width: int = 768
    text_max_length: int = 512


@dataclass(frozen=True)
class FlanT5Config:
    """Frozen FLAN-T5-large encoder (reference encoders/modules.py:113-198).

    Weights come from the monolithic checkpoint; only the tokenizer is
    fetched from HF (``google/flan-t5-large``)."""

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
    gated_act: bool = True  # flan-t5 uses gated-gelu


@dataclass(frozen=True)
class PhonemeEncoderConfig:
    """VITS-style phoneme TextEncoder (reference encoders/modules.py:30-110,
    phoneme_encoder/encoder.py)."""

    vocab_size: int = 183
    pad_token_id: int = 0
    pad_length: int = 310
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    window_size: int = 4  # relative-position attention window


@dataclass(frozen=True)
class AudioMAEConfig:
    """Frozen AudioMAE ViT-B/16 encoder + (avg+max)/2 pooling conditioner
    (reference encoders/modules.py:303-543, modules/audiomae/)."""

    img_size: Tuple[int, int] = (1024, 128)
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    contextual_depth: int = 8
    eval_time_pooling: int = 8
    eval_freq_pooling: int = 8
    # training-time random pooling (reference modules.py:359-379/481-499):
    # tf_separated=False ties freq_pool to time_pool (CTPoolRand);
    # True samples them independently (CTPoolRandTFSeparated)
    time_pooling_factors: Tuple[int, ...] = (1, 2, 4, 8)
    freq_pooling_factors: Tuple[int, ...] = (1, 2, 4, 8)
    tf_separated: bool = False
    regularization: bool = False


@dataclass(frozen=True)
class GPT2Config:
    """GPT-2 base backbone for the "language of audio" sequence generator
    (reference audiomae_gen/sequence_input.py:68)."""

    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_positions: int = 1024
    layer_norm_epsilon: float = 1e-5


@dataclass(frozen=True)
class SequenceGenConfig:
    """Sequence2AudioMAE: projects input conditions to 768-d, wraps each with
    learned SOS/EOS tokens, and autoregressively generates
    ``sequence_gen_length`` continuous AudioMAE-like tokens with GPT-2
    (reference encoders/modules.py:201-300, audiomae_gen/sequence_input.py)."""

    sequence_gen_length: int = 8
    sequence_input_keys: Tuple[str, ...] = ("film_clap_cond1", "crossattn_flan_t5")
    sequence_input_embed_dims: Tuple[int, ...] = (512, 1024)
    gpt2: GPT2Config = field(default_factory=GPT2Config)
    max_context: int = 1024


@dataclass(frozen=True)
class ConditionerSpec:
    """One entry of the conditioning stack.

    ``name`` carries the UNet wiring contract via substring
    (film/crossattn/concat/noncond) and the stack order defines context-slot
    order — same semantics as the reference ``cond_stage_config`` dict.
    ``kind`` selects the typed implementation from the registry.
    """

    name: str
    kind: str  # clap | flan_t5 | phoneme | audiomae_pooled | sequence_gen
    cond_stage_key: str = "text"  # which batch entry feeds it ("all" = whole batch)
    clap: Optional[CLAPConfig] = None
    flan_t5: Optional[FlanT5Config] = None
    phoneme: Optional[PhonemeEncoderConfig] = None
    audiomae: Optional[AudioMAEConfig] = None
    sequence_gen: Optional[SequenceGenConfig] = None
    # nested conditioning stack (used by sequence_gen)
    nested: Tuple["ConditionerSpec", ...] = ()


# ---------------------------------------------------------------------------
# Latent diffusion + top-level model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DiffusionConfig:
    """DDPM schedule parameters (reference ddpm.py:201-303)."""

    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    parameterization: str = "eps"


@dataclass(frozen=True)
class ModelConfig:
    name: str = "audioldm2-full"
    # Compute dtype for the hot path (UNet/VAE/vocoder). bfloat16 maps convs
    # and matmuls onto the MXU at full rate (fp32 runs at ~1/4 on v5e);
    # normalizations and sampler math always stay float32.
    compute_dtype: str = "bfloat16"
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    vocoder: VocoderConfig = field(default_factory=lambda: VOCODER_16K)
    unet: UNetConfig = field(default_factory=UNetConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    conditioners: Tuple[ConditionerSpec, ...] = ()
    latent_t_size: int = 256
    latent_f_size: int = 16
    latent_channels: int = 8
    latent_t_per_second: float = 25.6
    # evaluation defaults (reference utils.py:345-349)
    guidance_scale: float = 3.5
    ddim_steps: int = 200
    n_candidates: int = 3
    # CLAP reranker embedded at the DDPM level (reference ddpm.py:114-120)
    reranker_clap: Optional[CLAPConfig] = field(default_factory=CLAPConfig)
    # Opt-in serving quantization: "int8" stores the UNet spatial-transformer
    # matmul weights as int8 with per-output-channel scales, streamed at half
    # the bf16 bytes and dequantized only inside the Pallas matmul kernels
    # (ops/quant.py). None = full-precision weights (default; parity tests
    # always run with None).
    weight_quant: Optional[str] = None


def _clap_spec(name: str = "film_clap_cond1") -> ConditionerSpec:
    return ConditionerSpec(name=name, kind="clap", cond_stage_key="text", clap=CLAPConfig())


def _t5_spec(name: str = "crossattn_flan_t5") -> ConditionerSpec:
    return ConditionerSpec(name=name, kind="flan_t5", cond_stage_key="text", flan_t5=FlanT5Config())


def _audiomae_spec(eval_time_pooling: int, eval_freq_pooling: int) -> ConditionerSpec:
    return ConditionerSpec(
        name="crossattn_audiomae_pooled",
        kind="audiomae_pooled",
        cond_stage_key="ta_kaldi_fbank",
        audiomae=AudioMAEConfig(
            eval_time_pooling=eval_time_pooling, eval_freq_pooling=eval_freq_pooling
        ),
    )


def _seqgen_tta_spec() -> ConditionerSpec:
    """TTA sequence generator: CLAP + T5 -> GPT-2, 8 generated tokens
    (reference utils.py:350-402)."""
    return ConditionerSpec(
        name="crossattn_audiomae_generated",
        kind="sequence_gen",
        cond_stage_key="all",
        sequence_gen=SequenceGenConfig(
            sequence_gen_length=8,
            sequence_input_keys=("film_clap_cond1", "crossattn_flan_t5"),
            sequence_input_embed_dims=(512, 1024),
        ),
        nested=(_clap_spec(), _t5_spec(), _audiomae_spec(8, 8)),
    )


def _seqgen_tts_spec() -> ConditionerSpec:
    """TTS sequence generator: CLAP + phoneme -> GPT-2, 512 generated tokens
    (reference utils.py:121-187)."""
    return ConditionerSpec(
        name="crossattn_audiomae_generated",
        kind="sequence_gen",
        cond_stage_key="all",
        sequence_gen=SequenceGenConfig(
            sequence_gen_length=512,
            sequence_input_keys=("film_clap_cond1", "crossattn_vits_phoneme"),
            sequence_input_embed_dims=(512, 192),
        ),
        nested=(
            _clap_spec(),
            ConditionerSpec(
                name="crossattn_vits_phoneme",
                kind="phoneme",
                cond_stage_key="phoneme_idx",
                phoneme=PhonemeEncoderConfig(),
            ),
            _audiomae_spec(1, 1),
        ),
    )


def default_audioldm_config(model_name: str = "audioldm2-full") -> ModelConfig:
    """Typed analogue of reference ``default_audioldm_config`` (utils.py:116-192)."""
    if "48k" in model_name:
        return ModelConfig(
            name=model_name,
            preprocessing=PreprocessingConfig(
                sampling_rate=48000,
                filter_length=2048,
                hop_length=480,
                win_length=2048,
                n_mel_channels=256,
                mel_fmin=20.0,
                mel_fmax=24000.0,
            ),
            vae=VAEConfig(embed_dim=16, z_channels=16, ch_mult=(1, 2, 4, 8), mel_bins=256),
            vocoder=VOCODER_48K,
            unet=UNetConfig(
                in_channels=16,
                out_channels=16,
                context_dims=(None,),
                extra_film_condition_dim=512,
            ),
            conditioners=(_clap_spec(),),
            latent_t_size=128,
            latent_f_size=32,
            latent_channels=16,
            latent_t_per_second=12.8,
        )

    if "t5" in model_name:
        return ModelConfig(
            name=model_name,
            unet=UNetConfig(context_dims=(1024,)),
            conditioners=(_t5_spec(),),
        )

    if "-speech-" in model_name:
        return ModelConfig(
            name=model_name,
            unet=UNetConfig(context_dims=(768,)),
            conditioners=(_seqgen_tts_spec(),),
        )

    unet = UNetConfig(context_dims=(768, 1024))
    if "-large-" in model_name:
        unet = UNetConfig(context_dims=(768, 1024, None), transformer_depth=2)
    return ModelConfig(
        name=model_name,
        unet=unet,
        conditioners=(_seqgen_tta_spec(), _t5_spec()),
    )


def replace(cfg, **kwargs):
    """dataclasses.replace passthrough (convenience for tests)."""
    return dataclasses.replace(cfg, **kwargs)


def coerce(cfg, cls=None):
    """``cfg`` as an instance of this module's class of the same name
    (``ModelConfig`` unless ``cls`` says otherwise), rebuilt field by field
    and recursively through nested configs and tuples of them. Takes any
    dataclass instance whose class name and field names match one of this
    module's config classes (the JAX package's configs do); raises
    TypeError for anything else."""
    cls = cls or ModelConfig
    if isinstance(cfg, cls):
        return cfg
    if (not dataclasses.is_dataclass(cfg) or isinstance(cfg, type)
            or type(cfg).__name__ != cls.__name__):
        raise TypeError(f"expected a {cls.__name__} (or a dataclass with its fields), "
                        f"got {type(cfg).__name__}")
    want = [f.name for f in dataclasses.fields(cls)]
    got = [f.name for f in dataclasses.fields(cfg)]
    if sorted(want) != sorted(got):
        raise TypeError(f"{type(cfg).__name__} fields {got} differ from {cls.__name__}'s {want}")
    return cls(**{name: _coerce_value(getattr(cfg, name)) for name in want})


def _coerce_value(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        target = globals().get(type(v).__name__)
        if not (isinstance(target, type) and dataclasses.is_dataclass(target)):
            raise TypeError(f"no config class named {type(v).__name__} in the port")
        return coerce(v, target)
    if isinstance(v, tuple):
        return tuple(_coerce_value(x) for x in v)
    return v
