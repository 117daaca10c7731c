"""audioldm2_torch: the AudioLDM2 prompt -> waveform path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``audioldm2_tpu`` (the JAX reference, which stays beside it).
The port imports the JAX package's jax-free host modules (config,
diffusion schedule, tokenizers, wav IO) and never imports jax.

Public surface: build_model, text_to_audio, save_wave, round_up_duration,
default_audioldm_config. Only the t5 family (audioldm_16k_crossattn_t5)
runs so far.
"""

from audioldm2_tpu.config import CHECKPOINT_NAMES, default_audioldm_config
from audioldm2_tpu.utils.audio_io import save_wave
from audioldm2_torch.pipeline import build_model, round_up_duration, text_to_audio

__all__ = [
    "build_model",
    "text_to_audio",
    "save_wave",
    "round_up_duration",
    "default_audioldm_config",
    "CHECKPOINT_NAMES",
]
