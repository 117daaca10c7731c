"""audioldm2_torch: the AudioLDM2 prompt -> waveform path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``audioldm2_tpu`` (the JAX reference, which stays beside it).
The port imports neither jax nor audioldm2_tpu: it keeps its own copies of
the host modules it needs (config, diffusion schedule, tokenizers, wav IO).

Public surface: build_model, text_to_audio, super_resolution_and_inpainting,
save_wave, read_wav_file, round_up_duration, default_audioldm_config. The t5
family (audioldm_16k_crossattn_t5), audioldm2-full and
audioldm2-full-large-1150k run, each in bf16 or in the int8 serving mode
(``build_model(weight_quant="int8")``), with the DDIM, PLMS and DDPM
samplers and the CLAP rerank of ``n_candidate_gen_per_text`` candidates.
"""

from audioldm2_torch.config import CHECKPOINT_NAMES, default_audioldm_config
from audioldm2_torch.utils.audio_io import read_wav_file, save_wave
from audioldm2_torch.pipeline import (build_model, round_up_duration,
                                      super_resolution_and_inpainting, text_to_audio)

__all__ = [
    "build_model",
    "text_to_audio",
    "super_resolution_and_inpainting",
    "save_wave",
    "read_wav_file",
    "round_up_duration",
    "default_audioldm_config",
    "CHECKPOINT_NAMES",
]
