"""audioldm2_torch: the AudioLDM2 prompt -> waveform path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``audioldm2_tpu`` (the JAX reference, which stays beside it).
The port imports neither jax nor audioldm2_tpu: it keeps its own copies of
the host modules it needs (config, diffusion schedule, tokenizers, wav IO).

Public surface: build_model, text_to_audio, super_resolution_and_inpainting,
seed_everything, save_wave, read_wav_file, round_up_duration,
default_audioldm_config, with the JAX package's signatures. All seven
checkpoint families run (the t5 family, audioldm2-full and -music-665k,
audioldm2-full-large-1150k, audioldm_48k and the two speech families),
each in bf16 or in the int8 serving mode
(``build_model(weight_quant="int8")``), with the DDIM, PLMS and DDPM
samplers and the CLAP rerank of ``n_candidate_gen_per_text`` candidates.
Audio in: ``AudioLDM2.make_batch(waveform=, fbank=)`` feeds the AudioMAE
conditioner and CLAP's audio embedding mode; every CLAP tower of the JAX
registry (HTSAT, PANN CNN14 / CNN10, RoBERTa, BERT, BART, the CLIP-BPE
transformer) is ported.

Training (``parallel.train``, ``parallel.ema``, ``utils.data``):
make_full_train_step, make_train_step, AdamW, AudioDataset, DatasetConfig,
the f32 latent-diffusion step with the hand kernels under autograd.

Entry points: ``python -m audioldm2_torch`` (``cli.py``, the JAX CLI's
flags; ``-d auto`` is the CUDA card) and the web demo
``audioldm2_torch.app``. Editing: ``LatentDiffusionModel.edit`` over
``diffusion.ddim.stochastic_encode`` and ``ddim_decode``.
"""

from audioldm2_torch.config import CHECKPOINT_NAMES, default_audioldm_config
from audioldm2_torch.utils.audio_io import read_wav_file, save_wave
from audioldm2_torch.pipeline import (build_model, round_up_duration, seed_everything,
                                      super_resolution_and_inpainting, text_to_audio)
from audioldm2_torch.parallel.train import AdamW, make_full_train_step, make_train_step
from audioldm2_torch.utils.data import AudioDataset, DatasetConfig

__all__ = [
    "build_model",
    "text_to_audio",
    "super_resolution_and_inpainting",
    "seed_everything",
    "save_wave",
    "read_wav_file",
    "round_up_duration",
    "default_audioldm_config",
    "CHECKPOINT_NAMES",
    "make_full_train_step",
    "make_train_step",
    "AdamW",
    "AudioDataset",
    "DatasetConfig",
]
