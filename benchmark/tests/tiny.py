"""Cells of the benchmark at a tiny width, for runs on the CPU.

``tiny_cell("full")``, ``tiny_cell("k48")`` and ``tiny_cell("tts")`` are
audioldm2-full, audioldm_48k and audioldm2-speech-gigaspeech in miniature
(a small UNet, VAE, vocoder, FLAN-T5, phoneme encoder and one GPT-2
layer; CLAP at its fixed published width, the only one the program has)
with a mix of the cells' kind at two DDIM steps; the speech cell's mix
reads ``traffic/speech_prompts.txt``, the others' ``captions.txt``. Each
returns the cell (the attributes ``harness.run`` reads) and the program's
config.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from a2bench import traffic  # noqa: E402
from a2bench.reference import config as rc  # noqa: E402

# the published phoneme encoder's vocabulary, window and pad length at a
# small width
TINY_PHONEME = dict(hidden_channels=16, filter_channels=32, n_heads=2, n_layers=2)


def _program_config(kind: str):
    from audioldm2_torch import config as pc

    unet = pc.UNetConfig(in_channels=4, out_channels=4, model_channels=32, num_res_blocks=1,
                         attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16)
    vae = pc.VAEConfig(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                       mel_bins=16)
    vocoder = pc.VocoderConfig(num_mels=16, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                               upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                               resblock_dilation_sizes=((1, 3),), sampling_rate=64)
    # 4 latent frames a second, 8 mel frames, hop 8: 64 samples a second
    pre = pc.PreprocessingConfig(sampling_rate=64, filter_length=16, hop_length=8,
                                 win_length=16, n_mel_channels=16, mel_fmin=0.0, mel_fmax=32.0)
    clap = pc.CLAPConfig()
    if kind == "k48":
        return pc.ModelConfig(
            name="tiny-48k", preprocessing=pre, vae=vae, vocoder=vocoder,
            unet=dataclasses.replace(unet, context_dims=(None,), extra_film_condition_dim=512),
            conditioners=(pc.ConditionerSpec(name="film_clap_cond1", kind="clap", clap=clap),),
            latent_t_size=8, latent_f_size=8, latent_channels=4, latent_t_per_second=4.0)
    if kind == "tts":
        phoneme = pc.ConditionerSpec(name="crossattn_vits_phoneme", kind="phoneme",
                                     cond_stage_key="phoneme_idx",
                                     phoneme=pc.PhonemeEncoderConfig(**TINY_PHONEME))
        seqgen = pc.ConditionerSpec(
            name="crossattn_audiomae_generated", kind="sequence_gen", cond_stage_key="all",
            sequence_gen=pc.SequenceGenConfig(
                sequence_gen_length=4,
                sequence_input_keys=("film_clap_cond1", "crossattn_vits_phoneme"),
                sequence_input_embed_dims=(512, TINY_PHONEME["hidden_channels"]),
                gpt2=pc.GPT2Config(n_layer=1)),
            nested=(pc.ConditionerSpec(name="film_clap_cond1", kind="clap", clap=clap), phoneme))
        return pc.ModelConfig(
            name="tiny-tts", preprocessing=pre, vae=vae, vocoder=vocoder,
            unet=dataclasses.replace(unet, context_dims=(768,)), conditioners=(seqgen,),
            latent_t_size=8, latent_f_size=8, latent_channels=4, latent_t_per_second=4.0)
    t5 = pc.FlanT5Config(d_model=64, d_kv=16, d_ff=96, num_layers=2, num_heads=4,
                         max_length=16)
    t5_spec = pc.ConditionerSpec(name="crossattn_flan_t5", kind="flan_t5", flan_t5=t5)
    seqgen = pc.ConditionerSpec(
        name="crossattn_audiomae_generated", kind="sequence_gen", cond_stage_key="all",
        sequence_gen=pc.SequenceGenConfig(
            sequence_gen_length=3, sequence_input_keys=("film_clap_cond1", "crossattn_flan_t5"),
            sequence_input_embed_dims=(512, 64), gpt2=pc.GPT2Config(n_layer=1)),
        nested=(pc.ConditionerSpec(name="film_clap_cond1", kind="clap", clap=clap), t5_spec))
    return pc.ModelConfig(
        name="tiny-full", preprocessing=pre, vae=vae, vocoder=vocoder,
        unet=dataclasses.replace(unet, context_dims=(768, 64)),
        conditioners=(seqgen, t5_spec),
        latent_t_size=8, latent_f_size=8, latent_channels=4, latent_t_per_second=4.0)


def tiny_cell(kind: str, candidates: int = 1, batchsize: int = 2, rows: int = 1):
    """(cell, program config) of a tiny cell: ``kind`` "full", "k48" or
    "tts"."""
    pcfg = _program_config(kind)
    config = json.loads(json.dumps(rc.to_dict(pcfg)))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = "request_s" if candidates > 1 else "audio_s_per_s"
    mix = {"batchsize": batchsize, "n_candidate_gen_per_text": candidates, "ddim_steps": 2,
           "guidance_scale": 3.5, "duration": 2.0, "duration_bucket": 2.5,
           "captions": "speech_prompts.txt" if kind == "tts" else "captions.txt",
           "warmup_ddim_steps": 2, "check": {"rows": rows}}
    limits = {"cond_rel": 1e-5, "latent_rel": 1e-2, "mel_rms": 1e-2, "wav_rms": 1e-3,
              "returned_mismatch": 0}
    if candidates > 1:
        limits.update({"sim_abs": 1e-5, "pick_mismatch": 0})
    cell = types.SimpleNamespace(
        name=f"tiny.{kind}", chips=1, entry={}, config_entry={"file": "(tiny)"},
        config_file={"model_name": pcfg.name, "config": config}, mix=mix, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if m["name"] in (e2e, "setup_s")],
        per_layer=[],
        prompts=lambda: traffic.read_prompts(os.path.join(BENCH, "traffic", mix["captions"])))
    return cell, pcfg
