"""Command-line interface of the port, flag for flag the JAX package's
(``audioldm2_tpu/cli.py``, itself the reference ``audioldm2`` CLI's):

    python -m audioldm2_torch -t "A dog barking" --model_name audioldm_16k_crossattn_t5
    python -m audioldm2_torch --mode sr_inpainting -f in.wav -t "..."
    python -m audioldm2_torch -tl prompts.lst      # one prompt per line, "prompt|name"

The same options, dests, defaults, choices and types; the same TTS switch
(``--transcription`` on a non-speech family moves to
audioldm2-speech-gigaspeech), the audioldm2-* families fixed at 10 s, the
output folder ``<save_path>/<time>`` and the file names. ``-d/--device``,
which the JAX CLI parses and ignores, chooses the device: ``auto`` is the
CUDA card and raises without one; ``cpu`` or ``cuda:N`` must be asked for.
There is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

MODEL_NAMES = [
    "audioldm2-full",
    "audioldm2-full-large-1150k",
    "audioldm2-music-665k",
    "audioldm_48k",
    "audioldm_16k_crossattn_t5",
    "audioldm2-speech-ljspeech",
    "audioldm2-speech-gigaspeech",
]


def get_time() -> str:
    return time.strftime("%d_%m_%Y_%H_%M_%S", time.localtime())


def read_list(fname: str):
    with open(fname, "r", encoding="utf-8") as f:
        return [line.strip("\n") for line in f.readlines()]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="audioldm2-torch")
    parser.add_argument(
        "--mode", type=str, default="generation", choices=["generation", "sr_inpainting"],
        help="generation: text-to-audio; sr_inpainting: super-resolution/inpainting",
    )
    parser.add_argument("-t", "--text", type=str, default="", help="text prompt")
    parser.add_argument("--transcription", type=str, default="",
                        help="transcription for text-to-speech")
    parser.add_argument("-tl", "--text_list", type=str, default="",
                        help="file with one prompt per line (prompt|name supported)")
    parser.add_argument("-s", "--save_path", type=str, default="./output")
    parser.add_argument("--model_name", type=str, default="audioldm2-full", choices=MODEL_NAMES)
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="path to a reference .pth checkpoint")
    parser.add_argument("-b", "--batchsize", type=int, default=1)
    parser.add_argument("--ddim_steps", type=int, default=200)
    parser.add_argument("-gs", "--guidance_scale", type=float, default=3.5)
    parser.add_argument("-dur", "--duration", type=float, default=10.0)
    parser.add_argument("-n", "--n_candidate_gen_per_text", type=int, default=3)
    parser.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "plms", "ddpm"],
                        help="ddim (default) | plms | ddpm (full 1000-step ancestral)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("-f", "--file_path", type=str, default=None,
                        help="input audio for sr_inpainting")
    parser.add_argument("-d", "--device", type=str, default="auto",
                        help="auto: the CUDA card (an error without one); cpu or cuda:N")
    return parser


def resolve_device(name: str):
    """``auto`` -> the current CUDA device, refused without one; any other
    name as torch reads it."""
    import torch

    if name != "auto":
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError("-d auto runs on a CUDA device and none is available; pass -d cpu "
                           "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def main(argv=None) -> int:
    import torch

    from audioldm2_torch.pipeline import (build_model, super_resolution_and_inpainting,
                                          text_to_audio)
    from audioldm2_torch.utils.audio_io import save_wave

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    save_path = os.path.join(args.save_path, get_time())
    text = args.text
    duration = args.duration
    sample_rate = 16000
    if "audioldm2" in args.model_name:
        # the audioldm2-* families are 10 s only (reference __main__.py:150-153)
        duration = 10
    if "48k" in args.model_name:
        sample_rate = 48000

    transcription = args.transcription
    if transcription:
        if "speech" not in args.model_name:
            print("Warning: TTS via --transcription needs a speech checkpoint; "
                  "switching to audioldm2-speech-gigaspeech")
            args.model_name = "audioldm2-speech-gigaspeech"
        if not text:
            text = "A female reporter is speaking full of emotion"

    os.makedirs(save_path, exist_ok=True)
    model = build_model(ckpt_path=args.ckpt_path, model_name=args.model_name, device=device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    print(f"audioldm2_torch: {args.model_name} on {device} ({where})", flush=True)

    if args.text_list:
        print("Generate audio based on the text prompts in %s" % args.text_list)
        prompt_todo = read_list(args.text_list)
    else:
        prompt_todo = [text]

    for text in prompt_todo:
        if "|" in text:
            text, name = text.split("|")
        else:
            name = text[:128]
        if transcription:
            name += "-TTS-%s" % transcription
        common = dict(transcription=transcription, seed=args.seed, duration=duration,
                      guidance_scale=args.guidance_scale, ddim_steps=args.ddim_steps,
                      n_candidate_gen_per_text=args.n_candidate_gen_per_text,
                      batchsize=args.batchsize, sampler=args.sampler)
        if args.mode == "generation":
            waveform = text_to_audio(model, text, **common)
        else:
            if args.file_path is None or not os.path.exists(args.file_path):
                raise FileNotFoundError(
                    "The original audio file '%s' does not exist" % args.file_path)
            waveform = super_resolution_and_inpainting(
                model, text, original_audio_file_path=args.file_path, **common)
        save_wave(waveform, save_path, name=name, samplerate=sample_rate)
    return 0
