"""SHA-256 of one short request's waveform on each served family, to show on
the card that a change keeps a family's outputs bit for bit.

    python -m audioldm2_torch.tools.output_digest [--steps 50] [--save DIR] [--deterministic]
    python -m audioldm2_torch.tools.output_digest --compare DIR_A DIR_B   # any machine

Each of the paths ``chip_smoke.py`` serves (t5, full, sr, full8, large, 48k,
tts) is built with ``build_model(seed=0, nonzero_init=True)`` on the card
(the weights ``chip_smoke.py`` draws) and answers one request: 10 s,
``--steps`` DDIM steps, seed 42, batch 1, one candidate (tts with a
transcription; sr through ``super_resolution_and_inpainting`` on a
synthesized 16 kHz wav), in f32 with TF32 off outside the bf16 UNet and
VAE, as ``chip_smoke.py`` runs. It prints each waveform's SHA-256 and each
tree's leaf count; ``--save DIR`` writes the waveforms as ``<path>.npy``.
``--deterministic`` sets ``torch.backends.cudnn.deterministic``. To compare
two trees, unpack the other into a gitignored directory, copy this file
into its ``audioldm2_torch/tools/`` and run both in one chip call; equal
digests mean equal waveforms, and ``--compare`` prints each path's largest
difference between two ``--save`` directories.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys
import tempfile
import time

PATHS = (("t5", "audioldm_16k_crossattn_t5"), ("full", "audioldm2-full"),
         ("sr", "audioldm2-full"), ("full8", "audioldm2-full"),
         ("large", "audioldm2-full-large-1150k"), ("48k", "audioldm_48k"),
         ("tts", "audioldm2-speech-gigaspeech"))
PROMPT = "A dog barking in the distance."
TRANSCRIPTION = "The quick brown fox jumps over the lazy dog, twice."


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _wav(path: str, sr: int, seconds: float) -> str:
    import numpy as np
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds)) / sr
    x = 0.5 * np.sin(2 * np.pi * (0.01 * sr * t + 0.44 * sr * t ** 2 / (2 * seconds)))
    wavfile.write(path, sr, (x * 32767).astype(np.int16))
    return path


def run(steps: int, save=None, deterministic: bool = False, log=print):
    import numpy as np
    import torch
    import audioldm2_torch as at

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = _wav(os.path.join(tmp, "in.wav"), 16000, 10.0)
        for tag, name in PATHS:
            cfg = at.default_audioldm_config(name)
            if tag == "full8":
                cfg = dataclasses.replace(cfg, weight_quant="int8")
            t0 = time.perf_counter()
            model = at.build_model(config=cfg, device="cuda", seed=0, nonzero_init=True)
            kw = dict(seed=42, ddim_steps=steps, duration=10.0, batchsize=1,
                      n_candidate_gen_per_text=1)
            if tag == "sr":
                wav = at.super_resolution_and_inpainting(
                    model, PROMPT, original_audio_file_path=wav_path, **kw)
            else:
                wav = at.text_to_audio(model, PROMPT,
                                       transcription=TRANSCRIPTION if tag == "tts" else "", **kw)
            if save:
                np.save(os.path.join(save, f"{tag}.npy"), wav)
            n_leaves = sum(1 for _ in _leaves(model.ldm.params))
            out[tag] = {"wave_sha256": hashlib.sha256(wav.tobytes()).hexdigest(),
                        "shape": list(wav.shape), "leaves": n_leaves}
            log(f"{tag}: {name}, {n_leaves} leaves, waveform {wav.shape} SHA-256 "
                f"{out[tag]['wave_sha256']} ({time.perf_counter() - t0:.1f} s)")
            del model
            torch.cuda.empty_cache()
    return out


def compare(dir_a: str, dir_b: str, log=print):
    """max |a - b| per path between two ``--save`` directories."""
    import numpy as np

    out = {}
    for tag, _ in PATHS:
        a, b = (np.load(os.path.join(d, f"{tag}.npy")) for d in (dir_a, dir_b))
        out[tag] = float(np.abs(a - b).max())
        log(f"{tag}: max |a - b| {out[tag]:.6e} (rms of a {float(np.sqrt(np.mean(a ** 2))):.6f})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--save", help="write each waveform here as <path>.npy")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.backends.cudnn.deterministic = True")
    ap.add_argument("--compare", nargs=2, metavar="DIR",
                    help="compare two --save directories and exit")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("output_digest: no CUDA device", file=sys.stderr)
        return 2
    if args.save:
        os.makedirs(args.save, exist_ok=True)
    run(args.steps, args.save, args.deterministic)
    return 0


if __name__ == "__main__":
    sys.exit(main())
