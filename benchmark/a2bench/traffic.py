"""The traffic generator: the requests of one closed-loop client.

A mix (``traffic/<name>.json``) fixes every request's sizes (batch,
candidates, steps, guidance, duration) and names the prompts file
(``captions``); the run's seed fixes the order of the prompts and each
request's own seed. Every seed gives the same sizes; only the prompts and
the draws move, and a request's work does not depend on its prompt (T5,
CLAP and the phoneme ids pad to their fixed lengths, the sequence
generator always makes its tokens).

A prompts file holds one prompt a line: the caption, or the caption, a
tab and the transcription that a speech configuration speaks. Blank lines
and lines that start with ``#`` are skipped.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

Prompt = Tuple[str, str]  # (caption, transcription; "" where the line has none)

MIX_KEYS = ("batchsize", "n_candidate_gen_per_text", "ddim_steps", "guidance_scale",
            "duration", "duration_bucket", "captions", "warmup_ddim_steps", "check")


def check_mix(mix: Dict) -> None:
    missing = [k for k in MIX_KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")


def rng(seed: int, stream: int) -> np.random.Generator:
    """The run's generator number ``stream`` (0: requests, 1: the check)."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed), stream])))


def read_prompts(path: str) -> List[Prompt]:
    """The prompts of a prompts file, in its order."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            caption, _, transcription = line.partition("\t")
            out.append((caption.strip(), transcription.strip()))
    return out


def requests(mix: Dict, prompts: List[Prompt], seed: int) -> Iterator[Tuple[str, str, int]]:
    """(caption, transcription, request seed) of each request in turn: the
    prompts in an order drawn from ``seed``, cycled, and a 31-bit seed for
    each request. A transcription comes from its prompt's line and takes
    no draw, so a file without transcriptions gives the same stream as
    one of captions alone."""
    check_mix(mix)
    r = rng(seed, 0)
    order = r.permutation(len(prompts))
    i = 0
    while True:
        caption, transcription = prompts[order[i % len(prompts)]]
        yield caption, transcription, int(r.integers(0, 2 ** 31 - 1))
        i += 1


def warmup(prompts: List[Prompt], seed: int) -> Tuple[str, str, int]:
    """The set-up's request: the first prompt, a seed of its own."""
    caption, transcription = prompts[0]
    return caption, transcription, int(rng(seed, 2).integers(0, 2 ** 31 - 1))
