"""The traffic generator: the requests of one closed-loop client.

A mix (``traffic/<name>.json``) fixes every request's sizes (batch,
candidates, steps, guidance, duration) and names the caption list; the
run's seed fixes the order of the captions and each request's own seed.
Every seed gives the same sizes; only the captions and the draws move, and
a request's work does not depend on its caption (T5 and CLAP pad to their
fixed lengths, the sequence generator always makes its tokens).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

MIX_KEYS = ("batchsize", "n_candidate_gen_per_text", "ddim_steps", "guidance_scale",
            "duration", "duration_bucket", "captions", "warmup_ddim_steps", "check")


def check_mix(mix: Dict) -> None:
    missing = [k for k in MIX_KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")


def rng(seed: int, stream: int) -> np.random.Generator:
    """The run's generator number ``stream`` (0: requests, 1: the check)."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed), stream])))


def requests(mix: Dict, captions: List[str], seed: int) -> Iterator[Tuple[str, int]]:
    """(caption, request seed) of each request in turn: the captions in an
    order drawn from ``seed``, cycled, and a 31-bit seed for each request."""
    check_mix(mix)
    r = rng(seed, 0)
    order = r.permutation(len(captions))
    i = 0
    while True:
        yield captions[order[i % len(captions)]], int(r.integers(0, 2 ** 31 - 1))
        i += 1


def warmup(captions: List[str], seed: int) -> Tuple[str, int]:
    """The set-up's request: the first caption, a seed of its own."""
    return captions[0], int(rng(seed, 2).integers(0, 2 ** 31 - 1))
