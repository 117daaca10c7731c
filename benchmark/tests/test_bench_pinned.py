"""What the cells draw, pinned: the request stream of each mix and the
weights of each configuration, as the benchmark drew them before prompts
could carry a transcription. A change that moves one moves every number
of those cells, so these hold them where they were.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402
import torch  # noqa: E402

import tiny  # noqa: E402
from a2bench import manifest, traffic, weights  # noqa: E402
from a2bench.reference import config as rc  # noqa: E402
from a2bench.reference import layout  # noqa: E402

SEED = 3_000_000_017
# (index in traffic/captions.txt, request seed) of the first 16 requests
STREAM = [(20, 477305515), (49, 857694850), (1, 1949407186), (22, 980489698),
          (46, 1733623070), (7, 1519696325), (39, 852754870), (30, 1818257356),
          (8, 965874883), (27, 1661659658), (40, 1851594220), (19, 867473326),
          (44, 2124447762), (43, 946572960), (14, 743499608), (10, 2135652372)]
WARMUP = (0, 1270274224)
TINY_TREES = {"full": "ae59dcea0d0f561270ce348a3e13a438fe6c0290bec776494068db89ac379c1d",
              "k48": "f90d1adb877ded4fb6d586ce212050375b90508cbcae9e6d565dfe0f13b9fddc"}
LAYOUTS = {"audioldm2-full": "81669fe1bd2e3e4d5e73c894da2ac3b6f9f4360bf59d9bc8c0a413c77185b85a",
           "audioldm_48k": "216875d9859f1cf7d63e76d21e2509192839342c0d1b36aa1de77ae084f5ffb9"}


def _digest(tree, values: bool) -> str:
    """SHA-256 over each leaf's path and shape and, with ``values``, its
    dtype and bytes."""
    h = hashlib.sha256()
    for path, leaf in weights.leaves(tree):
        if not values:
            h.update(("/".join(map(str, path)) + str(tuple(leaf.shape))).encode())
            continue
        h.update("/".join(map(str, path)).encode())
        h.update(str(leaf.dtype).encode())
        h.update(str(tuple(leaf.shape)).encode())
        t = leaf.detach().cpu().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell", ["full.batch24", "k48.batch8"])
def test_the_request_stream_is_pinned(cell):
    c = manifest.Cell(manifest.load(), cell)
    prompts = c.prompts()
    captions = [caption for caption, _ in prompts]
    stream = traffic.requests(c.mix, prompts, SEED)
    got = [next(stream) for _ in range(len(STREAM))]
    assert [(captions.index(caption), rseed) for caption, _, rseed in got] == STREAM
    assert all(transcription == "" for _, transcription, _ in got)
    caption, transcription, wseed = traffic.warmup(prompts, SEED)
    assert (captions.index(caption), wseed) == WARMUP and transcription == ""


@pytest.mark.parametrize("kind", sorted(TINY_TREES))
def test_the_drawn_weights_are_pinned(kind):
    cell, _ = tiny.tiny_cell(kind)
    tree = weights.make(rc.from_dict(cell.config_file["config"]), SEED, "cpu")
    assert _digest(tree, values=True) == TINY_TREES[kind]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_the_published_layout_is_pinned(name):
    entry = {c["name"]: c for c in manifest.load()["configs"]}[name]
    with open(os.path.join(tiny.ROOT, entry["file"])) as f:
        cfg = rc.from_dict(json.load(f)["config"])
    assert _digest(layout.model(cfg), values=False) == LAYOUTS[name]
