"""The plain reference against the program's plain CPU path at a tiny width.

Both sides run in float32 on the same bf16-valued weights, so every stage
agrees to float32 rounding: the whole run (conditioning, the CFG DDIM loop
from the same draws, the VAE decode, the vocoder, the rerank and its pick)
through ``harness.run``, the tree's layout leaf for leaf, and the phoneme
ids of every transcription the benchmark holds.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import tiny  # noqa: E402
from a2bench import harness, traffic, weights  # noqa: E402
from a2bench.reference import conditioning, layout, rerank  # noqa: E402
from a2bench.reference import config as rc  # noqa: E402

F32_LIMITS = {"cond_rel": 1e-5, "latent_rel": 1e-4, "mel_rms": 1e-5, "wav_rms": 1e-6,
              "returned_mismatch": 0, "sim_abs": 1e-5, "pick_mismatch": 0}


@pytest.mark.parametrize("name", ["audioldm2-full", "audioldm_48k",
                                  "audioldm2-speech-gigaspeech"])
def test_layout_is_the_programs_tree(name):
    from audioldm2_torch import config as pc
    from audioldm2_torch import params as pp

    pcfg = pc.default_audioldm_config(name)
    rcfg = rc.from_dict(json.loads(json.dumps(rc.to_dict(pcfg))))
    mine = {"/".join(map(str, p)): tuple(leaf.shape)
            for p, leaf in weights.leaves(layout.model(rcfg))}
    theirs = {k: tuple(v.shape) for k, v in pp.tree_paths(
        pp.init_params(pcfg, torch.Generator().manual_seed(0), "meta"))}
    assert mine == theirs


def test_weights_are_seeded_and_live():
    cell, pcfg = tiny.tiny_cell("k48")
    rcfg = rc.from_dict(cell.config_file["config"])
    a, b = weights.make(rcfg, 2**31 + 11, "cpu"), weights.make(rcfg, 2**31 + 11, "cpu")
    c = weights.make(rcfg, 2**31 + 12, "cpu")
    for (pa, la), (_, lb), (_, lc) in zip(weights.leaves(a), weights.leaves(b),
                                          weights.leaves(c)):
        assert torch.equal(la, lb) and not torch.equal(la, lc), pa
        assert la.abs().max() > 0, pa
        assert la.dtype == (torch.bfloat16 if pa[0] in weights.BF16_SUBTREES else torch.float32)


def _f32_cell(kind, **kw):
    cell, pcfg = tiny.tiny_cell(kind, **kw)
    pcfg = dataclasses.replace(pcfg, compute_dtype="float32")
    cell.config_file["config"]["compute_dtype"] = "float32"
    cell.limits = {k: v for k, v in F32_LIMITS.items()
                   if kw.get("candidates", 1) > 1 or k not in ("sim_abs", "pick_mismatch")}
    return cell, pcfg


@pytest.mark.parametrize("kind,kw", [("full", dict(batchsize=2)),
                                     ("k48", dict(batchsize=1, candidates=3, rows=2)),
                                     ("tts", dict(batchsize=2))])
def test_reference_agrees_with_the_plain_program(kind, kw):
    torch.set_num_threads(4)
    cell, pcfg = _f32_cell(kind, **kw)
    result = harness.run(cell, pcfg, 3_000_000_021, 0.1, False, "cpu", time.perf_counter())
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert result["correct"], checks
    assert set(checks) == set(cell.limits)
    assert result["failed"] == 0 and result["attempted"] >= 1


def test_a_speech_configuration_without_transcriptions_is_refused():
    cell, pcfg = tiny.tiny_cell("tts")
    cell.mix["captions"] = "captions.txt"
    result = harness.run(cell, pcfg, 3_000_000_023, 0.1, False, "cpu", time.perf_counter())
    assert isinstance(result, str) and "transcription" in result, result


EDGE_TRANSCRIPTIONS = ["", "Dr. Smith and Mrs. Jones", "A <b>tag</b>   and   spaces",
                       "Forty two is 42, a symbol outside the table", "word " * 80]


def test_reference_phoneme_ids_are_the_programs():
    """Every transcription of the prompts file, and a few edges (none, an
    abbreviation, a tag, digits outside the symbol table, past 310), reads
    the program's ids; no line of the file holds a symbol outside the table
    or passes 310."""
    from audioldm2_torch.utils import text

    path = os.path.join(tiny.BENCH, "traffic", "speech_prompts.txt")
    lines = [t for _, t in traffic.read_prompts(path)]
    assert len(lines) >= 40 and all(lines)
    for t in lines + EDGE_TRANSCRIPTIONS:
        phonemes = conditioning.text_to_phonemes(t) if t else ""
        want = text.phoneme_ids([text.text_to_phonemes(t) if t else ""] * 2)
        got = conditioning.phoneme_ids(phonemes, 310)
        assert got.shape == (1, 310) and np.array_equal(np.tile(got, (2, 1)), want), t
        if t in lines:
            assert np.count_nonzero(got) == len(phonemes) + 1 <= 310, t


def test_rerank_resample_agrees():
    """The CLAP rerank of 16 kHz clips (the resample the 48 kHz cells skip)."""
    from audioldm2_torch.models import clap
    from audioldm2_torch.utils import text

    torch.set_num_threads(4)
    pcfg = tiny._program_config("k48")
    rcfg = rc.from_dict(json.loads(json.dumps(rc.to_dict(pcfg))))
    tree = weights.make(rcfg, 77, "cpu")["reranker_clap"]
    wav = torch.randn(2, 16000, generator=torch.Generator().manual_seed(0)) * 0.1
    ids, mask = text.clap_tokenizer(pcfg.reranker_clap)(["rain on a roof"] * 2)
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    want = clap.rerank_score(tree, pcfg.reranker_clap, 16000, wav, ids, mask)
    got = rerank.similarities(tree, rcfg.reranker_clap, 16000, wav, ids, mask)
    assert torch.allclose(got, want, atol=1e-5), (got, want)
