"""The check of ``correct`` fails a broken timed path and the control.

A tiny cell runs through ``harness.run`` on the CPU (the look for the
card skipped) with the program's bf16 path, once sound and once with each
fault the cells can have planted in the program underneath: a sampler
whose steps leave the state unchanged, half of the batch left out of the
decode, a waveform altered where the vocoder makes it, on a speech
configuration the transcription lost where the batch is made, and, with
candidates, the rerank's pick altered. The limits are set above the
sound run's own readings at this size; each fault has to come out not
correct. The control (the reference in TF32 for the conditioning and the
rerank, in float8 for the loop, the decode and the vocoder) has to read
above the sound program and fail its limits.
"""

import os
import pkgutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402
import torch  # noqa: E402

import tiny  # noqa: E402
from a2bench import check, harness, program, traffic, weights  # noqa: E402
from a2bench.reference import config as rc  # noqa: E402

SEED = 2_500_000_003


def _run(cell, pcfg):
    torch.set_num_threads(4)
    return harness.run(cell, pcfg, SEED, 0.1, False, "cpu", time.perf_counter())


def _limits_above(result):
    """Twice each sound reading (a floor of 1e-7), 0 for the exact counts."""
    out = {}
    for k, v in result["checks"].items():
        out[k] = 0 if k.endswith("mismatch") else max(2 * float(v["value"]), 1e-7)
    return out


@pytest.fixture(scope="module")
def cells():
    """kind -> (cell, program config) of a tiny cell at batch 4, its limits
    above its sound run's readings (each made once)."""
    made = {}

    def get(kind):
        if kind not in made:
            cell, pcfg = tiny.tiny_cell(kind, batchsize=4, rows=2)
            cell.limits = _limits_above(_run(cell, pcfg))
            made[kind] = cell, pcfg
        return made[kind]
    return get


@pytest.fixture(scope="module")
def full_cell(cells):
    return cells("full")


def _silence_first_clip(original):
    def vocoder(p, cfg, mel):
        wav = original(p, cfg, mel).clone()
        wav[0, : wav.shape[1] // 10] = 0.0
        return wav
    return vocoder


def _frozen_sampler(original):
    from audioldm2_torch.diffusion import ddim

    def sample(eps_fn, shape, schedule, **kw):
        return ddim.initial_latent(shape, kw.get("x_T"), kw.get("generator"), kw.get("device"))
    return sample


def _half_decode(original):
    def decode(params, cfg, z):
        half = z.shape[0] // 2
        wav, mel = original(params, cfg, z[:half])
        return torch.cat([wav, wav]), torch.cat([mel, mel])
    return decode


def _transcription_lost(original):
    def make_batch(self, text, transcription="", *args, **kwargs):
        return original(self, text, "", *args, **kwargs)
    return make_batch


# fault -> (the cell's kind, the owner of the function, its name, the fault
# made from the original, the number that has to read above its limit)
FAULTS = {
    "step_returns_state_unchanged": ("full", "audioldm2_torch.diffusion.ddim", "ddim_sample",
                                     _frozen_sampler, None),
    "half_batch_left_out": ("full", "audioldm2_torch.diffusion.latent_diffusion",
                            "decode_latent", _half_decode, None),
    "answer_altered": ("full", "audioldm2_torch.models.vocoder", "apply_vocoder",
                       _silence_first_clip, None),
    "transcription_lost": ("tts", "audioldm2_torch.pipeline:AudioLDM2", "make_batch",
                           _transcription_lost, "cond_rel"),
}


@pytest.mark.parametrize("kind", ["full", "tts"])
def test_sound_run_is_correct(cells, kind):
    cell, pcfg = cells(kind)
    assert _run(cell, pcfg)["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(cells, fault, monkeypatch):
    kind, owner, attr, make, number = FAULTS[fault]
    cell, pcfg = cells(kind)
    owner = pkgutil.resolve_name(owner)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    result = _run(cell, pcfg)
    assert not result["correct"], result["checks"]
    if number is not None:
        assert result["checks"][number]["value"] > cell.limits[number], result["checks"]


def test_altered_pick_is_not_correct(monkeypatch):
    from audioldm2_torch.models import clap

    cell, pcfg = tiny.tiny_cell("k48", batchsize=1, candidates=3, rows=2)
    sound = _run(cell, pcfg)
    cell.limits = _limits_above(sound)
    original = clap.rerank_score

    def reversed_scores(*args, **kwargs):
        s = original(*args, **kwargs)
        return -s  # the worst candidate ranks first

    monkeypatch.setattr(clap, "rerank_score", reversed_scores)
    result = _run(cell, pcfg)
    assert not result["correct"]
    assert result["checks"]["pick_mismatch"]["value"] >= 1


def test_control_reads_above_the_program(full_cell):
    cell, pcfg = full_cell
    torch.set_num_threads(4)
    rcfg = rc.from_dict(cell.config_file["config"])
    tree = weights.make(rcfg, SEED, "cpu")
    caption, transcription, rseed = next(traffic.requests(cell.mix, cell.prompts(), SEED))
    _, rows = check.sample(traffic.rng(SEED, 1), 1, cell.mix)
    sound = program.Program(pcfg, tree, "cpu")
    cap = sound.request(cell.mix, caption, rseed, transcription)
    sound.close()
    ref = check.Reference(rcfg, tree, "cpu")
    lower = check.numbers(ref, cap, cell.mix, rows, cell.limits)
    upper = check.control_numbers(ref, cap, cell.mix, rows)
    assert not check.judge(upper, {k: cell.limits[k] for k in upper})
    # TF32, the conditioning's and the rerank's control, exists only on the card
    for k in ("latent_rel", "mel_rms", "wav_rms"):
        assert upper[k] > lower[k], (k, upper[k], lower[k])
