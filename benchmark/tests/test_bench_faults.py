"""The check of ``correct`` fails a broken timed path and the control.

A tiny cell runs through ``harness.run`` on the CPU (the look for the
card skipped) with the program's bf16 path, once sound and once with each
fault the cells can have planted in the program underneath: a sampler
whose steps leave the state unchanged, half of the batch left out of the
decode, a waveform altered where the vocoder makes it, and, with
candidates, the rerank's pick altered. The limits are set above the
sound run's own readings at this size; each fault has to come out not
correct. The control (the reference in TF32 for the conditioning and the
rerank, in float8 for the loop, the decode and the vocoder) has to read
above the sound program and fail its limits.
"""

import os
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
def full_cell():
    cell, pcfg = tiny.tiny_cell("full", batchsize=4, rows=2)
    sound = _run(cell, pcfg)
    cell.limits = _limits_above(sound)
    return cell, pcfg


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


FAULTS = {
    "step_returns_state_unchanged": ("audioldm2_torch.diffusion.ddim", "ddim_sample",
                                     _frozen_sampler),
    "half_batch_left_out": ("audioldm2_torch.diffusion.latent_diffusion", "decode_latent",
                            _half_decode),
    "answer_altered": ("audioldm2_torch.models.vocoder", "apply_vocoder", _silence_first_clip),
}


def test_sound_run_is_correct(full_cell):
    cell, pcfg = full_cell
    assert _run(cell, pcfg)["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(full_cell, fault, monkeypatch):
    import importlib

    cell, pcfg = full_cell
    module_name, attr, make = FAULTS[fault]
    module = importlib.import_module(module_name)
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    result = _run(cell, pcfg)
    assert not result["correct"], result["checks"]


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
    caption, rseed = next(traffic.requests(cell.mix, cell.captions(), SEED))
    _, rows = check.sample(traffic.rng(SEED, 1), 1, cell.mix)
    sound = program.Program(pcfg, tree, "cpu")
    cap = sound.request(cell.mix, caption, rseed)
    sound.close()
    ref = check.Reference(rcfg, tree, "cpu")
    lower = check.numbers(ref, cap, cell.mix, rows, cell.limits)
    upper = check.control_numbers(ref, cap, cell.mix, rows)
    assert not check.judge(upper, {k: cell.limits[k] for k in upper})
    # TF32, the conditioning's and the rerank's control, exists only on the card
    for k in ("latent_rel", "mel_rms", "wav_rms"):
        assert upper[k] > lower[k], (k, upper[k], lower[k])
