"""The GPT-2 sequence generator's spans (``models/sequence_gen.py`` on
``utils.profiling``) on the CPU: ``seqgen.prefix``, ``seqgen.prefill`` and
``seqgen.decode`` under ``conditioning`` in a speech request and in
audioldm2-full's, one ``seqgen.token`` step per generated token (counted
in ``last_timings`` and one range each in a trace), the device-time keys
with stand-in CUDA events, and outputs bit for bit the same inside and
outside a request."""

import json
import os

import pytest
import torch

import audioldm2_torch as at
from audioldm2_torch import config as config_m
from audioldm2_torch.models import sequence_gen
from audioldm2_torch.utils import profiling
from test_torch_full import tiny_full_config
from test_torch_spans import _Event
from test_torch_tts import TRANSCRIPTION, tiny_tts_config

torch.set_num_threads(2)

SEQGEN = ["seqgen.prefix", "seqgen.prefill", "seqgen.decode"]
KW = dict(seed=3, ddim_steps=2, duration=0.32, duration_bucket=None,
          n_candidate_gen_per_text=1)
CONFIGS = {"tts": tiny_tts_config, "full": tiny_full_config}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    cfg = config_m.coerce(CONFIGS[request.param]())
    return at.build_model(config=cfg, device="cpu", seed=0, nonzero_init=True)


def _request(model, **kw):
    return at.text_to_audio(model, "a man speaks", transcription=TRANSCRIPTION,
                            **{**KW, **kw})


def _gen_length(model) -> int:
    (spec,) = [s for s in model.cfg.conditioners if s.kind == "sequence_gen"]
    return spec.sequence_gen.sequence_gen_length


def test_generation_spans_nest_under_conditioning(model):
    _request(model)
    spans = model.last_spans
    (cond,) = [s for s in spans if s.name == "conditioning"]
    inner = [s for s in spans if s.name.startswith("seqgen.")]
    assert [s.name for s in inner] == SEQGEN
    assert all(s.parent == cond.id for s in inner)
    for a, b in zip(inner, inner[1:]):  # one after another, inside conditioning
        assert a.host_end_ns <= b.host_start_ns
    assert cond.host_start_ns <= inner[0].host_start_ns
    assert inner[-1].host_end_ns <= cond.host_end_ns
    assert [s.steps for s in inner] == [0, 0, _gen_length(model)]
    assert cond.steps == 0


def test_decode_counts_one_step_per_generated_token(model):
    _request(model)
    t = model.last_timings
    want = {"tiny-tts": 512, "tiny-full": 8}[model.cfg.name]
    assert t["seqgen_decode_steps"] == _gen_length(model) == want
    assert "seqgen_prefix_steps" not in t and "seqgen_prefill_steps" not in t
    assert t["sampler_steps"] == 2
    assert not [k for k in t if k.endswith("_device_s")]  # no device clock on the CPU


def test_trace_holds_one_token_range_per_token(model, tmp_path):
    log_dir = str(tmp_path)
    with profiling.trace(log_dir):
        _request(model)
    (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert all(len(ranges[n]) == 1 for n in SEQGEN)
    assert len(ranges["seqgen.token"]) == _gen_length(model)

    def within(inner, outer):
        return any(s <= inner[0] and inner[1] <= t for s, t in outer)

    assert all(within(r, ranges["seqgen.decode"]) for r in ranges["seqgen.token"])
    assert all(within(ranges[n][0], ranges["conditioning"]) for n in SEQGEN)


def test_outputs_are_bit_for_bit_the_same_inside_and_outside_a_request(model):
    (spec,) = [s for s in model.cfg.conditioners if s.kind == "sequence_gen"]
    params = model.ldm.params["cond"][spec.name]
    batch = model.make_batch("a man speaks", transcription=TRANSCRIPTION, batchsize=2)
    outside = sequence_gen.generate(params, spec, batch)
    with profiling.request("cpu") as req:
        inside = sequence_gen.generate(params, spec, batch)
    assert [s.name for s in req.spans] == ["request"] + SEQGEN
    assert torch.equal(inside, outside)

    def waveform(gen_seed):
        return model.ldm.generate(batch, torch.Generator().manual_seed(gen_seed),
                                  latent_t_size=8, ddim_steps=2)[0]

    bare = waveform(5)
    with profiling.request("cpu"):
        recorded = waveform(5)
    assert torch.equal(torch.as_tensor(recorded), torch.as_tensor(bare))
    # and through the pipeline, which always records
    assert (_request(model, seed=7) == _request(model, seed=7)).all()


def test_device_keys_with_stand_in_events(model, monkeypatch):
    """The CUDA path's records with stand-in events: each generation span
    gets its ``<span>_device_s`` and the decode its token count."""
    (spec,) = [s for s in model.cfg.conditioners if s.kind == "sequence_gen"]
    params = model.ldm.params["cond"][spec.name]
    batch = model.make_batch("a man speaks", transcription=TRANSCRIPTION)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    with profiling.request("cuda") as req:
        sequence_gen.generate(params, spec, batch)
    t = req.timings()
    assert set(t) == {"request_device_s", "seqgen_prefix_device_s", "seqgen_prefill_device_s",
                      "seqgen_decode_device_s", "seqgen_decode_steps"}
    assert t["seqgen_decode_steps"] == _gen_length(model)
