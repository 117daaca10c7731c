"""The port's stage spans (``audioldm2_torch.utils.profiling``) on the CPU:
a request's records, how they nest, the sampler's steps against its UNet
calls, the ranges a profiler trace holds, the device-time arithmetic with
stand-in CUDA events, and what ``last_timings`` exports."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import audioldm2_torch as at
from audioldm2_torch import config as config_m
from audioldm2_torch.diffusion import latent_diffusion as ld
from audioldm2_torch.models import conditioners
from audioldm2_torch.utils import profiling
from tiny import tiny_t5_model_config

torch.set_num_threads(2)

STAGES = ["tokenize", "conditioning", "prepare_unet", "sampler", "vae.decode", "vocoder",
          "to_host", "rerank"]
HOST_KEYS = {"tokenize_s", "generate_s", "rerank_s", "total_s", "x_realtime"}
KW = dict(duration=0.32, duration_bucket=None, n_candidate_gen_per_text=1)


@pytest.fixture(scope="module")
def model():
    # a 20-step schedule, so that DDPM's every-step trajectory stays short
    cfg = dataclasses.replace(config_m.coerce(tiny_t5_model_config()),
                              diffusion=config_m.DiffusionConfig(timesteps=20))
    return at.build_model(config=cfg, device="cpu", seed=0, nonzero_init=True)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_request_spans_nest_under_one_request(model):
    at.text_to_audio(model, "rain", seed=3, ddim_steps=4, **KW)
    spans = model.last_spans
    root = spans[0]
    assert root.name == "request" and root.parent is None
    assert [s.name for s in spans[1:]] == STAGES
    assert len({s.request for s in spans}) == 1
    assert len({s.id for s in spans}) == len(spans)
    for s in spans[1:]:
        assert s.parent == root.id
        assert root.host_start_ns <= s.host_start_ns <= s.host_end_ns <= root.host_end_ns
    for a, b in zip(spans[1:], spans[2:]):  # the stages run one after another
        assert a.host_end_ns <= b.host_start_ns
    assert _by_name(spans)["sampler"][0].steps == 4
    assert all(s.device_s is None for s in spans)  # no device clock on the CPU
    assert profiling._current.request is None


@pytest.mark.parametrize("sampler", ["ddim", "plms", "ddpm"])
def test_one_sampler_step_per_unet_forward(model, monkeypatch, sampler):
    calls = []
    apply_unet = ld.unet.apply_unet

    def counted(*args, **kwargs):
        calls.append(1)
        return apply_unet(*args, **kwargs)

    monkeypatch.setattr(ld.unet, "apply_unet", counted)
    at.text_to_audio(model, "rain", seed=1, ddim_steps=4, sampler=sampler, **KW)
    want = ld.unet_forwards(model.cfg, 4, sampler)
    assert len(calls) == want == model.last_timings["sampler_steps"]
    assert [s.steps for s in _by_name(model.last_spans)["sampler"]] == [want]


def test_sr_opens_vae_encode(model, tmp_path):
    sr = model.cfg.preprocessing.sampling_rate
    x = 0.3 * np.sin(2 * np.pi * 200 * np.arange(int(0.64 * sr)) / sr)
    path = str(tmp_path / "in.wav")
    wavfile.write(path, sr, (x * 32767).astype(np.int16))
    at.super_resolution_and_inpainting(model, "a chirp", original_audio_file_path=path,
                                       ddim_steps=4, duration=0.64,
                                       n_candidate_gen_per_text=1)
    spans = model.last_spans
    names = [s.name for s in spans]
    assert names[0] == "request" and "vae.encode" in names
    assert names.index("tokenize") < names.index("vae.encode") < names.index("conditioning")
    assert all(s.parent == spans[0].id for s in spans[1:])
    assert {"prepare_s", "generate_s", "sampler_steps"} <= set(model.last_timings)


def test_profiler_trace_holds_the_ranges_nested(model, tmp_path):
    log_dir = str(tmp_path)
    with profiling.trace(log_dir):
        at.text_to_audio(model, "rain", seed=2, ddim_steps=5, **KW)
    (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    for name in ["request"] + STAGES:
        assert len(ranges[name]) == 1, name
    assert len(ranges["sampler.step"]) == len(ranges["unet"]) == 5

    def within(inner, outer):
        return any(s <= inner[0] and inner[1] <= t for s, t in outer)

    assert all(within(r, ranges["sampler.step"]) for r in ranges["unet"])
    assert all(within(r, ranges["sampler"]) for r in ranges["sampler.step"])
    assert all(within(ranges[n][0], ranges["request"]) for n in STAGES)


def test_spans_outside_a_request_keep_nothing(model):
    at.text_to_audio(model, "rain", seed=3, ddim_steps=4, **KW)
    kept = list(model.last_spans)
    with profiling.span("conditioning"):
        assert profiling._current.request is None
    with profiling.step("sampler.step"):
        pass
    batch = model.make_batch("rain")
    model.ldm.generate(batch, None, latent_t_size=8, ddim_steps=4)
    assert model.last_spans == kept
    assert profiling._current.request is None


def test_an_exception_inside_a_span_leaves_no_open_span(model, monkeypatch):
    encode = conditioners.encode

    def fails(*args, **kwargs):
        raise RuntimeError("conditioner down")

    monkeypatch.setattr(conditioners, "encode", fails)
    with pytest.raises(RuntimeError, match="conditioner down"):
        at.text_to_audio(model, "rain", seed=3, ddim_steps=4, **KW)
    assert profiling._current.request is None
    monkeypatch.setattr(conditioners, "encode", encode)
    at.text_to_audio(model, "rain", seed=3, ddim_steps=4, **KW)
    spans = model.last_spans
    assert [s.name for s in spans] == ["request"] + STAGES
    assert spans[0].parent is None and all(s.parent == spans[0].id for s in spans[1:])
    assert all(s.host_end_ns >= s.host_start_ns > 0 for s in spans)


def test_last_timings_keeps_its_keys_and_has_no_device_key_on_the_cpu(model):
    at.text_to_audio(model, "rain", seed=3, ddim_steps=4, **KW)
    t = model.last_timings
    assert HOST_KEYS <= set(t)
    assert t["total_s"] == pytest.approx(t["tokenize_s"] + t["generate_s"] + t["rerank_s"])
    assert t["sampler_steps"] == 4
    assert not [k for k in t if k.endswith("_device_s")]


class _Event:
    """A stand-in for ``torch.cuda.Event``: the time it was recorded, s."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = self.clock[0]

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def test_device_times_from_events_are_summed_by_name(monkeypatch):
    """The CUDA path's arithmetic with stand-in events: each span's device
    time is its exit event less its entry event; a host-only span and a
    step keep no events; times sum by name, ``.`` written ``_``."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    clock = _Event.clock
    clock[0] = 0.0
    with profiling.request("cuda") as req:
        with profiling.span("tokenize", device=False):
            clock[0] = 1.0
        with profiling.span("sampler"):
            for _ in range(3):
                with profiling.step("sampler.step"):
                    clock[0] += 2.0
        for _ in range(2):
            with profiling.span("vae.decode"):
                clock[0] += 0.5
    spans = _by_name(req.spans)
    assert spans["tokenize"][0].device_s is None
    assert spans["sampler"][0].device_s == pytest.approx(6.0)
    assert req.timings() == {"request_device_s": pytest.approx(8.0),
                             "sampler_device_s": pytest.approx(6.0),
                             "vae_decode_device_s": pytest.approx(1.0),
                             "sampler_steps": 3}
    assert all(s.events is None for s in req.spans)


def test_a_request_inside_a_request_records_on_its_own():
    with profiling.request("cpu") as outer:
        with profiling.span("conditioning"):
            with profiling.request("cpu") as inner:
                with profiling.span("sampler"):
                    pass
            assert profiling._current.request is outer
        with profiling.span("rerank"):
            pass
    assert [s.name for s in outer.spans] == ["request", "conditioning", "rerank"]
    assert [s.name for s in inner.spans] == ["request", "sampler"]
    assert inner.spans[0].parent is None and inner.id != outer.id
    assert profiling._current.request is None
