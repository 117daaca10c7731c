"""The speech cell ``tts.batch16`` and the readers of the GPT-2 token loop
(``a2bench/tokens.py``, ``token_idle_ms.tput`` and ``token_roofline.tput``):
the readers on hand-made windows and traces, the loop's bytes and FLOPs by
hand, the configuration file against the program's, the manifest's
entries, and a tiny speech run's token count."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

import tiny  # noqa: E402
from a2bench import harness, manifest, tokens, window  # noqa: E402
from a2bench.reference import config as rc  # noqa: E402
from a2bench.trace import Trace  # noqa: E402

ROOT = tiny.ROOT
CELL = "tts.batch16"
CONFIG = "audioldm2-speech-gigaspeech"
TOKEN_METRICS = ("token_idle_ms.tput", "token_roofline.tput")
# the earlier cells' per-layer metrics that this cell reports too; those read
# from the requests after the traced one are not listed for it (its traced
# request outlasts the window, so none follows), nor is step_idle_ms, whose
# list test_bench_spans.py pins to the earlier two cells
TRACED = ("unet_roofline.tput", "device_idle.tput")
UNTRACED = ("step_ms.tput", "mfu.tput", "conditioning_ms.tput", "step_device_ms.tput",
            "vae_decode_ms.tput", "vocoder_ms.tput", "step_idle_ms.tput")


def _cfg(name=CONFIG):
    entry = {c["name"]: c for c in manifest.load()["configs"]}[name]
    with open(os.path.join(ROOT, entry["file"])) as f:
        return rc.from_dict(json.load(f)["config"])


def _window(timings, traced_first=False, trace=None, cfg_name=CONFIG):
    """One request a timings dict, 20 s apart; the first one traced."""
    reqs = [window.Request(20.0 * i, 20.0 * i + 18.0, t, traced=traced_first and i == 0)
            for i, t in enumerate(timings)]
    return window.Window(requests=reqs, setup_s=15.0, mix=manifest.Cell(manifest.load(), CELL).mix,
                         cfg=_cfg(cfg_name), unet_values=1_000_000_000, trace=trace)


def _timings():
    """A speech request's timings on the card."""
    return {"tokenize_s": 0.01, "generate_s": 18.0, "rerank_s": 0.0,
            "conditioning_device_s": 5.2, "seqgen_prefix_device_s": 0.05,
            "seqgen_prefill_device_s": 0.1, "seqgen_decode_device_s": 5.0,
            "seqgen_decode_steps": 512, "sampler_device_s": 12.0, "sampler_steps": 200}


def _trace(device, tokens_at, others=()):
    """Kernels (name, ts, dur, launch ts or None) and ``seqgen.token``
    ranges (ts, dur), in us; a kernel with a launch time has its runtime
    call (the same correlation id) there."""
    ev = []
    for c, (name, ts, dur, launch) in enumerate(device):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": c}})
        if launch is not None:
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 1, "args": {"correlation": c}})
    ev += [{"ph": "X", "cat": "user_annotation", "name": "seqgen.token", "ts": ts, "dur": d}
           for ts, d in tokens_at]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": d}
           for n, ts, d in others]
    return Trace(ev)


def test_the_readers_read_nothing_where_there_is_nothing():
    cpu = {"tokenize_s": 0.01, "generate_s": 18.0, "seqgen_decode_steps": 512,
           "sampler_steps": 200}
    parent = {"tokenize_s": 0.01, "generate_s": 18.0, "conditioning_device_s": 5.0,
              "sampler_device_s": 12.0, "sampler_steps": 200}
    # the parent's trace: kernels inside conditioning, no token ranges
    parent_trace = _trace([("k", 0, 30, 0), ("k", 40, 30, 35)], [],
                          others=[("conditioning", 0, 100)])
    for w in (_window([cpu, cpu]),  # on the CPU: steps, no device time
              _window([parent, parent], traced_first=True, trace=parent_trace),
              _window([_timings()], traced_first=True)):  # all traced, no trace read
        assert all(manifest.reader(name)(w) is None for name in TOKEN_METRICS)
    # a trace without device ops
    cpu_trace = Trace([{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 30},
                       {"ph": "X", "cat": "user_annotation", "name": "seqgen.token", "ts": 0,
                        "dur": 30}])
    w = _window([_timings()], trace=cpu_trace)
    assert tokens.token_idle_ms(w) is None and tokens.token_roofline(w) is None
    # a configuration without a sequence generator has no token roofline
    tr = _trace([("k", 0, 30, 5)], [(0, 40)])
    assert tokens.token_roofline(_window([_timings()], trace=tr,
                                         cfg_name="audioldm_48k")) is None


def test_token_idle_is_the_idle_time_inside_the_token_ranges():
    # busy 0-40 (two overlapping kernels), 60-70, 95-130; tokens 10-50 (idle
    # 10 us) and 50-100 (busy 60-70 and 95-100: idle 35 us)
    tr = _trace([("k", 0, 30, 0), ("k", 25, 15, 20), ("k", 60, 10, 55), ("k", 95, 35, 90)],
                [(10, 40), (50, 50)], others=[("seqgen.decode", 5, 120)])
    w = _window([_timings()] * 2, traced_first=True, trace=tr)
    assert tokens.token_idle_ms(w) == pytest.approx((10.0 + 35.0) / 2 / 1e3)
    assert manifest.reader("token_idle_ms.tput")(w) == pytest.approx(22.5e-3)


def test_token_roofline_is_the_least_time_over_the_device_time_in_the_ranges():
    # two token ranges 0-1000 and 1000-2000 us; kernels launched inside them
    # run 300 + 200 and 400 us; one launched outside (at 2500) is not counted
    tr = _trace([("gemv", 100, 300, 50), ("attn", 500, 200, 400), ("gemv", 1100, 400, 1050),
                 ("unet", 2600, 5000, 2500)], [(0, 1000), (1000, 1000)])
    w = _window([_timings()] * 2, traced_first=True, trace=tr)
    spec = tokens.sequence_gen(w.cfg)
    least = tokens.least_s(spec, 2)
    assert tokens.token_roofline(w) == pytest.approx(100.0 * least / 900e-6)
    assert manifest.reader("token_roofline.tput")(w) == pytest.approx(100.0 * least / 900e-6)
    # the card's HBM bounds a token step: under 100% at a few hundred us
    assert 0.0 < tokens.token_roofline(w) < 100.0


def test_the_token_loops_bytes_and_flops_by_hand():
    spec = tokens.sequence_gen(_cfg())
    d, layers = 768, 12
    # CLAP 1 and the phonemes 310, each inside its SOS/EOS
    assert tokens.prefix_slots(spec) == 315
    per_block = (3 * d * d + 3 * d) + (d * d + d) + (4 * d * d + 4 * d) + (4 * d * d + d) + 4 * d
    assert tokens.block_values(spec) == layers * per_block == 85_054_464
    assert round(tokens.block_values(spec) / 1e6, 1) == 85.1
    kv_slot = layers * 2 * d * 4  # one row's f32 K and V of one slot, every layer
    assert tokens.ROWS == 1
    assert tokens.step_bytes(spec, 0) == 85_054_464 * 4 + kv_slot * 316
    assert tokens.step_bytes(spec, 511) == 85_054_464 * 4 + kv_slot * 827
    # the four matrices (2 FLOPs a multiply-add) and QK^T and PV over the slots
    assert tokens.step_flops(spec, 0) == layers * (2 * 12 * d * d + 2 * 2 * d * 316)
    # bytes bound: 340 MB and the cache at 3.35 TB/s, about 0.11 ms a token
    least = tokens.least_s(spec, 512)
    want = sum((85_054_464 * 4 + kv_slot * (316 + i)) / 3.35e12 for i in range(512))
    assert least == pytest.approx(want)
    assert 0.10e-3 < least / 512 < 0.12e-3
    # audioldm2-full's 8 tokens: CLAP 1 and FLAN-T5 128, each inside its pair
    assert tokens.prefix_slots(tokens.sequence_gen(_cfg("audioldm2-full"))) == 133


def test_the_configuration_file_is_the_programs_field_for_field():
    from audioldm2_torch.config import default_audioldm_config

    entry = {c["name"]: c for c in manifest.load()["configs"]}[CONFIG]
    with open(os.path.join(ROOT, entry["file"])) as f:
        doc = json.load(f)
    want = json.loads(json.dumps(rc.to_dict(default_audioldm_config(CONFIG))))
    assert doc["model_name"] == CONFIG and doc["reduced"] == [] == entry["reduced"]
    assert doc["config"] == want
    # ljspeech has the same configuration but for its name
    other = json.loads(json.dumps(rc.to_dict(default_audioldm_config(
        "audioldm2-speech-ljspeech"))))
    assert {**other, "name": CONFIG} == want
    cfg = rc.from_dict(doc["config"])
    (seqgen,) = cfg.conditioners
    assert seqgen.sequence_gen.sequence_gen_length == 512
    assert tuple(cfg.unet.context_dims) == (768,)
    assert doc["served"]["unet"] == doc["served"]["vae"] == doc["served"]["vocoder"] == "bfloat16"
    assert doc["served"]["conditioners"].startswith("float32, TF32 off")


def test_the_cell_and_its_metrics_are_in_the_manifest():
    bench = manifest.load()
    (entry,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (entry["config"], entry["traffic"], entry["chips"]) == (CONFIG, "speech16", 1)
    assert bench["workloads"][-1] is entry and bench["configs"][-1]["name"] == CONFIG
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in TRACED:
        assert per_layer[name]["workloads"] == ["full.batch24", "k48.batch8", CELL]
    for name in UNTRACED:
        assert per_layer[name]["workloads"] == ["full.batch24", "k48.batch8"]
    for name in TOKEN_METRICS:
        m = per_layer[name]
        assert (m["layer"], m["moves"], m["workloads"]) == ("conditioning", "audio_s_per_s",
                                                            [CELL])
        assert m["unit"] == ("%" if "roofline" in name else "ms")
        assert m["better"] == ("higher" if "roofline" in name else "lower")
        assert m["source"] == "device_trace"
    assert [m["name"] for m in bench["per_layer"]][-2:] == list(TOKEN_METRICS)
    cell = manifest.Cell(bench, CELL)
    assert [m["name"] for m in cell.end_to_end] == ["audio_s_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == set(TRACED) | set(TOKEN_METRICS)
    mix = cell.mix
    assert (mix["batchsize"], mix["n_candidate_gen_per_text"], mix["ddim_steps"]) == (16, 1, 200)
    assert window.Window([], 0.0, mix, _cfg(), 0).cfg_batch == 32
    prompts = cell.prompts()
    assert len(prompts) >= 16 and all(t for _, t in prompts)
    assert set(cell.limits) == {"cond_rel", "latent_rel", "mel_rms", "wav_rms",
                                "returned_mismatch"}


def test_a_tiny_speech_runs_requests_count_their_tokens(monkeypatch):
    """The tiny speech cell through ``harness.run`` on the CPU: each
    request's timings, as the window keeps them, count the tiny
    generator's tokens on ``seqgen.decode``."""
    import torch

    torch.set_num_threads(4)
    cell, pcfg = tiny.tiny_cell("tts")
    seen = []
    original = window.Window.__init__

    def keep(self, *args, **kwargs):
        original(self, *args, **kwargs)
        seen.append(self)

    monkeypatch.setattr(window.Window, "__init__", keep)
    result = harness.run(cell, pcfg, 3_000_000_029, 0.1, False, "cpu", time.perf_counter())
    assert result["failed"] == 0
    (w,) = seen
    (spec,) = pcfg.conditioners
    assert w.requests and all(
        r.timings["seqgen_decode_steps"] == spec.sequence_gen.sequence_gen_length == 4
        for r in w.requests)
