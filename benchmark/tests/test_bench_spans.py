"""The readers of the program's stage spans (``a2bench/spans.py`` and the
five metrics on it) on hand-made windows and traces."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

import tiny  # noqa: E402,F401  (puts the benchmark's folder on the path)
from a2bench import manifest, spans, window  # noqa: E402
from a2bench.reference import config as rc  # noqa: E402
from a2bench.trace import Trace  # noqa: E402

ROOT = tiny.ROOT
SPAN_METRICS = ("conditioning_ms.tput", "step_device_ms.tput", "vae_decode_ms.tput",
                "vocoder_ms.tput", "step_idle_ms.tput")


def _window(timings, traced_first=False, trace=None):
    """One request a timings dict, 10 s apart; the first one traced."""
    with open(os.path.join(ROOT, "benchmark", "configs", "audioldm2-full.json")) as f:
        cfg = rc.from_dict(json.load(f)["config"])
    with open(os.path.join(ROOT, "benchmark", "traffic", "batch24.json")) as f:
        mix = json.load(f)
    reqs = [window.Request(10.0 * i, 10.0 * i + 9.0, t, traced=traced_first and i == 0)
            for i, t in enumerate(timings)]
    return window.Window(requests=reqs, setup_s=9.5, mix=mix, cfg=cfg,
                         unet_values=1_000_000_000, trace=trace)


def _timings(conditioning, sampler, steps, decode, vocoder):
    return {"tokenize_s": 0.01, "generate_s": 9.0, "rerank_s": 0.0,
            "conditioning_device_s": conditioning, "sampler_device_s": sampler,
            "sampler_steps": steps, "vae_decode_device_s": decode,
            "vocoder_device_s": vocoder}


def _trace(device, steps, others=()):
    """Device ops and ``record_function`` ranges, (name, ts, dur) in us."""
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d, "args": {}}
          for n, ts, d in device]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "sampler.step", "ts": ts, "dur": d}
           for ts, d in steps]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": d}
           for n, ts, d in others]
    return Trace(ev)


def test_device_times_read_only_the_untraced_requests():
    w = _window([_timings(9.0, 90.0, 50, 9.0, 9.0),  # the profiler's: left out
                 _timings(0.2, 20.0, 200, 0.4, 0.8),
                 _timings(0.4, 24.0, 200, 0.6, 1.2)], traced_first=True)
    read = {name: manifest.reader(name)(w) for name in SPAN_METRICS}
    assert read["conditioning_ms.tput"] == pytest.approx(300.0)
    assert read["vae_decode_ms.tput"] == pytest.approx(500.0)
    assert read["vocoder_ms.tput"] == pytest.approx(1000.0)
    # summed over the requests, then over their steps: 44 s over 400 steps
    assert read["step_device_ms.tput"] == pytest.approx(110.0)
    assert read["step_idle_ms.tput"] is None  # no trace


def test_device_times_read_nothing_where_there_is_nothing():
    cpu = {"tokenize_s": 0.01, "generate_s": 9.0, "rerank_s": 0.0, "sampler_steps": 200}
    parent = {"tokenize_s": 0.01, "generate_s": 9.0, "rerank_s": 0.0}
    for w in (_window([cpu, cpu]),  # on the CPU: steps, no device time
              _window([parent, parent]),  # a program without the spans
              _window([_timings(0.2, 20.0, 200, 0.4, 0.8)], traced_first=True)):  # all traced
        assert all(manifest.reader(name)(w) is None for name in SPAN_METRICS)
    # a sampler that ran no step gives no step time
    assert spans.step_device_ms(_window([_timings(0.2, 0.0, 0, 0.4, 0.8)])) is None


def test_covered_counts_each_busy_interval_inside_the_range():
    busy = [(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)]
    assert spans.covered_us(busy, 5.0, 45.0) == pytest.approx(5.0 + 10.0 + 5.0)
    assert spans.covered_us(busy, 12.0, 18.0) == 0.0
    assert spans.covered_us(busy, 22.0, 28.0) == pytest.approx(6.0)
    assert spans.covered_us(busy, -5.0, 100.0) == pytest.approx(30.0)
    assert spans.covered_us(busy, 60.0, 70.0) == 0.0
    assert spans.covered_us([], 0.0, 10.0) == 0.0


def test_step_idle_is_the_idle_time_inside_the_step_ranges():
    # device ops 0-30 and 25-40 (overlapping: busy 0-40), 60-70, 95-130;
    # steps 10-50 (idle 40-50: 10 us), 50-100 (busy 60-70 and 95-100: idle 35 us)
    tr = _trace([("k", 0, 30), ("k", 25, 15), ("k", 60, 10), ("k", 95, 35)],
                [(10, 40), (50, 50)], others=[("request", 0, 200), ("unet", 12, 20)])
    w = _window([_timings(0.2, 20.0, 200, 0.4, 0.8)] * 2, traced_first=True, trace=tr)
    assert spans.step_idle_ms(w) == pytest.approx((10.0 + 35.0) / 2 / 1e3)
    assert manifest.reader("step_idle_ms.tput")(w) == pytest.approx(22.5e-3)


def test_step_idle_reads_nothing_without_steps_or_device_ops():
    no_steps = _trace([("k", 0, 30)], [], others=[("unet", 0, 30)])  # the parent's trace
    cpu_only = Trace([{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 30},
                      {"ph": "X", "cat": "user_annotation", "name": "sampler.step", "ts": 0,
                       "dur": 30}])
    for tr in (no_steps, cpu_only):
        w = _window([_timings(0.2, 20.0, 200, 0.4, 0.8)], trace=tr)
        assert spans.step_idle_ms(w) is None


def test_the_span_metrics_are_in_the_manifest_for_both_cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["workloads"] == ["full.batch24", "k48.batch8"] and m["moves"] == "audio_s_per_s"
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert m["source"] == ("device_trace" if name == "step_idle_ms.tput" else "program_span")
