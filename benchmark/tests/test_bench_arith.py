"""The metric arithmetic on synthetic requests and intervals."""

import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

import tiny  # noqa: E402,F401  (puts the benchmark's folder on the path)
from a2bench import manifest, window, work  # noqa: E402
from a2bench.reference import config as rc  # noqa: E402
from a2bench.trace import Trace  # noqa: E402

ROOT = tiny.ROOT


def _cfg(name: str):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return rc.from_dict(json.load(f)["config"])


def _mix(batchsize=8, candidates=1):
    with open(os.path.join(ROOT, "benchmark", "traffic", "batch8.json")) as f:
        mix = json.load(f)
    return dict(mix, batchsize=batchsize, n_candidate_gen_per_text=candidates)


def _events(device, host=(), annotations=()):
    """Chrome-trace complete events: device ops (name, ts, dur), host ops,
    and record_function ranges, with correlation ids tying launches to
    kernels."""
    out = []
    for i, (name, ts, dur) in enumerate(device):
        out.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                    "args": {"correlation": i}})
        out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                    "ts": ts, "dur": 0, "args": {"correlation": i}})
    for name, ts, dur in host:
        out.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur})
    for name, ts, dur in annotations:
        out.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur})
    return out


def _window(n=3, wall=30.0, trace=None, cfg="audioldm2-full", steps=0, step_s=0.1,
            traced_first=False, **mix):
    """n requests back to back over ``wall`` s, each with ``steps`` sampler
    steps ``step_s`` apart (the traced first request's twice as far)."""
    starts = [i * wall / n for i in range(n)]
    reqs = []
    for i, s in enumerate(starts):
        traced = traced_first and i == 0
        gap = 2 * step_s if traced else step_s
        reqs.append(window.Request(s, s + wall / n, {"rerank_s": 0.1 * (i + 1)},
                                   [s + 0.5 + k * gap for k in range(steps)], traced=traced))
    return window.Window(requests=reqs, setup_s=9.5, mix=_mix(**mix), cfg=_cfg(cfg),
                         unet_values=1_000_000_000, trace=trace)


def test_rate_and_request_time():
    w = _window(n=3, wall=30.0)
    assert w.wall_s == pytest.approx(30.0)
    assert window.audio_s_per_s(w) == pytest.approx(3 * 8 * 10 / 30.0)
    assert window.request_s(w) == pytest.approx(10.0)


def test_mean_timing():
    w = _window(n=3)
    assert window.mean_timing_ms(w, "rerank_s") == pytest.approx(200.0)
    assert window.mean_timing_ms(w, "absent") is None


def test_busy_union_idle_and_gaps():
    # device ops 0-10, 5-20 (overlap), 40-50; host window 0-100
    tr = Trace(_events([("a", 0, 10), ("b", 5, 15), ("a", 40, 10)],
                       host=[("aten::op", 20, 20)],
                       annotations=[("outer", 0, 100), ("inner", 50, 50)]))
    assert tr.busy_s() == pytest.approx(30e-6)
    assert tr.window_s == pytest.approx(100e-6)
    w = _window(trace=tr)
    assert window.device_idle(w) == pytest.approx(70.0)
    assert tr.device_ops() == [["a", pytest.approx(20e-6)], ["b", pytest.approx(15e-6)]]
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    # 20-40 lies in "outer" (and the host op); 50-100 in "inner"
    assert gaps == {"outer": pytest.approx(20e-6), "inner": pytest.approx(50e-6)}


def test_step_time_and_roofline():
    # two "unet" ranges of 1 ms (host), 10 ms apart; 0.5 ms of kernels in each
    dev = [("k", 100, 500), ("k", 10_100, 500), ("outside", 20_000, 700)]
    ann = [("unet", 50, 1000), ("unet", 10_050, 1000)]
    tr = Trace(_events(dev, annotations=ann))
    assert tr.range_device_s("unet") == (pytest.approx(1e-3), 2)
    w = _window(trace=tr, steps=201, step_s=0.09, traced_first=True)
    # the host clock's steps of the requests the profiler did not run in
    assert window.step_ms(w) == pytest.approx(90.0)
    assert window.step_ms(_window(n=1, steps=201, traced_first=True)) is None
    least = work.unet_least_s(w.cfg, w.unet_values, 16, 256)
    assert window.unet_roofline(w) == pytest.approx(100.0 * 2 * least / 1e-3)


def test_roofline_bound_is_the_larger_of_flops_and_bytes():
    cfg = _cfg("audioldm2-full")
    flops_s = work.unet_step_flops(cfg, 16, 256) / work.PEAK_BF16_FLOPS
    bytes_s = work.unet_forward_bytes(cfg, 1_000_000_000, 16, 256) / work.PEAK_HBM_BYTES_PER_S
    assert work.unet_least_s(cfg, 1_000_000_000, 16, 256) == max(flops_s, bytes_s)
    assert flops_s > bytes_s  # CFG 16 is compute-bound
    # at CFG 2 with a large weight count the bytes bound it
    assert work.unet_least_s(cfg, 10**11, 2, 256) == pytest.approx(
        work.unet_forward_bytes(cfg, 10**11, 2, 256) / work.PEAK_HBM_BYTES_PER_S)


def test_mfu():
    w = _window(n=2, wall=20.0)
    per = (200 * work.unet_step_flops(w.cfg, 16, 256) + work.vae_decode_flops(w.cfg.vae, 8, 256, 16)
           + work.vocoder_flops(w.cfg.vocoder, 8, 1024))
    assert window.mfu(w) == pytest.approx(100.0 * 2 * per / (20.0 * 989e12))
    assert 0 < window.mfu(w) < 100
    # the profiler's request is left out: the other two over their 20 s
    w3 = _window(n=3, wall=30.0, traced_first=True)
    assert window.mfu(w3) == pytest.approx(100.0 * 2 * per / (20.0 * 989e12))
    assert window.mfu(_window(n=1, traced_first=True)) is None


def test_flops_match_published_step_counts():
    # the step FLOPs the records quote: 2.734 TFLOP (full) and 2.326 TFLOP (48k) at CFG 16
    assert work.unet_step_flops(_cfg("audioldm2-full"), 16, 256) / 1e12 == pytest.approx(
        2.7343, rel=1e-4)
    assert work.unet_step_flops(_cfg("audioldm_48k"), 16, 128) / 1e12 == pytest.approx(
        2.3265, rel=1e-4)


def test_readers_return_nothing_without_a_trace():
    w = _window()
    for name in ("step_ms.tput", "unet_roofline.tput", "device_idle.tput"):
        assert manifest.reader(name)(w) is None
    assert manifest.reader("rerank_ms.lat")(w) is None  # one candidate: no rerank
    w3 = _window(candidates=3, batchsize=1)
    assert manifest.reader("rerank_ms.lat")(w3) == pytest.approx(200.0)
    assert math.isfinite(manifest.reader("mfu.lat")(w3))
