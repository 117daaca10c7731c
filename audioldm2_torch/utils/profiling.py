"""Profiling helpers on ``torch.profiler``: a trace written to disk and
tables read back from it, with no tensorboard.

The port's counterpart of ``audioldm2_tpu/utils/profiling.py``.
:func:`trace` records CPU ops and, on a CUDA device, the device's kernels,
copies and sets (CUPTI), and writes one Chrome trace (JSON) into a
directory. :func:`op_table` sums op time by name from the newest trace
there: device time where the trace holds device ops, else CPU op time.
:func:`busy_share` and :func:`range_device_ms` read the same trace: the
union of the device's op intervals over the traced window, and the device
time of the kernels launched inside a ``torch.profiler.record_function``
range (the sampler's UNet calls sit in ``"unet"`` ones).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

# Chrome-trace categories of the device's own ops. The host's runtime calls
# that launch them ("cuda_runtime", "cuda_driver") are not device time.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into a new ``trace_<pid>_<ns>.json`` under
    ``log_dir``: CPU ops, and the device's ops where CUDA is available (the
    device is synchronized before the profiler stops, so the block's last
    kernels are in the trace). Yields ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _events(log_dir: str) -> List[dict]:
    """The complete ("X") events of the newest trace under ``log_dir``."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with open(paths[-1]) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _device_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES]


def op_table(log_dir: str, top: int = 25) -> List[Tuple[str, float]]:
    """[(op name, total ms)] sorted descending, at most ``top`` rows, from
    the newest trace under ``log_dir``: the device's kernels, copies and
    sets where the trace has them (each once: the runtime call that
    launched it is host time), else the CPU ops (each op's own total, so a
    parent's time includes its children's)."""
    events = _events(log_dir)
    ops = _device_events(events) or [e for e in events if e.get("cat") == "cpu_op"]
    agg: Dict[str, float] = collections.Counter()
    for e in ops:
        agg[e["name"]] += float(e["dur"])
    return [(name, us / 1e3) for name, us in agg.most_common(top)]


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def busy_share(log_dir: str) -> Tuple[float, float]:
    """(busy ms, window ms) of the newest trace: the union of the device
    ops' intervals, and the traced window from the first event's start to
    the last event's end (host and device). Busy is 0 without device ops."""
    events = _events(log_dir)
    if not events:
        raise ValueError(f"the newest trace under {log_dir} holds no events")
    dev = _device_events(events)
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    return busy / 1e3, (end - start) / 1e3


def range_device_ms(log_dir: str, name: str) -> Tuple[float, int]:
    """(device ms, ranges) of the kernels launched inside the
    ``record_function(name)`` ranges of the newest trace: a kernel counts
    when the host call that launched it (the same ``correlation`` id)
    starts inside such a range, or, where the trace has no such call, when
    the kernel itself lies inside the range's device-side copy
    (``gpu_user_annotation``)."""
    events = _events(log_dir)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == name)
    on_device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                       if e.get("cat") == "gpu_user_annotation" and e["name"] == name)
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def inside(ranges, ts: float) -> bool:
        i = bisect.bisect_right(ranges, (ts, float("inf"))) - 1
        return i >= 0 and ranges[i][0] <= ts <= ranges[i][1]

    total = 0.0
    for e in _device_events(events):
        launched = launches.get(e.get("args", {}).get("correlation"))
        if launched is not None:
            counted = inside(host, launched)
        else:
            counted = inside(on_device, float(e["ts"]))
        if counted:
            total += float(e["dur"])
    return total / 1e3, len(host)


def _synchronize(device: Optional[torch.device] = None) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    elif device is None and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timer of a block that waits for the device: on CUDA
    (``device``, or any initialized CUDA device when None) it synchronizes
    on entry and on exit. ``elapsed`` is in seconds; with a ``name`` it
    prints the milliseconds."""

    def __init__(self, name: str = "", device=None):
        self.name = name
        self.device = device

    def __enter__(self):
        _synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _synchronize(self.device)
        self.elapsed = time.perf_counter() - self.t0
        if self.name:
            print(f"[{self.name}] {self.elapsed * 1000:.2f} ms")


def _tensor_devices(out) -> set:
    if isinstance(out, torch.Tensor):
        return {out.device}
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_tensor_devices(o) for o in out)) if out else set()
    return set()


def timeit(fn, *args, n: int = 10, warmup: int = 1) -> float:
    """Median wall seconds of ``fn(*args)`` over ``n`` calls after
    ``warmup`` ones, each call ending when its output's CUDA devices have
    finished (a synchronize per device it returned tensors on)."""

    def call():
        out = fn(*args)
        for dev in _tensor_devices(out):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    for _ in range(warmup):
        call()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
