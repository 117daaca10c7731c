"""Reading a ``torch.profiler`` trace: the device's busy time, the device
time inside named ranges, the device ops by name and the idle gaps.

A frozen copy of the reading in ``audioldm2_torch/utils/profiling.py``
(``busy_share``, ``range_device_ms``, ``op_table``), taken from one Chrome
trace that a :class:`Recorder` writes and parses once, plus the idle gaps
between device ops by the host range they fall in.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Tuple

import torch

# Chrome-trace categories of the device's own ops; the runtime calls that
# launch them are host time
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """The complete events of one trace, indexed for the readers."""

    def __init__(self, events: List[dict]):
        self.events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = sorted((e for e in self.events if e.get("cat") in DEVICE_CATEGORIES),
                             key=lambda e: float(e["ts"]))
        if not self.events:
            raise ValueError("the trace holds no events")
        self.start_us = min(float(e["ts"]) for e in self.events)
        self.end_us = max(float(e["ts"]) + float(e["dur"]) for e in self.events)

    @property
    def window_s(self) -> float:
        """From the first event's start to the last event's end, host and device."""
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device ops' intervals, in us, sorted."""
        out: List[Tuple[float, float]] = []
        for e in self.device:
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if out and s <= out[-1][1]:
                if t > out[-1][1]:
                    out[-1] = (out[-1][0], t)
            else:
                out.append((s, t))
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def ranges(self, name: str) -> List[Tuple[float, float]]:
        """The host intervals (us) of the ``record_function(name)`` ranges."""
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.events
                      if e.get("cat") == "user_annotation" and e["name"] == name)

    def range_device_s(self, name: str) -> Tuple[float, int]:
        """(device seconds, ranges) of the device ops launched inside the
        ``record_function(name)`` ranges: an op counts when the host call
        that launched it (the same ``correlation`` id) starts inside such a
        range, or, where the trace has no such call, when the op lies inside
        the range's device-side copy (``gpu_user_annotation``)."""
        host = self.ranges(name)
        on_device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in self.events
                           if e.get("cat") == "gpu_user_annotation" and e["name"] == name)
        launches = {e["args"]["correlation"]: float(e["ts"]) for e in self.events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}

        def inside(intervals, ts: float) -> bool:
            i = bisect.bisect_right(intervals, (ts, float("inf"))) - 1
            return i >= 0 and intervals[i][0] <= ts <= intervals[i][1]

        total = 0.0
        for e in self.device:
            launched = launches.get(e.get("args", {}).get("correlation"))
            counted = (inside(host, launched) if launched is not None
                       else inside(on_device, float(e["ts"])))
            if counted:
                total += float(e["dur"])
        return total / 1e6, len(host)

    def device_ops(self, top: int = 10) -> List[List]:
        """[[op name, seconds]] of the device ops with the most time."""
        agg: Dict[str, float] = collections.Counter()
        for e in self.device:
            agg[e["name"]] += float(e["dur"])
        return [[name, us / 1e6] for name, us in agg.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[[host range, seconds]] of the device's idle time inside the traced
        window, each gap named by the innermost named host range
        (``record_function``) open at the gap's start, else by the innermost
        host op there, summed by name and sorted."""
        busy = self.busy_intervals()
        gaps = []
        prev = self.start_us
        for s, t in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if self.end_us > prev:
            gaps.append((prev, self.end_us))
        host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                        e.get("cat") == "user_annotation")
                       for e in self.events if e.get("cat") in ("user_annotation", "cpu_op")),
                      key=lambda h: h[0])
        agg: Dict[str, float] = collections.Counter()
        stack: List[tuple] = []  # host ranges open at the sweep's position, nested
        nxt = 0
        for s, t in gaps:  # in increasing start order
            while nxt < len(host) and host[nxt][0] <= s:
                while stack and stack[-1][1] < host[nxt][0]:
                    stack.pop()
                stack.append(host[nxt])
                nxt += 1
            while stack and stack[-1][1] < s:
                stack.pop()
            open_now = [h for h in stack if h[1] >= s]
            named = [h[2] for h in open_now if h[3]]
            ops = [h[2] for h in open_now if not h[3]]
            label = (named[-1] if named else ops[-1] if ops else "(no host range)")
            agg[label] += (t - s)
        return [[name, us / 1e6] for name, us in agg.most_common(top)]


class Recorder:
    """A profiler session (CPU ops and the device's ops) that the caller
    starts, and that stops at :meth:`stop` or after ``steps`` calls of
    :meth:`step`, whichever comes first. :meth:`read` parses it once, after
    the window: the Chrome trace goes through a file in ``TMPDIR``, deleted
    once read."""

    def __init__(self, steps: int):
        self.steps_left = steps
        self.prof = None
        self.running = False

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.running = True

    def step(self) -> None:
        self.steps_left -= 1
        if self.steps_left <= 0:
            self.stop()

    def stop(self) -> None:
        if self.running:
            torch.cuda.synchronize()
            self.prof.stop()
            self.running = False

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="a2bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        return Trace(data["traceEvents"] if isinstance(data, dict) else data)
