"""Profiling on ``torch.profiler``: the port's stage spans, a trace written
to disk, and tables read back from it, with no tensorboard.

The port's counterpart of ``audioldm2_tpu/utils/profiling.py``.

Spans. A request (``pipeline.text_to_audio``,
``pipeline.super_resolution_and_inpainting``) runs inside :func:`request`,
whose root span is ``"request"``; each stage boundary under it opens a
:func:`span`: ``tokenize`` (host only), ``conditioning``, ``prepare_unet``,
``sampler``, ``vae.decode``, ``vocoder``, ``vae.encode``, ``to_host`` and
``rerank``; each sampler step a :func:`step` (``"sampler.step"``, around
the ``"unet"`` range of its UNet call). Inside ``conditioning`` the GPT-2
sequence generator (``models/sequence_gen.py``) opens ``seqgen.prefix``,
``seqgen.prefill`` and ``seqgen.decode``, and each generated token is a
``"seqgen.token"`` step (``seqgen_decode_steps``). Every span and step is a
``torch.profiler.record_function`` range, so a running profiler puts it in
the device trace on the device ops' clock, and the device's idle gaps can
be named by the host stage that was running. Inside a request a span also
keeps a :class:`Span` record: its name, its id and its parent's, the
request's id, the host clock at entry and exit, and, on a CUDA device, the
device time between two ``torch.cuda.Event`` s recorded on the current
stream at entry and exit (the events are read once the request is over,
after its own ``.cpu()`` copies). A step keeps no record: it counts itself
on the enclosing span (``Span.steps``). Outside a request spans and steps
are ranges only. Inside a request :func:`count` keeps named counters
(``unet_graph_captures``, ``unet_graph_replays``: ``diffusion/unet_graph``).
The pipeline exports the records as ``model.last_spans`` and their sums
and the counters as ``model.last_timings`` (``<span>_device_s``,
``sampler_steps``; :meth:`Request.timings`), which the benchmark's
per-layer readers read.

Traces. :func:`trace` records CPU ops and, on a CUDA device, the device's
kernels, copies and sets (CUPTI), and writes one Chrome trace (JSON) into a
directory. :func:`op_table` sums op time by name from the newest trace
there: device time where the trace holds device ops, else CPU op time.
:func:`busy_share` and :func:`range_device_ms` read the same trace: the
union of the device's op intervals over the traced window, and the device
time of the kernels launched inside a ``record_function`` range (the
sampler's UNet calls sit in ``"unet"`` ones).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import glob
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# Chrome-trace categories of the device's own ops. The host's runtime calls
# that launch them ("cuda_runtime", "cuda_driver") are not device time.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Span:
    """One span of a request, as :func:`span` keeps it. ``device_s`` is
    None off CUDA, for host-only spans, and until the request is over."""

    name: str
    id: int
    parent: Optional[int]  # the enclosing span's id; None for the root
    request: int  # the request's id, shared by all its spans
    host_start_ns: int  # time.perf_counter_ns()
    host_end_ns: int = 0
    device_s: Optional[float] = None
    steps: int = 0  # the steps (:func:`step`) run directly inside it
    events: Optional[list] = dataclasses.field(default=None, repr=False)


_ids = itertools.count(1)
# per thread: the request being recorded (a request runs on one thread, and
# the functions that open its spans take no handle to it)
_current = threading.local()


class Request:
    """The spans of one request, in the order they opened."""

    def __init__(self, device):
        self.id = next(_ids)
        device = torch.device(device)
        self.device = device if device.type == "cuda" else None
        self.spans: List[Span] = []
        self.open: List[Span] = []
        self.counters: Dict[str, int] = collections.Counter()  # :func:`count`'s

    def enter(self, name: str, events: bool) -> Span:
        rec = Span(name, next(_ids), self.open[-1].id if self.open else None, self.id,
                   time.perf_counter_ns())
        if events and self.device is not None:
            rec.events = [torch.cuda.Event(enable_timing=True)]
            rec.events[0].record(torch.cuda.current_stream(self.device))
        self.spans.append(rec)
        self.open.append(rec)
        return rec

    def exit(self, rec: Span) -> None:
        if rec.events is not None:
            rec.events.append(torch.cuda.Event(enable_timing=True))
            rec.events[1].record(torch.cuda.current_stream(self.device))
        rec.host_end_ns = time.perf_counter_ns()
        self.open.pop()

    def resolve(self) -> None:
        """Read every span's events into ``device_s``. Called once the
        request's output is on the host: its copies drained the stream, so
        each wait here finds its event done, but for the root span's exit
        event, recorded after the last copy on an idle stream."""
        for rec in self.spans:
            if rec.events is not None:
                start, end = rec.events
                end.synchronize()
                rec.device_s = start.elapsed_time(end) / 1e3
                rec.events = None

    def timings(self) -> Dict[str, float]:
        """``<name>_device_s`` (``.`` written ``_``), summed over the spans
        of each name with a device time, ``<name>_steps`` for each span
        that ran steps (``sampler_steps``), and every :func:`count` counter
        under its name, 0 included."""
        out: Dict[str, float] = collections.Counter()
        for rec in self.spans:
            key = rec.name.replace(".", "_")
            if rec.device_s is not None:
                out[key + "_device_s"] += rec.device_s
            if rec.steps:
                out[key + "_steps"] += rec.steps
        out.update(self.counters)
        return dict(out)


@contextlib.contextmanager
def request(device) -> Iterator[Request]:
    """Record one request on ``device``: the root span ``"request"`` and
    every span opened under it on this thread. Yields the
    :class:`Request`; its device times are read when the block ends
    normally. A request inside a request records on its own and hands the
    outer one back on exit."""
    req, outer = Request(device), getattr(_current, "request", None)
    _current.request = req
    try:
        with span("request"):
            yield req
    finally:
        _current.request = outer
    req.resolve()


@contextlib.contextmanager
def span(name: str, device: bool = True) -> Iterator[None]:
    """A stage of a request: a ``record_function(name)`` range always and,
    inside a :func:`request`, a :class:`Span` record, with device events
    unless ``device`` is False (a host-only stage)."""
    with torch.profiler.record_function(name):
        req = getattr(_current, "request", None)
        if req is None:
            yield
            return
        rec = req.enter(name, device)
        try:
            yield
        finally:
            req.exit(rec)


@contextlib.contextmanager
def step(name: str) -> Iterator[None]:
    """One step of a loop: a ``record_function(name)`` range only, counted
    on the enclosing span inside a request."""
    req = getattr(_current, "request", None)
    if req is not None and req.open:
        req.open[-1].steps += 1
    with torch.profiler.record_function(name):
        yield


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (0 makes the counter present) to the counter ``name`` of
    the request recorded on this thread; nothing outside a request."""
    req = getattr(_current, "request", None)
    if req is not None:
        req.counters[name] += n


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
