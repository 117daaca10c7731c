"""The readers of the program's own stage spans.

``audioldm2_torch`` keeps, for each request, the device time of each stage
span (``conditioning``, ``sampler``, ``vae.decode``, ``vocoder``, ...) from
CUDA events, and the sampler's step count, in ``model.last_timings``
(``<span>_device_s`` with ``.`` written ``_``, ``sampler_steps``), which
each :class:`a2bench.window.Request` carries as ``timings``. Each sampler
step is also a ``record_function("sampler.step")`` range in a trace. The
readers below take the requests the profiler did not run in, and the
traced ranges; each returns None where the run has nothing to read (no
card, no untraced request, or a program without the spans).
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from a2bench.window import Window


def mean_device_ms(w: Window, key: str) -> Optional[float]:
    """The mean of ``timings[key]`` (seconds of device time) over the
    requests the profiler did not run in that have it, ms."""
    values = [r.timings[key] for r in w.untraced if key in r.timings]
    return 1e3 * sum(values) / len(values) if values else None


def step_device_ms(w: Window) -> Optional[float]:
    """The sampler span's device time over its steps, summed over the
    requests the profiler did not run in, ms a step."""
    reqs = [r for r in w.untraced
            if "sampler_device_s" in r.timings and r.timings.get("sampler_steps")]
    if not reqs:
        return None
    return (1e3 * sum(r.timings["sampler_device_s"] for r in reqs)
            / sum(r.timings["sampler_steps"] for r in reqs))


def covered_us(busy: List[Tuple[float, float]], s: float, t: float) -> float:
    """How much of [s, t] the sorted, disjoint intervals ``busy`` cover."""
    i = max(bisect.bisect_right(busy, (s, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(busy) and busy[i][0] < t:
        total += max(0.0, min(t, busy[i][1]) - max(s, busy[i][0]))
        i += 1
    return total


def step_idle_ms(w: Window) -> Optional[float]:
    """The device's idle time inside the host intervals of the traced
    ``"sampler.step"`` ranges (each range's length less the part of it the
    device's ops cover), over the number of those ranges, ms."""
    if w.trace is None or not w.trace.device:
        return None
    steps = w.trace.ranges("sampler.step")
    if not steps:
        return None
    busy = w.trace.busy_intervals()
    idle = sum((t - s) - covered_us(busy, s, t) for s, t in steps)
    return idle / len(steps) / 1e3
