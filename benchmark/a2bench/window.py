"""What a run measured, and the arithmetic every metric reader shares.

A :class:`Window` holds the requests the window finished (their host-clock
start and end, the host clock at each sampler step's end, and the program's
own timings), the set-up time and, in a traced run, the trace of the
window's first request. The profiler slows the host it runs on, so the
host-clock readers of a traced run (``step_ms``, ``mfu``) read the
requests it did not run in. The
readers under ``metrics/`` turn it into one number each, or None where
the run has nothing to read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from a2bench import work
from a2bench.reference.config import ModelConfig
from a2bench.trace import Trace


@dataclasses.dataclass
class Request:
    start: float  # host clock, s
    end: float
    timings: Dict[str, float]  # the program's own (``last_timings``)
    steps: List[float] = dataclasses.field(default_factory=list)  # host clock, each step's end
    traced: bool = False  # the profiler ran in it


@dataclasses.dataclass
class Window:
    requests: List[Request]
    setup_s: float
    mix: Dict
    cfg: ModelConfig
    unet_values: int  # values in the UNet's weights
    trace: Optional[Trace] = None  # of the window's first request

    @property
    def wall_s(self) -> float:
        """From the first request's start to the last one's end."""
        return max(r.end for r in self.requests) - min(r.start for r in self.requests)

    @property
    def untraced(self) -> List[Request]:
        return [r for r in self.requests if not r.traced]

    @property
    def latent_t(self) -> int:
        return work.latent_frames(self.cfg, self.mix)

    @property
    def cfg_batch(self) -> int:
        b = self.mix["batchsize"] * self.mix["n_candidate_gen_per_text"]
        return 2 * b if self.mix["guidance_scale"] != 1.0 else b


def audio_s_per_s(w: Window) -> float:
    """Seconds of kept audio over the window's wall."""
    return len(w.requests) * w.mix["batchsize"] * w.mix["duration"] / w.wall_s


def request_s(w: Window) -> float:
    """The window's wall over the requests it finished."""
    return w.wall_s / len(w.requests)


def mean_timing_ms(w: Window, key: str) -> Optional[float]:
    values = [r.timings[key] for r in w.requests if key in r.timings]
    return 1e3 * sum(values) / len(values) if values else None


def step_ms(w: Window) -> Optional[float]:
    """Over the requests the profiler did not run in: the host clock from
    each one's first sampler step's end to its last, summed, over the steps
    between them, ms."""
    spans = [(r.steps[-1] - r.steps[0], len(r.steps) - 1) for r in w.untraced
             if len(r.steps) >= 2]
    if not spans:
        return None
    return 1e3 * sum(s for s, _ in spans) / sum(n for _, n in spans)


def unet_roofline(w: Window) -> Optional[float]:
    """The least time of the traced UNet forwards (work.unet_least_s at the
    cell's CFG batch) over the device time of the ops launched inside their
    ``"unet"`` ranges, in %."""
    if w.trace is None:
        return None
    device_s, n = w.trace.range_device_s("unet")
    if n == 0 or device_s <= 0:
        return None
    least = work.unet_least_s(w.cfg, w.unet_values, w.cfg_batch, w.latent_t)
    return 100.0 * n * least / device_s


def device_idle(w: Window) -> Optional[float]:
    """One minus the device's busy share of the traced window, in %."""
    if w.trace is None or not w.trace.device:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s)


def mfu(w: Window) -> Optional[float]:
    """The model FLOPs of the requests the profiler did not run in
    (work.request_flops) over their wall, first start to last end, at the
    card's bf16 peak, in %."""
    reqs = w.untraced
    if not reqs:
        return None
    clips = w.mix["batchsize"] * w.mix["n_candidate_gen_per_text"]
    per_request = work.request_flops(w.cfg, clips, w.cfg_batch, w.mix["ddim_steps"],
                                     w.latent_t)
    wall = max(r.end for r in reqs) - min(r.start for r in reqs)
    return 100.0 * len(reqs) * per_request / (wall * work.PEAK_BF16_FLOPS)
