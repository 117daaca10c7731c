"""The UNet forward of a request as one CUDA graph, replayed every step.

Within one request the UNet forward reads nothing that changes from step
to step but the latent ``x`` and the timestep ``t``: the cast weights, the
fused QKV, the cross K/V, the contexts, masks and FiLM ``y`` are made once
a request (``latent_diffusion.prepare_unet``). :class:`GraphedForward`
wraps such a forward. Where capture is sound (:func:`engages`: a CUDA
device, one tensor-parallel rank, grad off) its first call runs eager on
the device's capture stream, which warms every kernel, plan, library
workspace and per-stream scratch that stream will use. Its second call
captures the forward into a CUDA graph over static copies of ``x`` and
``t``. That call and every later one copies ``x`` and ``t`` into them,
replays the graph on the caller's stream and returns a copy of the static
output, so no two calls share an output. Elsewhere it calls the forward as
it is.

Per device there is one long-lived capture stream, one graph memory pool
that every capture shares, and at most one live graph. A capture retires
the graph it finds there: the new capture reuses the pool's memory, so the
old graph must never replay again, and its owner captures anew if it is
called again. A request's graph goes with its :class:`GraphedForward`,
that is with the request's eps function. A one-node graph keeps the pool
alive between requests: the caching allocator refuses a capture into a
pool whose every graph is gone (torch 2.11).

Counts: a replay adds the kernel launches and declined calls that its
capture recorded to ``ops.launch_counts()`` and ``ops.declined_counts()``,
so the counts after a request are those of the eager request. Inside a
request (``utils.profiling``) it counts ``unet_graph_captures`` and
``unet_graph_replays``.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict

import torch

from audioldm2_torch import ops
from audioldm2_torch.parallel import collectives
from audioldm2_torch.utils import profiling

Forward = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def engages(device) -> bool:
    """Whether a forward on ``device`` is captured: a CUDA device, one
    tensor-parallel rank (a tp forward holds collectives staged through
    host memory, which no graph can hold) and grad off."""
    return (torch.device(device).type == "cuda" and collectives.tp_size() == 1
            and not torch.is_grad_enabled())


class _Device:
    """One device's capture stream, graph memory pool and live graph."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.owner = lambda: None  # a weakref to the GraphedForward whose graph is live
        # never replayed: it only holds the pool (module docstring)
        self._anchor, _ = self.capture(torch.zeros(1, device=device).zero_)

    def eager(self, fn):
        """fn() run on the stream, the caller's stream waiting for it."""
        caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            out = fn()
        caller.wait_stream(self.stream)
        out.record_stream(caller)
        return out

    def capture(self, fn):
        """(graph, fn()): fn's launches captured on the stream into the pool."""
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        return graph, out


_DEVICES: Dict[int, _Device] = {}


def _device(device: torch.device) -> _Device:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _DEVICES:
        _DEVICES[index] = _Device(torch.device("cuda", index))
    return _DEVICES[index]


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


class GraphedForward:
    """``forward(x, t)``, replayed from one CUDA graph from its second call
    on where :func:`engages` holds (module docstring)."""

    def __init__(self, forward: Forward):
        self.forward = forward
        self.calls = 0  # the calls that engaged
        self.graph = None
        self.static = None  # (x, t, out) that the graph reads and writes
        self.key = None  # x's and t's shapes and dtypes at the capture
        self.counts = None  # (launches, declined) of one replay
        profiling.count("unet_graph_captures", 0)
        profiling.count("unet_graph_replays", 0)

    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if not engages(x.device):
            return self.forward(x, t)
        dev = _device(x.device)
        self.calls += 1
        if self.calls == 1:
            return dev.eager(lambda: self.forward(x, t))
        if (self.graph is None or dev.owner() is not self
                or self.key != (x.shape, x.dtype, t.shape, t.dtype)):
            self._capture(dev, x, t)
        static_x, static_t, out = self.static
        static_x.copy_(x)
        static_t.copy_(t)
        self.graph.replay()
        ops.add_counts(*self.counts)
        profiling.count("unet_graph_replays")
        return out.clone()

    def _retire(self) -> None:
        self.graph = self.static = self.counts = None

    def _capture(self, dev: _Device, x, t) -> None:
        live = dev.owner()
        if live is not None:
            live._retire()
        self._retire()
        static_x, static_t, forward = x.clone(), t.clone(), self.forward
        before = ops.launch_counts(), ops.declined_counts()
        graph, out = dev.capture(lambda: forward(static_x, static_t))
        counts = (_diff(ops.launch_counts(), before[0]), _diff(ops.declined_counts(), before[1]))
        ops.add_counts(*counts, times=-1)  # capture launches nothing; each replay counts
        self.graph, self.static, self.counts = graph, (static_x, static_t, out), counts
        self.key = (x.shape, x.dtype, t.shape, t.dtype)
        dev.owner = weakref.ref(self)
        profiling.count("unet_graph_captures")
