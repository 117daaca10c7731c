"""CUDA-event timing of short calls: the one timer of the smoke run and of
the tools on the card.

A kernel that runs for less time than the host needs to launch it is, in a
plain loop of launches between two events, timed by the host's launch rate.
:func:`cuda_ms` therefore holds the device with a spin kernel while the host
queues the timed calls, so the events enclose the calls back to back on the
device. ``hold=False`` gives the plain loop, for reading the two apart.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

# clock cycles of the spin kernel per millisecond of hold (the H100's boost
# clock, 1.98 GHz, rounded up) and the longest hold
SPIN_CYCLES_PER_MS = 2.0e6
HOLD_MS_MAX = 50.0


def cuda_ms(fn, reps: Optional[int] = None, target_ms: float = 20.0, max_reps: int = 50,
            hold: bool = True) -> float:
    """Mean device time of fn() in ms over ``reps`` calls, after a warm-up.
    Without ``reps``: as many calls as fill ``target_ms``, 3 to ``max_reps``.
    The hold lasts 1.5 times what the host needed to queue one call, times
    the calls, at most HOLD_MS_MAX."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    fn()
    e.record()
    host_ms = (time.perf_counter() - t0) * 1e3  # to queue one call
    torch.cuda.synchronize()
    if reps is None:
        reps = max(3, min(max_reps, int(target_ms / max(s.elapsed_time(e), 1e-3))))
    if hold:
        hold_ms = min(1.5 * reps * host_ms + 0.2, HOLD_MS_MAX)
        torch.cuda._sleep(int(hold_ms * SPIN_CYCLES_PER_MS))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps
