"""Start the ranks of a mesh: one process per rank.

``spawn(fn, world, args)`` runs ``fn(rank, world, *args)`` in ``world``
fresh processes (``torch.multiprocessing``, the spawn start method), each
with the default process group initialized from a ``file://`` store in a
temporary directory (no network address, no port), and returns every
rank's return value in rank order. The dry runs (``serve.dryrun_infer``,
``train.dryrun``), the tests and ``chip_smoke.py`` start their ranks
through it.

The ranks share the host's cores: each takes ``cpu_count // world``
intra-op threads (``fn`` may set fewer). Each run has a deadline: a rank
that raises fails the call (the others are ended), and so does a run that
outlasts ``timeout`` (a hung collective), whose processes are killed. The
collectives' own timeout is the same.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, List, Sequence


def _rank_main(rank: int, world: int, backend: str, tmp: str, timeout: float, fn: Callable,
               args: Sequence) -> None:
    import torch
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # loopback: no hostname lookup
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()  # no rank tears the group down while another still uses it
    finally:
        dist.destroy_process_group()
    # Every collective and the teardown are done and the result is on disk:
    # leave without the interpreter's shutdown, which now and then aborts
    # in a process that ran gloo ("terminate called without an active
    # exception").
    os._exit(0)


def spawn(fn: Callable, world: int, args: Sequence = (), *, backend: str = "gloo",
          timeout: float = 300.0) -> List:
    """``[fn(r, world, *args) for r in range(world)]``, each in its own
    process with torch.distributed initialized (``backend``); ``fn`` and
    ``args`` must pickle, and so must the results (tensors are saved with
    ``torch.save``: move them to the CPU). Raises if a rank raises or the
    run outlasts ``timeout`` seconds."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank_main, args=(world, backend, tmp, timeout, fn, tuple(args)),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"spawn: {world} ranks did not finish within {timeout:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
