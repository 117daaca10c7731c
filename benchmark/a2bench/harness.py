"""One run of one cell: set-up, the measured window, the metrics and the
check of ``correct``, and the result line.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. The run needs the card: without CUDA, or with fewer
cards than the cell asks for, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "audioldm2_tpu")
# a traced run profiles the window's first request from its start through
# this many sampler steps (its conditioning and the first fifth of the loop)
TRACED_STEPS = 40


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int) -> int:
    print(f"a2bench: {message}", file=sys.stderr, flush=True)
    return code


def config_dict(cfg) -> Dict:
    from a2bench.reference import config as rc

    return json.loads(json.dumps(rc.to_dict(cfg)))


def main(argv: List[str], t_process: float) -> int:
    args = parse(argv)
    from a2bench import manifest

    cell = manifest.Cell(manifest.load(), args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: this benchmark runs only on the card", 2)
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} seen", 2)
    from a2bench import program

    pcfg = program.config(cell.config_file["model_name"])
    if config_dict(pcfg) != cell.config_file["config"]:
        return fail(f"the program's {cell.config_file['model_name']} differs from "
                    f"{cell.config_entry['file']}", 3)
    torch.cuda.set_device(0)
    result = run(cell, pcfg, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    if isinstance(result, str):
        return fail(result, 3)
    loaded = set(program.loaded_modules()) & set(FORBIDDEN)
    if loaded:
        return fail(f"modules loaded in the measuring process: {sorted(loaded)}", 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run(cell, pcfg, seed: int, seconds: float, traced_run: bool, device: str,
        t_process: float):
    """Everything of a run after the look for the card: the weights, the
    program and its warm-up, the window, the metrics and the check. Returns
    the result (a dict), or a string that says why there is none."""
    import torch

    from a2bench import check, manifest, program, traffic, trace, weights
    from a2bench import window as window_m
    from a2bench.reference import conditioning
    from a2bench.reference import config as rc

    cuda = device == "cuda"
    mix = cell.mix
    traffic.check_mix(mix)
    rcfg = rc.from_dict(cell.config_file["config"])
    prompts = cell.prompts()
    if conditioning.reads_transcription(rcfg) and not all(t for _, t in prompts):
        return (f"{cell.config_file['model_name']} speaks a transcription, and "
                f"traffic/{mix['captions']} has a line without one")
    tree = weights.make(rcfg, seed, device)
    unet_values = weights.count(tree["unet"])
    prog = program.Program(pcfg, tree, device)
    caption, transcription, wseed = traffic.warmup(prompts, seed)
    prog.request(mix, caption, wseed, transcription, steps=mix["warmup_ddim_steps"], keep=False)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # the window: requests back to back from the first one's start until
    # one would start after `seconds`; the last one started runs to its end
    caps, errors = [], []
    recorder = trace.Recorder(TRACED_STEPS) if traced_run else None
    stream = traffic.requests(mix, prompts, seed)
    t_first: Optional[float] = None
    attempted = 0
    while t_first is None or time.perf_counter() - t_first < seconds:
        caption, transcription, rseed = next(stream)
        attempted += 1
        if t_first is None:
            t_first = time.perf_counter()
        first = attempted == 1
        try:
            if recorder is not None and first:
                recorder.start()
                prog.on_step = recorder.step
            caps.append(prog.request(mix, caption, rseed, transcription))
        except Exception:  # a failed request counts against the run and the loop goes on
            errors.append(traceback.format_exc())
            print(errors[-1], file=sys.stderr, flush=True)
        finally:
            if recorder is not None and first:
                recorder.stop()
                prog.on_step = None
    setup_s = t_first - t_process
    t_closed = time.perf_counter()
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    if not caps:
        return f"no request finished ({len(errors)} failed)"

    w = window_m.Window(
        requests=[window_m.Request(c.start, c.end, c.timings, c.steps,
                                   traced=recorder is not None and i == 0)
                  for i, c in enumerate(caps)], setup_s=setup_s,
        mix=mix, cfg=rcfg, unet_values=unet_values,
        trace=recorder.read() if recorder is not None else None)
    metrics = {}
    for m in (cell.per_layer if traced_run else cell.end_to_end):
        value = manifest.reader(m["name"])(w)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else device,
                   "kind": torch.cuda.get_device_name(0) if cuda else device,
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    breakdown = None
    if w.trace is not None:
        device_info["busy_s"] = w.trace.busy_s()
        device_info["window_s"] = w.trace.window_s
        breakdown = {"device_ops": w.trace.device_ops(10), "idle_gaps": w.trace.idle_gaps(10)}
    del w
    t_read = time.perf_counter()

    # the check, after the window: the program's state freed, the reference
    # on the same weights, a request and rows drawn from the seed
    caps_done = len(caps)
    walls = " ".join(f"{c.end - c.start:.3f}" for c in caps)
    k, rows = check.sample(traffic.rng(seed, 1), caps_done, mix)
    cap = caps[k]
    del caps
    prog.close()
    del prog
    if cuda:
        torch.cuda.empty_cache()
    values = check.numbers(check.Reference(rcfg, tree, device), cap, mix, rows, cell.limits)
    correct = not errors and check.judge(values, cell.limits)
    t_checked = time.perf_counter()
    print(f"a2bench: set-up {setup_s:.1f} s, window {t_closed - t_first:.1f} s, "
          f"{caps_done} requests ({walls} s), metrics {t_read - t_closed:.1f} s, "
          f"check {t_checked - t_read:.1f} s", file=sys.stderr, flush=True)

    result = {"correct": bool(correct), "attempted": attempted, "failed": len(errors),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v if math.isfinite(v) else repr(v),
                               "limit": cell.limits.get(name)}
                        for name, v in values.items()}
    return result
