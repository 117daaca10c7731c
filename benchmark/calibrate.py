"""Readings that set a cell's limits of ``correct`` (not run by the benchmark).

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--first-seed N] [--out FILE]

For each seed, on the card and at the cell's own sizes, as a run makes
them: the weights, one request of the cell's mix through the program, and
every number of ``a2bench.check`` against the float32 reference (the lower
readings). For the first ``--control-seeds`` seeds also the control's
numbers (``check.control_numbers``: the reference in TF32 for the
conditioning and the rerank, in float8 for the DDIM loop, the VAE and the
vocoder; the upper readings). Prints one JSON line a seed and, with
``--out``, writes them all.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ["USE_FLAX"] = "0"
os.environ["HF_HUB_OFFLINE"] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from a2bench import check, manifest, program, traffic, weights
    from a2bench.reference import config as rc

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.Cell(manifest.load(), args.workload)
    mix = cell.mix
    rcfg = rc.from_dict(cell.config_file["config"])
    name = cell.config_file["model_name"]
    rows_out = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        tree = weights.make(rcfg, seed, "cuda")
        prog = program.Program(program.config(name), tree, "cuda")
        caption, transcription, rseed = next(traffic.requests(mix, cell.prompts(), seed))
        _, rows = check.sample(traffic.rng(seed, 1), 1, mix)
        cap = prog.request(mix, caption, rseed, transcription)
        prog.close()
        ref = check.Reference(rcfg, tree, "cuda")
        t0 = time.perf_counter()
        row = {"seed": seed, "rows": rows, "request_s": cap.end - cap.start,
               "program": check.numbers(ref, cap, mix, rows, cell.limits)}
        row["reference_s"] = time.perf_counter() - t0
        if i < args.control_seeds:
            row["control"] = check.control_numbers(ref, cap, mix, rows)
        print(json.dumps(row), flush=True)
        rows_out.append(row)
        del cap, ref, tree
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": cell.name, "device": torch.cuda.get_device_name(0),
                       "readings": rows_out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
