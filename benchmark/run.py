"""Run one cell of the benchmark of ``audioldm2_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Prints one JSON
line (the result) as the last line of standard output; see
``benchmark/README.md``.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")

# every build and kernel cache at a fixed path inside the checkout; no JAX
# behind any library the program loads
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["HF_HUB_OFFLINE"] = "1"
os.environ["TRANSFORMERS_OFFLINE"] = "1"
os.environ.pop("AUDIOLDM2_WEIGHT_QUANT", None)

sys.path[:0] = [HERE, ROOT]

if __name__ == "__main__":
    from a2bench import harness

    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
