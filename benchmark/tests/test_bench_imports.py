"""What the benchmark's modules import, read from their source, and the
result of a run that finds no card."""

import ast
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tiny  # noqa: E402

BENCH = tiny.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "audioldm2_tpu"}


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    checked = 0
    for path in _sources(BENCH):
        found = _top_level_imports(path) & FORBIDDEN
        assert not found, (path, found)
        checked += 1
    assert checked > 20


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "a2bench", "reference")):
        names = _top_level_imports(path)
        assert "audioldm2_torch" not in names, path
        # phonemizer: the phoneme pipeline's optional espeak step, as the program's
        assert names <= {"__future__", "contextlib", "contextvars", "dataclasses", "hashlib",
                         "math", "re", "typing", "numpy", "torch", "a2bench",
                         "phonemizer"}, (path, names)


def test_only_the_program_module_imports_the_program():
    importers = {os.path.relpath(p, BENCH) for p in _sources(os.path.join(BENCH, "a2bench"))
                 if "audioldm2_torch" in _top_level_imports(p)}
    assert importers <= {os.path.join("a2bench", "program.py")}


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "full.batch24",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_folder_of_only_the_benchmark_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "k48.batch8", "--seed", "5",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
