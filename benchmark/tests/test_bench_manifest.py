"""``BENCHMARK.json`` against the benchmark's contract, and the files it names."""

import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

import tiny  # noqa: E402
from a2bench import manifest, traffic  # noqa: E402

ROOT = tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and len(bench["command"]) <= 32
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch") and not p.startswith("/")
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits in 43200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group if group in ("configs", "workloads") else "metric",
                          entry["name"]))
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in ([w["why"] for w in bench["workloads"]] + [c["why"] for c in bench["configs"]]
                 + [c["source"] for c in bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]] + bench["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    allowed = {"name", "unit", "better", "bound", "source", "workloads"}
    for m in e2e.values():
        assert set(m) <= allowed and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for cell in cells:
        reported = [n for n, m in e2e.items() if manifest.reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2


def test_per_layer_workloads_match_their_end_to_end_metric(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert manifest.reports(e2e[m["moves"]], cell), (m["name"], cell)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m["workloads"] for m in bench["per_layer"]), cell


def test_cells_configs_and_their_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == [] and set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        cell = manifest.Cell(bench, w["name"])
        traffic.check_mix(cell.mix)
        assert len(cell.prompts()) >= 16
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        for m in cell.end_to_end + cell.per_layer:
            assert callable(manifest.reader(m["name"]))


def test_configuration_files_hold_the_programs_configuration(bench):
    from audioldm2_torch.config import default_audioldm_config
    from a2bench.reference import config as rc

    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            doc = json.load(f)
        assert doc["model_name"] == c["name"]
        want = json.loads(json.dumps(rc.to_dict(default_audioldm_config(c["name"]))))
        assert doc["config"] == want
        assert rc.to_dict(rc.from_dict(doc["config"])) == doc["config"]


def test_command_names_only_the_benchmarks_files(bench):
    assert bench["command"][0] == "python3"
    for word in bench["command"][1:]:
        assert any(word == p or word.startswith(p + "/") for p in bench["paths"])
        assert os.path.isfile(os.path.join(ROOT, word))
