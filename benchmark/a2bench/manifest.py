"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[i]``) names a configuration and a traffic mix. The
configuration's file is ``configs/<config>.json`` (its ``file`` in the
manifest), the mix's ``traffic/<traffic>.json``, the cell's limits of
``correct`` ``limits/<cell>.json``, and each metric's reader
``metrics/<metric>.py``, all under the benchmark's folder. A later cell,
mix, configuration or metric is files and manifest entries, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

from a2bench import traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the benchmark's folder
ROOT = os.path.dirname(HERE)  # the checkout


def load() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, manifest: Dict, name: str):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(ROOT, self.config_entry["file"])) as f:
            self.config_file = json.load(f)
        self.mix = _json("traffic", self.entry["traffic"] + ".json")
        self.limits = _json("limits", name + ".json")["limits"]
        self.end_to_end = [m for m in manifest["end_to_end"] if reports(m, name)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e_names)]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def prompts(self) -> List[traffic.Prompt]:
        """The mix's prompts file (``traffic/<captions>``), as
        ``traffic.read_prompts`` reads it."""
        return traffic.read_prompts(os.path.join(HERE, "traffic", self.mix["captions"]))


def reports(metric: Dict, cell: str) -> bool:
    """Whether ``cell`` reports the end-to-end ``metric``."""
    return cell in metric["workloads"] if "workloads" in metric else True


def reader(name: str):
    """The ``read(window)`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("a2bench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
