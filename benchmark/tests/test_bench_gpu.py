"""On the card: the program passes a cell's limits and the control fails them,
at the cell's own size (``pytest -m gpu benchmark/tests`` on the card; skips
without one)."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

import tiny  # noqa: E402,F401  (puts the benchmark's folder on the path)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["full.batch24"])
def test_program_passes_and_control_fails_at_the_cells_size(cell, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import calibrate
    from a2bench import check, manifest

    out = tmp_path / "readings.json"
    assert calibrate.main(["--workload", cell, "--seeds", "1", "--control-seeds", "1",
                           "--first-seed", "3900000001", "--out", str(out)]) == 0
    reading = json.loads(out.read_text())["readings"][0]
    limits = manifest.Cell(manifest.load(), cell).limits
    assert check.judge(reading["program"], limits), reading["program"]
    control = reading["control"]
    assert not check.judge(control, {k: v for k, v in limits.items() if k in control}), control
