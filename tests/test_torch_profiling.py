"""audioldm2_torch.utils.profiling on the CPU: a trace written to disk, the
op table and the range and busy readings of it; and the
table readers on a hand-written trace with device ops (what the card's
CUPTI trace holds), so that a kernel is counted once, not again as the
runtime call that launched it."""

import json
import os
import time

import pytest
import torch

from audioldm2_torch.utils import profiling


def _work(n=3):
    a = torch.randn(128, 128)
    for _ in range(n):
        with torch.profiler.record_function("unet"):
            b = a @ a
        torch.relu(b)


def test_trace_writes_a_trace_and_op_table_reads_cpu_ops(tmp_path):
    log_dir = str(tmp_path / "prof")
    with profiling.trace(log_dir) as d:
        assert d == log_dir
        _work()
    assert [f for f in os.listdir(log_dir) if f.endswith(".json")]
    table = profiling.op_table(log_dir, top=4)
    assert 0 < len(table) <= 4
    names = [n for n, _ in table]
    assert "aten::mm" in names or "aten::matmul" in names
    ms = [t for _, t in table]
    assert ms == sorted(ms, reverse=True) and ms[0] > 0
    busy, window = profiling.busy_share(log_dir)
    assert busy == 0.0 and window > 0  # no device ops on the CPU
    assert profiling.range_device_ms(log_dir, "unet") == (0.0, 3)


def test_op_table_reads_the_newest_trace(tmp_path):
    log_dir = str(tmp_path)
    with profiling.trace(log_dir):
        torch.relu(torch.randn(64))
    time.sleep(0.05)
    with profiling.trace(log_dir):
        torch.sigmoid(torch.randn(64))
    names = [n for n, _ in profiling.op_table(log_dir)]
    assert "aten::sigmoid" in names and "aten::relu" not in names


def test_op_table_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.op_table(str(tmp_path))


def _device_trace(path):
    """A Chrome trace shaped like the card's: two runtime launches inside a
    "unet" range, their kernels (correlation ids 1, 2), one kernel launched
    outside it (3), a copy and an overlap of kernels 1 and 2."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "unet", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150, "dur": 5,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 30, "dur": 40,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 50, "dur": 40,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 200, "dur": 10,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 300, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 1000},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_device_tables_count_each_kernel_once(tmp_path):
    _device_trace(str(tmp_path / "t.json"))
    table = dict(profiling.op_table(str(tmp_path)))
    assert table == {"k_a": 0.05, "k_b": 0.04, "Memcpy DtoH": 0.1}  # no cudaLaunchKernel, no CPU op
    busy, window = profiling.busy_share(str(tmp_path))
    assert busy == pytest.approx((90 - 30 + 10 + 100) / 1e3)  # k_a and k_b overlap
    assert window == pytest.approx(1.005)
    assert profiling.range_device_ms(str(tmp_path), "unet") == (pytest.approx(0.08), 1)


def test_range_falls_back_to_the_device_side_range(tmp_path):
    ev = [{"ph": "X", "cat": "gpu_user_annotation", "name": "unet", "ts": 0, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 20, "args": {}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 60, "dur": 20, "args": {}}]
    with open(tmp_path / "t.json", "w") as f:
        json.dump({"traceEvents": ev}, f)
    assert profiling.range_device_ms(str(tmp_path), "unet") == (pytest.approx(0.02), 0)
