"""The UNet forward's CUDA graph (``audioldm2_torch/diffusion/unet_graph.py``)
on the CPU: where it engages, its counters in ``last_timings``, and its
calls, captures, replays and launch counts with a stand-in device whose
"graph" reruns the captured function (the card's tests are in
``tests/test_torch_gpu.py``)."""

import dataclasses

import pytest
import torch

import audioldm2_torch as at
from audioldm2_torch import config as config_m
from audioldm2_torch import ops
from audioldm2_torch.diffusion import unet_graph
from audioldm2_torch.ops import resblock_kernel
from audioldm2_torch.parallel import collectives
from audioldm2_torch.utils import profiling
from tiny import tiny_t5_model_config

torch.set_num_threads(2)

KW = dict(duration=0.32, duration_bucket=None, n_candidate_gen_per_text=1)
LAUNCHES = 3  # the stand-in forward's conv2d launches


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(config_m.coerce(tiny_t5_model_config()),
                              diffusion=config_m.DiffusionConfig(timesteps=20))
    return at.build_model(config=cfg, device="cpu", seed=0, nonzero_init=True)


def test_engages_on_cuda_with_one_rank_and_grad_off(monkeypatch):
    with torch.no_grad():
        assert unet_graph.engages("cuda")
        assert unet_graph.engages(torch.device("cuda", 1))
        assert not unet_graph.engages("cpu")
        monkeypatch.setattr(collectives, "tp_size", lambda: 2)
        assert not unet_graph.engages("cuda")
    monkeypatch.setattr(collectives, "tp_size", lambda: 1)
    with torch.enable_grad():
        assert not unet_graph.engages("cuda")
    with torch.inference_mode():
        assert unet_graph.engages("cuda")


@pytest.mark.parametrize("sampler", ["ddim", "plms", "ddpm"])
def test_counters_are_in_last_timings_and_zero_on_the_cpu(model, sampler):
    at.text_to_audio(model, "rain", seed=3, ddim_steps=4, sampler=sampler, **KW)
    t = model.last_timings
    assert t["unet_graph_captures"] == 0 and t["unet_graph_replays"] == 0
    assert t["sampler_steps"] > 0


def test_on_the_cpu_the_forward_runs_as_it_is():
    x, t = torch.randn(2, 3), torch.tensor([5, 5])
    out = x * 2
    graphed = unet_graph.GraphedForward(lambda a, b: out)
    assert graphed(x, t) is out and graphed(x, t) is out
    assert graphed.calls == 0 and graphed.graph is None


class _Graph:
    """Replays by running the captured function again into its output."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):  # a replay runs no Python: the counts stay as they were
        n = resblock_kernel.conv2d.launches
        self.out.copy_(self.fn())
        resblock_kernel.conv2d.launches = n


class _Device:
    def __init__(self):
        self.owner = lambda: None
        self.eager_calls = 0
        self.captures = 0

    def eager(self, fn):
        self.eager_calls += 1
        return fn()

    def capture(self, fn):
        self.captures += 1
        out = fn()
        return _Graph(fn, out), out


def _forward(x, t):
    resblock_kernel.conv2d.launches += LAUNCHES
    return x * 2.0 + t.float()[:, None]


@pytest.fixture
def device(monkeypatch):
    dev = _Device()
    monkeypatch.setattr(unet_graph, "engages", lambda device: True)
    monkeypatch.setattr(unet_graph, "_device", lambda device: dev)
    ops.reset_launch_counts()
    yield dev
    ops.reset_launch_counts()


def _inputs(i, rows=2):
    g = torch.Generator().manual_seed(i)
    return torch.randn(rows, 4, generator=g), torch.randint(0, 1000, (rows,), generator=g)


def test_one_eager_call_one_capture_then_replays(device):
    with profiling.request("cpu") as req:
        graphed = unet_graph.GraphedForward(_forward)
        outs = []
        for i in range(5):
            x, t = _inputs(i)
            outs.append(graphed(x, t))
            assert torch.equal(outs[-1], _forward(x, t))
    assert device.eager_calls == 1 and device.captures == 1
    # 5 calls and 5 direct forwards: the capture counts nothing, each replay its launches
    assert ops.launch_counts()["conv2d"] == 10 * LAUNCHES
    for i, out in enumerate(outs):  # no call's output was overwritten by a later replay
        assert torch.equal(out, _forward(*_inputs(i)))
    static_out = graphed.static[2]
    assert all(o.data_ptr() != static_out.data_ptr() for o in outs)
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert req.timings() == {"unet_graph_captures": 1, "unet_graph_replays": 4}


def test_a_capture_retires_the_live_graph(device):
    a, b = unet_graph.GraphedForward(_forward), unet_graph.GraphedForward(_forward)
    for i in range(2):
        a(*_inputs(i))
    assert a.graph is not None and device.owner() is a
    b(*_inputs(2))  # eager
    assert a.graph is not None
    assert torch.equal(b(*_inputs(3)), _forward(*_inputs(3)))  # captures: a's graph goes
    assert a.graph is None and device.owner() is b
    assert torch.equal(a(*_inputs(4)), _forward(*_inputs(4)))  # a captures anew
    assert b.graph is None and device.owner() is a and device.captures == 3


def test_a_new_shape_captures_anew(device):
    graphed = unet_graph.GraphedForward(_forward)
    for i in range(3):
        graphed(*_inputs(i))
    x, t = _inputs(3, rows=4)
    assert torch.equal(graphed(x, t), _forward(x, t))
    assert device.captures == 2 and graphed.static[0].shape == x.shape


def test_a_dropped_forward_leaves_no_live_graph(device):
    graphed = unet_graph.GraphedForward(_forward)
    for i in range(3):
        graphed(*_inputs(i))
    del graphed
    assert device.owner() is None


def test_add_counts_adds_times_the_counts():
    ops.reset_launch_counts()
    launches = dict.fromkeys(ops.launch_counts(), 0)
    launches.update(ln_matmul=2, conv2d=3)
    ops.add_counts(launches, {"conv2d": 1}, times=4)
    counts = ops.launch_counts()
    assert counts.pop("ln_matmul") == 8 and counts.pop("conv2d") == 12
    assert set(counts.values()) == {0}
    assert ops.declined_counts() == {"conv2d": 4}
    ops.add_counts(launches, {"conv2d": 1}, times=-4)
    assert set(ops.launch_counts().values()) == {0} and ops.declined_counts() == {"conv2d": 0}
