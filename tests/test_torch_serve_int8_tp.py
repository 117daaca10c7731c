"""The int8 serving mode (``weight_quant="int8"``) under tensor parallelism:
the port's ``ShardedGenerator`` on gloo ranks on the CPU, in f32, against
the unsharded port and against the JAX package's ``ShardedGenerator(tp=2)``
on its 8-device virtual CPU mesh (tests/conftest.py).

The config is the tiny t5 one at model_channels 128, channel_mult (1, 3),
attention at both levels and head width 32: its ladders at C = 128 and 384
have whole shapes at multiples of 128, which the quantization predicate
takes, and tp 2 slices at 64, 192 and 576, which it would refuse. Every
zero leaf of JAX's init is redrawn (the spatial transformers' proj_out is
zero there, which would leave the int8 ST linears out of the output).

- (a) each tp 2 rank's int8 leaves of ``prepare_unet`` equal the slices of
  the unsharded quantization bit for bit;
- (b) with the int8 plain versions' bf16 rounding of the activation turned
  off on both sides, the waveforms at tp 2 (world 2) and dp 2 x tp 2
  (world 4) lie within PORT_TOL, 1e-5 relative, of the unsharded int8
  generate on the same x_T and noise (measured: 8.1e-7 on every rank), and
  one UNet forward on the tp 2 slices within 1e-5 of the whole one
  (measured: 1.7e-6): the tp sums differ from the whole products by f32
  summation order alone. With that rounding kept, as shipped, an
  activation that the two orders put on either side of a bf16 rounding
  boundary moves by a whole bf16 ulp, so the shipped waveforms are held to
  ROUNDING_TOL, 2e-3 relative, of the unsharded shipped generate
  (measured: 4.2e-4 for both worlds; the rounding itself moves the
  unsharded waveform by 3.2e-4);
- (c) within JAX_OP_TOL (2e-2 relative, tests/test_torch_int8.py's bound:
  off the TPU JAX takes an exact-dequant path that does not round the int8
  kernels' activations to bf16) of JAX's tp 2 int8 output, and a mel MAE
  against it within 1.25 times the unsharded port's own (measured: 4.1e-4
  relative, mel MAE 3.06e-3 against the unsharded port's 3.28e-3);
- (d) the int8 row-parallel linear (K5's f32-output mode) and GEGLU FF
  (K3q into K4q's f32-residual mode) at tp 2 within 1e-5 relative of the
  whole int8 ops (measured: 6.8e-7 and 1.1e-7);
- (e) each rank's int8 calls, by kernel and shape, in one UNet forward equal
  the shape functions' tp 2 counts (``models.unet``).

Each world size is one spawn (tests/torch_parallel_workers.py), with a time
limit of its own."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import audioldm2_torch as at
from audioldm2_torch.diffusion.latent_diffusion import prepare_unet
from audioldm2_torch.models import unet as tunet
from audioldm2_torch.ops import nn as tnn
from audioldm2_torch.parallel import launch, mesh as tmesh, serve as tserve
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.parallel.serve import ShardedGenerator as JShardedGenerator
from test_torch_models import nonzero_tree
from test_torch_serve_sharded import _jax_draws, _mel_mae
from tiny import tiny_t5_model_config
from torch_parallel_workers import _rows, int8_activations_unrounded, serve_int8_ranks

TEXTS = ["rain", "wind", "fire", "piano"]
STEPS, DURATION = 4, 0.64
PORT_TOL = 1e-5
ROUNDING_TOL = 2e-3
JAX_OP_TOL = 2e-2
FLOOR_FACTOR = 1.25
SEED = 5
SPAWN_S = 240.0


def int8_tp_config():
    cfg = tiny_t5_model_config()
    return dataclasses.replace(cfg, weight_quant="int8", unet=dataclasses.replace(
        cfg.unet, model_channels=128, channel_mult=(1, 3), attention_resolutions=(1, 2),
        num_head_channels=32))


def _rel(got, want):
    got, want = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def served():
    """JAX's tp 2 output, computed while the two spawns run (each in a
    thread of its own, since each only waits on its ranks), and the
    unsharded port's."""
    cfg = int8_tp_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg, fast=False))
    shape = (len(TEXTS), int(DURATION * cfg.latent_t_per_second), cfg.latent_f_size,
             cfg.latent_channels)
    x_T, noise = _jax_draws(jax.random.PRNGKey(0), shape, STEPS)
    tcfg = at.config.coerce(cfg)
    with ThreadPoolExecutor(2) as pool:
        spawns = {world: pool.submit(launch.spawn, serve_int8_ranks, world,
                                     (tcfg, tree, TEXTS, x_T, noise, SEED), timeout=SPAWN_S)
                  for world in (2, 4)}
        want = JShardedGenerator(jpipe.AudioLDM2(cfg, tree), tp=2).generate(
            TEXTS, jax.random.PRNGKey(0), duration=DURATION, n_gen=1, ddim_steps=STEPS)
        runs = {world: job.result() for world, job in spawns.items()}
    model = at.build_model(config=tcfg, device="cpu", params=tree)
    gen = tserve.ShardedGenerator(model)
    kw = dict(duration=DURATION, n_gen=1, ddim_steps=STEPS, x_T=torch.from_numpy(x_T),
              noise=torch.from_numpy(noise))
    whole = gen.generate(TEXTS, SEED, **kw)
    with int8_activations_unrounded():
        whole_unrounded = gen.generate(TEXTS, SEED, **kw)
    return {"want": np.asarray(want), "runs": runs, "whole": whole,
            "whole_unrounded": whole_unrounded, "model": model, "cfg": tcfg}


def test_int8_tp_is_served(served):
    """ShardedGenerator no longer refuses the int8 mode at tp 2; the mesh
    layouts are JAX's."""
    coords = sorted(out["coords"] for out in served["runs"][4])
    assert coords == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]
    assert [out["coords"] for out in served["runs"][2]] == [(1, 2, 0, 0), (1, 2, 0, 1)]


def _cut(path: str, leaf, tp: int, r: int):
    """Rank r's slice of a leaf of the unsharded prepared int8 tree, as
    ``mesh.shard_params`` cuts the float weights it was quantized from:
    the fused QKV's q, k and v columns each, the GEGLU proj_in's a and gate
    columns each, to_q's columns; to_out's and proj_out's rows (wq; their ws
    stays whole); the rest (the convs, the ST's own 1x1 projections) whole."""
    keys = path.split(".")
    name, leafname = keys[-2], keys[-1]
    in_ff = keys[-3] == "ff"
    col = {"to_qkv": 3, "to_q": 1}.get(name) or (2 if name == "proj_in" and in_ff else 0)
    if col:
        return torch.cat([torch.chunk(b, tp, dim=-1)[r] for b in torch.chunk(leaf, col, dim=-1)],
                         dim=-1)
    if leafname == "wq" and (name == "to_out" or (name == "proj_out" and in_ff)):
        return torch.chunk(leaf, tp, dim=0)[r]
    return leaf


def test_each_rank_quantizes_the_slices_of_the_whole_weights_bitwise(served):
    """(a) On both tp 2 ranks, every wq and ws leaf of prepare_unet equals
    the slice of the unsharded prepare_unet tree's bit for bit: the leaves
    whose slices are no multiple of 128 (N = 64, 192, 576; K = 64, 192) are
    quantized as the whole weight is, and the row-split ones take the whole
    weight's scales."""
    cfg, model = served["cfg"], served["model"]
    ctx = _rows((2, 6, cfg.unet.context_dims[0]), SEED + 2)
    with torch.inference_mode():
        whole, _ = prepare_unet(model.ldm.params, cfg, [ctx])
    leaves = {".".join(map(str, p)): t for p, t in tmesh.leaves_with_paths(whole)
              if p[-1] in ("wq", "ws")}
    odd = set()
    for r, out in enumerate(served["runs"][2]):
        got = out["int8_leaves"]
        assert set(got) == set(leaves)
        for path, leaf in leaves.items():
            want = _cut(path, leaf, 2, r).numpy()
            assert got[path].dtype == want.dtype and got[path].shape == want.shape, path
            np.testing.assert_array_equal(got[path], want, err_msg=path)
            if path.endswith("wq") and leaf.dim() == 2 and any(
                    s % 128 for s in got[path].shape):
                odd.add(path.rsplit(".", 2)[-2])
    assert odd == {"to_qkv", "to_q", "to_out"}
    # 14 transformer blocks of six int8 linears, plus the q of the 21 fused
    # self-attentions (kept beside to_qkv, as in JAX); 8 ResBlocks' two convs
    n_linear = sum(1 for p, t in leaves.items() if p.endswith("wq") and t.dim() == 2)
    n_conv = sum(1 for p, t in leaves.items() if p.endswith("wq") and t.dim() == 4)
    assert n_linear == 14 * 6 + 21 and n_conv == 16


@pytest.mark.parametrize("world,key", [(2, "tp2"), (4, "dp2tp2")])
def test_int8_tp_matches_the_unsharded_port(served, world, key):
    """(b) Every rank's waveforms within PORT_TOL of the unsharded int8
    generate on the same x_T and noise with the int8 plain versions' bf16
    rounding turned off on both sides, and within ROUNDING_TOL of it as
    shipped."""
    whole, unrounded = served["whole"], served["whole_unrounded"]
    assert whole.shape == (4, 1024) and float(np.abs(whole).max()) > 1e-2
    assert _rel(unrounded, whole) > PORT_TOL  # the rounding is on as shipped
    for rank, out in enumerate(served["runs"][world]):
        assert out["wav"].shape == whole.shape, (key, rank)
        err = _rel(out["wav_unrounded"], unrounded)
        assert err <= PORT_TOL, (key, rank, err)
        assert _rel(out["wav"], whole) <= ROUNDING_TOL, (key, rank, _rel(out["wav"], whole))


def test_int8_tp_sums_are_exact_to_f32_order(served):
    """(b) One int8 UNet forward on the tp 2 ranks' slices, with the int8
    plain versions' bf16 rounding of the activation turned off, within 1e-5
    relative of the whole forward: the tp sums differ from the whole
    products by f32 summation order alone."""
    cfg, model = served["cfg"], served["model"]
    ctx = _rows((2, 6, cfg.unet.context_dims[0]), SEED + 2)
    x = _rows((2, 8, 8, cfg.unet.in_channels), SEED + 3)
    with torch.inference_mode(), int8_activations_unrounded():
        unet_p, kv = prepare_unet(model.ldm.params, cfg, [ctx])
        want = tunet.apply_unet(unet_p, cfg.unet, x, torch.tensor([5, 6]), [ctx],
                                [torch.ones(2, 6)], cross_kv=kv).numpy()
    for r, run in enumerate(served["runs"][2]):
        assert _rel(run["eps_unrounded"], want) <= PORT_TOL, (r, _rel(run["eps_unrounded"], want))


@pytest.mark.parametrize("world,key", [(2, "tp2"), (4, "dp2tp2")])
def test_int8_tp_matches_jax_sharded_generator(served, world, key):
    """(c) Within JAX_OP_TOL of JAX's ShardedGenerator(tp=2) int8 output,
    and a mel MAE against it within FLOOR_FACTOR times the unsharded port's
    own."""
    want, whole = served["want"], served["whole"]
    assert want.shape == (4, 1024) and np.isfinite(want).all()
    floor = _mel_mae(served["model"], whole, want)
    for rank, out in enumerate(served["runs"][world]):
        got = out["wav"]
        assert _rel(got, want) <= JAX_OP_TOL, (key, rank, _rel(got, want))
        assert _mel_mae(served["model"], got, want) <= FLOOR_FACTOR * floor, (key, rank)


def test_int8_tp_products_match_the_whole_ones(served):
    """(d) The int8 row-parallel linear and GEGLU FF on tp 2 against the
    whole int8 ops (f32, 1e-5 relative)."""
    blk = served["model"].ldm.params["unet"]["middle_block"]["self_st"]["blocks"][0]
    with torch.inference_mode():
        q = tunet.quantize_st_linears({"blk": {"attn1": blk["attn1"], "ff": blk["ff"]}})["blk"]
        for r, run in enumerate(served["runs"][2]):
            got = run["products"]
            x, a = torch.from_numpy(got["x"]), torch.from_numpy(got["a"])
            y = tnn.linear(q["attn1"]["to_out"], a)
            h = tnn.ln_linear(blk["norm3"], q["ff"]["proj_in"], x, tunet.LN_EPS)
            z = tnn.geglu_ff_out(q["ff"]["proj_out"], h, x)
            assert "wq" in q["attn1"]["to_out"] and "wq" in q["ff"]["proj_out"]
            assert _rel(got["linear"], y) <= PORT_TOL, (r, _rel(got["linear"], y))
            assert _rel(got["geglu"], z) <= PORT_TOL, (r, _rel(got["geglu"], z))


def test_int8_tp_launches_are_the_shape_functions(served):
    """(e) One int8 UNet forward on a rank's slices (latent [2, 8, 8]) calls
    K3q, K4q, K5 and K1q at the shapes and counts of the shape functions at
    tp 2, as many calls as the unsharded forward's
    kernel_launches_per_forward(cfg, "int8"), and no bf16 K1, K3 or K4."""
    u = served["cfg"].unet
    size = (u, 2, 8, 8)
    want = {"ln_matmul_q": tunet.ln_matmul_shapes(*size, weight_quant="int8", tp=2),
            "geglu_matmul_q": tunet.geglu_matmul_shapes(*size, weight_quant="int8", tp=2),
            "int8_matmul": tunet.int8_matmul_shapes(*size, tp=2),
            "gn_silu_conv3x3_q": tunet.conv_shapes(*size, weight_quant="int8")}
    launches = tunet.kernel_launches_per_forward(u, "int8")
    for r, run in enumerate(served["runs"][2]):
        got = {name: {} for name in ("ln_matmul", "geglu_matmul", "gn_silu_conv3x3", *want)}
        for (name, shape), n in run["calls"].items():
            got[name][shape] = n
        for name, shapes in want.items():
            assert got[name] == shapes, (r, name)
            assert sum(shapes.values()) == launches[name] > 0, (r, name)
        assert not got["ln_matmul"] and not got["geglu_matmul"] and not got["gn_silu_conv3x3"]
