"""The port's ``ShardedGenerator`` (``audioldm2_torch/parallel/serve.py``)
on gloo ranks on the CPU, in f32, against the JAX package's on its
8-device virtual CPU mesh (tests/conftest.py).

JAX's ``ShardedGenerator(tp=2)`` serves 8 prompts (dp 4 x tp 2) on the tiny
t5 config, 4 DDIM steps, 0.64 s. The port serves them at tp 2 (world 2)
and at dp 2 x tp 2 (world 4) with JAX's x_T and per-step noise, which are
reproduced from JAX's key as ``ddim_sample`` draws them: both within the
JAX test's own bound (tests/test_serve_sharded.py: atol 2e-4, rtol 1e-3)
and a mel MAE < 1e-3. The port's dp 2 output on its own seed's draws
equals its dp 1 output within 1e-5 (the noise does not depend on dp).
Each world size is one spawn (tests/torch_parallel_workers.py), with a
time limit of its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audioldm2_torch as at
from audioldm2_torch.parallel import launch, mesh as tmesh, serve as tserve
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.parallel.serve import ShardedGenerator as JShardedGenerator
from tiny import tiny_t5_model_config
from torch_parallel_workers import serve_ranks

TEXTS = ["rain", "wind", "fire", "birdsong", "thunder", "waves", "engine", "piano"]
STEPS, DURATION = 4, 0.64
ATOL, RTOL, MEL_MAE = 2e-4, 1e-3, 1e-3
DP_TOL = 1e-5
SEED = 5
SPAWN_S = 240.0


def _jax_draws(key, shape, steps):
    """x_T and the per-step noise of JAX's ddim_sample for ``key``."""
    key, k_init = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, shape, jnp.float32))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.split(sk)[1], shape, jnp.float32))
                      for sk in jax.random.split(key, steps)])
    return x_T, noise


@pytest.fixture(scope="module")
def served():
    cfg = tiny_t5_model_config()
    tree = jax.tree.map(np.asarray, jpipe.init_params(jax.random.PRNGKey(0), cfg, fast=False))
    want = JShardedGenerator(jpipe.AudioLDM2(cfg, tree), tp=2).generate(
        TEXTS, jax.random.PRNGKey(0), duration=DURATION, n_gen=1, ddim_steps=STEPS)
    shape = (len(TEXTS), int(DURATION * cfg.latent_t_per_second), cfg.latent_f_size,
             cfg.latent_channels)
    x_T, noise = _jax_draws(jax.random.PRNGKey(0), shape, STEPS)
    tcfg = at.config.coerce(cfg)
    ff = tparams_ff(tree)
    runs = {world: launch.spawn(serve_ranks, world,
                                (tcfg, tree, TEXTS, x_T, noise, SEED, ff if world == 2 else None),
                                timeout=SPAWN_S)
            for world in (2, 4)}
    model = at.build_model(config=tcfg, device="cpu", params=tree)
    dp1 = tserve.ShardedGenerator(model).generate(TEXTS, SEED, duration=DURATION, n_gen=1,
                                                  ddim_steps=STEPS)
    return {"want": np.asarray(want), "runs": runs, "dp1": dp1, "model": model, "ff": ff}


def tparams_ff(tree):
    """The middle block's first self-ST FF leaves, as torch tensors."""
    from audioldm2_torch.params import from_jax_tree

    return from_jax_tree(tree["unet"]["middle_block"]["self_st"]["blocks"][0]["ff"])


def _mel_mae(model, a, b):
    return float(np.abs(model.mel.mel(a).numpy() - model.mel.mel(b).numpy()).mean())


@pytest.mark.parametrize("world,key", [(2, "tp2"), (4, "dp2tp2")])
def test_sharded_port_matches_jax_sharded_generator(served, world, key):
    want = served["want"]
    assert want.shape == (8, 1024) and np.isfinite(want).all()
    for rank, out in enumerate(served["runs"][world]):  # every rank returns every waveform
        got = out[key]
        assert got.shape == want.shape, (rank, got.shape)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        assert _mel_mae(served["model"], got, want) < MEL_MAE


def test_dp2_equals_dp1_for_one_seed(served):
    dp1 = served["dp1"]
    assert dp1.shape == (8, 1024) and float(np.abs(dp1).max()) > 1e-2
    for out in served["runs"][2]:
        assert float(np.abs(out["dp2_seed"] - dp1).max()) <= DP_TOL


def test_mesh_layout_and_sharded_count(served):
    coords = sorted(out["coords"] for out in served["runs"][4])
    assert coords == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]
    n = tmesh.sharded_leaf_count(served["model"].ldm.params)
    assert all(out["tp2_sharded"] == n > 0 for out in served["runs"][2])


def test_divisibility_guard(served):
    for out in served["runs"][4]:
        assert "must divide over dp=2" in out["divisibility"]
    gen = tserve.ShardedGenerator(served["model"], mesh=tmesh.Mesh(dp=2, tp=1))
    with pytest.raises(AssertionError, match="must divide over dp=2"):
        gen.generate(["a"], 0, duration=DURATION, n_gen=1, ddim_steps=STEPS)


def test_tp_products_match_the_whole_ones(served):
    """The row-parallel linear and GEGLU FF, and their gradients, on tp 2
    against the unsharded ops (f32, tolerance 1e-5 relative)."""
    from audioldm2_torch.ops import nn
    from torch_parallel_workers import _rows

    ff = served["ff"]
    c, f = ff["proj_out"]["w"].shape[1], ff["proj_out"]["w"].shape[0]
    x = _rows((3, 5, c), SEED).requires_grad_(True)
    a = _rows((3, 5, f), SEED + 1).requires_grad_(True)
    lin = {k: v.clone().requires_grad_(True) for k, v in ff["proj_out"].items()}
    gin = {k: v.clone().requires_grad_(True) for k, v in ff["proj_in"].items()}
    y = nn.linear(lin, a)
    z = nn.geglu_ff_out(lin, nn.linear(gin, x), x)
    (y.square().sum() + z.square().sum()).backward()
    w_in = gin["w"].grad
    for r, got in enumerate(out["products"] for out in served["runs"][2]):
        def close(name, want):
            want = want.detach().numpy()
            err = float(np.abs(got[name] - want).max() / np.abs(want).max())
            assert err <= DP_TOL, (r, name, err)

        close("linear", y)
        close("geglu", z)
        close("grad_x", x.grad)  # whole on every rank
        close("grad_b", lin["b"].grad)
        close("grad_w", torch.chunk(lin["w"].grad, 2, 0)[r])
        close("grad_a", torch.chunk(a.grad, 2, -1)[r])
        wa, wg = torch.chunk(w_in, 2, -1)
        close("grad_in_w", torch.cat([torch.chunk(wa, 2, -1)[r], torch.chunk(wg, 2, -1)[r]], -1))
