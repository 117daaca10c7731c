"""The ranks' bodies of the port's sharded tests: run by
``audioldm2_torch.parallel.launch.spawn`` in fresh processes, so this module
imports neither jax nor the JAX package (the ranks start faster, and hold
less memory, without them).

Every check of one world size runs in one spawn; each rank returns numpy
results, which the tests hold against JAX's and the unsharded port's."""

import numpy as np
import torch

import audioldm2_torch as at
from audioldm2_torch.parallel import collectives, mesh as mesh_lib, serve


def _model(cfg, tree):
    return at.build_model(config=cfg, device="cpu", params=tree)


def serve_ranks(rank, world, cfg, tree, texts, x_T, noise, seed, ff_tree=None):
    """World 2: the layout (dp 1, tp 2) on JAX's injected draws, (dp 2,
    tp 1) on the seed's draws, and (with ``ff_tree``) the tp products
    (``tp_products``). World 4: (dp 2, tp 2) on JAX's draws, the mesh's
    coordinates, and the divisibility assertion."""
    torch.set_num_threads(1)
    model = _model(cfg, tree)
    kw = dict(duration=0.64, n_gen=1, ddim_steps=4)
    inj = dict(x_T=torch.from_numpy(x_T), noise=torch.from_numpy(noise))
    out = {}
    if world == 2:
        tp_mesh = mesh_lib.make_mesh(world, tp=2, device="cpu")
        gen = serve.ShardedGenerator(model, mesh=tp_mesh)
        out["tp2"] = gen.generate(texts, seed, **kw, **inj)
        out["tp2_sharded"] = gen.n_sharded
        gen = serve.ShardedGenerator(model, mesh=mesh_lib.make_mesh(world, tp=1, device="cpu"))
        out["dp2_seed"] = gen.generate(texts, seed, **kw)
        if ff_tree is not None:
            out["products"] = tp_products(tp_mesh, ff_tree, seed)
    else:
        mesh = mesh_lib.make_mesh(world, device="cpu")  # JAX's default: tp 2
        gen = serve.ShardedGenerator(model, mesh=mesh)
        out["coords"] = (mesh.dp, mesh.tp, mesh.dp_rank, mesh.tp_rank)
        out["dp2tp2"] = gen.generate(texts, seed, **kw, **inj)
        try:
            gen.generate(texts[:1], seed, **kw)
            out["divisibility"] = "no error"
        except AssertionError as e:
            out["divisibility"] = str(e)
    return out


def _rows(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def tp_products(mesh, ff, seed):
    """The tp products on a (dp 1, tp 2) mesh, for the tests to hold
    against the whole ones: a row-parallel linear with its bias, the
    row-parallel GEGLU FF (K4's f32-residual mode; its plain version on the
    CPU) on a column-parallel GEGLU projection, and the gradients of both
    (the replicated input's, the bias's and the rank's slices')."""
    shard = mesh_lib.shard_params({"unet": {"blk": {"ff": ff}}}, mesh)["unet"]["blk"]["ff"]
    c, f = ff["proj_out"]["w"].shape[1], ff["proj_out"]["w"].shape[0]
    x = _rows((3, 5, c), seed).requires_grad_(True)
    lin = {k: v.clone().requires_grad_(True) for k, v in shard["proj_out"].items()}
    a = _rows((3, 5, f), seed + 1)
    a_local = torch.chunk(a, 2, dim=-1)[mesh.tp_rank].clone().requires_grad_(True)
    gin = {k: v.clone().requires_grad_(True) for k, v in shard["proj_in"].items()}
    out = {}
    with collectives.tensor_parallel(mesh):
        y = collectives.row_parallel_linear(lin, a_local)
        h = at.ops.nn.linear(gin, collectives.copy_to_tp(x))
        z = collectives.row_parallel_geglu(lin, h, x)
    (y.square().sum() + z.square().sum()).backward()
    out["linear"] = y.detach().numpy()
    out["geglu"] = z.detach().numpy()
    out["grad_x"] = x.grad.numpy()
    out["grad_b"] = lin["b"].grad.numpy()
    out["grad_w"] = lin["w"].grad.numpy()
    out["grad_in_w"] = gin["w"].grad.numpy()
    out["grad_a"] = a_local.grad.numpy()
    return out
