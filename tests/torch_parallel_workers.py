"""The ranks' bodies of the port's sharded tests: run by
``audioldm2_torch.parallel.launch.spawn`` in fresh processes, so this module
imports neither jax nor the JAX package (the ranks start faster, and hold
less memory, without them).

Every check of one world size runs in one spawn; each rank returns numpy
results, which the tests hold against JAX's and the unsharded port's."""

import contextlib

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


# ---------------------------------------------------------------------------
# The int8 serving mode under tp (tests/test_torch_serve_int8_tp.py)
# ---------------------------------------------------------------------------


def _int8_leaves(tree):
    """{dotted path: numpy} of every wq / ws leaf of a prepared UNet tree."""
    return {".".join(map(str, path)): leaf.numpy()
            for path, leaf in mesh_lib.leaves_with_paths(tree) if path[-1] in ("wq", "ws")}


def _recorded_int8_calls():
    """Wrap the int8 (and bf16 K3/K4) wrappers so that each call is recorded
    as (kernel, shape) the way the shape functions of ``models.unet`` key
    it; returns (calls, restore)."""
    from audioldm2_torch.ops import lnmm_kernel, resblock_kernel

    calls = {}
    saved = []

    def rec(mod, name, key):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(*a, **kw):
            k = (name, key(*a))
            calls[k] = calls.get(k, 0) + 1
            return fn(*a, **kw)

        setattr(mod, name, wrapped)

    rows = lambda t: t.numel() // t.shape[-1]  # noqa: E731
    rec(lnmm_kernel, "ln_matmul_q", lambda x, g, b, wq, *r: (rows(x), wq.shape[0], wq.shape[1]))
    rec(lnmm_kernel, "geglu_matmul_q", lambda h, wq, *r: (rows(h), wq.shape[0], wq.shape[1]))
    rec(lnmm_kernel, "int8_matmul", lambda x, wq, *r: (rows(x), wq.shape[0], wq.shape[1]))
    rec(resblock_kernel, "gn_silu_conv3x3_q", lambda x1, x2, g, b, wq, *r: (
        *x1.shape, 0 if x2 is None else x2.shape[-1], wq.shape[-1]))
    for name in ("ln_matmul", "geglu_matmul"):
        rec(lnmm_kernel, name, lambda *a: ())
    rec(resblock_kernel, "gn_silu_conv3x3", lambda *a: ())

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return calls, restore


@contextlib.contextmanager
def int8_activations_unrounded():
    """The int8 plain versions (K1q, K3q, K4q on the CPU) with their bf16
    rounding of the activation turned off: the exact-dequant products that
    the JAX package computes off the TPU. With it the tp sums can be held
    to f32 summation order, which a bf16 rounding boundary would otherwise
    amplify to a whole bf16 ulp of one activation."""
    from audioldm2_torch.ops import lnmm_kernel, resblock_kernel

    saved = lnmm_kernel.BF16, resblock_kernel.BF16
    lnmm_kernel.BF16 = resblock_kernel.BF16 = torch.float32
    try:
        yield
    finally:
        lnmm_kernel.BF16, resblock_kernel.BF16 = saved


def serve_int8_ranks(rank, world, cfg, tree, texts, x_T, noise, seed):
    """The int8 serving mode (``cfg.weight_quant == "int8"``) on a (dp 1,
    tp 2) mesh (world 2) or JAX's (dp 2, tp 2) one (world 4): the generate
    on injected draws, as shipped and with the int8 plain versions' bf16
    rounding turned off (``int8_activations_unrounded``); with world 2 also the rank's int8 leaves of
    ``prepare_unet`` (the quantization), the int8 tp products on the middle
    block's first self-ST (``int8_tp_products``) and the (kernel, shape)
    calls of one int8 UNet forward on the rank's slices."""
    from audioldm2_torch.diffusion.latent_diffusion import prepare_unet
    from audioldm2_torch.models import unet as unet_lib

    model = _model(cfg, tree)
    mesh = mesh_lib.make_mesh(world, tp=2, device="cpu")
    gen = serve.ShardedGenerator(model, mesh=mesh)
    draws = {"x_T": torch.from_numpy(x_T), "noise": torch.from_numpy(noise)}
    out = {"coords": (mesh.dp, mesh.tp, mesh.dp_rank, mesh.tp_rank),
           "wav": gen.generate(texts, seed, duration=0.64, n_gen=1, ddim_steps=4, **draws)}
    with int8_activations_unrounded():
        out["wav_unrounded"] = gen.generate(texts, seed, duration=0.64, n_gen=1, ddim_steps=4,
                                            **draws)
    if world != 2:
        return out
    ctx = _rows((2, 6, cfg.unet.context_dims[0]), seed + 2)
    with collectives.tensor_parallel(mesh), torch.inference_mode():
        unet_p, kv = prepare_unet(gen.params, cfg, [ctx])
        out["int8_leaves"] = _int8_leaves(unet_p)
        x = _rows((2, 8, 8, cfg.unet.in_channels), seed + 3)
        args = (unet_p, cfg.unet, x, torch.tensor([5, 6]), [ctx], [torch.ones(2, 6)])
        calls, restore = _recorded_int8_calls()
        try:
            unet_lib.apply_unet(*args, cross_kv=kv)
        finally:
            restore()
        with int8_activations_unrounded():
            out["eps_unrounded"] = unet_lib.apply_unet(*args, cross_kv=kv).numpy()
    out["calls"] = calls
    out["products"] = int8_tp_products(mesh, gen.params["unet"], seed)
    return out


def int8_tp_products(mesh, unet_shard, seed):
    """On the middle block's first self-ST (this rank's slices): attn1's
    to_out as an int8 row-parallel linear (K5 in its f32-output mode; its
    plain version on the CPU) of a's columns, and the FF as the
    column-parallel int8 LN projection (K3q) into the row-parallel int8
    GEGLU output (K4q in its f32-residual mode) of x, both quantized as
    ``quantize_st_linears`` does under tp."""
    from audioldm2_torch.models import unet as unet_lib
    from audioldm2_torch.ops import nn

    blk = unet_shard["middle_block"]["self_st"]["blocks"][0]
    c = blk["attn1"]["to_out"]["w"].shape[1]
    x, a = _rows((3, 5, c), seed), _rows((3, 5, c), seed + 1)
    a_local = torch.chunk(a, mesh.tp, dim=-1)[mesh.tp_rank]
    with collectives.tensor_parallel(mesh), torch.inference_mode():
        q = unet_lib.quantize_st_linears({"blk": {"attn1": blk["attn1"], "ff": blk["ff"]}})["blk"]
        y = collectives.row_parallel_linear(q["attn1"]["to_out"], a_local)
        h = nn.ln_linear(blk["norm3"], q["ff"]["proj_in"], x, unet_lib.LN_EPS)
        z = collectives.row_parallel_geglu(q["ff"]["proj_out"], h, x)
    return {"linear": y.numpy(), "geglu": z.numpy(), "x": x.numpy(), "a": a.numpy()}
