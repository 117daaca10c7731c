"""Training in audioldm2_torch against audioldm2_tpu (CPU, float32).

The same numpy parameter tree and inputs go through the JAX functions and
their ports; the port is given JAX's own random draws (t, the eps noise and
the posterior noise from JAX's key split, ``train.py:129-138``). Also here:
the autograd Functions of the hand kernels (``ops.autograd``), with the
plain version standing in for the kernel, and the wrappers' routing with
``torch.Tensor.is_cuda`` patched and a recording stand-in for the kernel
library, as ``test_torch_kernel_plans.py`` does.

Tolerances (f32): losses within 1e-5 relative; gradients within 1e-4 of
JAX's, as max |diff| over max |JAX| per leaf; parameters after AdamW steps
within 1e-5; the EMA within 1e-7; KL and NLL within 1e-6 relative; the
CLAP loss within 1e-6.
"""

import math
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import audioldm2_torch as at
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from audioldm2_tpu.models import unet as junet
from audioldm2_tpu.models import vae as jvae
from audioldm2_tpu.parallel import ema as jema
from audioldm2_tpu.parallel import train as jtrain
from audioldm2_torch import ops
from audioldm2_torch.config import UNetConfig, coerce
from audioldm2_torch.diffusion.schedule import DiffusionSchedule
from audioldm2_torch.models import unet as tunet
from audioldm2_torch.models import vae as tvae
from audioldm2_torch.ops import _build, attention_kernel as ak, autograd
from audioldm2_torch.ops import groupnorm_kernel as gk, lnmm_kernel as lk, resblock_kernel as rk
from audioldm2_torch.params import from_jax_tree
from audioldm2_torch.parallel import ema as tema
from audioldm2_torch.parallel import train as ttrain
from test_torch_full import tiny_full_config
from test_torch_kernel_plans import SMS, _Recorder
from test_torch_models import nonzero_tree
from tiny import tiny_t5_model_config

torch.set_num_threads(2)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# A leaf whose exact gradient is zero (in the tiny configs the emb and conv
# biases that a GroupNorm of one channel a group cancels) holds f32 rounding
# only, about 1e-8 of the tree's largest gradient in either package; such a
# leaf (below ZERO_GRAD of the largest) is held to ZERO_GRAD of the largest
# in absolute terms instead of to a share of its own noise.
ZERO_GRAD = 1e-6


def _leaves_close(got, want, tol):
    """Per leaf: max |got - want| <= tol * max |want|; a leaf of
    rounding-level gradient (see ZERO_GRAD) within ZERO_GRAD of the tree's
    largest gradient. Returns the worst relative error of the others."""
    g, w = dict(_paths(got)), dict(_paths(want))
    assert g.keys() == w.keys()
    gmax = max(float(np.abs(np.asarray(v)).max()) for v in w.values())
    worst = 0.0
    for k, wv in w.items():
        wv = np.asarray(wv)
        gv = g[k].detach().numpy() if isinstance(g[k], torch.Tensor) else np.asarray(g[k])
        assert gv.shape == wv.shape, k
        err, scale = float(np.abs(gv - wv).max()), float(np.abs(wv).max())
        if scale < ZERO_GRAD * gmax:
            assert err <= ZERO_GRAD * gmax, (k, err, gmax)
        else:
            assert err <= tol * scale, (k, err / scale)
            worst = max(worst, err / scale)
    return worst


def _consts_jax(schedule):
    return {"num_timesteps": schedule.num_timesteps,
            "sqrt_alphas_cumprod": jnp.asarray(schedule.sqrt_alphas_cumprod),
            "sqrt_one_minus_alphas_cumprod": jnp.asarray(schedule.sqrt_one_minus_alphas_cumprod)}


def _key_draws(key, x0_shape, b, num_timesteps=1000):
    """JAX's own draws for full_diffusion_loss's key (train.py:129-138):
    (posterior noise, t, eps noise) as numpy."""
    k_enc, k_t, k_n = jax.random.split(key, 3)
    return (np.asarray(jax.random.normal(k_enc, x0_shape, jnp.float32)),
            np.asarray(jax.random.randint(k_t, (b,), 0, num_timesteps)),
            np.asarray(jax.random.normal(k_n, x0_shape, jnp.float32)))


# ---------------------------------------------------------------------------
# diffusion_loss on the tiny UNet
# ---------------------------------------------------------------------------


def test_diffusion_loss_and_gradients_match_jax():
    cfg = tiny_t5_model_config().unet
    tree = nonzero_tree(junet.init_unet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    batch = {"latent": rng.standard_normal((2, 16, 8, cfg.in_channels)).astype(np.float32),
             "context": rng.standard_normal((2, 6, cfg.context_dims[0])).astype(np.float32),
             "context_mask": np.array([[1] * 6, [1, 1, 1, 0, 0, 0]], np.float32)}
    schedule = JSchedule.create()
    key = jax.random.PRNGKey(3)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jtrain.diffusion_loss(p, cfg, _consts_jax(schedule), batch, key))(tree)
    k_t, k_n = jax.random.split(key)
    t = np.asarray(jax.random.randint(k_t, (2,), 0, schedule.num_timesteps))
    noise = np.asarray(jax.random.normal(k_n, batch["latent"].shape, jnp.float32))

    params = from_jax_tree(tree)
    leaves = [leaf.requires_grad_(True) for _, leaf in _paths(params)]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    consts = ttrain.schedule_consts(DiffusionSchedule.create(), "cpu")
    loss_t = ttrain.diffusion_loss(params, coerce(cfg, UNetConfig), consts, tbatch,
                                   t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    grads = torch.autograd.grad(loss_t, leaves)
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_TOL * abs(float(loss_j))
    paths = [p for p, _ in _paths(params)]
    _leaves_close(dict(zip(paths, grads)), dict(_paths(jax.device_get(grads_j))), GRAD_TOL)


# ---------------------------------------------------------------------------
# make_full_train_step against optax.adamw
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def t5_tree():
    return nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), tiny_t5_model_config()))


def _fbank_batch(jmodel, seed=0):
    batch = jmodel.make_batch("rain", batchsize=2)
    batch["fbank"] = np.random.default_rng(seed).standard_normal(
        (2, 32, 16, 1)).astype(np.float32)
    return {k: np.asarray(v) for k, v in batch.items()}


# Adam divides each gradient element by its own magnitude plus eps. At
# optax's eps 1e-8 an element whose exact gradient is zero (the emb and conv
# biases that a GroupNorm of one channel a group cancels, about 3e-9 of
# rounding in either package) moves by +-lr at the sign of that rounding,
# so the step parity runs at eps 1e-3 in both packages (an element's step
# then follows its gradient, which agrees to 1e-4); the optimizer alone is
# held to optax.adamw at its defaults in test_adamw_is_optax_adamw.
PARITY_EPS = 1e-3


@pytest.mark.parametrize("train_unet_only,steps", [(True, 3), (False, 1)])
def test_full_train_step_matches_optax_adamw(t5_tree, train_unet_only, steps):
    cfg = tiny_t5_model_config()
    jmodel = jpipe.AudioLDM2(cfg, t5_tree)
    jp = jmodel.ldm.params
    tp = at.build_model(config=cfg, device="cpu", params=t5_tree).ldm.params
    batch = _fbank_batch(jmodel)
    opt = optax.adamw(1e-3, eps=PARITY_EPS)
    jstep = jax.jit(jtrain.make_full_train_step(cfg, opt, train_unet_only))
    jstate = opt.init(jp["unet"] if train_unet_only else jp)
    topt = ttrain.AdamW(1e-3, eps=PARITY_EPS)
    tstep = ttrain.make_full_train_step(coerce(cfg), topt, train_unet_only)
    tstate = topt.init(tp["unet"] if train_unet_only else tp)
    latent = jvae.encode_moments(jp["vae"], cfg.vae, batch["fbank"])[0].shape
    for i in range(steps):
        key = jax.random.PRNGKey(10 + i)
        post, t, noise = _key_draws(key, latent, 2)
        jp, jstate, loss_j = jstep(jp, jstate, batch, key)
        tp, tstate, loss_t = tstep(tp, tstate, batch, t=torch.from_numpy(t),
                                   noise=torch.from_numpy(noise),
                                   posterior_noise=torch.from_numpy(post))
        assert abs(loss_t.item() - float(loss_j)) <= LOSS_TOL * abs(float(loss_j)), i
        got = tp["unet"] if train_unet_only else tp
        want = jax.device_get(jp["unet"] if train_unet_only else jp)
        g, w = dict(_paths(got)), dict(_paths(want))
        assert g.keys() == w.keys()
        for k in w:
            err = np.abs(g[k].detach().numpy() - np.asarray(w[k])).max()
            assert err <= PARAM_TOL, (i, k, err)
    frozen = dict(_paths(tp["vae"]))
    assert all(leaf.requires_grad != train_unet_only for leaf in frozen.values())


def test_full_train_step_loss_and_gradients_on_the_full_family():
    """audioldm2-full in miniature (the sequence generator's CLAP + T5
    context and a second T5 slot): the loss and every UNet gradient of one
    full_diffusion_loss against JAX's."""
    cfg = tiny_full_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    jmodel = jpipe.AudioLDM2(cfg, tree)
    jp = jmodel.ldm.params
    tp = at.build_model(config=cfg, device="cpu", params=tree).ldm.params
    batch = _fbank_batch(jmodel, seed=4)
    d = cfg.diffusion
    schedule = JSchedule.create(d.timesteps, d.beta_schedule, d.linear_start, d.linear_end)
    key = jax.random.PRNGKey(5)

    def loss_fn(unet_p):
        return jtrain.full_diffusion_loss({**jp, "unet": unet_p}, cfg, _consts_jax(schedule),
                                          batch, key)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jp["unet"])
    mean, _ = jvae.encode_moments(jp["vae"], cfg.vae, batch["fbank"])
    post, t, noise = _key_draws(key, mean.shape, 2, schedule.num_timesteps)
    leaves = [leaf.requires_grad_(True) for _, leaf in _paths(tp["unet"])]
    consts = ttrain.schedule_consts(DiffusionSchedule.create(
        d.timesteps, d.beta_schedule, d.linear_start, d.linear_end), "cpu")
    loss_t = ttrain.full_diffusion_loss(tp, coerce(cfg), consts, batch, t=torch.from_numpy(t),
                                        noise=torch.from_numpy(noise),
                                        posterior_noise=torch.from_numpy(post),
                                        train_unet_only=True)
    grads = torch.autograd.grad(loss_t, leaves)
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_TOL * abs(float(loss_j))
    paths = [p for p, _ in _paths(tp["unet"])]
    _leaves_close(dict(zip(paths, grads)), dict(_paths(jax.device_get(grads_j))), GRAD_TOL)


def test_adamw_is_optax_adamw():
    """The optimizer alone at optax.adamw's defaults (b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4): three steps on given gradients, parameters
    within 1e-6 of optax's (the two orders of the same f32 formula differ
    by a few ulps)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": [rng.standard_normal((3,)).astype(np.float32)]}
    opt = optax.adamw(1e-2)
    state = opt.init(params)
    tparams = from_jax_tree(params)
    topt = ttrain.AdamW(1e-2).init(tparams)
    jp = params
    for _ in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        gdict = dict(_paths(grads))
        for k, leaf in _paths(tparams):
            leaf.grad = torch.from_numpy(gdict[k])
        topt.step()
        want = dict(_paths(jax.device_get(jp)))
        for k, got in _paths(tparams):
            np.testing.assert_allclose(got.detach().numpy(), want[k], rtol=0, atol=1e-6)


def test_full_train_step_reduces_loss():
    """The port's counterpart of test_training.py's: the port's own init
    (zero output convs), AdamW(1e-3), eight steps on one batch with draws
    from a generator: losses finite, the late ones below the first."""
    cfg = tiny_t5_model_config()
    model = at.build_model(config=cfg, device="cpu", seed=0)
    params = model.ldm.params
    optimizer = at.AdamW(1e-3)
    step = at.make_full_train_step(model.cfg, optimizer)
    opt_state = optimizer.init(params["unet"])
    batch = model.make_batch("rain", batchsize=2)
    batch["fbank"] = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 16, 1)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        params, opt_state, loss = step(params, opt_state, batch, g)
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert min(losses[4:]) < losses[0]


# ---------------------------------------------------------------------------
# EMA, KL / NLL, the CLAP contrastive loss
# ---------------------------------------------------------------------------


def test_ema_update_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "blocks": [{"b": rng.standard_normal((6,)).astype(np.float32)}]}
    js, ts = jema.init(tree), tema.init(from_jax_tree(tree))
    for _ in range(5):
        tree = jax.tree.map(lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
                            tree)
        js = jema.update(js, tree, decay=0.999)
        ts = tema.update(ts, from_jax_tree(tree), decay=0.999)
    assert ts.updates == int(js.updates) == 5
    want = dict(_paths(jax.device_get(js.params)))
    for k, got in _paths(ts.params):
        np.testing.assert_allclose(got.numpy(), want[k], rtol=0, atol=1e-7)


@pytest.mark.parametrize("other", [False, True])
def test_kl_divergence_and_nll_match_jax(other):
    rng = np.random.default_rng(3)
    m, lv, m2, lv2, x = (rng.standard_normal((2, 8, 4, 8)).astype(np.float32) for _ in range(5))
    args = (m, lv, m2, lv2) if other else (m, lv)
    want = np.asarray(jvae.kl_divergence(*args))
    got = tvae.kl_divergence(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = np.asarray(jvae.nll(m, lv, x))
    got = tvae.nll(*(torch.from_numpy(a) for a in (m, lv, x))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_clap_contrastive_loss_matches_jax():
    rng = np.random.default_rng(0)
    a, t = _unit_rows(rng, 8, 16), _unit_rows(rng, 8, 16)
    want = float(jtrain.clap_contrastive_loss(a, t, 10.0))
    got = ttrain.clap_contrastive_loss(torch.from_numpy(a), torch.from_numpy(t), 10.0).item()
    assert abs(got - want) <= 1e-6


def _gathered_loss_worker(rank, world, a, t, out_dir):
    import torch.distributed as dist

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"  # no hostname lookup: loopback only
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
                            world_size=world, rank=rank)
    try:
        rows = a.shape[0] // world
        la = torch.from_numpy(a[rank * rows:(rank + 1) * rows]).requires_grad_(True)
        lt = torch.from_numpy(t[rank * rows:(rank + 1) * rows]).requires_grad_(True)
        loss = ttrain.clap_contrastive_loss(la, lt, 10.0, group=dist.group.WORLD)
        loss.backward()
        torch.save({"loss": loss.item(), "ga": la.grad, "gt": lt.grad},
                   os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()  # no rank tears the group down while another still uses it
    finally:
        dist.destroy_process_group()
    # The worker's interpreter shutdown aborts now and then under load
    # ("terminate called without an active exception", about 1 run in 12
    # with six at once), after every collective and the teardown have
    # finished: its results are on disk, so it leaves without the shutdown.
    os._exit(0)


def test_clap_contrastive_loss_gathers_across_processes():
    """Two gloo processes on the CPU, four rows each: every rank's loss is
    the full-batch loss within 1e-6, and each rank's gradient, averaged over
    the ranks as data-parallel training averages it, is the full-batch
    gradient of its rows."""
    import torch.multiprocessing as mp

    rng = np.random.default_rng(0)
    a, t = _unit_rows(rng, 8, 16), _unit_rows(rng, 8, 16)
    fa, ft = (torch.from_numpy(x).requires_grad_(True) for x in (a, t))
    full = ttrain.clap_contrastive_loss(fa, ft, 10.0)
    full.backward()
    world = 2
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.spawn(_gathered_loss_worker, args=(world, a, t, out_dir), nprocs=world,
                       join=False)
        deadline = time.monotonic() + 120.0
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("the gloo processes did not finish within 120 s")
        assert not any(p.is_alive() for p in ctx.processes)
        for rank in range(world):
            got = torch.load(os.path.join(out_dir, f"rank{rank}.pt"))
            assert abs(got["loss"] - full.item()) <= 1e-6
            rows = slice(rank * 4, rank * 4 + 4)
            torch.testing.assert_close(got["ga"] / world, fa.grad[rows], rtol=0, atol=1e-6)
            torch.testing.assert_close(got["gt"] / world, ft.grad[rows], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The autograd Functions of the hand kernels
# ---------------------------------------------------------------------------


def _k1_args(g, x2):
    x1 = torch.randn(2, 6, 4, 64, generator=g) + 0.5
    x2 = torch.randn(2, 6, 4, 32, generator=g) if x2 else None
    cin = 64 + (32 if x2 is not None else 0)
    return (x1, x2, 1 + 0.1 * torch.randn(cin, generator=g), 0.1 * torch.randn(cin, generator=g),
            torch.randn(3, 3, cin, 48, generator=g) / math.sqrt(9 * cin),
            torch.randn(48, generator=g), 32, 1e-5)


def _cases():
    """name -> (wrapper, plain version, maker of its arguments) of each kernel
    with a gradient."""
    def k2(g):
        q, k, v = (torch.randn(2, 24, 4, 32, generator=g) for _ in range(3))
        return (q, k, v, 32 ** -0.5)

    def k3(g, bias=True):
        return (torch.randn(2, 10, 64, generator=g) + 1.0, 1 + 0.1 * torch.randn(64, generator=g),
                0.1 * torch.randn(64, generator=g), torch.randn(64, 96, generator=g) / 8,
                torch.randn(96, generator=g) if bias else None, 1e-5)

    def k4(g):
        return (torch.randn(2, 10, 128, generator=g), torch.randn(64, 48, generator=g) / 8,
                torch.randn(48, generator=g), torch.randn(2, 10, 48, generator=g))

    def k6(g):
        return (torch.randn(2, 6, 4, 64, generator=g) + 2.0, 1 + 0.1 * torch.randn(64, generator=g),
                0.1 * torch.randn(64, generator=g), 32, 1e-5, True)

    return {
        "K1": (rk.gn_silu_conv3x3, rk.gn_silu_conv3x3_plain, lambda g: _k1_args(g, False)),
        "K1 with x2": (rk.gn_silu_conv3x3, rk.gn_silu_conv3x3_plain, lambda g: _k1_args(g, True)),
        "K2": (ak.flash_self_attention, ak.self_attention_plain, k2),
        "K3": (lk.ln_matmul, lk.ln_matmul_plain, k3),
        "K3 no bias": (lk.ln_matmul, lk.ln_matmul_plain, lambda g: k3(g, bias=False)),
        "K4": (lk.geglu_matmul, lk.geglu_matmul_plain, k4),
        "K6": (gk.group_norm_silu, gk.group_norm_silu_plain, k6),
    }


CASES = _cases()


def _with_grad(args):
    return tuple(a.clone().requires_grad_(True) if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_function_gradients_equal_the_plain_versions(case):
    """KernelFunction with the plain version standing in for the kernel:
    the output and the gradient of every tensor input (activations, norm
    scale and bias, weight, bias, residual) bitwise equal to autograd of
    the plain version; one recompute counted."""
    _, plain, make = CASES[case]
    args = make(torch.Generator().manual_seed(0))
    recomputes = []

    def counted(*a):
        recomputes.append(a)
        return plain(*a)

    a1, a2 = _with_grad(args), _with_grad(args)
    got = autograd.KernelFunction.apply(plain, counted, *a1)
    want = plain(*a2)
    assert got.grad_fn is not None and torch.equal(got, want) and not recomputes
    up = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    got.backward(up)
    want.backward(up)
    tensors = [(x, y) for x, y in zip(a1, a2) if isinstance(x, torch.Tensor)]
    assert tensors and all(x.grad is not None and torch.equal(x.grad, y.grad)
                           for x, y in tensors)
    assert len(recomputes) == 1


@pytest.fixture
def on_the_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors into a recording stand-in
    for the kernel library (every tensor reports is_cuda)."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "sm_count", lambda index: SMS)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *ts: None)
    monkeypatch.setattr(_build, "require_int8", lambda name, *ts: None)
    monkeypatch.setattr(_build, "gn_counter",
                        lambda index, stream: torch.zeros(8, dtype=torch.int32))
    monkeypatch.setattr(_build, "gn_barrier", lambda index, stream: torch.zeros(
        2 * _build.GN_COUNTER_SLOTS, dtype=torch.int32))
    monkeypatch.setattr(_build, "gn_partials",
                        lambda index, stream: torch.zeros(_build.GN_PARTIAL_FLOATS))
    monkeypatch.setattr(_build, "gn_silu_occupancy", lambda index, code, vec, smem: 1)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for fn in ops.kernel_wrappers().values():
        monkeypatch.setattr(fn, "launches", 0)
    return lib


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["grad", "no_grad", "nothing_requires_grad"])
def test_wrappers_route_through_the_function_only_under_grad(on_the_card, monkeypatch, case,
                                                            mode):
    """A CUDA call under grad with an input that requires grad goes through
    KernelFunction: the kernel launches once in its forward, and backward
    recomputes the plain version once and gives every input a gradient.
    Under torch.no_grad(), or with no input requiring grad, the wrapper
    launches its kernel as in serving, with no graph."""
    wrapper, plain, make = CASES[case]
    args = make(torch.Generator().manual_seed(0))
    recomputes = []

    def counted(*a):
        recomputes.append(a)
        return plain(*a)

    monkeypatch.setattr(sys.modules[wrapper.__module__], plain.__name__, counted)
    if mode != "nothing_requires_grad":
        args = _with_grad(args)
    with torch.no_grad() if mode == "no_grad" else torch.enable_grad():
        out = wrapper(*args)
    assert on_the_card.calls and wrapper.launches == 1
    if mode != "grad":
        assert out.grad_fn is None and not recomputes
        return
    assert type(out.grad_fn).__name__ == "KernelFunctionBackward" and not recomputes
    out.backward(torch.ones(out.shape))
    assert len(recomputes) == 1 and wrapper.launches == 1
    assert all(a.grad is not None for a in args if isinstance(a, torch.Tensor))


def test_int8_kernels_refuse_grad(on_the_card):
    """K1q, K3q, K4q and K5 have no gradient: a CUDA call under grad with an
    input that requires grad raises; under torch.no_grad() it launches."""
    g = torch.Generator().manual_seed(0)
    x4 = torch.randn(2, 8, 4, 128, generator=g)
    x = torch.randn(2, 10, 128, generator=g)
    ones = torch.ones(128)
    wq = torch.zeros(128, 128, dtype=torch.int8)
    calls = {
        "gn_silu_conv3x3_q": lambda x4: rk.gn_silu_conv3x3_q(
            x4, None, ones, ones, torch.zeros(3, 3, 128, 128, dtype=torch.int8), ones, ones),
        "ln_matmul_q": lambda x: lk.ln_matmul_q(x, ones, ones, wq, ones, ones),
        "geglu_matmul_q": lambda x: lk.geglu_matmul_q(
            torch.cat([x, x], -1), wq, ones, ones, x.detach()),
        "int8_matmul": lambda x: lk.int8_matmul(x, wq, ones, ones),
    }
    for name, call in calls.items():
        arg = x4 if name == "gn_silu_conv3x3_q" else x
        with pytest.raises(RuntimeError, match="no gradient"):
            call(arg.clone().requires_grad_(True))
        with torch.no_grad():
            call(arg.clone().requires_grad_(True))
    assert {n: ops.launch_counts()[n] for n in calls} == dict.fromkeys(calls, 1)


# ---------------------------------------------------------------------------
# The production-geometry UNet (slow: Tier-1 skips it)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_production_geometry_unet_forward_and_gradient():
    """The audioldm_16k_crossattn_t5 UNet at full width (265.5 M
    parameters) on the 10.24 s latent [1, 256, 16, 8], batch 1, f32: the
    port's forward and the gradient of a fixed scalar of its output
    (sum(out * r), r drawn once) against JAX's apply_unet and jax.grad.
    Forward within 1e-4 of JAX's (max |diff| / max |JAX|), each leaf's
    gradient within 1e-3 (production depth adds rounding)."""
    cfg = jpipe.default_audioldm_config("audioldm_16k_crossattn_t5").unet
    _unet_forward_and_gradient_match(cfg, 256, 16, 128, fwd_tol=1e-4, grad_tol=1e-3)


def _unet_forward_and_gradient_match(cfg, t, f, ctx_len, fwd_tol, grad_tol):
    tree = nonzero_tree(junet.init_unet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, t, f, cfg.in_channels)).astype(np.float32)
    ts = np.array([421], np.int32)
    ctx = (0.3 * rng.standard_normal((1, ctx_len, cfg.context_dims[0]))).astype(np.float32)
    mask = np.ones((1, ctx_len), np.float32)
    mask[:, ctx_len * 3 // 4:] = 0.0
    r = rng.standard_normal(x.shape[:3] + (cfg.out_channels,)).astype(np.float32)

    def scalar(p):
        out = junet.apply_unet(p, cfg, x, ts, [ctx], [mask])
        return jnp.sum(out * r), out

    (_, out_j), grads_j = jax.value_and_grad(scalar, has_aux=True)(tree)
    params = from_jax_tree(tree)
    leaves = [leaf.requires_grad_(True) for _, leaf in _paths(params)]
    out_t = tunet.apply_unet(params, coerce(cfg, UNetConfig), torch.from_numpy(x),
                             torch.from_numpy(ts), [torch.from_numpy(ctx)],
                             [torch.from_numpy(mask)])
    grads = torch.autograd.grad(torch.sum(out_t * torch.from_numpy(r)), leaves)
    out_j = np.asarray(out_j)
    err = np.abs(out_t.detach().numpy() - out_j).max() / np.abs(out_j).max()
    assert err <= fwd_tol, err
    paths = [p for p, _ in _paths(params)]
    worst = _leaves_close(dict(zip(paths, grads)), dict(_paths(jax.device_get(grads_j))),
                          grad_tol)
    return err, worst
