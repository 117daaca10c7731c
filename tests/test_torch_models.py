"""audioldm2_torch models and sampler against the JAX package on the tiny
t5 geometry (tests/tiny.py), float32 on the CPU.

Both packages get the same numpy parameter tree (through
params.from_jax_tree) with every all-zero leaf redrawn, so the UNet output
and everything downstream of it is non-trivial; inputs are made with numpy.
Tolerance 1e-4 (float32, differing in summation order only)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.diffusion import ddim as jddim
from audioldm2_tpu.diffusion.schedule import DiffusionSchedule
from audioldm2_tpu.models import t5 as jt5
from audioldm2_tpu.models import unet as junet
from audioldm2_tpu.models import vae as jvae
from audioldm2_tpu.models import vocoder as jvoc
from audioldm2_torch import params as tparams
from audioldm2_torch.diffusion import ddim as tddim
from audioldm2_torch.models import t5 as tt5
from audioldm2_torch.models import unet as tunet
from audioldm2_torch.models import vae as tvae
from audioldm2_torch.models import vocoder as tvoc
from audioldm2_torch.ops import nn as tnn
from tiny import TINY_T5, tiny_t5_model_config

torch.set_num_threads(2)

TOL = 1e-4


def nonzero_tree(tree, seed=123):
    """numpy copy of a JAX parameter tree with every all-zero leaf redrawn."""
    rng = np.random.default_rng(seed)

    def fix(x):
        x = np.asarray(x)
        if x.size and x.dtype.kind == "f" and not np.any(x):
            return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree.map(fix, tree)


@pytest.fixture(scope="module")
def cfg():
    return tiny_t5_model_config()


@pytest.fixture(scope="module")
def np_tree(cfg):
    return nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _unet_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, cfg.latent_f_size, cfg.latent_channels)).astype(np.float32)
    t = np.array([3, 900], np.int32)
    ctx = rng.standard_normal((2, 16, cfg.unet.context_dims[0])).astype(np.float32)
    mask = np.ones((2, 16), np.float32)
    mask[0, 1:] = 0.0
    mask[1, 7:] = 0.0
    return x, t, ctx, mask


@pytest.mark.parametrize("fused", [False, True])
def test_unet_matches_jax(cfg, np_tree, fused):
    """apply_unet, with the per-call transforms (precomputed cross K/V and
    fused self-attention QKV) or without them."""
    x, t, ctx, mask = _unet_inputs(cfg)
    want = junet.apply_unet(np_tree["unet"], cfg.unet, jnp.asarray(x), jnp.asarray(t),
                            [jnp.asarray(ctx)], [jnp.asarray(mask)])
    p = tparams.from_jax_tree(np_tree["unet"])
    tx, tt, tctx, tmask = map(torch.from_numpy, (x, t, ctx, mask))
    kv = None
    if fused:
        kv = tunet.precompute_cross_kv(p, cfg.unet, [tctx])
        p = tunet.fuse_self_qkv(p)
    got = tunet.apply_unet(p, cfg.unet, tx, tt, [tctx], [tmask], cross_kv=kv)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2  # non-trivial output
    _close(got, want)


def test_vae_decode_matches_jax(cfg, np_tree):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((1, 8, cfg.latent_f_size, cfg.vae.embed_dim)).astype(np.float32)
    want = jvae.decode(np_tree["vae"], cfg.vae, jnp.asarray(z))
    got = tvae.decode(tparams.from_jax_tree(np_tree["vae"]), cfg.vae, torch.from_numpy(z))
    assert tuple(got.shape) == (1, 16, 16, 1)
    _close(got, want)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_vocoder_matches_jax(cfg, resblock):
    vcfg = dataclasses.replace(cfg.vocoder, resblock=resblock)
    tree = nonzero_tree(jvoc.init_vocoder(jax.random.PRNGKey(2), vcfg))
    mel = np.random.default_rng(2).standard_normal((2, 12, vcfg.num_mels)).astype(np.float32)
    want = jvoc.apply_vocoder(tree, vcfg, jnp.asarray(mel))
    got = tvoc.apply_vocoder(tparams.from_jax_tree(tree), vcfg, torch.from_numpy(mel))
    assert tuple(got.shape) == (2, 12 * 16)
    _close(got, want)


def test_t5_encoder_matches_jax():
    tree = jax.tree.map(np.asarray, jt5.init_t5_encoder(jax.random.PRNGKey(3), TINY_T5))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, TINY_T5.vocab_size, (2, TINY_T5.max_length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 5:] = 0
    mask[1, 11:] = 0
    want = jt5.apply_t5_encoder(tree, TINY_T5, jnp.asarray(ids), jnp.asarray(mask))
    got = tt5.apply_t5_encoder(tparams.from_jax_tree(tree), TINY_T5, torch.from_numpy(ids),
                               torch.from_numpy(mask))
    _close(got, want)


def _eps_pair():
    def eps_j(x, t):
        return 0.5 * jnp.tanh(x) + (t.astype(jnp.float32) / 1000.0)[:, None, None, None]

    def eps_t(x, t):
        return 0.5 * torch.tanh(x) + (t.float() / 1000.0)[:, None, None, None]

    return eps_j, eps_t


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_sample_matches_jax(eta):
    """eta 0 from a fixed x_T; eta 1 with JAX's own per-step noise fed to
    the port (threefry and Philox never agree, so the noise is injected)."""
    sched = DiffusionSchedule.create()
    shape, steps = (2, 8, 8, 4), 10
    x_T = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    eps_j, eps_t = _eps_pair()
    key = jax.random.PRNGKey(5)
    want = jddim.ddim_sample(eps_j, key, shape, sched, num_steps=steps, eta=eta,
                             x_T=jnp.asarray(x_T))
    # the JAX sampler's key schedule (ddim.py:92-117), reproduced to get its noise
    k, _ = jax.random.split(key)
    step_keys = jax.random.split(k, steps)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.split(sk)[1], shape, jnp.float32))
                      for sk in step_keys])
    got = tddim.ddim_sample(eps_t, shape, sched, num_steps=steps, eta=eta,
                            x_T=torch.from_numpy(x_T), noise=torch.from_numpy(noise))
    _close(got, want)


def test_cfg_eps_fn_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 4, 4, 2)).astype(np.float32)
    t = np.array([10, 20], np.int32)

    def model_j(x2, t2):
        return x2 * jnp.arange(1, 5, dtype=jnp.float32)[:, None, None, None]

    def model_t(x2, t2):
        return x2 * torch.arange(1, 5, dtype=torch.float32)[:, None, None, None]

    want = jddim.cfg_eps_fn(model_j, 3.5)(jnp.asarray(x), jnp.asarray(t))
    got = tddim.cfg_eps_fn(model_t, 3.5)(torch.from_numpy(x), torch.from_numpy(t))
    _close(got, want)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(np.shape(tree))}


@pytest.mark.parametrize("nonzero", [False, True])
def test_init_params_structure_matches_jax(cfg, nonzero):
    """init_params draws the JAX tree's keys and shapes (the CLAP reranker,
    absent from the tiny config, is not ported)."""
    jtree = jpipe.init_params(jax.random.PRNGKey(0), cfg)
    ttree = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu", nonzero=nonzero)
    assert _flatten(ttree) == _flatten(jax.tree.map(np.asarray, jtree))
    zero = not bool(ttree["unet"]["out_conv"]["w"].abs().max() > 0)
    assert zero is (not nonzero)


def test_kernel_launch_formula_matches_dispatch_calls(cfg, monkeypatch):
    """unet/vae.kernel_launches_* equal the calls that reach each kernel's
    dispatch point in one forward (head_dim 32 so self-attention takes K2)."""
    ucfg = dataclasses.replace(cfg.unet, num_head_channels=32)
    calls = {"gn_silu_conv3x3": 0, "flash_self_attention": 0, "ln_matmul": 0, "geglu_matmul": 0}

    def counting(name, fn, cond=None):
        def wrapped(*a, **kw):
            if cond is None or cond(*a, **kw):
                calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def uses_kernel(q, k, v, mask=None, bias=None, scale=None):
        return tnn.attention_uses_kernel(q.shape, k.shape, mask is not None, bias is not None)

    for attr, name, cond in [("gn_silu_conv", "gn_silu_conv3x3", None),
                             ("gn_silu_conv_cat", "gn_silu_conv3x3", None),
                             ("ln_linear", "ln_matmul", None),
                             ("geglu_ff_out", "geglu_matmul", None),
                             ("attention", "flash_self_attention", uses_kernel)]:
        monkeypatch.setattr(tnn, attr, counting(name, getattr(tnn, attr), cond))
    g = torch.Generator().manual_seed(0)
    ini = tparams.Init(g, "cpu")
    p = tunet.init_unet(ini, ucfg)
    x, t, ctx, mask = map(torch.from_numpy, _unet_inputs(cfg))
    kv = tunet.precompute_cross_kv(p, ucfg, [ctx])
    tunet.apply_unet(tunet.fuse_self_qkv(p), ucfg, x, t, [ctx], [mask], cross_kv=kv)
    assert calls == tunet.kernel_launches_per_forward(ucfg)
    for k in calls:
        calls[k] = 0
    z = torch.randn((1, 8, cfg.latent_f_size, cfg.vae.embed_dim), generator=g)
    tvae.decode(tvae.init_vae(ini, cfg.vae), cfg.vae, z)
    assert calls == tvae.kernel_launches_per_decode(cfg.vae)


def test_full_config_launch_counts():
    """The counts chip_smoke.py holds the t5 main path to: per UNet forward
    44 K1 (22 ResBlocks), 48 K2, 96 K3, 32 K4; per VAE decode 22 K1."""
    from audioldm2_torch import default_audioldm_config
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate

    full = default_audioldm_config("audioldm_16k_crossattn_t5")
    assert tunet.kernel_launches_per_forward(full.unet) == {
        "gn_silu_conv3x3": 44, "flash_self_attention": 48, "ln_matmul": 96, "geglu_matmul": 32}
    assert kernel_launches_per_generate(full, 200) == {
        "gn_silu_conv3x3": 200 * 44 + 22, "flash_self_attention": 200 * 48,
        "ln_matmul": 200 * 96, "geglu_matmul": 200 * 32}
