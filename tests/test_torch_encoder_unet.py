"""The legacy QKV attention block (both head splits) and the EncoderUNet
half-UNet classifier of the port against the JAX package's (CPU, f32), on
tests/test_unet_parity.py's tiny classifier config, through the weight
bridge (params.from_jax_tree of JAX's init_encoder_unet tree, every
all-zero leaf redrawn); the port's init against JAX's tree structure
(``num_heads`` and ``pool`` non-array leaves where JAX puts them); the
launch formula against the calls that reach the kernel dispatch points.
Tolerance 1e-4 (f32, summation order only)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from audioldm2_tpu.config import UNetConfig as JUNetConfig
from audioldm2_tpu.models import unet as junet
from audioldm2_torch import params as tparams
from audioldm2_torch.config import UNetConfig, default_audioldm_config
from audioldm2_torch.models import unet as tunet
from audioldm2_torch.ops import KERNEL_NAMES
from audioldm2_torch.ops import nn as tnn
from test_torch_models import count_plain_conv_dispatches
from test_torch_models import nonzero_tree as _nonzero_arrays

torch.set_num_threads(2)

TOL = 1e-4
TINY = dict(in_channels=4, out_channels=10, model_channels=32, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16)


def nonzero_tree(tree, seed=123):
    """test_torch_models.nonzero_tree on the array leaves; the non-array
    leaves (``num_heads``, ``pool``) stay as JAX's init made them."""
    flat, treedef = jax.tree.flatten(tree)
    arrays = [i for i, x in enumerate(flat) if hasattr(x, "shape")]
    fixed = _nonzero_arrays([flat[i] for i in arrays], seed)
    for i, x in zip(arrays, fixed):
        flat[i] = x
    return jax.tree.unflatten(treedef, flat)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(np.shape(tree)) if hasattr(tree, "shape") else tree}


@pytest.mark.parametrize("new_order", [False, True])
@pytest.mark.parametrize("channels,heads,nhc", [(64, 1, 16), (48, 3, -1)])
def test_legacy_attention_block_matches_jax(new_order, channels, heads, nhc):
    p = nonzero_tree(junet.init_legacy_attention_block(jax.random.PRNGKey(1), channels,
                                                       num_heads=heads, num_head_channels=nhc))
    assert p["num_heads"] == (channels // nhc if nhc != -1 else heads)
    x = np.random.default_rng(2).standard_normal((2, 8, 4, channels)).astype(np.float32)
    want = junet.apply_legacy_attention_block(p, x, new_order=new_order)
    got = tunet.apply_legacy_attention_block(tparams.from_jax_tree(p), torch.from_numpy(x),
                                             new_order=new_order)
    assert got.shape == x.shape
    _close(got, want)


def test_legacy_head_splits_differ_on_one_qkv():
    """The two orders read different channels as q, k and v (they agree
    only where the weights were trained for one of them)."""
    p = tparams.from_jax_tree(nonzero_tree(
        junet.init_legacy_attention_block(jax.random.PRNGKey(3), 64, num_head_channels=16)))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 4, 4, 64)).astype(np.float32))
    a = tunet.apply_legacy_attention_block(p, x, new_order=False)
    b = tunet.apply_legacy_attention_block(p, x, new_order=True)
    assert (a - b).abs().max() > 1e-3


@pytest.fixture(scope="module")
def jtree():
    return nonzero_tree(junet.init_encoder_unet(jax.random.PRNGKey(5), JUNetConfig(**TINY)))


@pytest.mark.parametrize("batch", [1, 2])
def test_encoder_unet_matches_jax(jtree, batch):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((batch, 16, 16, 4)).astype(np.float32)
    t = np.array([7, 930][:batch], np.int32)
    want = junet.apply_encoder_unet(jtree, JUNetConfig(**TINY), x, t)
    p = tparams.from_jax_tree(jtree)
    assert p["pool"] == "adaptive" and p["middle_block"]["attn"]["num_heads"] == 4
    got = tunet.apply_encoder_unet(p, UNetConfig(**TINY), torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (batch, 10) and float(np.abs(np.asarray(want)).max()) > 1e-3
    _close(got, want)


@pytest.mark.parametrize("nonzero", [False, True])
def test_init_encoder_unet_structure_matches_jax(nonzero):
    want = _leaves(junet.init_encoder_unet(jax.random.PRNGKey(0), JUNetConfig(**TINY)))
    ttree = tunet.init_encoder_unet(tparams.Init(torch.Generator().manual_seed(0), "cpu",
                                                 nonzero=nonzero), UNetConfig(**TINY))
    assert _leaves(ttree) == want
    assert bool(ttree["out_conv"]["w"].abs().max() > 0) is nonzero
    assert bool(ttree["middle_block"]["attn"]["proj_out"]["w"].abs().max() > 0) is nonzero
    with pytest.raises(ValueError, match="adaptive"):
        tunet.init_encoder_unet(tparams.Init(torch.Generator(), "cpu"), UNetConfig(**TINY),
                                pool="attention")


def _count_calls(monkeypatch):
    calls = dict.fromkeys(KERNEL_NAMES, 0)

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
                             ("group_norm_silu", "group_norm_silu", None),
                             ("ln_linear", "ln_matmul", None),
                             ("geglu_ff_out", "geglu_matmul", None),
                             ("attention", "flash_self_attention", uses_kernel)]:
        monkeypatch.setattr(tnn, attr, counting(name, getattr(tnn, attr), cond))
    count_plain_conv_dispatches(monkeypatch, calls)
    return calls


@pytest.mark.parametrize("nhc", [16, 32])
def test_launch_formula_matches_dispatch_calls(monkeypatch, nhc):
    cfg = UNetConfig(**{**TINY, "num_head_channels": nhc})
    calls = _count_calls(monkeypatch)
    p = tunet.init_encoder_unet(tparams.Init(torch.Generator().manual_seed(0), "cpu"), cfg)
    tunet.apply_encoder_unet(p, cfg, torch.randn(2, 16, 16, 4), torch.tensor([1, 2]))
    assert calls == tunet.kernel_launches_per_encoder_forward(cfg)
    assert calls["flash_self_attention"] == (2 if nhc == 32 else 0)


def test_t5_width_classifier_launch_counts():
    """The counts chip_smoke.py holds its encoder path to: the t5 UNet's
    widths, 10 ResBlocks (20 K1), legacy blocks at ds 2, 4, 8 and the
    middle (7 K2, head_dim 32), one K6; in bf16 the plain conv for the
    stem, 3 downsamples and 3 skips (the out_conv onto 10 channels stays
    cuDNN's)."""
    cfg = dataclasses.replace(default_audioldm_config("audioldm_16k_crossattn_t5").unet,
                              in_channels=8, out_channels=10)
    assert (cfg.model_channels, cfg.channel_mult, cfg.attention_resolutions,
            cfg.num_head_channels) == (128, (1, 2, 3, 5), (8, 4, 2), 32)
    assert tunet.kernel_launches_per_encoder_forward(cfg) == {
        **dict.fromkeys(KERNEL_NAMES, 0), "gn_silu_conv3x3": 20, "flash_self_attention": 7,
        "group_norm_silu": 1, "conv2d": 7}
