"""The int8 serving mode of audioldm2_torch against audioldm2_tpu on the
CPU: quantization (bitwise), each int8 kernel's plain version against the
Pallas kernel it replaces (interpret mode, as tests/test_pallas_kernels.py
runs them), each int8 dispatch point and a tiny int8 UNet against the JAX
ops, and the int8 launch counts.

Tolerances, measured here: plain versions against the Pallas kernels
<= 2.4e-7 relative, and 1.1e-5 for ln_matmul_q, where one LN output lies
at a bf16 rounding boundary and rounds the other way (the same rounding
points; stated bound 1e-4).
Against the JAX dispatch points and the JAX UNet, which off the TPU take
an exact-dequant path with no bf16 rounding of the activation, the
bf16-rounded activation of K1q/K3q/K4q costs up to 4e-3 relative (stated
bound 2e-2)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from audioldm2_tpu.config import UNetConfig
from audioldm2_tpu.models import unet as junet
from audioldm2_tpu.ops import lnmm_pallas as lp
from audioldm2_tpu.ops import nn as jnn
from audioldm2_tpu.ops import quant as jquant
from audioldm2_tpu.ops import resblock_pallas as rp
from audioldm2_torch import params as tparams
from audioldm2_torch.models import unet as tunet
from audioldm2_torch.ops import KERNEL_NAMES, lnmm_kernel, quant, resblock_kernel
from audioldm2_torch.ops import nn as tnn
from test_torch_models import count_plain_conv_dispatches, nonzero_tree

torch.set_num_threads(2)

PALLAS_TOL = 1e-4
JAX_OP_TOL = 2e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _weights(rng, shape):
    w = (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel: the s == 0 -> 1 guard
    w[..., 5] *= 1e-3
    return w


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


def _bitwise(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(640, 1920), (3, 3, 384, 128)])
def test_quantization_is_bitwise_jax(rng, shape):
    w = _weights(rng, shape)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    if len(shape) == 2:
        jq, js = jquant.quantize_weight(jnp.asarray(w))
        tq, ts = quant.quantize_weight(_t(w))
        _bitwise(tq, jq)
        _bitwise(ts, js)
        jd, td = jquant.quantize_linear_dict({"w": w, "b": b}), quant.quantize_linear_dict(
            {"w": _t(w), "b": _t(b)})
        _bitwise(quant.dequantize(td), jquant.dequantize(jd))
    else:
        jd, td = jquant.quantize_conv3x3_dict({"w": w, "b": b}), quant.quantize_conv3x3_dict(
            {"w": _t(w), "b": _t(b)})
        _bitwise(quant.dequantize_conv(td), jquant.dequantize_conv(jd))
    assert sorted(td) == sorted(jd) == ["b", "wq", "ws"]
    for k in td:
        _bitwise(td[k], jd[k])
    assert float(td["ws"][3]) == 1.0


def _quantized_trees(cfg):
    """(JAX, port) int8 UNet trees from one f32 numpy tree, each through its
    package's fuse_self_qkv, quantize_st_linears, quantize_resblock_convs."""
    jtree = nonzero_tree(junet.init_unet(jax.random.PRNGKey(0), cfg))

    def jq(t):
        return junet.quantize_resblock_convs(junet.quantize_st_linears(junet.fuse_self_qkv(t)))

    tq = tunet.quantize_resblock_convs(tunet.quantize_st_linears(
        tunet.fuse_self_qkv(tparams.from_jax_tree(jtree))))
    return jtree, jax.tree.map(np.asarray, jq(jtree)), tq


def _int8_unet_cfg():
    """Widths 128 and 256, so every quantization predicate fires."""
    return UNetConfig(in_channels=4, out_channels=4, model_channels=128, num_res_blocks=1,
                      attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
                      context_dims=(64,))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_quantized_unet_trees_match_jax():
    _, jq, tq = _quantized_trees(_int8_unet_cfg())
    jl, tl = _leaves(jq), _leaves(tq)
    assert sorted(tl) == sorted(jl)
    n_q = 0
    for k, v in tl.items():
        _bitwise(v, jl[k])
        n_q += k.endswith("/wq")
    # 2 convs in each of 8 ResBlocks; 4 ladders, each a self-ST block (attn1 and attn2
    # to_q, to_qkv, to_out; ff proj_in, proj_out: 8) and a cross-ST block (attn2 has no
    # to_qkv: 7)
    assert n_q == 2 * 8 + 4 * (8 + 7)


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _int8(rng, shape):
    q, s = jquant.quantize_weight(jnp.asarray(_weights(rng, shape)).reshape(-1, shape[-1]))
    return np.asarray(q).reshape(shape), np.asarray(s)


def test_gn_silu_conv3x3_q_plain_matches_pallas_kernel(rng):
    B, T, F, cin, cout = 2, 8, 4, 128, 128
    x = rng.standard_normal((B, T, F, cin)).astype(np.float32)
    scale, bias = (rng.standard_normal(cin).astype(np.float32) for _ in range(2))
    wq, ws = _int8(rng, (3, 3, cin, cout))
    b = rng.standard_normal(cout).astype(np.float32)
    s = T * F
    want = pl.pallas_call(
        functools.partial(rp._kernel_q, groups=32, eps=1e-5, T=T, F=F),
        out_shape=jax.ShapeDtypeStruct((B, s, cout), jnp.float32),
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, s, cin), lambda i: (i, 0, 0)),
            pl.BlockSpec((cin,), lambda i: (0,)),
            pl.BlockSpec((cin,), lambda i: (0,)),
            pl.BlockSpec((3, 3, cin, cout), lambda i: (0, 0, 0, 0)),
            pl.BlockSpec((cout,), lambda i: (0,)),
            pl.BlockSpec((cout,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((1, s, cout), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(x).reshape(B, s, cin), scale, bias, wq, ws, b).reshape(B, T, F, cout)
    args = (_t(x), None, _t(scale), _t(bias), _t(wq), _t(ws), _t(b), 32, 1e-5)
    got = resblock_kernel.gn_silu_conv3x3_q_plain(*args)
    assert _rel(got, want) <= PALLAS_TOL
    assert torch.equal(resblock_kernel.gn_silu_conv3x3_q(*args), got)  # the CPU route


def _rows_call(kernel, m, bm, in_specs, out_n, *args):
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((m, out_n), jnp.float32), grid=(m // bm,),
        in_specs=in_specs, out_specs=pl.BlockSpec((bm, out_n), lambda i: (i, 0)),
        interpret=True,
    )(*args)


def test_ln_matmul_q_plain_matches_pallas_kernel(rng):
    m, c, n, bm = 64, 128, 384, 32
    x = (rng.standard_normal((m, c)) + 1.0).astype(np.float32)
    s, b = (rng.standard_normal(c).astype(np.float32) for _ in range(2))
    wq, ws = _int8(rng, (c, n))
    bias = rng.standard_normal(n).astype(np.float32)
    vec = lambda k: pl.BlockSpec((k,), lambda i: (0,))  # noqa: E731
    want = _rows_call(functools.partial(lp._ln_matmul_kernel, eps=1e-5), m, bm,
                      [pl.BlockSpec((bm, c), lambda i: (i, 0)), vec(c), vec(c),
                       pl.BlockSpec((c, n), lambda i: (0, 0)), vec(n), vec(n)],
                      n, x, s, b, wq, ws, bias)
    args = (_t(x)[None], _t(s), _t(b), _t(wq), _t(ws), _t(bias), 1e-5)
    got = lnmm_kernel.ln_matmul_q(*args)[0]
    assert torch.equal(got, lnmm_kernel.ln_matmul_q_plain(*args)[0])
    assert _rel(got, want) <= PALLAS_TOL


def test_geglu_matmul_q_plain_matches_pallas_kernel(rng):
    """The Pallas gate uses a rational erf (~3e-6 absolute); the plain
    version uses the exact erf, which is the residue here."""
    m, f, n, bm = 64, 256, 128, 32
    h = rng.standard_normal((m, 2 * f)).astype(np.float32)
    wq, ws = _int8(rng, (f, n))
    bias = rng.standard_normal(n).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    vec = pl.BlockSpec((n,), lambda i: (0,))
    want = _rows_call(lp._geglu_matmul_kernel, m, bm,
                      [pl.BlockSpec((bm, 2 * f), lambda i: (i, 0)),
                       pl.BlockSpec((f, n), lambda i: (0, 0)), vec, vec,
                       pl.BlockSpec((bm, n), lambda i: (i, 0))],
                      n, h, wq, ws, bias, res)
    got = lnmm_kernel.geglu_matmul_q(_t(h), _t(wq), _t(ws), _t(bias), _t(res))
    assert _rel(got, want) <= PALLAS_TOL


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_matmul_plain_matches_pallas_kernel(rng, dtype):
    """x is not rounded: in f32 the product is f32; in bf16 both sum bf16
    products in f32 and round once."""
    m, k, n, bm = 64, 256, 128, 32
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)).astype(dtype)
    wq, ws = _int8(rng, (k, n))
    bias = rng.standard_normal(n).astype(np.float32)
    vec = pl.BlockSpec((n,), lambda i: (0,))
    want = pl.pallas_call(
        lp._matmul_kernel, out_shape=jax.ShapeDtypeStruct((m, n), x.dtype), grid=(m // bm,),
        in_specs=[pl.BlockSpec((bm, k), lambda i: (i, 0)), pl.BlockSpec((k, n), lambda i: (0, 0)),
                  vec, vec],
        out_specs=pl.BlockSpec((bm, n), lambda i: (i, 0)), interpret=True,
    )(x, wq, ws, bias)
    tx = _t(np.asarray(x.astype(jnp.float32)))
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    got = lnmm_kernel.int8_matmul(tx, _t(wq), _t(ws), _t(bias))
    assert got.dtype == tx.dtype
    tol = PALLAS_TOL if dtype == np.float32 else 2 ** -8  # one bf16 rounding of the output
    assert _rel(got, np.asarray(want.astype(jnp.float32))) <= tol


# ---------------------------------------------------------------------------
# Dispatch points and the UNet against the JAX package (exact dequant off TPU)
# ---------------------------------------------------------------------------


def _dispatch_case(name, rng):
    """(JAX output, port output) of one int8 dispatch point, f32 inputs."""
    c = 256
    pn = {"scale": rng.standard_normal(c).astype(np.float32),
          "bias": rng.standard_normal(c).astype(np.float32)}
    tpn = {k: _t(v) for k, v in pn.items()}

    def lin(k, n):
        p = quant.quantize_linear_dict({"w": _t(_weights(rng, (k, n))),
                                        "b": _t(rng.standard_normal(n).astype(np.float32))})
        return {k2: v.numpy() for k2, v in p.items()}, p

    if name == "linear":
        jp, tp = lin(c, 384)
        x = rng.standard_normal((2, 40, c)).astype(np.float32)
        return jnn.linear(jp, jnp.asarray(x)), tnn.linear(tp, _t(x))
    if name == "ln_linear":
        jp, tp = lin(c, 768)
        x = rng.standard_normal((2, 40, c)).astype(np.float32)
        return jnn.ln_linear(pn, jp, jnp.asarray(x)), tnn.ln_linear(tpn, tp, _t(x))
    if name == "geglu_ff_out":
        jp, tp = lin(c, 128)
        h = rng.standard_normal((2, 40, 2 * c)).astype(np.float32)
        r = rng.standard_normal((2, 40, 128)).astype(np.float32)
        return (jnn.geglu_ff_out(jp, jnp.asarray(h), jnp.asarray(r)),
                tnn.geglu_ff_out(tp, _t(h), _t(r)))
    cout = 128
    pc = quant.quantize_conv3x3_dict({"w": _t(_weights(rng, (3, 3, c, cout))),
                                      "b": _t(rng.standard_normal(cout).astype(np.float32))})
    jpc = {k: v.numpy() for k, v in pc.items()}
    x = (rng.standard_normal((2, 8, 4, c)) + 0.5).astype(np.float32)
    if name == "gn_silu_conv":
        return jnn.gn_silu_conv(pn, jpc, jnp.asarray(x)), tnn.gn_silu_conv(tpn, pc, _t(x))
    x1, x2 = x[..., :128], x[..., 128:]
    return (jnn.gn_silu_conv_cat(pn, jpc, jnp.asarray(x1), jnp.asarray(x2)),
            tnn.gn_silu_conv_cat(tpn, pc, _t(x1), _t(x2)))


@pytest.mark.parametrize("name", ["linear", "ln_linear", "geglu_ff_out", "gn_silu_conv",
                                  "gn_silu_conv_cat"])
def test_int8_dispatch_point_matches_jax(rng, name):
    want, got = _dispatch_case(name, rng)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) <= JAX_OP_TOL


def test_int8_unet_matches_jax():
    cfg = _int8_unet_cfg()
    jtree, jq, tq = _quantized_trees(cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 900], np.int32)
    ctx = rng.standard_normal((2, 6, 64)).astype(np.float32)
    mask = np.ones((2, 6), np.float32)
    mask[0, 2:] = 0.0
    jctx = [jnp.asarray(ctx)]
    want = junet.apply_unet(jq, cfg, jnp.asarray(x), jnp.asarray(t), jctx, [jnp.asarray(mask)],
                            cross_kv=junet.precompute_cross_kv(jtree, cfg, jctx))
    tctx = [_t(ctx)]
    kv = tunet.precompute_cross_kv(tparams.from_jax_tree(jtree), cfg, tctx)
    got = tunet.apply_unet(tq, cfg, _t(x), _t(t), tctx, [_t(mask)], cross_kv=kv)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    assert _rel(got, want) <= JAX_OP_TOL


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------


def test_int8_launch_formula_matches_kernel_calls(monkeypatch):
    """kernel_launches_per_forward(cfg, "int8") equals the calls that reach
    each kernel wrapper in one int8 forward (head_dim 32, so self-attention
    takes K2 by the dispatch rule)."""
    from audioldm2_torch.ops import attention_kernel, groupnorm_kernel, nn

    cfg = _int8_unet_cfg()
    calls = dict.fromkeys(KERNEL_NAMES, 0)

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for mod, name in [(resblock_kernel, "gn_silu_conv3x3"), (resblock_kernel, "gn_silu_conv3x3_q"),
                      (lnmm_kernel, "ln_matmul"), (lnmm_kernel, "ln_matmul_q"),
                      (lnmm_kernel, "geglu_matmul"), (lnmm_kernel, "geglu_matmul_q"),
                      (lnmm_kernel, "int8_matmul"), (groupnorm_kernel, "group_norm_silu")]:
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    orig_attention = nn.attention

    def attention(q, k, v, mask=None, bias=None, scale=None):
        if nn.attention_uses_kernel(q.shape, k.shape, mask is not None, bias is not None):
            calls["flash_self_attention"] += 1
        return orig_attention(q, k, v, mask=mask, bias=bias, scale=scale)

    monkeypatch.setattr(nn, "attention", attention)
    count_plain_conv_dispatches(monkeypatch, calls)
    assert attention_kernel.flash_self_attention.launches == 0
    jtree, _, tq = _quantized_trees(cfg)
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    ctx = [_t(rng.standard_normal((2, 6, 64)).astype(np.float32))]
    kv = tunet.precompute_cross_kv(tparams.from_jax_tree(jtree), cfg, ctx)
    tunet.apply_unet(tq, cfg, x, torch.tensor([5, 6]), ctx, [torch.ones(2, 6)], cross_kv=kv)
    assert calls == tunet.kernel_launches_per_forward(cfg, "int8")
    assert calls["gn_silu_conv3x3"] == calls["ln_matmul"] == calls["geglu_matmul"] == 0


def test_full_config_int8_launch_counts():
    """The counts chip_smoke.py holds the audioldm2-full paths to: 22
    ResBlocks (44 convs) and 16 transformer ladders of 3 blocks (a self-ST
    and two cross-STs); every width is a multiple of 128, so int8 quantizes
    all of them. The 119 plain convs (the stem, downsamples, skips, the 48
    spatial transformers' proj_in and proj_out, upsamples, out_conv) keep
    bf16 weights in both modes; the VAE decode adds 10."""
    from audioldm2_torch import default_audioldm_config
    from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate

    full = default_audioldm_config("audioldm2-full")
    none = dict.fromkeys(KERNEL_NAMES, 0)
    assert tunet.kernel_launches_per_forward(full.unet) == {
        **none, "gn_silu_conv3x3": 44, "flash_self_attention": 64, "ln_matmul": 144,
        "geglu_matmul": 48, "group_norm_silu": 1, "conv2d": 119}
    assert tunet.kernel_launches_per_forward(full.unet, "int8") == {
        **none, "gn_silu_conv3x3_q": 44, "flash_self_attention": 64, "ln_matmul_q": 144,
        "geglu_matmul_q": 48, "int8_matmul": 96, "group_norm_silu": 1, "conv2d": 119}
    full8 = dataclasses.replace(full, weight_quant="int8")
    assert kernel_launches_per_generate(full8, 200) == {
        **none, "gn_silu_conv3x3": 22, "gn_silu_conv3x3_q": 200 * 44,
        "flash_self_attention": 200 * 64, "ln_matmul_q": 200 * 144, "geglu_matmul_q": 200 * 48,
        "int8_matmul": 200 * 96, "group_norm_silu": 200 + 1, "conv2d": 200 * 119 + 10}
