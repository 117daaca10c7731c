"""Each Hopper kernel's plain PyTorch version against the JAX Pallas kernel
it replaces, run in interpret mode on the CPU as tests/test_pallas_kernels.py
runs them, at 128-channel shapes. float32, atol 1e-4.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from audioldm2_tpu.ops import attention_pallas as ap
from audioldm2_tpu.ops import lnmm_pallas as lp
from audioldm2_tpu.ops import resblock_pallas as rp
from audioldm2_torch.ops import attention_kernel, lnmm_kernel, resblock_kernel

torch.set_num_threads(2)

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)


def _gn_inputs(rng, B, T, F, cin, cout, offset=0.0):
    x = (rng.standard_normal((B, T, F, cin)) + offset).astype(np.float32)
    scale = rng.standard_normal(cin).astype(np.float32)
    bias = rng.standard_normal(cin).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, scale, bias, w, b


def test_gn_silu_conv3x3_plain_matches_pallas_kernel(rng):
    B, T, F, cin, cout = 2, 8, 4, 128, 128
    x, scale, bias, w, b = _gn_inputs(rng, B, T, F, cin, cout)
    s = T * F
    want = pl.pallas_call(
        functools.partial(rp._kernel, groups=32, eps=1e-5, T=T, F=F),
        out_shape=jax.ShapeDtypeStruct((B, s, cout), jnp.float32),
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, s, cin), lambda i: (i, 0, 0)),
            pl.BlockSpec((cin,), lambda i: (0,)),
            pl.BlockSpec((cin,), lambda i: (0,)),
            pl.BlockSpec((3, 3, cin, cout), lambda i: (0, 0, 0, 0)),
            pl.BlockSpec((cout,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((1, s, cout), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(x).reshape(B, s, cin), scale, bias, w, b).reshape(B, T, F, cout)
    got = resblock_kernel.gn_silu_conv3x3_plain(_t(x), None, _t(scale), _t(bias), _t(w), _t(b),
                                                32, 1e-5)
    _close(got, want)
    # the CPU route of the wrapper is the plain version
    routed = resblock_kernel.gn_silu_conv3x3(_t(x), None, _t(scale), _t(bias), _t(w), _t(b),
                                             32, 1e-5)
    assert torch.equal(routed, got)


def test_gn_silu_conv3x3_cat_plain_matches_pallas_kernel(rng):
    B, T, F, c1, c2, cout = 2, 8, 4, 128, 128, 128
    x1, scale, bias, w, b = _gn_inputs(rng, B, T, F, c1 + c2, cout)
    x1, x2 = x1[..., :c1] + 1.0, x1[..., c1:] - 0.5
    want = rp.gn_silu_conv3x3_cat(jnp.asarray(x1), jnp.asarray(x2), scale, bias, w, b,
                                  groups=32, eps=1e-6, interpret=True)
    got = resblock_kernel.gn_silu_conv3x3(_t(x1), _t(x2), _t(scale), _t(bias), _t(w), _t(b),
                                          32, 1e-6)
    _close(got, want)


def test_gn_silu_conv3x3_tiled_plain_matches_pallas_kernel(rng):
    """The T-tiled Pallas variant (folded GN affine, halo rows) computes the
    same function at a VAE-like offset input."""
    B, T, F, cin, cout = 1, 16, 8, 128, 128
    x, scale, bias, w, b = _gn_inputs(rng, B, T, F, cin, cout, offset=2.0)
    want = rp.gn_silu_conv3x3_tiled(jnp.asarray(x), scale, bias, w, b, groups=32, eps=1e-6,
                                    interpret=True)
    got = resblock_kernel.gn_silu_conv3x3(_t(x), None, _t(scale), _t(bias), _t(w), _t(b),
                                          32, 1e-6)
    _close(got, want)


@pytest.mark.parametrize("t,h,d", [(256, 4, 32), (128, 2, 64)])
def test_self_attention_plain_matches_pallas_kernel(rng, t, h, d):
    q, k, v = (rng.standard_normal((2, t, h, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    want = ap.fused_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                   interpret=True)
    got = attention_kernel.flash_self_attention(_t(q), _t(k), _t(v), scale)
    _close(got, want)


def test_ln_matmul_plain_matches_pallas_kernel(rng):
    m, c, n = 64, 128, 384
    x = rng.standard_normal((m, c)).astype(np.float32)
    s = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    w = (rng.standard_normal((c, n)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    bm = 32
    want = pl.pallas_call(
        functools.partial(lp._ln_matmul_kernel, eps=1e-5),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        grid=(m // bm,),
        in_specs=[
            pl.BlockSpec((bm, c), lambda i: (i, 0)),
            pl.BlockSpec((c,), lambda i: (0,)),
            pl.BlockSpec((c,), lambda i: (0,)),
            pl.BlockSpec((c, n), lambda i: (0, 0)),
            pl.BlockSpec((n,), lambda i: (0,)),
            pl.BlockSpec((n,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((bm, n), lambda i: (i, 0)),
        interpret=True,
    )(x, s, b, w, jnp.ones((n,), jnp.float32), bias)
    got = lnmm_kernel.ln_matmul(_t(x)[None], _t(s), _t(b), _t(w), _t(bias), 1e-5)[0]
    _close(got, want)


def test_geglu_matmul_plain_matches_pallas_kernel(rng):
    m, f, n = 64, 256, 128
    h = rng.standard_normal((m, 2 * f)).astype(np.float32)
    w = (rng.standard_normal((f, n)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    bm = 32
    want = pl.pallas_call(
        lp._geglu_matmul_kernel,
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        grid=(m // bm,),
        in_specs=[
            pl.BlockSpec((bm, 2 * f), lambda i: (i, 0)),
            pl.BlockSpec((f, n), lambda i: (0, 0)),
            pl.BlockSpec((n,), lambda i: (0,)),
            pl.BlockSpec((n,), lambda i: (0,)),
            pl.BlockSpec((bm, n), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((bm, n), lambda i: (i, 0)),
        interpret=True,
    )(h, w, jnp.ones((n,), jnp.float32), bias, res)
    got = lnmm_kernel.geglu_matmul(_t(h), _t(w), _t(bias), _t(res))
    _close(got, want)


def test_kernel_launch_counters_stay_zero_on_cpu(rng):
    """CPU tensors take the plain versions: no wrapper counts a launch."""
    from audioldm2_torch import ops

    ops.reset_launch_counts()
    x = _t(rng.standard_normal((1, 4, 4, 32)))
    resblock_kernel.gn_silu_conv3x3(x, None, torch.ones(32), torch.zeros(32),
                                    torch.zeros(3, 3, 32, 32), torch.zeros(32), 32, 1e-5)
    q = _t(rng.standard_normal((1, 8, 1, 32)))
    attention_kernel.flash_self_attention(q, q, q, 0.2)
    assert ops.launch_counts() == {"gn_silu_conv3x3": 0, "flash_self_attention": 0,
                                   "ln_matmul": 0, "geglu_matmul": 0}
