"""Why the f32 K1 multiplies in 3xTF32, on the CPU.

The f32 conv kernel (``a2k_gn_silu_conv3x3_f32``) splits every f32 operand
v into hi = tf32(v) and lo = tf32(v - hi) (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero, 10 explicit mantissa bits) and sums lo.hi +
hi.lo + hi.hi in f32. Here the same arithmetic is emulated in plain torch,
rounding by bit operations on an f32 view, and held at the encoder's
deepest K = 9 x 512 = 4608 to the f32 bar of the smoke run (max|d| /
max|ref| <= 1e-4) against the exact f32 conv and against the JAX f32 kernel
(in interpret mode, as tests/test_torch_kernels.py runs it). One TF32 product
misses that bar, which is why the kernel pays for three.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioldm2_tpu.ops import resblock_pallas as rp
from audioldm2_torch.ops import groupnorm_kernel, resblock_kernel
from audioldm2_torch.ops import nn as tnn

torch.set_num_threads(2)

F32_BAR = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 as cvt.rna does it: add half of the 13 dropped bits'
    weight to the magnitude (the sign is apart in the bit pattern, so ties
    go away from zero), then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def conv(h, w):
    return tnn.conv2d({"w": w, "b": torch.zeros(w.shape[-1])}, h)


def conv_3xtf32(h, w):
    """lo.hi + hi.lo + hi.hi, each product of two tf32 values exact in
    f32, summed in f32."""
    (hh, hl), (wh, wl) = split(h), split(w)
    return conv(hl, wh) + conv(hh, wl) + conv(hh, wh)


def rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _inputs(seed, cin, cout=64, T=8, F=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, T, F, cin)).astype(np.float32) + 0.5
    gamma = (1.0 + 0.3 * rng.standard_normal(cin)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, gamma, beta, w, b


def test_tf32_rounding_by_bits():
    """Ten explicit mantissa bits kept, ties away from zero, and hi + lo
    within 2^-21 of the value, relatively."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0, -0.0])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0, -0.0]
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    hi, lo = split(v)
    for part in (hi, lo):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi - v).abs() <= v.abs() * 2.0 ** -11).all()
    assert ((hi + lo - v).abs() <= v.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("cin", [128, 512])
def test_3xtf32_conv_meets_the_f32_bar_one_tf32_product_does_not(cin):
    """On the activation of GroupNorm + SiLU (as the kernel splits it, once
    per patch element) and the weight: 3xTF32 lies orders of magnitude
    inside 1e-4 of the exact f32 conv at K = 9 x cin; one TF32 product
    misses 1e-4."""
    x, gamma, beta, w, _ = _inputs(1, cin)
    h = groupnorm_kernel.group_norm_silu_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                                               torch.from_numpy(beta), 32, 1e-6)
    wt = torch.from_numpy(w)
    exact = conv(h, wt)
    three = rel(conv_3xtf32(h, wt), exact)
    one = rel(conv(tf32(h), tf32(wt)), exact)
    assert three <= F32_BAR / 20, three
    assert one > F32_BAR, one


def test_3xtf32_k1_matches_the_jax_f32_kernel_at_the_deepest_k():
    """The whole f32 K1 at the encoder's deepest level (K = 4608), with the
    conv in emulated 3xTF32, against the JAX Pallas kernel in f32 (interpret
    mode) over the concat [x1 ; x2]: within the f32 bar; and the plain
    version the card is held to agrees with both."""
    x, gamma, beta, w, b = _inputs(2, 512)
    c1 = 256
    want = np.array(rp.gn_silu_conv3x3_cat(
        jnp.asarray(x[..., :c1]), jnp.asarray(x[..., c1:]), gamma, beta, w, b, groups=32,
        eps=1e-6, interpret=True))
    want = torch.from_numpy(want)
    xt, gt, bt, wt, bb = map(torch.from_numpy, (x, gamma, beta, w, b))
    h = groupnorm_kernel.group_norm_silu_plain(xt, gt, bt, 32, 1e-6)
    got = conv_3xtf32(h, wt) + bb
    assert rel(got, want) <= F32_BAR
    plain = resblock_kernel.gn_silu_conv3x3_plain(xt[..., :c1], xt[..., c1:], gt, bt, wt, bb, 32,
                                                  1e-6)
    assert rel(plain, want) <= F32_BAR and rel(got, plain) <= F32_BAR
