"""audioldm2_torch plain ops against audioldm2_tpu.ops.nn (CPU, float32).

Both packages get the same numpy inputs; tolerance atol 1e-5, rtol 1e-4
(float32, differing only in summation order)."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioldm2_tpu.ops import nn as jnn
from audioldm2_torch.ops import nn as tnn

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tree_t(p):
    return {k: _t(v) for k, v in p.items()}


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _conv_p(rng, *shape):
    return {"w": (rng.standard_normal(shape) * 0.1).astype(np.float32),
            "b": rng.standard_normal(shape[-1]).astype(np.float32)}


def _norm_p(rng, c):
    return {"scale": rng.standard_normal(c).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32)}


def _case_linear(rng):
    p = _conv_p(rng, 24, 40)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    return jnn.linear(p, jnp.asarray(x)), tnn.linear(_tree_t(p), _t(x))


def _case_conv2d_same(rng):
    p = _conv_p(rng, 3, 3, 8, 16)
    x = rng.standard_normal((2, 7, 5, 8)).astype(np.float32)
    return jnn.conv2d(p, jnp.asarray(x)), tnn.conv2d(_tree_t(p), _t(x))


def _case_conv2d_stride2_pad1(rng):
    p = _conv_p(rng, 3, 3, 8, 8)
    x = rng.standard_normal((2, 8, 6, 8)).astype(np.float32)
    return (jnn.conv2d(p, jnp.asarray(x), stride=(2, 2), padding=1),
            tnn.conv2d(_tree_t(p), _t(x), stride=(2, 2), padding=1))


def _case_conv2d_1x1(rng):
    p = _conv_p(rng, 1, 1, 8, 12)
    x = rng.standard_normal((1, 4, 4, 8)).astype(np.float32)
    return jnn.conv2d(p, jnp.asarray(x)), tnn.conv2d(_tree_t(p), _t(x))


def _case_conv1d_dilated(rng):
    p = _conv_p(rng, 3, 6, 10)
    x = rng.standard_normal((2, 20, 6)).astype(np.float32)
    return (jnn.conv1d(p, jnp.asarray(x), padding=3, dilation=3),
            tnn.conv1d(_tree_t(p), _t(x), padding=3, dilation=3))


def _case_conv_transpose1d(rng):
    p = {"w": (rng.standard_normal((8, 6, 10)) * 0.1).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    x = rng.standard_normal((2, 9, 10)).astype(np.float32)
    return (jnn.conv_transpose1d(p, jnp.asarray(x), stride=4, padding=2),
            tnn.conv_transpose1d(_tree_t(p), _t(x), stride=4, padding=2))


def _case_group_norm(rng):
    p = _norm_p(rng, 64)
    x = (rng.standard_normal((2, 6, 4, 64)) + 3.0).astype(np.float32)
    return (jnn.group_norm(p, jnp.asarray(x), eps=1e-6),
            tnn.group_norm(_tree_t(p), _t(x), eps=1e-6))


def _case_layer_norm(rng):
    p = _norm_p(rng, 48)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    return jnn.layer_norm(p, jnp.asarray(x)), tnn.layer_norm(_tree_t(p), _t(x))


def _case_rms_norm(rng):
    p = {"scale": rng.standard_normal(48).astype(np.float32)}
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    return jnn.rms_norm(p, jnp.asarray(x)), tnn.rms_norm(_tree_t(p), _t(x))


def _case_silu(rng):
    x = (rng.standard_normal((3, 50)) * 4).astype(np.float32)
    return jnn.silu(jnp.asarray(x)), tnn.silu(_t(x))


def _case_gelu(rng):
    x = (rng.standard_normal((3, 50)) * 4).astype(np.float32)
    return jnn.gelu(jnp.asarray(x)), tnn.gelu(_t(x))


def _case_leaky_relu(rng):
    x = rng.standard_normal((3, 50)).astype(np.float32)
    return jnn.leaky_relu(jnp.asarray(x), 0.1), tnn.leaky_relu(_t(x), 0.1)


def _case_nearest_upsample(rng):
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    return jnn.nearest_upsample_2d(jnp.asarray(x), 4, 2), tnn.nearest_upsample_2d(_t(x), 4, 2)


def _case_timestep_embedding(rng):
    t = np.array([1, 17, 500, 981], np.int32)
    return (jnn.timestep_embedding(jnp.asarray(t), 33),
            tnn.timestep_embedding(torch.from_numpy(t), 33))


def _case_attention_masked_bias(rng):
    q = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
    bias = rng.standard_normal((1, 3, 6, 9)).astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    mask[0, 4:] = 0.0
    mask[1, :] = 0.0  # a fully masked row: uniform weights, not NaN
    got = tnn.attention(_t(q), _t(k), _t(v), mask=_t(mask), bias=_t(bias), scale=0.7)
    assert torch.isfinite(got).all()
    want = jnn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
                         bias=jnp.asarray(bias), scale=0.7)
    return want, got


def _case_attention_self(rng):
    q, k, v = (rng.standard_normal((2, 16, 2, 32)).astype(np.float32) for _ in range(3))
    return (jnn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)),
            tnn.attention(_t(q), _t(k), _t(v)))


def _case_conv1x1_cat(rng):
    p = _conv_p(rng, 1, 1, 24, 16)
    x1 = rng.standard_normal((2, 4, 3, 16)).astype(np.float32)
    x2 = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
    return (jnn.conv1x1_cat(p, jnp.asarray(x1), jnp.asarray(x2)),
            tnn.conv1x1_cat(_tree_t(p), _t(x1), _t(x2)))


def _case_gn_silu_conv_cat(rng):
    pn, pc = _norm_p(rng, 64), _conv_p(rng, 3, 3, 64, 32)
    x1 = rng.standard_normal((2, 5, 4, 40)).astype(np.float32)
    x2 = rng.standard_normal((2, 5, 4, 24)).astype(np.float32)
    return (jnn.gn_silu_conv_cat(pn, pc, jnp.asarray(x1), jnp.asarray(x2), eps=1e-5),
            tnn.gn_silu_conv_cat(_tree_t(pn), _tree_t(pc), _t(x1), _t(x2), eps=1e-5))


def _case_ln_linear(rng):
    pn, pl = _norm_p(rng, 64), _conv_p(rng, 64, 96)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    return jnn.ln_linear(pn, pl, jnp.asarray(x)), tnn.ln_linear(_tree_t(pn), _tree_t(pl), _t(x))


def _case_geglu_ff_out(rng):
    pl = _conv_p(rng, 32, 16)
    h = rng.standard_normal((2, 10, 64)).astype(np.float32)
    r = rng.standard_normal((2, 10, 16)).astype(np.float32)
    return (jnn.geglu_ff_out(pl, jnp.asarray(h), jnp.asarray(r)),
            tnn.geglu_ff_out(_tree_t(pl), _t(h), _t(r)))


CASES = {name[len("_case_"):]: fn for name, fn in globals().items() if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_op_matches_jax(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    want, got = CASES[case](rng)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want)


@pytest.mark.parametrize(
    "q_shape,k_shape,has_mask,has_bias,expected",
    [
        ((2, 1024, 8, 32), (2, 1024, 8, 32), False, False, True),    # UNet self-attention
        ((2, 64, 20, 32), (2, 64, 20, 32), False, False, True),
        ((1, 300, 2, 64), (1, 300, 2, 64), False, False, True),      # ragged T
        ((1, 256, 1, 128), (1, 256, 1, 128), False, False, True),
        ((2, 1024, 8, 32), (2, 128, 8, 32), True, False, False),     # masked cross-attention
        ((2, 1024, 8, 32), (2, 128, 8, 32), False, False, False),    # unmasked cross-attention
        ((1, 128, 16, 64), (1, 128, 16, 64), True, True, False),     # T5: mask + bias
        ((1, 128, 16, 64), (1, 128, 16, 64), False, True, False),
        ((1, 4096, 1, 512), (1, 4096, 1, 512), False, False, False),  # VAE mid block
        ((2, 100, 4, 16), (2, 100, 4, 16), False, False, False),      # head_dim 16
    ],
)
def test_attention_dispatch_rule(q_shape, k_shape, has_mask, has_bias, expected):
    assert tnn.attention_uses_kernel(q_shape, k_shape, has_mask, has_bias) is expected


def test_import_does_not_import_jax():
    """Importing every module of the port (the A/B tool included) imports
    neither jax nor anything of audioldm2_tpu."""
    code = (
        "import sys, pkgutil, importlib, audioldm2_torch; "
        "names = [m.name for m in pkgutil.walk_packages(audioldm2_torch.__path__, "
        "'audioldm2_torch.')]; "
        "[importlib.import_module(n) for n in names]; "
        "assert 'audioldm2_torch.tools.ab_attn_variants' in names, names; "
        "assert 'audioldm2_torch.models.htsat' in names, names; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'audioldm2_tpu')); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# bf16: the bias is summed into the f32 accumulator before the one rounding
# ---------------------------------------------------------------------------

ROUND_ONCE_SHARE = 1e-3


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _round_once_case(op, rng):
    """(JAX op output, port op output), both bf16, on bf16-rounded inputs
    at UNet-like widths."""
    def p(*shape, scale):
        return {"w": _bf16(rng.standard_normal(shape) * scale),
                "b": _bf16(rng.standard_normal(shape[-1]))}

    if op == "linear":
        pp, x, kw = p(640, 640, scale=0.04), _bf16(rng.standard_normal((512, 640))), {}
    elif op == "conv2d":
        pp, x, kw = p(3, 3, 256, 128, scale=0.02), _bf16(rng.standard_normal((1, 16, 16, 256))), {}
    elif op == "conv1d":
        pp, x, kw = p(7, 128, 128, scale=0.03), _bf16(rng.standard_normal((2, 256, 128))), {}
    elif op == "conv_transpose1d":
        pp = {"w": _bf16(rng.standard_normal((16, 128, 256)) * 0.02),
              "b": _bf16(rng.standard_normal(128))}
        x, kw = _bf16(rng.standard_normal((1, 64, 256))), dict(stride=8, padding=4)
    else:  # conv1x1_cat
        pp, kw = p(1, 1, 640, 384, scale=0.04), {}
        x = (_bf16(rng.standard_normal((2, 16, 16, 384))), _bf16(rng.standard_normal((2, 16, 16, 256))))
    jp = {k: jnp.asarray(v) for k, v in pp.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16) for k, v in pp.items()}
    xs = x if isinstance(x, tuple) else (x,)
    want = getattr(jnn, op)(jp, *(jnp.asarray(a) for a in xs), **kw)
    got = getattr(tnn, op)(tp, *(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                                 for a in xs), **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("op", ["linear", "conv2d", "conv1d", "conv_transpose1d", "conv1x1_cat"])
def test_plain_op_rounds_once_in_bf16_like_jax(op):
    """The JAX ops keep the f32 accumulator, add the bias and round once.
    The port gives the bias to the op: the measured share of bf16 outputs
    that differ from JAX's is 0 (linear) to 1.5e-4 (conv1d) on the CPU;
    with the product rounded before the bias add it was 0.23-0.32."""
    want, got = _round_once_case(op, np.random.default_rng(zlib.crc32(op.encode())))
    assert got.shape == want.shape
    share = float(np.mean(got != want))
    assert share <= ROUND_ONCE_SHARE, share


@pytest.mark.parametrize(
    "w_shape,stride,pads,parts,expected",
    [
        ((3, 3, 8, 128), (1, 1), ((1, 1), (1, 1)), (8,), True),          # UNet stem
        ((3, 3, 128, 8), (1, 1), ((1, 1), (1, 1)), (128,), True),        # out_conv, Cout 8
        ((3, 3, 128, 16), (1, 1), ((1, 1), (1, 1)), (128,), True),       # 48k out_conv
        ((3, 3, 384, 384), (2, 2), ((1, 1), (1, 1)), (384,), True),      # downsample
        ((1, 1, 640, 640), (1, 1), ((0, 0), (0, 0)), (640,), True),      # proj_in / proj_out
        ((1, 1, 1024, 640), (1, 1), ((0, 0), (0, 0)), (640, 384), True),  # decoder skip
        ((1, 1, 8, 8), (1, 1), ((0, 0), (0, 0)), (8,), True),            # post_quant_conv
        ((5, 5, 128, 128), (1, 1), ((2, 2), (2, 2)), (128,), False),     # VAE time-stride-4
        ((3, 3, 128, 1), (1, 1), ((1, 1), (1, 1)), (128,), False),       # VAE conv_out
        ((3, 3, 4, 32), (1, 1), ((1, 1), (1, 1)), (4,), False),          # 4 latent channels
        ((1, 1, 20, 16), (1, 1), ((0, 0), (0, 0)), (12, 8), False),      # a part of 12
        ((3, 3, 64, 64), (4, 2), ((0, 0), (0, 0)), (64,), False),        # stride (4, 2)
        ((3, 3, 64, 64), (1, 1), ((0, -1), (0, 0)), (64,), False),       # cropping
        ((16, 16, 1, 768), (16, 16), ((0, 0), (0, 0)), (1,), False),     # AudioMAE patches
    ],
)
def test_conv2d_dispatch_rule(w_shape, stride, pads, parts, expected):
    """The one rule that sends a CUDA bf16 conv2d to the plain conv kernel:
    1x1 or 3x3, stride 1 or 2 in both dims, no negative padding, Cout and
    every input part a multiple of 8."""
    assert tnn.conv2d_uses_kernel(w_shape, stride, pads, parts) is expected


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_conv_dispatch_points_keep_the_cpu_composition(dtype):
    """On the CPU the new dispatch points are the compositions they replace,
    bit for bit: gn_conv2d is conv2d of group_norm, upsample_conv2d conv2d
    of nearest_upsample_2d, and conv2d itself its plain path; none counts a
    declined call."""
    from audioldm2_torch import ops

    ops.reset_launch_counts()
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 6, 4, 64))).to(dtype)
    norm = {"scale": _t(rng.standard_normal(64)).to(dtype),
            "bias": _t(rng.standard_normal(64)).to(dtype)}
    p1 = {k: _t(v).to(dtype) for k, v in _conv_p(rng, 1, 1, 64, 64).items()}
    p3 = {k: _t(v).to(dtype) for k, v in _conv_p(rng, 3, 3, 64, 32).items()}
    assert torch.equal(tnn.gn_conv2d(norm, p1, x, eps=1e-6),
                       tnn.conv2d(p1, tnn.group_norm(norm, x, eps=1e-6)))
    assert torch.equal(tnn.upsample_conv2d(p3, x), tnn.conv2d(p3, tnn.nearest_upsample_2d(x)))
    assert torch.equal(tnn.conv2d(p3, x, stride=(2, 2), padding=1),
                       tnn.conv2d_plain(p3, x, (2, 2), ((1, 1), (1, 1))))
    assert ops.declined_counts() == {"conv2d": 0}
