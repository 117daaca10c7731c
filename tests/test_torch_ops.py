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
    code = (
        "import sys; import audioldm2_torch, audioldm2_torch.pipeline, audioldm2_torch.ops.nn; "
        "import audioldm2_torch.ops.resblock_kernel, audioldm2_torch.ops.attention_kernel; "
        "import audioldm2_torch.ops.lnmm_kernel, audioldm2_torch.ops._build; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
