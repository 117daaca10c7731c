"""K7 (v6bd) and K8 (v7) plain versions against the Pallas kernels of
``tools/ab_attn_variants.py`` in interpret mode (CPU), and the A/B entry
point's ``--check``.

Both packages get the same numpy inputs. f32 tolerance 1e-5 relative to
max|out| (summation order only). The bf16 cases show that each plain
version rounds where its Pallas kernel rounds: the mismatch share against
the Pallas kernel stays near zero while a variant that rounds elsewhere
flips a visible share of outputs."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioldm2_torch.ops import attention_variants_kernel as avk
from audioldm2_torch.ops import nn as tnn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "ab_attn_variants_jax", os.path.join(REPO, "tools", "ab_attn_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JT = _jax_tool()


def _qkv(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32) for _ in range(3)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("variant", ["v6bd", "v7"])
@pytest.mark.parametrize("shape", [(1, 128, 4, 32), (2, 256, 8, 32), (1, 256, 2, 64)])
def test_plain_matches_pallas_interpret_f32(variant, shape):
    q, k, v = _qkv(shape, seed=sum(shape))
    scale = shape[-1] ** -0.5
    jfn = getattr(JT, f"{variant}_attention")
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, interpret=True))
    plain = getattr(avk, f"{variant}_attention_plain")
    got = plain(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _rel(got.numpy(), want) < TOL
    # the wrapper takes the plain version for CPU tensors
    wrapped = getattr(avk, f"{variant}_attention")(*(torch.from_numpy(a) for a in (q, k, v)),
                                                    scale)
    assert torch.equal(wrapped, got)
    # and both are softmax attention where no logit clamps
    soft = tnn.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale=scale)
    assert _rel(got.numpy(), soft.numpy()) < 1e-5


def test_v7_clamp_matches_pallas_and_differs_from_softmax():
    """Logits scaled past +-100: v7 and its plain version agree (clamped
    exp2, no max subtraction) and both differ from softmax; v6bd stays
    softmax."""
    shape = (1, 128, 4, 32)
    q, k, v = _qkv(shape, seed=5)
    q = q * 40.0
    scale = shape[-1] ** -0.5
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * scale * avk.LOG2E
    assert np.abs(logits).max() > 150 and (np.abs(logits) > 100).mean() > 0.01
    args_j = [jnp.asarray(a) for a in (q, k, v)]
    args_t = [torch.from_numpy(a) for a in (q, k, v)]
    want7 = np.asarray(JT.v7_attention(*args_j, scale, interpret=True))
    got7 = avk.v7_attention_plain(*args_t, scale).numpy()
    assert _rel(got7, want7) < TOL
    soft = tnn.attention_plain(*args_t, scale=scale).numpy()
    assert _rel(got7, soft) > 0.1
    want6 = np.asarray(JT.v6bd_attention(*args_j, scale, interpret=True))
    got6 = avk.v6bd_attention_plain(*args_t, scale).numpy()
    assert _rel(got6, want6) < TOL and _rel(got6, soft) < 1e-5


def _two_level_inputs(shape, seed):
    """q . k * scale * log2(e) takes two values per row, 2^-8 and 1 (so p
    sits on two levels whose bf16 rounding errs the same way on every
    key), and v is small integers: the output then depends visibly on
    whether the sum runs over the rounded or the unrounded p."""
    b, t, h, d = shape
    rng = np.random.default_rng(seed)
    scale = 1.0 / avk.LOG2E
    q = np.zeros(shape, np.float32)
    q[..., 0] = 1.0
    k = np.zeros(shape, np.float32)
    k[..., 0] = np.where(rng.random((b, t, h)) < 0.5, 2.0 ** -8, 1.0)
    v = rng.integers(-8, 9, shape).astype(np.float32)
    return q, k, v, scale


def test_v7_sums_the_rounded_pb():
    """q and k in f32, v in bf16: v7 rounds pb to v's dtype and outputs
    f32, so its rounding point shows without an output rounding."""
    q, k, v, scale = _two_level_inputs((1, 256, 4, 32), seed=1)
    want = np.asarray(JT.v7_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v, jnp.bfloat16), scale, interpret=True))
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v).bfloat16()
    got = avk.v7_attention_plain(tq, tk, tv, scale)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL
    # summing the unrounded p instead moves the output by ~1e-3
    logits = avk._logits(tq, tk, scale)
    p = torch.exp2(logits.clamp(-100.0, 100.0))
    alt = avk._pv(p.to(torch.bfloat16), tv) / p.sum(-1).permute(0, 2, 1)[..., None]
    assert _rel(alt.numpy(), want) > 1e-4


def test_v6bd_sums_the_unrounded_p_in_bf16():
    """All in bf16 (v6bd rounds p to the output dtype): the plain version
    matches the Pallas kernel on nearly every output; summing the rounded
    p instead flips a visible share of the bf16 outputs."""
    q, k, v, scale = _two_level_inputs((1, 256, 4, 32), seed=2)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(JT.v6bd_attention(*jargs, scale, interpret=True).astype(jnp.float32))
    targs = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = avk.v6bd_attention_plain(*targs, scale)
    assert got.dtype == torch.bfloat16
    assert float(np.mean(got.float().numpy() != want)) < 0.01
    logits = avk._logits(targs[0], targs[1], scale)
    pb = torch.exp2(logits - logits.amax(-1, keepdim=True)).bfloat16()
    alt = (avk._pv(pb, targs[2]) / pb.float().sum(-1).permute(0, 2, 1)[..., None]).bfloat16()
    assert float(np.mean(alt.float().numpy() != want)) > 0.05


@pytest.mark.parametrize("variant", ["v6bd", "v7"])
@pytest.mark.parametrize("shape,match", [
    ((1, 128, 3, 32), "multiple of 128"),    # H * D = 96
    ((1, 128, 4, 48), "divide 128"),         # D = 48
    ((1, 1001, 4, 32), "no q block"),        # T with no divisor block in the budget
    ((1, 128, 4, 32, 1), "one"),             # not [B, T, H, D]
])
def test_wrappers_refuse_what_pallas_refuses(variant, shape, match):
    q = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        getattr(avk, f"{variant}_attention")(q, q, q, 0.1)


def test_block_q_rules_match_jax():
    from audioldm2_tpu.ops import attention_pallas as ap

    for t in (64, 128, 256, 384, 1024, 1536, 2048, 4096, 8192):
        assert avk.v6bd_block_q(t) == JT._v6bd_block_q(t)
        for d in (32, 64, 128):
            assert avk.v7_block_q(t, d) == ap._block_q(t, d)


def test_ab_tool_check_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "audioldm2_torch.tools.ab_attn_variants",
                          "--check"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "plain numerics OK" in out.stdout
