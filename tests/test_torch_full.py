"""The audioldm2-full slice of audioldm2_torch against audioldm2_tpu on the
CPU, float32: RoBERTa, the CLAP text embedding, GPT-2 (prefill and each
KV-cached step against the full forward), the sequence generator, the
clap and sequence_gen conditioners, the parameter tree, and the tiny
audioldm2-full-shaped pipeline end to end.

Both packages get the same numpy parameter trees and numpy inputs.
Module tolerance 1e-4 (float32, summation order only); end to end, mel
MAE < 1e-3 (ROADMAP), with the same x_T and the same per-step noise."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audioldm2_torch as at
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.config import AudioMAEConfig, ConditionerSpec, GPT2Config, SequenceGenConfig
from audioldm2_tpu.models import clap as jclap
from audioldm2_tpu.models import conditioners as jcond
from audioldm2_tpu.models import gpt2 as jgpt2
from audioldm2_tpu.models import roberta as jroberta
from audioldm2_tpu.models import sequence_gen as jsg
from audioldm2_torch import params as tparams
from audioldm2_torch.models import clap as tclap
from audioldm2_torch.models import conditioners as tcond
from audioldm2_torch.models import gpt2 as tgpt2
from audioldm2_torch.models import pann as tpann
from audioldm2_torch.models import roberta as troberta
from audioldm2_torch.models import sequence_gen as tsg
from test_torch_models import _flatten, nonzero_tree
from tiny import TINY_T5, tiny_clap_config, tiny_t5_model_config

torch.set_num_threads(2)

TOL = 1e-4
TINY_GPT2 = GPT2Config(n_embd=768, n_layer=1, n_head=4)
TINY_ROBERTA = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)


TINY_PANN = dict(sample_rate=1600, window_size=64, hop_size=16, mel_bins=16, fmin=10.0,
                 fmax=790.0, embed_dim=24, variant="cnn10", channels_override=(8, 16))


def tiny_clap():
    """tests/tiny.py's CLAP config, with its 1-layer RoBERTa text tower and
    its tiny PANN audio tower registered in the port as in the JAX
    registry."""
    cfg = tiny_clap_config()
    tclap.register_text_tower("roberta-tiny", lambda: troberta.RobertaConfig(**TINY_ROBERTA), 16)
    tclap.register_audio_tower("PANN-tiny", lambda: tpann.PANNConfig(**TINY_PANN), 24)
    return cfg


def _seqgen_spec(max_context: int = 1024) -> ConditionerSpec:
    """seqgen[CLAP + T5] -> GPT-2, 8 tokens, with audioldm2-full's nested
    AudioMAE spec (drawn, not an input, so never encoded by generation)."""
    clap = ConditionerSpec(name="film_clap_cond1", kind="clap", clap=tiny_clap())
    t5 = ConditionerSpec(name="crossattn_flan_t5", kind="flan_t5", flan_t5=TINY_T5)
    mae = ConditionerSpec(
        name="crossattn_audiomae_pooled", kind="audiomae_pooled",
        cond_stage_key="ta_kaldi_fbank",
        audiomae=AudioMAEConfig(img_size=(64, 32), embed_dim=48, depth=1, num_heads=4,
                                mlp_ratio=2.0, contextual_depth=1),
    )
    return ConditionerSpec(
        name="crossattn_audiomae_generated", kind="sequence_gen", cond_stage_key="all",
        sequence_gen=SequenceGenConfig(
            sequence_gen_length=8,
            sequence_input_keys=("film_clap_cond1", "crossattn_flan_t5"),
            sequence_input_embed_dims=(24, TINY_T5.d_model),
            gpt2=TINY_GPT2,
            max_context=max_context,
        ),
        nested=(clap, t5, mae),
    )


def tiny_full_config():
    """audioldm2-full in miniature: seqgen[CLAP + T5] plus T5, two context
    slots (768, T5 width)."""
    base = tiny_t5_model_config()
    t5 = ConditionerSpec(name="crossattn_flan_t5", kind="flan_t5", flan_t5=TINY_T5)
    return dataclasses.replace(
        base, name="tiny-full",
        unet=dataclasses.replace(base.unet, context_dims=(768, TINY_T5.d_model)),
        conditioners=(_seqgen_spec(), t5),
    )


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _batch(b=2, seed=0):
    """Token ids and masks for the T5 and CLAP inputs (trailing pads), and
    their unconditional entries, as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, length, pad in (("t5", TINY_T5.max_length, 0), ("clap", 16, 1)):
        for prefix, rows in (("", b), ("uncond_", 1)):
            ids = rng.integers(3, 1000, (rows, length)).astype(np.int32)
            mask = np.ones((rows, length), np.int32)
            for r in range(rows):
                mask[r, 3 + 4 * r:] = 0
            ids[mask == 0] = pad
            out[f"{name}_{prefix}ids"], out[f"{name}_{prefix}mask"] = ids, mask
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_roberta_matches_jax():
    cfg = jroberta.RobertaConfig(vocab_size=500, max_position_embeddings=40, **{
        **TINY_ROBERTA, "num_layers": 2})
    tree = _np(jroberta.init_roberta(jax.random.PRNGKey(1), cfg))
    b = _batch()
    ids, mask = b["clap_ids"] % 500, b["clap_mask"]
    want_seq, want_pool = jroberta.apply_roberta(tree, cfg, jnp.asarray(ids), jnp.asarray(mask))
    tcfg = troberta.RobertaConfig(**dataclasses.asdict(cfg))
    got_seq, got_pool = troberta.apply_roberta(tparams.from_jax_tree(tree), tcfg,
                                               torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got_seq, want_seq)
    _close(got_pool, want_pool)


def test_clap_text_embedding_matches_jax():
    cfg = tiny_clap()
    tree = _np(jclap.init_clap(jax.random.PRNGKey(2), cfg))
    b = _batch()
    want = jclap.text_embedding(tree, cfg, jnp.asarray(b["clap_ids"]), jnp.asarray(b["clap_mask"]))
    got = tclap.text_embedding(tparams.from_jax_tree(tree), cfg, torch.from_numpy(b["clap_ids"]),
                               torch.from_numpy(b["clap_mask"]))
    assert tuple(got.shape) == (2, 1, cfg.embed_dim)
    _close(got, want)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-6)


def test_clap_refuses_unported_text_towers():
    """Every text tower of the JAX registry is ported (bert among them); a
    name in neither registry raises, in the lookup and in build_model."""
    for name in ("roberta", "bert", "bart", "transformer"):
        assert tclap.text_tower(dataclasses.replace(tiny_clap(), tmodel=name))[1] == \
            jclap.text_tower(dataclasses.replace(tiny_clap(), tmodel=name))[1]
    bad = dataclasses.replace(tiny_clap(), tmodel="gpt-neo")
    with pytest.raises(KeyError):
        tclap.text_tower(bad)
    spec = ConditionerSpec(name="film_clap_cond1", kind="clap", clap=bad)
    with pytest.raises(ValueError, match="unknown CLAP tower"):
        at.build_model(config=dataclasses.replace(tiny_full_config(), conditioners=(spec,)),
                       device="cpu")


def test_gpt2_prefill_and_steps_match_forward_full():
    """prefill, then three KV-cached steps, each against JAX's prefill and
    the cache-free forward over the grown sequence, JAX's and the port's
    (a pad mid-prefix)."""
    tree = _np(jgpt2.init_gpt2(jax.random.PRNGKey(3), TINY_GPT2))
    p = tparams.from_jax_tree(tree)
    rng = np.random.default_rng(3)
    b, length, steps = 2, 7, 3
    seq = rng.standard_normal((b, length + steps, 768)).astype(np.float32)
    mask = np.ones((b, length), np.float32)
    mask[1, 2:4] = 0.0
    want_h, _ = jgpt2.prefill(tree, TINY_GPT2, jnp.asarray(seq[:, :length]), jnp.asarray(mask),
                              length + steps)
    h, cache = tgpt2.prefill(p, TINY_GPT2, torch.from_numpy(seq[:, :length]),
                             torch.from_numpy(mask), length + steps)
    _close(h, want_h)
    cache_mask = torch.nn.functional.pad(torch.from_numpy(mask), (0, steps))
    content = torch.from_numpy(mask).sum(1).long()
    for i in range(steps):
        g, cache = tgpt2.step(p, TINY_GPT2, torch.from_numpy(seq[:, length + i]), cache,
                              cache_mask, length + i, content + i)
        cache_mask[:, length + i] = 1.0
        full_mask = np.concatenate([mask, np.ones((b, i + 1), np.float32)], axis=1)
        want = jgpt2.forward_full(tree, TINY_GPT2, jnp.asarray(seq[:, :length + i + 1]),
                                  jnp.asarray(full_mask))
        _close(g, np.asarray(want)[:, -1])
        own = tgpt2.forward_full(p, TINY_GPT2, torch.from_numpy(seq[:, :length + i + 1]),
                                 torch.from_numpy(full_mask))
        _close(g, own[:, -1])


@pytest.mark.parametrize("pad", [False, True])
def test_gpt2_forward_full_matches_jax(pad):
    tree = _np(jgpt2.init_gpt2(jax.random.PRNGKey(5), TINY_GPT2))
    rng = np.random.default_rng(5)
    seq = rng.standard_normal((2, 9, 768)).astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    if pad:
        mask[0, 3:5] = 0.0
        mask[1, -2:] = 0.0
    want = jgpt2.forward_full(tree, TINY_GPT2, jnp.asarray(seq), jnp.asarray(mask))
    got = tgpt2.forward_full(tparams.from_jax_tree(tree), TINY_GPT2, torch.from_numpy(seq),
                             torch.from_numpy(mask))
    assert got.shape == (2, 9, 768)
    _close(got, want)


@pytest.mark.parametrize("max_context", [1024, 22])
def test_sequence_gen_matches_jax(max_context):
    """The T5 pads sit mid-prefix (before its EOS wrapper); max_context 22
    truncates the prefix inside those pads, so the last prefix position is
    a pad and g0 comes from the last valid one."""
    spec = _seqgen_spec(max_context)
    tree = _np(jsg.init_sequence_gen(jax.random.PRNGKey(4), spec))
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want_seq, want_mask = jsg.assemble_prefix(tree, spec, jb)
    p = tparams.from_jax_tree(tree)
    got_seq, got_mask = tsg.assemble_prefix(p, spec, _tbatch(b))
    _close(got_seq, want_seq)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    if max_context == 22:
        assert not np.asarray(want_mask)[:, -1].any()
    want = jsg.generate(tree, spec, jb)
    got = tsg.generate(p, spec, _tbatch(b))
    assert tuple(got.shape) == (2, 8, 768)
    _close(got, want)


@pytest.mark.parametrize("kind", ["clap", "sequence_gen"])
def test_conditioner_matches_jax(kind):
    """encode and unconditional of the clap (film) and sequence_gen
    (crossattn) kinds."""
    spec = _seqgen_spec()
    if kind == "clap":
        spec = spec.nested[0]
    tree = _np(jcond.init_conditioner(jax.random.PRNGKey(5), spec))
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    p, tb = tparams.from_jax_tree(tree), _tbatch(b)
    for want, got in ((jcond.encode(tree, spec, jb), tcond.encode(p, spec, tb)),
                      (jcond.unconditional(tree, spec, jb, 3),
                       tcond.unconditional(p, spec, tb, 3))):
        assert got[0] == want[0] == ("film" if kind == "clap" else "crossattn")
        for g, w in zip(jax.tree.leaves(got[1]), jax.tree.leaves(want[1])):
            assert tuple(g.shape) == tuple(np.shape(w))
            _close(g, w)


def test_init_params_structure_matches_jax():
    """init_params draws the JAX tree's keys and shapes, the nested AudioMAE
    and the text-mode CLAP's PANN audio tower and projection included."""
    cfg = tiny_full_config()
    jtree = _np(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    ttree = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _flatten(ttree) == _flatten(jtree)


@pytest.fixture(scope="module")
def full_models():
    cfg = tiny_full_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jpipe.AudioLDM2(cfg, tree), at.build_model(config=cfg, device="cpu", params=tree)


def test_tiny_full_end_to_end_matches_jax(full_models):
    cfg, jmodel, tmodel = full_models
    prompt = "a dog barking in the rain"
    jbatch = jmodel.make_batch(prompt, batchsize=2)
    tbatch = tmodel.make_batch(prompt, batchsize=2)
    assert sorted(tbatch) == sorted(k for k in jbatch
                                    if k.startswith(("t5_", "clap_", "ta_kaldi_fbank")))
    for k, v in tbatch.items():
        np.testing.assert_array_equal(v.numpy(), jbatch[k])
    lt, steps, key = 16, 4, jax.random.PRNGKey(9)
    shape = (2, lt, cfg.latent_f_size, cfg.latent_channels)
    x_T = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    # the JAX sampler's per-step noise (ddim.py:92-117), handed to the port
    k, _ = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.split(sk)[1], shape, jnp.float32))
                      for sk in jax.random.split(k, steps)])
    kw = dict(latent_t_size=lt, n_gen=1, guidance=3.5, ddim_steps=steps, ddim_eta=1.0)
    wj, mj = jmodel.ldm.generate(jbatch, key, x_T=x_T, **kw)
    wt, mt = tmodel.ldm.generate(tbatch, None, x_T=torch.from_numpy(x_T),
                                 noise=torch.from_numpy(noise), **kw)
    assert mt.shape == mj.shape == (2, 2 * lt, 16, 1)
    assert float(np.abs(mj).mean()) > 1e-2
    mel_mae = float(np.abs(mt - mj).mean())
    assert mel_mae < 1e-3, mel_mae


def test_tiny_full_text_to_audio(full_models):
    _, _, tmodel = full_models
    wav = at.text_to_audio(tmodel, "rain", seed=3, batchsize=2, ddim_steps=4, duration=0.32,
                           duration_bucket=None, n_candidate_gen_per_text=1)
    assert wav.shape == (2, 1, 512) and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
