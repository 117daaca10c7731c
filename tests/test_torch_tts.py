"""The speech families (audioldm2-speech-gigaspeech, -ljspeech) of
audioldm2_torch against audioldm2_tpu on the CPU, float32: the VITS phoneme
encoder (conditioned, partly padded and all-pad inputs; the relative-position
attention with fully masked rows), the phoneme conditioner, the TTS sequence
generator (CLAP + phonemes -> GPT-2, prefix truncation), the parameter tree,
make_batch's phoneme ids, and a tiny TTS pipeline end to end through
text_to_audio with a transcription.

Both packages get the same numpy parameter trees and numpy inputs. Module
tolerance: max abs <= 1e-5 (float32, summation order only); end to end,
mel MAE < 1e-3 with the same x_T and per-step noise. Neither machine has
phonemizer/espeak, so both packages take the same grapheme fallback."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audioldm2_torch as at
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.config import (AudioMAEConfig, ConditionerSpec, PhonemeEncoderConfig,
                                  SequenceGenConfig)
from audioldm2_tpu.models import conditioners as jcond
from audioldm2_tpu.models import phoneme as jph
from audioldm2_tpu.models import sequence_gen as jsg
from audioldm2_tpu.utils import text as jtext
from audioldm2_torch import params as tparams
from audioldm2_torch.models import conditioners as tcond
from audioldm2_torch.models import phoneme as tph
from audioldm2_torch.models import sequence_gen as tsg
from test_torch_full import TINY_GPT2, tiny_clap
from test_torch_models import _flatten, nonzero_tree
from tiny import tiny_t5_model_config

torch.set_num_threads(2)

TOL = 1e-5
# the shipped encoder's vocabulary, pad length and window; narrow widths, two layers
TINY_PHONEME = PhonemeEncoderConfig(hidden_channels=16, filter_channels=32, n_heads=2,
                                    n_layers=2)
TRANSCRIPTION = "Dr. Smith read 2 books; the quick brown fox jumps!"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _phoneme_spec():
    return ConditionerSpec(name="crossattn_vits_phoneme", kind="phoneme",
                           cond_stage_key="phoneme_idx", phoneme=TINY_PHONEME)


def _tts_spec(max_context: int = 1024, gen_length: int = 512) -> ConditionerSpec:
    """The TTS sequence generator in miniature: CLAP + phonemes (192 -> 16
    wide) -> GPT-2, with the nested AudioMAE spec the shipped config carries
    (drawn, not an input, so never encoded by generation)."""
    mae = ConditionerSpec(
        name="crossattn_audiomae_pooled", kind="audiomae_pooled",
        cond_stage_key="ta_kaldi_fbank",
        audiomae=AudioMAEConfig(img_size=(64, 32), embed_dim=48, depth=1, num_heads=4,
                                mlp_ratio=2.0, contextual_depth=1, eval_time_pooling=1,
                                eval_freq_pooling=1))
    clap = ConditionerSpec(name="film_clap_cond1", kind="clap", clap=tiny_clap())
    return ConditionerSpec(
        name="crossattn_audiomae_generated", kind="sequence_gen", cond_stage_key="all",
        sequence_gen=SequenceGenConfig(
            sequence_gen_length=gen_length,
            sequence_input_keys=("film_clap_cond1", "crossattn_vits_phoneme"),
            sequence_input_embed_dims=(clap.clap.embed_dim, TINY_PHONEME.hidden_channels),
            gpt2=TINY_GPT2, max_context=max_context),
        nested=(clap, _phoneme_spec(), mae))


def tiny_tts_config():
    """audioldm2-speech-* in miniature: the TTS sequence generator (512
    tokens) as the only conditioner, one 768-wide context slot."""
    base = tiny_t5_model_config()
    return dataclasses.replace(base, name="tiny-tts",
                               unet=dataclasses.replace(base.unet, context_dims=(768,)),
                               conditioners=(_tts_spec(),))


def _ids(rows=3, seed=0):
    """[rows, 310] ids: one partly padded row per length, the last row all
    pad."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY_PHONEME.vocab_size, (rows, TINY_PHONEME.pad_length)).astype(np.int32)
    for r, n in enumerate((57, 300, 0)[:rows]):
        ids[r, n:] = 0
    return ids


@pytest.fixture(scope="module")
def phoneme_tree():
    tree = nonzero_tree(jph.init_phoneme_encoder(jax.random.PRNGKey(1), TINY_PHONEME))
    return tree, tparams.from_jax_tree(tree)


def test_phoneme_tree_matches_jax():
    """The port draws the JAX tree's keys and shapes: emb_rel_k/v [1, 9,
    h / heads], the q/k/v/o and FFN convs as [k, Cin, Cout], the unused
    proj head and the positional embedding [1, 310, h] of zeros."""
    jtree = jph.init_phoneme_encoder(jax.random.PRNGKey(0), TINY_PHONEME)
    ttree = tph.init_phoneme_encoder(tparams.Init(torch.Generator().manual_seed(0), "cpu"),
                                     TINY_PHONEME)
    assert _flatten(ttree) == _flatten(jtree)
    assert tuple(ttree["layers"][0]["attn"]["emb_rel_k"].shape) == (1, 9, 8)
    assert tuple(ttree["layers"][0]["ffn"]["conv1"]["w"].shape) == (3, 16, 32)
    assert not ttree["pos_emb"].any()
    full = tph.init_phoneme_encoder(tparams.Init(torch.Generator(), "meta"), PhonemeEncoderConfig())
    assert tuple(full["layers"][5]["attn"]["emb_rel_v"].shape) == (1, 9, 96)
    assert tuple(full["pos_emb"].shape) == (1, 310, 192)


def test_phoneme_encoder_matches_jax(phoneme_tree):
    """Rows of 57 and 300 phonemes and an all-pad row (the unconditional
    input): embeddings and the prefix mask."""
    tree, p = phoneme_tree
    ids = _ids()
    want, want_mask = jph.apply_phoneme_encoder(tree, TINY_PHONEME, jnp.asarray(ids))
    got, got_mask = tph.apply_phoneme_encoder(p, TINY_PHONEME, torch.from_numpy(ids))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got_mask.sum(1).tolist() == [57, 300, 0]
    assert float(np.abs(np.asarray(want)[:2]).max()) > 1.0
    _close(got, want)
    # the all-pad row is the positional embedding alone
    _close(got[2], np.asarray(tree["pos_emb"])[0])


def test_relative_attention_fills_masked_logits_like_jax(phoneme_tree):
    """One attention layer on its own, with rows whose logits are all
    masked (the pad positions): the -1e4 fill softmaxes them as JAX does."""
    tree, p = phoneme_tree
    rng = np.random.default_rng(2)
    length = 40
    x = rng.standard_normal((2, length, TINY_PHONEME.hidden_channels)).astype(np.float32)
    lengths = np.array([25, 0])
    m = (np.arange(length)[None, :] < lengths[:, None]).astype(np.float32)
    keep = (m[:, None, :, None] * m[:, None, None, :]) > 0
    assert not keep[0, 0, 30].any() and not keep[1].any()
    want = jph._rel_attention(tree["layers"][0]["attn"], jnp.asarray(x), jnp.asarray(keep),
                              TINY_PHONEME)
    got = tph._rel_attention(p["layers"][0]["attn"], torch.from_numpy(x), torch.from_numpy(keep),
                             TINY_PHONEME)
    _close(got, want)


@pytest.mark.parametrize("way", ["encode", "unconditional"])
def test_phoneme_conditioner_matches_jax(phoneme_tree, way):
    """The phoneme kind: ("crossattn", (ctx, mask)), the unconditional one
    the encoding of all-pad inputs tiled to the batch."""
    tree, p = phoneme_tree
    spec = _phoneme_spec()
    ids = _ids(2)
    if way == "encode":
        want = jcond.encode(tree, spec, {"phoneme_idx": jnp.asarray(ids)})
        got = tcond.encode(p, spec, {"phoneme_idx": torch.from_numpy(ids)})
    else:
        want = jcond.unconditional(tree, spec, {"phoneme_idx": jnp.asarray(ids)}, 3)
        got = tcond.unconditional(p, spec, {"phoneme_idx": torch.from_numpy(ids)}, 3)
    assert got[0] == want[0] == "crossattn"
    _close(got[1][0], want[1][0])
    np.testing.assert_array_equal(got[1][1].numpy(), np.asarray(want[1][1]))


def _seqgen_batch(transcription=TRANSCRIPTION, b=2):
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 1000, (b, 16)).astype(np.int32)
    mask = np.ones((b, 16), np.int32)
    mask[:, 6:] = 0
    ids[mask == 0] = 1
    phonemes = jtext.text_to_phonemes(transcription)
    return {"clap_ids": ids, "clap_mask": mask, "clap_uncond_ids": ids[:1],
            "clap_uncond_mask": mask[:1], "phoneme_idx": jtext.phoneme_ids([phonemes] * b)}


@pytest.mark.parametrize("max_context", [1024, 60])
def test_tts_sequence_gen_matches_jax(max_context):
    """The CLAP + phoneme prefix (3 + 312 tokens, the phoneme pads
    mid-prefix before its EOS wrapper) and 8 generated tokens; at
    max_context 60 the prefix is truncated to 52 inside the phonemes."""
    spec = _tts_spec(max_context, gen_length=8)
    tree = _np(jsg.init_sequence_gen(jax.random.PRNGKey(4), spec))
    b = _seqgen_batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    p = tparams.from_jax_tree(tree)
    want_seq, want_mask = jsg.assemble_prefix(tree, spec, jb)
    got_seq, got_mask = tsg.assemble_prefix(p, spec, tb)
    assert tuple(got_seq.shape) == (2, min(315, max_context - 8), 768)
    _close(got_seq, want_seq)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    want = jsg.generate(tree, spec, jb)
    got = tsg.generate(p, spec, tb)
    assert tuple(got.shape) == (2, 8, 768)
    _close(got, want)


def test_tts_sequence_gen_generates_512_tokens():
    """The shipped generator's 512 KV-cached steps (the tiny GPT-2) and its
    unconditional branch: zeros of the generated length, mask all ones."""
    spec = _tts_spec()
    tree = _np(jsg.init_sequence_gen(jax.random.PRNGKey(5), spec))
    b = _seqgen_batch(b=1)
    want = jsg.generate(tree, spec, {k: jnp.asarray(v) for k, v in b.items()})
    got = tsg.generate(tparams.from_jax_tree(tree), spec,
                       {k: torch.from_numpy(v) for k, v in b.items()})
    assert tuple(got.shape) == (1, 512, 768)
    _close(got, want)
    kind, (ctx, mask) = tcond.unconditional({}, spec, {k: torch.from_numpy(v)
                                                      for k, v in b.items()}, 2)
    assert kind == "crossattn" and tuple(ctx.shape) == (2, 512, 768) and not ctx.any()
    assert bool((mask == 1).all())


def test_init_params_structure_matches_jax():
    """init_params draws the JAX tree's keys and shapes for the TTS family,
    the nested AudioMAE and the text-mode CLAP's PANN audio tower and
    projection included."""
    cfg = tiny_tts_config()
    jtree = _np(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    ttree = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _flatten(ttree) == _flatten(jtree)


@pytest.fixture(scope="module")
def tts_models():
    cfg = tiny_tts_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jpipe.AudioLDM2(cfg, tree), at.build_model(config=cfg, device="cpu", params=tree)


@pytest.mark.parametrize("transcription", [TRANSCRIPTION, ""])
def test_make_batch_phoneme_idx_matches_jax(tts_models, transcription):
    """make_batch(text, transcription, batchsize) in JAX's order: the same
    phoneme ids (the grapheme fallback, "⚠" EOS, 310 wide) and tokens."""
    _, jmodel, tmodel = tts_models
    jb = jmodel.make_batch("a man speaks", transcription, 2)
    tb = tmodel.make_batch("a man speaks", transcription, 2)
    assert tuple(tb["phoneme_idx"].shape) == (2, 310)
    for k, v in tb.items():
        np.testing.assert_array_equal(v.numpy(), jb[k])
    text = at.pipeline.text_utils
    n = len(text.text_to_phonemes(transcription))  # "2" is no VITS symbol: it maps to "_", 0
    ids = tb["phoneme_idx"][0].numpy()
    assert ids[n] == text.VITS_SYMBOLS.index("⚠") and not ids[n + 1:].any()


def _injected(jmodel, tmodel, x_T, steps, run):
    """run() with JAX's x_T and per-step DDIM noise (eta 1) given to both
    packages' generate; returns (JAX's result, the port's)."""
    keys = {}
    orig = jmodel.ldm.generate

    def generate(batch, key, **kw):
        keys["key"] = key
        return orig(batch, key, x_T=x_T, **kw)

    jmodel.ldm.generate = generate
    try:
        want = run(jpipe, jmodel)
    finally:
        del jmodel.ldm.generate
    k, _ = jax.random.split(keys["key"])
    noise = np.stack([np.asarray(jax.random.normal(jax.random.split(sk)[1], x_T.shape,
                                                   jnp.float32))
                      for sk in jax.random.split(k, steps)])
    torig = tmodel.ldm.generate
    tmodel.ldm.generate = lambda batch, gen, **kw: torig(
        batch, gen, x_T=torch.from_numpy(x_T), noise=torch.from_numpy(noise), **kw)
    try:
        got = run(at, tmodel)
    finally:
        del tmodel.ldm.generate
    return want, got


def test_tiny_tts_text_to_audio_matches_jax(tts_models):
    """text_to_audio with a transcription at batch 2 (the 512-token
    generator, CFG): the same waveform shape and a mel MAE < 1e-3; a
    different transcription changes the port's output."""
    cfg, jmodel, tmodel = tts_models
    bsz, steps, lt = 2, 4, 16
    x_T = np.random.default_rng(9).standard_normal(
        (bsz, lt, cfg.latent_f_size, cfg.latent_channels)).astype(np.float32)
    kw = dict(seed=11, ddim_steps=steps, duration=0.32, batchsize=bsz, duration_bucket=None,
              n_candidate_gen_per_text=1)
    want, got = _injected(jmodel, tmodel, x_T, steps, lambda pkg, m: pkg.text_to_audio(
        m, "a man speaks", transcription=TRANSCRIPTION, **kw))
    assert got.shape == want.shape == (bsz, 1, 512)
    mel_t = tmodel.mel.mel(got[:, 0]).numpy()
    mel_j = tmodel.mel.mel(np.asarray(want)[:, 0]).numpy()
    assert float(np.abs(mel_j).mean()) > 1e-2
    mae = float(np.abs(mel_t - mel_j).mean())
    assert mae < 1e-3, mae
    other = at.text_to_audio(tmodel, "a man speaks", transcription="Hello.", **kw)
    assert np.abs(other - got).max() > 0
