"""CLAP's other towers, audioldm2_torch against audioldm2_tpu on the CPU,
float32: PANN CNN14 and CNN10, the BERT, BART and CLIP-transformer text
towers (and RoBERTa, through the same dispatch), the CLIP BPE tokenizer,
``convert_clip_text``, the long-audio windows, the rerank scorer on a PANN
+ transformer CLAP, the feature-fusion gates, and each tower's drawn tree
at its published width.

Both packages get the same numpy parameter trees (``from_jax_tree``) and
numpy inputs. Tiny towers are registered in both packages; BERT, BART and
the transformer under their own names (which select their pooling and
tokenizer), for one test at a time (monkeypatch). Tolerance 1e-5 relative to the largest
magnitude (float32, summation order only) unless a test says otherwise."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audioldm2_torch as at
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.config import CLAPConfig
from audioldm2_tpu.models import clap as jclap
from audioldm2_tpu.models import clip_text as jclip
from audioldm2_tpu.models import feature_fusion as jff
from audioldm2_tpu.models import pann as jpann
from audioldm2_tpu.models import roberta as jroberta
from audioldm2_tpu.ops import nn as jnn
from audioldm2_tpu.utils import bpe as jbpe
from audioldm2_tpu.utils import text as jtext
from audioldm2_torch import params as tparams
from audioldm2_torch.models import clap as tclap
from audioldm2_torch.models import clip_text as tclip
from audioldm2_torch.models import feature_fusion as tff
from audioldm2_torch.models import pann as tpann
from audioldm2_torch.models import roberta as troberta
from audioldm2_torch.utils import bpe as tbpe
from audioldm2_torch.utils import text as ttext
from test_torch_full import TINY_PANN, tiny_clap
from test_torch_models import _flatten, nonzero_tree
from tiny import tiny_t5_model_config

torch.set_num_threads(2)

TOL = 1e-5
TINY_CLIP = dict(vocab_size=49408, width=16, heads=2, layers=2, context_length=77)
TINY_TEXT = {
    "bert": dict(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                 intermediate_size=32, max_position_embeddings=64, type_vocab_size=2,
                 pad_token_id=0),
    "bart": dict(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                 intermediate_size=32, max_position_embeddings=66),
    "roberta": dict(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                    intermediate_size=32, max_position_embeddings=66),
}
PROMPTS = ["A dog barking in the distance.", "", "   rain,  on a TIN roof!!  ",
           "Café naïve — 東京の雨 🎵", "it's what we'll've done; isn't it?",
           "&amp;lt;b&amp;gt; html &quot;entities&quot;", "x" * 3 + " word" * 90,
           "multiple\n\nlines\tand\ttabs", "123 4.56 7,890"]


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _wav(rows=2, n=4000, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal((rows, n))).astype(np.float32)


def _ids(b=2, length=24, vocab=1000, pad=0, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    for r in range(b):
        mask[r, 7 + 5 * r:] = 0
    ids[mask == 0] = pad
    return ids, mask


@pytest.fixture
def tiny_text_towers(monkeypatch):
    """The tiny BERT, BART, RoBERTa and transformer under the published
    names, in both registries, for one test."""
    for name, kw in TINY_TEXT.items():
        monkeypatch.setitem(jclap.TEXT_TOWERS, name, (lambda kw=kw: jroberta.RobertaConfig(**kw), 16))
        monkeypatch.setitem(tclap.TEXT_TOWERS, name,
                            (lambda kw=kw: troberta.RobertaConfig(**kw), 16))
    monkeypatch.setitem(jclap.TEXT_TOWERS, "transformer",
                        (lambda: jclip.CLIPTextConfig(**TINY_CLIP), TINY_CLIP["width"]))
    monkeypatch.setitem(tclap.TEXT_TOWERS, "transformer",
                        (lambda: tclip.CLIPTextConfig(**TINY_CLIP), TINY_CLIP["width"]))
    tiny_clap()  # PANN-tiny in both


def _clap_cfg(tmodel="roberta", amodel="PANN-tiny"):
    return CLAPConfig(amodel=amodel, tmodel=tmodel, sampling_rate=1600, embed_dim=24,
                      clip_samples=1024, text_max_length=24)


# ---------------------------------------------------------------------------
# PANN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["cnn14", "cnn10"])
def test_pann_encode_matches_jax(variant):
    """Three stages (CNN14 leaves its last unpooled, CNN10 pools every one),
    BatchNorms with drawn statistics, the embedding and the clip-wise
    output."""
    kw = dict(TINY_PANN, variant=variant, channels_override=(8, 16, 32), embed_dim=24)
    jcfg, tcfg = jpann.PANNConfig(**kw), tpann.PANNConfig(**kw)
    assert tcfg.pools == jcfg.pools == ((2, 2, 1) if variant == "cnn14" else (2, 2, 2))
    tree = nonzero_tree(jpann.init_pann(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    for blk in tree["blocks"]:  # running statistics away from (0, 1)
        for bn in ("bn1", "bn2"):
            blk[bn]["var"] = (0.5 + rng.random(blk[bn]["var"].shape)).astype(np.float32)
    wav = _wav()
    want = jpann.encode(tree, jnp.asarray(wav), jcfg)
    got = tpann.encode(tparams.from_jax_tree(tree), _t(wav), tcfg)
    assert tuple(got["embedding"].shape) == (2, 24)
    for k in ("embedding", "clipwise_output"):
        assert _rel(got[k], want[k]) < TOL, k


def test_pann_tree_matches_jax_at_both_published_widths(jax_shapes_only):
    for kw in ({}, {"variant": "cnn10", "embed_dim": 1024}):
        jtree = jpann.init_pann(jax.random.PRNGKey(0), jpann.PANNConfig(**kw))
        ttree = tpann.init_pann(tparams.Init(torch.Generator(), "meta"), tpann.PANNConfig(**kw))
        assert _flatten(ttree) == _flatten(jtree)


# ---------------------------------------------------------------------------
# Text towers
# ---------------------------------------------------------------------------


def test_bert_style_roberta_and_bart_encoder_match_jax():
    """apply_roberta(bert_style=True) with and without token-type ids, and
    apply_bart_encoder, on the same tree."""
    jcfg = jroberta.RobertaConfig(**TINY_TEXT["bert"])
    tcfg = troberta.RobertaConfig(**TINY_TEXT["bert"])
    tree = nonzero_tree(jroberta.init_roberta(jax.random.PRNGKey(1), jcfg))
    p = tparams.from_jax_tree(tree)
    ids, mask = _ids()
    types = (np.arange(24)[None, :] >= 10).astype(np.int32).repeat(2, 0)
    for tt in (None, types):
        want = jroberta.apply_roberta(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                      bert_style=True,
                                      token_type_ids=None if tt is None else jnp.asarray(tt))
        got = troberta.apply_roberta(p, tcfg, _t(ids), _t(mask), bert_style=True,
                                     token_type_ids=None if tt is None else _t(tt))
        assert _rel(got[0], want[0]) < TOL and _rel(got[1], want[1]) < TOL
    want = jroberta.apply_bart_encoder(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    assert _rel(troberta.apply_bart_encoder(p, tcfg, _t(ids), _t(mask)), want) < TOL


@pytest.fixture(scope="module")
def clip_tree():
    return nonzero_tree(jclip.init_clip_text(jax.random.PRNGKey(2),
                                             jclip.CLIPTextConfig(**TINY_CLIP)))


def test_apply_clip_text_matches_jax(clip_tree):
    """Causal blocks, the features at the EOT (argmax id) position, on the
    BPE ids of real prompts."""
    ids = jbpe.SimpleTokenizer()(PROMPTS[:4])
    want = jclip.apply_clip_text(clip_tree, jclip.CLIPTextConfig(**TINY_CLIP), jnp.asarray(ids))
    got = tclip.apply_clip_text(tparams.from_jax_tree(clip_tree),
                                tclip.CLIPTextConfig(**TINY_CLIP), _t(ids))
    assert tuple(got.shape) == (4, 16) and _rel(got, want) < TOL


def test_convert_clip_text_matches_jax(clip_tree):
    """The reference's keys (written here from a drawn tree) through both
    converters: the same tree, bit for bit, equal to the drawn one."""
    prefix = "cond_stage_models.0.model."
    sd = {prefix + "token_embedding.weight": clip_tree["token_embedding"],
          prefix + "positional_embedding": clip_tree["positional_embedding"],
          prefix + "ln_final.weight": clip_tree["ln_final"]["scale"],
          prefix + "ln_final.bias": clip_tree["ln_final"]["bias"]}
    for i, blk in enumerate(clip_tree["blocks"]):
        bp = f"{prefix}text_branch.resblocks.{i}"
        sd[bp + ".attn.in_proj_weight"] = blk["attn"]["in_proj"]["w"].T
        sd[bp + ".attn.in_proj_bias"] = blk["attn"]["in_proj"]["b"]
        for name, p in (("ln_1", blk["ln_1"]), ("ln_2", blk["ln_2"])):
            sd[f"{bp}.{name}.weight"], sd[f"{bp}.{name}.bias"] = p["scale"], p["bias"]
        for name, p in (("attn.out_proj", blk["attn"]["out_proj"]),
                        ("mlp.c_fc", blk["mlp"]["c_fc"]), ("mlp.c_proj", blk["mlp"]["c_proj"])):
            sd[f"{bp}.{name}.weight"], sd[f"{bp}.{name}.bias"] = p["w"].T, p["b"]
    got = tclip.convert_clip_text(sd, tclip.CLIPTextConfig(**TINY_CLIP), prefix)
    want = jclip.convert_clip_text(sd, jclip.CLIPTextConfig(**TINY_CLIP), prefix)
    flat = [jax.tree.leaves(t) for t in (got, want, clip_tree)]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w, d in zip(*flat):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, d)


@pytest.mark.parametrize("tmodel", ["roberta", "bert", "bart", "transformer"])
def test_text_embedding_per_tower_matches_jax(tiny_text_towers, tmodel):
    """text_embedding's pooling per tower (RoBERTa's and BERT's pooler,
    BART's mean over positions, the transformer's EOT features) ->
    projection -> L2 norm, [B, 1, 24]."""
    cfg = _clap_cfg(tmodel)
    tree = nonzero_tree(jclap.init_clap(jax.random.PRNGKey(3), cfg))
    if tmodel == "transformer":
        ids, mask = jtext.clap_tokenizer(cfg)(PROMPTS[:2])
    else:
        ids, mask = _ids(pad=TINY_TEXT[tmodel].get("pad_token_id", 1))
    want = jclap.text_embedding(tree, cfg, jnp.asarray(ids), jnp.asarray(mask))
    got = tclap.text_embedding(tparams.from_jax_tree(tree), cfg, _t(ids), _t(mask))
    assert tuple(got.shape) == (2, 1, 24) and _rel(got, want) < TOL
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# The CLIP BPE tokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt", PROMPTS)
def test_bpe_ids_match_jax(prompt):
    """Punctuation, unicode, the empty string, whitespace runs, HTML
    entities and a text longer than the 77-token context (cut, EOT last)."""
    want = jbpe.SimpleTokenizer()([prompt])
    got = tbpe.SimpleTokenizer()([prompt])
    assert got.dtype == want.dtype == np.int32 and got.shape == (1, 77)
    np.testing.assert_array_equal(got, want)
    assert tbpe.SimpleTokenizer().encode(prompt) == jbpe.SimpleTokenizer().encode(prompt)


def test_clap_tokenizer_of_the_transformer_tower_matches_jax():
    cfg = CLAPConfig(tmodel="transformer")
    got, want = ttext.clap_tokenizer(cfg)(PROMPTS), jtext.clap_tokenizer(cfg)(PROMPTS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert got[1][1].sum() == 2 and got[0][0, 0] == 49406  # "" is SOT, EOT; SOT first


# ---------------------------------------------------------------------------
# Long audio, the rerank scorer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,hop", [(300, 512), (1024, 512), (1100, 512), (3000, 512),
                                   (3000, 5000), (700, 100), (0, 512)])
def test_sliding_windows_match_jax(n, hop):
    wav = np.arange(1, n + 1, dtype=np.float32)
    want = jclap.sliding_windows(wav, 1024, hop)
    got = tclap.sliding_windows(wav, 1024, hop)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def pann_clip_clap(monkeypatch):
    """A tiny PANN + transformer CLAP, the transformer registered under its
    own name in both registries for one test."""
    monkeypatch.setitem(jclap.TEXT_TOWERS, "transformer",
                        (lambda: jclip.CLIPTextConfig(**TINY_CLIP), TINY_CLIP["width"]))
    monkeypatch.setitem(tclap.TEXT_TOWERS, "transformer",
                        (lambda: tclip.CLIPTextConfig(**TINY_CLIP), TINY_CLIP["width"]))
    tiny_clap()
    cfg = _clap_cfg("transformer")
    tree = nonzero_tree(jclap.init_clap(jax.random.PRNGKey(4), cfg))
    return cfg, tree, tparams.from_jax_tree(tree)


def test_audio_embedding_long_matches_jax(pann_clip_clap):
    cfg, tree, ptree = pann_clip_clap
    wav = _wav(rows=1, n=3000)[0]
    want = jclap.audio_embedding_long(tree, cfg, wav, hopsize=512)
    got = tclap.audio_embedding_long(ptree, cfg, wav, hopsize=512)
    assert tuple(got.shape) == (5, 24) and _rel(got, want) < TOL


def test_cos_similarity_waveform_text_matches_jax(pann_clip_clap):
    """The host-coordinated scorer: resample 4800 -> 1600 Hz, fit the clip,
    the PANN and transformer embeddings, the cosine; within 1e-5."""
    cfg, tree, ptree = pann_clip_clap
    wav = _wav(rows=3, n=2400)[:, None]
    want = jclap.cos_similarity_waveform_text(tree, cfg, wav, "a dog barks",
                                              jtext.clap_tokenizer(cfg), 4800)
    got = tclap.cos_similarity_waveform_text(ptree, cfg, wav, "a dog barks",
                                             ttext.clap_tokenizer(cfg), 4800)
    assert got.shape == (3,) and np.all(np.abs(got) <= 1.0)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=TOL)


def test_pann_transformer_rerank_matches_jax(pann_clip_clap, capsys):
    """The tiny t5 model reranked by the PANN + transformer CLAP: six
    candidates of two prompts, the same similarities and picks as JAX."""
    cfg, rr_tree, _ = pann_clip_clap
    mcfg = dataclasses.replace(tiny_t5_model_config(), reranker_clap=cfg)
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), mcfg))
    tree["reranker_clap"] = rr_tree
    jmodel = jpipe.AudioLDM2(mcfg, tree)
    tmodel = at.build_model(config=mcfg, device="cpu", params=tree)
    wav = _wav(rows=6, n=512, seed=8)
    want = jpipe.rerank_and_select(jmodel, wav, "a dog barks", 2, 3)
    got = at.pipeline.rerank_and_select(tmodel, wav, "a dog barks", 2, 3)
    picks = [line for line in capsys.readouterr().err.splitlines()
             if line.startswith("Choose the following indexes")]
    assert len(picks) == 2 and picks[0] == picks[1]
    np.testing.assert_array_equal(got, want)
    sim = tmodel.last_similarities
    assert [int(i) for i in re.findall(r"\d+", picks[1].split(":", 1)[1])] == \
        [i + int(np.argmax(sim[i::2])) * 2 for i in range(2)]


# ---------------------------------------------------------------------------
# Feature fusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate", ["daf", "aff", "iaff"])
@pytest.mark.parametrize("shape", [(2, 5, 6, 16), (2, 7, 16)])
def test_fusion_gates_match_jax(gate, shape):
    tree = nonzero_tree(jff.init_aff(jax.random.PRNGKey(5), 16, 4, iterative=gate == "iaff"))
    rng = np.random.default_rng(6)
    x, res = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if gate == "daf":
        want, got = jff.daf(jnp.asarray(x), jnp.asarray(res)), tff.daf(_t(x), _t(res))
    else:
        want = getattr(jff, gate)(tree, jnp.asarray(x), jnp.asarray(res))
        got = getattr(tff, gate)(tparams.from_jax_tree(tree), _t(x), _t(res))
    assert _rel(got, want) < TOL
    ttree = tff.init_aff(tparams.Init(torch.Generator().manual_seed(0), "cpu"), 16, 4,
                         iterative=gate == "iaff")
    assert _flatten(ttree) == _flatten(tree)


# ---------------------------------------------------------------------------
# Trees at published width
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_shapes_only(monkeypatch):
    """JAX's fast init with every drawn leaf a zero-stride view."""
    monkeypatch.setattr(jnn, "_fast_fill",
                        lambda shape, scale: np.broadcast_to(np.float32(0), tuple(shape)))
    monkeypatch.setattr(jnn, "FAST_INIT", True)


@pytest.mark.parametrize("amodel,tmodel", [
    ("HTSAT-base", "roberta"), ("HTSAT-tiny", "roberta"), ("HTSAT-large", "roberta"),
    ("PANN-14", "roberta"), ("PANN-10", "roberta"), ("PANN-14", "bert"),
    ("PANN-14", "bart"), ("PANN-14", "transformer")])
def test_clap_tree_matches_jax_at_published_width(jax_shapes_only, amodel, tmodel):
    cfg = CLAPConfig(amodel=amodel, tmodel=tmodel)
    assert tclap.TEXT_TOWERS[tmodel][1] == jclap.TEXT_TOWERS[tmodel][1] == (
        512 if tmodel == "transformer" else 768)
    jtree = jclap.init_clap(jax.random.PRNGKey(0), cfg)
    ttree = tclap.init_clap(tparams.Init(torch.Generator(), "meta"), cfg)
    assert _flatten(ttree) == _flatten(jtree)
    widths = {"PANN-14": 2048, "PANN-10": 1024, "HTSAT-base": 1024, "HTSAT-tiny": 768,
              "HTSAT-large": 2048}
    assert tuple(ttree["audio_projection"]["lin1"]["w"].shape) == (widths[amodel], 512)
