"""Audio as a conditioning input, audioldm2_torch against audioldm2_tpu on the
CPU, float32: AudioMAE (``encode_no_mask``, both pools, the L2 option, the
training-time pooling factors), the ``audiomae_pooled`` conditioner, CLAP
in audio embedding mode, ``make_batch(waveform=, fbank=)`` key by key, a
tiny model conditioned on both end to end, and the drawn trees of the
seven families at full width.

Both packages get the same numpy parameter trees (``from_jax_tree``) and
numpy inputs. Tolerance 1e-5 relative to the largest magnitude (float32,
summation order only) unless a test says otherwise; end to end, mel MAE <
1e-3 (ROADMAP) from the same x_T."""

import dataclasses
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audioldm2_torch as at
from audioldm2_tpu import config as jconfig
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.config import AudioMAEConfig, ConditionerSpec
from audioldm2_tpu.models import audiomae as jmae
from audioldm2_tpu.models import clap as jclap
from audioldm2_tpu.models import conditioners as jcond
from audioldm2_tpu.ops import nn as jnn
from audioldm2_torch import config as tconfig
from audioldm2_torch import params as tparams
from audioldm2_torch.models import audiomae as tmae
from audioldm2_torch.models import conditioners as tcond
from test_film_pipeline import _film_model_config
from test_torch_full import TINY_PANN, TINY_ROBERTA, tiny_clap
from test_torch_models import _flatten, nonzero_tree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
# 768 wide (the width of the unconditional zeros), 3 blocks, the last two
# after contextual_depth 0: the contextual mean is over two LayerNorm'd outputs
TINY_MAE = AudioMAEConfig(embed_dim=768, depth=3, num_heads=12, mlp_ratio=1.0,
                          contextual_depth=0)
FAMILIES = ("audioldm_16k_crossattn_t5", "audioldm2-full", "audioldm2-music-665k",
            "audioldm2-full-large-1150k", "audioldm_48k", "audioldm2-speech-gigaspeech",
            "audioldm2-speech-ljspeech")


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mae_spec(cfg=TINY_MAE, tp=8, fp=8, regularization=False):
    return ConditionerSpec(name="crossattn_audiomae_pooled", kind="audiomae_pooled",
                           cond_stage_key="ta_kaldi_fbank",
                           audiomae=dataclasses.replace(cfg, eval_time_pooling=tp,
                                                        eval_freq_pooling=fp,
                                                        regularization=regularization))


def _fbank(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 1024, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def mae_tree():
    return _np(jmae.init_audiomae(jax.random.PRNGKey(1), TINY_MAE))


@pytest.fixture(scope="module")
def mae_tokens(mae_tree):
    fb = _fbank()
    want = jmae.encode_no_mask(mae_tree, TINY_MAE, jnp.asarray(fb))
    got = tmae.encode_no_mask(tparams.from_jax_tree(mae_tree), TINY_MAE, torch.from_numpy(fb))
    return got, np.asarray(want)


# ---------------------------------------------------------------------------
# AudioMAE
# ---------------------------------------------------------------------------


def test_audiomae_encode_no_mask_matches_jax(mae_tokens):
    got, want = mae_tokens
    assert tuple(got.shape) == (2, 513, 768)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("tp,fp", [(8, 8), (1, 1), (2, 4), (64, 8), (128, 16), (4, 2)])
def test_avg_max_pool_matches_jax(mae_tokens, tp, fp):
    """The (avg + max) / 2 pool at explicit factors (clamped to the 64 x 8
    grid), and at a config's evaluation factors."""
    got, want = mae_tokens
    pooled = tmae.avg_max_pool_factors(got, tp, fp)
    expect = jmae.avg_max_pool_factors(jnp.asarray(want), tp, fp)
    assert tuple(pooled.shape) == expect.shape == (2, 512 // (min(tp, 64) * min(fp, 8)), 768)
    assert _rel(pooled, expect) < TOL
    cfg = dataclasses.replace(TINY_MAE, eval_time_pooling=tp, eval_freq_pooling=fp)
    assert _rel(tmae.avg_max_pool(got, cfg), jmae.avg_max_pool(jnp.asarray(want), cfg)) < TOL


def test_l2_regularize_and_pooling_factors_match_jax(mae_tokens):
    got, want = mae_tokens
    assert _rel(tmae.l2_regularize(got), jmae.l2_regularize(jnp.asarray(want))) < TOL
    for tf_separated in (False, True):
        cfg = dataclasses.replace(TINY_MAE, tf_separated=tf_separated,
                                  time_pooling_factors=(1, 2, 4, 8, 128))
        draws = [tmae.sample_pooling_factors(np.random.default_rng(s), cfg) for s in range(20)]
        assert draws == [jmae.sample_pooling_factors(np.random.default_rng(s), cfg)
                         for s in range(20)]


@pytest.mark.parametrize("regularization", [False, True])
def test_audiomae_conditioner_matches_jax(mae_tree, regularization):
    """encode: the pooled tokens [B, 512 / (tp * fp), 768] and a mask of
    ones; unconditional: zeros of that many tokens, a mask of ones."""
    spec = _mae_spec(tp=4, fp=2, regularization=regularization)
    fb = _fbank(seed=1)
    jp, tp = {"audiomae": mae_tree}, {"audiomae": tparams.from_jax_tree(mae_tree)}
    jb, tb = {"ta_kaldi_fbank": jnp.asarray(fb)}, {"ta_kaldi_fbank": torch.from_numpy(fb)}
    kind, (ctx, mask) = tcond.encode(tp, spec, tb)
    jkind, (jctx, jmask) = jcond.encode(jp, spec, jb)
    assert kind == jkind == "crossattn" and tuple(ctx.shape) == (2, 64, 768)
    assert _rel(ctx, jctx) < TOL and np.array_equal(mask.numpy(), np.asarray(jmask))
    kind, (uctx, umask) = tcond.unconditional(tp, spec, tb, 3)
    jkind, (ujctx, ujmask) = jcond.unconditional(jp, spec, jb, 3)
    assert kind == jkind == "crossattn"
    np.testing.assert_array_equal(uctx.numpy(), np.asarray(ujctx))
    np.testing.assert_array_equal(umask.numpy(), np.asarray(ujmask))
    assert tuple(uctx.shape) == (3, 64, 768) and tcond.audiomae_token_num(spec) == 64


def test_audiomae_published_width_matches_jax():
    """ViT-B/16 at its published width (1024 x 128 fbank, 12 blocks of 768,
    contextual depth 8), batch 1, on JAX's pool-filled tree (its fast init:
    seconds, not the minutes of numpy's normal draws)."""
    cfg = AudioMAEConfig()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "FAST_INIT", True)
        tree = _np(jmae.init_audiomae(jax.random.PRNGKey(0), cfg))
    assert sum(np.size(x) for x in jax.tree.leaves(tree)) == 85_648_128
    fb = _fbank(b=1, seed=2)
    want = jmae.encode_no_mask(tree, cfg, jnp.asarray(fb))
    got = tmae.encode_no_mask(tparams.from_jax_tree(tree), cfg, torch.from_numpy(fb))
    assert _rel(got, want) < TOL
    assert _rel(tmae.avg_max_pool(got, cfg), jmae.avg_max_pool(want, cfg)) < TOL


# ---------------------------------------------------------------------------
# A tiny audio-conditioned model: CLAP in audio mode (FiLM) and AudioMAE
# ---------------------------------------------------------------------------


def tiny_audio_config():
    """tests/test_film_pipeline.py's FiLM model (1600 Hz; the tiny PANN +
    RoBERTa CLAP in audio embedding mode) with a 768-wide context slot for
    the pooled AudioMAE tokens (time and frequency pool 8: 8 tokens)."""
    cfg = _film_model_config("audio")
    tiny_clap()  # the tiny towers, in the port's registries
    return dataclasses.replace(
        cfg, name="tiny-audio-in",
        unet=dataclasses.replace(cfg.unet, context_dims=(768,)),
        conditioners=cfg.conditioners + (_mae_spec(),))


@pytest.fixture(scope="module")
def audio_models():
    cfg = tiny_audio_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, tree, jpipe.AudioLDM2(cfg, tree), at.build_model(config=cfg, device="cpu",
                                                                   params=tree)


def _wav(rows=2, n=16000, seed=3):
    return (0.3 * np.random.default_rng(seed).standard_normal((rows, n))).astype(np.float32)


# The kaldi fbank's DFT is an f32 matmul in both packages. After the DC
# removal and the preemphasis (a high-pass) the power of the narrow lowest
# mel bins nearly cancels, and its log moves with the summation order: on
# 1 s of noise up to 2.4e-4 (normalized units) in 0.3% of the values, the
# rest within 1e-6; JAX's own values move by 6e-6 between processes.
KALDI_ATOL, KALDI_SHARE = 5e-4, 1e-2


def _check_kaldi(got, want):
    """Within KALDI_ATOL, and within 1e-6 on all but KALDI_SHARE of the values."""
    d = np.abs(got - want)
    assert d.max() <= KALDI_ATOL and np.mean(d > 1e-6) < KALDI_SHARE, (d.max(), np.mean(d > 1e-6))


def _check_batch(tb, jb, keys):
    """Each key's shape and dtype as JAX's, its values within 1e-6 (the kaldi
    fbank: _check_kaldi)."""
    assert set(keys) <= set(tb) <= set(jb), (sorted(tb), sorted(jb))
    for k in keys:
        g, w = tb[k].numpy(), np.asarray(jb[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if k == "ta_kaldi_fbank":
            _check_kaldi(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("with_wav", [True, False])
def test_make_batch_matches_jax(audio_models, with_wav):
    """make_batch(text, transcription, batchsize, waveform, fbank) key by key
    within 1e-6 (ta_kaldi_fbank: _check_kaldi): the tokens, ta_kaldi_fbank
    (zeros without a waveform), clap_waveform_48k (zeros without one) and
    fbank, f32."""
    _, _, jmodel, tmodel = audio_models
    wav = _wav() if with_wav else None
    fbank = np.random.default_rng(4).standard_normal((2, 32, 16, 1))
    jb = jmodel.make_batch("a dog", batchsize=2, waveform=wav, fbank=fbank)
    tb = tmodel.make_batch("a dog", batchsize=2, waveform=wav, fbank=fbank)
    _check_batch(tb, jb, ["clap_ids", "clap_mask", "clap_uncond_ids", "clap_uncond_mask",
                          "ta_kaldi_fbank", "clap_waveform_48k", "fbank"])
    assert tuple(tb["ta_kaldi_fbank"].shape) == (2, 1024, 128)
    assert tuple(tb["clap_waveform_48k"].shape) == (2, 1024)
    assert bool(tb["ta_kaldi_fbank"].any()) == with_wav


def test_make_batch_resamples_the_clap_clip_as_jax():
    """At a model rate (4800 Hz) that is not the CLAP rate (1600 Hz), the
    clip is resampled and fit as JAX does it, within 1e-6."""
    cfg = tiny_audio_config()
    cfg = dataclasses.replace(cfg, preprocessing=dataclasses.replace(cfg.preprocessing,
                                                                     sampling_rate=4800))
    tree = jpipe.init_params(jax.random.PRNGKey(0), cfg)
    jmodel, tmodel = jpipe.AudioLDM2(cfg, tree), at.build_model(config=cfg, device="cpu",
                                                                params=_np(tree))
    wav = _wav(n=2000)
    _check_batch(tmodel.make_batch("", batchsize=2, waveform=wav),
                 jmodel.make_batch("", batchsize=2, waveform=wav),
                 ["clap_waveform_48k", "ta_kaldi_fbank"])


def test_make_batch_tiles_one_row_for_both_audio_keys(audio_models):
    """A known difference (ROADMAP): from a one-row waveform at batchsize 2
    JAX tiles clap_waveform_48k but leaves ta_kaldi_fbank at one row; the
    port tiles both, each row JAX's row."""
    _, _, jmodel, tmodel = audio_models
    wav = _wav(rows=1)
    jb = jmodel.make_batch("", batchsize=2, waveform=wav)
    tb = tmodel.make_batch("", batchsize=2, waveform=wav)
    assert np.shape(jb["ta_kaldi_fbank"]) == (1, 1024, 128)
    assert tuple(tb["ta_kaldi_fbank"].shape) == (2, 1024, 128)
    for row in range(2):
        _check_kaldi(tb["ta_kaldi_fbank"][row].numpy(), np.asarray(jb["ta_kaldi_fbank"])[0])
    _check_batch(tb, jb, ["clap_waveform_48k"])
    # a 1-D waveform is the one-row case
    one_d = tmodel.make_batch("", batchsize=2, waveform=wav[0])
    assert torch.equal(one_d["ta_kaldi_fbank"], tb["ta_kaldi_fbank"])


def test_clap_audio_mode_encode_matches_jax(audio_models):
    """CLAP's audio embedding mode: encode embeds clap_waveform_48k through
    the audio tower (clap.audio_embedding); the unconditional branch is the
    "" text embedding, tiled."""
    cfg, tree, jmodel, tmodel = audio_models
    spec = cfg.conditioners[0]
    jb = jmodel.make_batch("", batchsize=2, waveform=_wav())
    tb = tmodel.make_batch("", batchsize=2, waveform=_wav())
    jp, tp = tree["cond"][spec.name], tmodel.ldm.params["cond"][spec.name]
    kind, emb = tcond.encode(tp, spec, tb)
    jkind, jemb = jcond.encode(jp, spec, {k: jnp.asarray(v) for k, v in jb.items()})
    direct = jclap.audio_embedding(jp["clap"], spec.clap, jnp.asarray(jb["clap_waveform_48k"]))
    assert kind == jkind == "film" and tuple(emb.shape) == (2, spec.clap.embed_dim)
    assert _rel(emb, jemb) < TOL and _rel(emb, direct) < TOL
    np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=-1).numpy(), 1.0, atol=1e-6)
    kind, uemb = tcond.unconditional(tp, spec, tb, 2)
    jkind, ujemb = jcond.unconditional(jp, spec, {k: jnp.asarray(v) for k, v in jb.items()}, 2)
    assert kind == jkind == "film" and _rel(uemb, ujemb) < TOL


def test_tiny_audio_conditioned_generation_matches_jax(audio_models):
    """make_batch("", waveform=) -> generate on the tiny model: y from the
    CLAP audio embedding, the one context slot from the pooled AudioMAE
    tokens, CFG 3.5, the same x_T, DDIM eta 0: mel MAE < 1e-3."""
    cfg, _, jmodel, tmodel = audio_models
    wav = _wav()
    jb = jmodel.make_batch("", batchsize=2, waveform=wav)
    tb = tmodel.make_batch("", batchsize=2, waveform=wav)
    lt = 16
    x_T = np.random.default_rng(7).standard_normal(
        (2, lt, cfg.latent_f_size, cfg.latent_channels)).astype(np.float32)
    kw = dict(latent_t_size=lt, n_gen=1, guidance=3.5, ddim_steps=4, ddim_eta=0.0)
    wj, mj = jmodel.ldm.generate(jb, jax.random.PRNGKey(0), x_T=x_T, **kw)
    wt, mt = tmodel.ldm.generate(tb, None, x_T=torch.from_numpy(x_T), **kw)
    assert mt.shape == mj.shape and float(np.abs(mj).mean()) > 1e-2
    assert float(np.abs(mt - mj).mean()) < 1e-3
    np.testing.assert_allclose(wt, wj, atol=1e-4)


# ---------------------------------------------------------------------------
# Trees at full width: key paths and shapes, the nested AudioMAE included
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_shapes_only(monkeypatch):
    """JAX's fast init with every drawn leaf a zero-stride view: the
    full-width tree's structure in well under a second and a few MB."""
    monkeypatch.setattr(jnn, "_fast_fill",
                        lambda shape, scale: np.broadcast_to(np.float32(0), tuple(shape)))
    monkeypatch.setattr(jnn, "FAST_INIT", True)


@pytest.mark.parametrize("name", FAMILIES)
def test_drawn_tree_matches_jax_at_full_width(name, jax_shapes_only):
    jtree = jpipe.init_params(jax.random.PRNGKey(0), jconfig.default_audioldm_config(name),
                              fast=True)
    ttree = at.build_model(model_name=name, device="meta").ldm.params
    assert _flatten(ttree) == _flatten(jtree)
    if name not in ("audioldm_16k_crossattn_t5", "audioldm_48k"):
        mae = ttree["cond"]["crossattn_audiomae_generated"]["cond"]["crossattn_audiomae_pooled"]
        assert len(mae["audiomae"]["blocks"]) == 12


def test_nested_audiomae_is_drawn_from_a_fork():
    """The nested AudioMAE draws from its own generator: every other leaf
    of a seeded tree is what the same seed drew before it was ported (the
    tree without it, drawn with the AudioMAE spec left out), and the
    AudioMAE is a function of the seed."""
    from test_torch_full import tiny_full_config

    cfg = tconfig.coerce(tiny_full_config())
    sg = cfg.conditioners[0]
    without = dataclasses.replace(cfg, conditioners=(
        dataclasses.replace(sg, nested=sg.nested[:2]),) + cfg.conditioners[1:])

    def draw(c, seed=0):
        return tparams.init_params(c, torch.Generator().manual_seed(seed), "cpu")

    full, old = draw(cfg), draw(without)
    flat_full = dict(_leaves(full))
    for k, v in _leaves(old):
        assert torch.equal(flat_full[k], v), k
    mae_key = "/cond/crossattn_audiomae_generated/cond/crossattn_audiomae_pooled/audiomae/pos_embed"
    assert torch.equal(flat_full[mae_key], dict(_leaves(draw(cfg)))[mae_key])
    assert not torch.equal(flat_full[mae_key], dict(_leaves(draw(cfg, 1)))[mae_key])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# Without JAX
# ---------------------------------------------------------------------------


def test_audio_conditioning_and_pann_clip_rerank_do_not_import_jax():
    """In a fresh process: the audiomae_pooled conditioner and CLAP's audio
    mode through make_batch(waveform=) and generate, and a rerank of three
    candidates by a PANN + CLIP-BPE transformer CLAP (both towers tiny; the
    transformer's registered under its own name, which selects its pooling
    and tokenizer), leave jax and audioldm2_tpu unimported."""
    from test_torch_clap_towers import TINY_CLIP

    cfg = tconfig.coerce(tiny_audio_config())
    rr = tconfig.CLAPConfig(amodel="PANN-tiny", tmodel="transformer", sampling_rate=1600,
                            embed_dim=24, clip_samples=1024, text_max_length=77)
    t5 = tconfig.coerce(dataclasses.replace(_t5_config(), reranker_clap=None))
    code = (
        "import sys; import numpy as np; import audioldm2_torch as at; "
        "from audioldm2_torch.config import *; "
        "from audioldm2_torch.models import clap, clip_text, pann, roberta; "
        f"clap.register_audio_tower('PANN-tiny', lambda: pann.PANNConfig(**{TINY_PANN!r}), 24); "
        f"clap.register_text_tower('roberta-tiny', lambda: roberta.RobertaConfig(**{TINY_ROBERTA!r}),"
        " 16); "
        f"clap.register_text_tower('transformer', lambda: clip_text.CLIPTextConfig("
        f"**{TINY_CLIP!r}), {TINY_CLIP['width']}); "
        f"m = at.build_model(config={cfg!r}, device='cpu', seed=0, nonzero_init=True); "
        "w = np.random.default_rng(0).standard_normal((1, 16000)).astype(np.float32) * 0.3; "
        "b = m.make_batch('', batchsize=2, waveform=w); "
        "wav, _ = m.ldm.generate(b, None, latent_t_size=16, ddim_steps=2); "
        "assert wav.shape[0] == 2 and np.isfinite(wav).all(); "
        f"t = at.build_model(config={dataclasses.replace(t5, reranker_clap=rr)!r}, device='cpu', "
        "seed=0, nonzero_init=True); "
        "o = at.text_to_audio(t, 'rain', ddim_steps=2, duration=0.32, duration_bucket=None); "
        "assert o.shape == (1, 1, 512) and t.last_similarities.shape == (3,); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'audioldm2_tpu')); "
        "assert not bad, bad"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def _t5_config():
    from tiny import tiny_t5_model_config

    return tiny_t5_model_config()


def test_bpe_vocabulary_is_a_byte_copy():
    digest = [hashlib.sha256(open(os.path.join(REPO, pkg, "assets",
                                               "bpe_simple_vocab_16e6.txt.gz"), "rb").read())
              .hexdigest() for pkg in ("audioldm2_tpu", "audioldm2_torch")]
    assert digest[0] == digest[1]
