"""The t5 slice end to end: audioldm2_torch against audioldm2_tpu on the
tiny t5 config (CPU, float32), and the port's public API contract.

Parity: the same numpy parameter tree (all-zero leaves redrawn), the same
prompt tokenized by the shared tokenizer, the same x_T, eta 0, 4 DDIM steps
(the smallest count above 3 that divides the 1000-step schedule).
Bar: mel MAE < 1e-3 (ROADMAP)."""

import math

import numpy as np
import pytest
import torch

import jax

import audioldm2_torch as at
from audioldm2_tpu import pipeline as jpipe
from test_torch_models import _flatten, nonzero_tree
from tiny import tiny_t5_model_config

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfg():
    return tiny_t5_model_config()


@pytest.fixture(scope="module")
def np_tree(cfg):
    return nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def tmodel(cfg, np_tree):
    return at.build_model(config=cfg, device="cpu", params=np_tree)


def test_slice_end_to_end_matches_jax(cfg, np_tree, tmodel):
    jmodel = jpipe.AudioLDM2(cfg, np_tree)
    prompt = "a dog barking in the rain"
    jbatch = jmodel.make_batch(prompt, batchsize=2)
    tbatch = tmodel.make_batch(prompt, batchsize=2)
    for k in ("t5_ids", "t5_mask", "t5_uncond_ids", "t5_uncond_mask"):
        np.testing.assert_array_equal(tbatch[k].numpy(), jbatch[k])
    lt = 16
    x_T = np.random.default_rng(7).standard_normal(
        (2, lt, cfg.latent_f_size, cfg.latent_channels)).astype(np.float32)
    kw = dict(latent_t_size=lt, n_gen=1, guidance=3.5, ddim_steps=4, ddim_eta=0.0)
    wj, mj = jmodel.ldm.generate(jbatch, jax.random.PRNGKey(0), x_T=x_T, **kw)
    wt, mt = tmodel.ldm.generate(tbatch, None, x_T=torch.from_numpy(x_T), **kw)
    assert mt.shape == mj.shape == (2, 2 * lt, 16, 1)
    assert wt.shape == wj.shape
    assert float(np.abs(mj).mean()) > 1e-2
    mel_mae = float(np.abs(mt - mj).mean())
    assert mel_mae < 1e-3, mel_mae
    np.testing.assert_allclose(wt, wj, atol=1e-4)


def test_text_to_audio_shape_and_determinism(tmodel):
    kw = dict(ddim_steps=5, duration=0.32, duration_bucket=None, n_candidate_gen_per_text=1)
    a = at.text_to_audio(tmodel, "rain", seed=3, batchsize=2, **kw)
    b = at.text_to_audio(tmodel, "rain", seed=3, batchsize=2, **kw)
    c = at.text_to_audio(tmodel, "rain", seed=4, batchsize=2, **kw)
    assert a.shape == (2, 1, 512) and a.dtype == np.float32
    assert np.isfinite(a).all() and np.abs(a).max() <= 1.0
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0
    assert set(tmodel.last_timings) >= {"tokenize_s", "generate_s", "rerank_s", "total_s",
                                        "x_realtime"}


def test_text_to_audio_refuses_candidates_without_clap(tmodel):
    """A config without a reranker (the tiny t5 one) cannot rank
    candidates: as in JAX, n_candidate_gen_per_text > 1 (the default 3)
    warns and returns each prompt's first candidate; a transcription is
    refused."""
    kw = dict(seed=3, ddim_steps=5, duration=0.32, duration_bucket=None)
    with pytest.warns(UserWarning, match="CLAP reranker"):
        got = at.text_to_audio(tmodel, "rain", **kw)
    assert got.shape == (1, 1, 512) and np.isfinite(got).all()
    with pytest.raises(NotImplementedError, match="TTS"):
        at.text_to_audio(tmodel, "rain", transcription="hello", **kw)


@pytest.mark.parametrize("name", ["audioldm_48k", "audioldm2-speech-gigaspeech"])
def test_build_model_refuses_unported_families(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        at.build_model(model_name=name, device="cpu")


def test_build_model_builds_audioldm2_full_and_refuses_candidates():
    """The full-width audioldm2-full tree, drawn on the meta device (shapes
    only: its 1.62 B parameters would take 6.5 GB on the CPU); the tiny
    tree's structure is held against JAX in test_torch_full.py. It carries
    the HTSAT-base + RoBERTa reranker CLAP (0.198 B) that the default
    n_candidate_gen_per_text = 3 reads; a transcription is refused."""
    model = at.build_model(model_name="audioldm2-full", device="meta")
    p = model.ldm.params
    seqgen = p["cond"]["crossattn_audiomae_generated"]
    assert sorted(seqgen["cond"]) == ["crossattn_flan_t5", "film_clap_cond1"]
    assert len(seqgen["gpt2"]["blocks"]) == 12
    assert seqgen["cond"]["film_clap_cond1"]["clap"]["text_projection"]["lin2"]["w"].shape == (
        512, 512)
    cross = p["unet"]["middle_block"]["cross_sts"]
    assert [st["blocks"][0]["attn2"]["to_k"]["w"].shape[0] for st in cross] == [768, 1024]
    n = sum(math.prod(shape) for shape in _flatten(p).values())
    assert 1.6e9 < n < 1.65e9, n
    rr = sum(math.prod(shape) for shape in _flatten(p["reranker_clap"]).values())
    assert 1.9e8 < rr < 2.0e8, rr
    assert p["reranker_clap"]["audio_projection"]["lin1"]["w"].shape == (1024, 512)
    assert model.reranker_tok is not None
    with pytest.raises(NotImplementedError, match="TTS"):
        at.text_to_audio(model, "rain", transcription="hello")


def test_build_model_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.build_model(device="cuda")


def test_round_up_duration_matches_jax():
    for d in (0.3, 2.5, 2.51, 7.4, 10.0, 10.2):
        assert at.round_up_duration(d) == jpipe.round_up_duration(d)
