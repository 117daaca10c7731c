"""The t5 slice end to end: audioldm2_torch against audioldm2_tpu on the
tiny t5 config (CPU, float32), and the port's public API contract.

Parity: the same numpy parameter tree (all-zero leaves redrawn), the same
prompt tokenized by the shared tokenizer, the same x_T, eta 0, 4 DDIM steps
(the smallest count above 3 that divides the 1000-step schedule).
Bar: mel MAE < 1e-3 (ROADMAP)."""

import math
import pickle

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
    warns and returns each prompt's first candidate; a transcription, which
    only the speech families read, is accepted and changes nothing, as in
    JAX."""
    kw = dict(seed=3, ddim_steps=5, duration=0.32, duration_bucket=None)
    with pytest.warns(UserWarning, match="CLAP reranker"):
        got = at.text_to_audio(tmodel, "rain", **kw)
    assert got.shape == (1, 1, 512) and np.isfinite(got).all()
    with pytest.warns(UserWarning, match="CLAP reranker"):
        spoken = at.text_to_audio(tmodel, "rain", transcription="hello", **kw)
    np.testing.assert_array_equal(spoken, got)


def _unported_config(what):
    """A config with a part that the port once refused: a CLAP conditioner
    in audio embedding mode (ROADMAP queue 1 item 9) or an AudioMAE-pooled
    conditioner (item 10); both are ported now."""
    import dataclasses

    from audioldm2_torch.config import AudioMAEConfig, ConditionerSpec

    cfg = at.default_audioldm_config("audioldm_48k")
    if what == "clap_audio_mode":
        spec = cfg.conditioners[0]
        spec = dataclasses.replace(spec, clap=dataclasses.replace(spec.clap, embed_mode="audio"))
    else:
        spec = ConditionerSpec(name="crossattn_audiomae_pooled", kind="audiomae_pooled",
                               cond_stage_key="ta_kaldi_fbank", audiomae=AudioMAEConfig())
    return dataclasses.replace(cfg, conditioners=(spec,))


@pytest.mark.parametrize("name", ["clap_audio_mode", "audiomae_pooled"])
def test_build_model_refuses_unported_families(name):
    """The once-unported families build (on "meta", shapes only) with their
    conditioner's full tree; a kind the port does not know is refused."""
    import dataclasses

    cfg = _unported_config(name)
    cond = at.build_model(config=cfg, device="meta").ldm.params["cond"]
    if name == "clap_audio_mode":
        assert cond["film_clap_cond1"]["clap"]["audio_projection"]["lin1"]["w"].shape == (1024, 512)
    else:
        mae = cond["crossattn_audiomae_pooled"]["audiomae"]
        assert len(mae["blocks"]) == 12 and mae["pos_embed"].shape == (1, 513, 768)
    unknown = dataclasses.replace(cfg.conditioners[0], kind="audiomae_cls")
    with pytest.raises(ValueError, match="unknown conditioner kind"):
        at.build_model(config=dataclasses.replace(cfg, conditioners=(unknown,)), device="meta")


def test_build_model_builds_audioldm2_full_and_refuses_candidates():
    """The full-width audioldm2-full tree, drawn on the meta device (shapes
    only: its 1.71 B parameters, the nested AudioMAE's 85.6 M among them,
    would take 6.8 GB on the CPU); the tiny
    tree's structure is held against JAX in test_torch_full.py. It carries
    the HTSAT-base + RoBERTa reranker CLAP (0.198 B) that the default
    n_candidate_gen_per_text = 3 reads; a transcription is accepted and
    ignored (no phoneme ids in its batch), as in JAX."""
    model = at.build_model(model_name="audioldm2-full", device="meta")
    p = model.ldm.params
    seqgen = p["cond"]["crossattn_audiomae_generated"]
    assert sorted(seqgen["cond"]) == ["crossattn_audiomae_pooled", "crossattn_flan_t5",
                                      "film_clap_cond1"]
    assert len(seqgen["gpt2"]["blocks"]) == 12
    assert seqgen["cond"]["film_clap_cond1"]["clap"]["text_projection"]["lin2"]["w"].shape == (
        512, 512)
    cross = p["unet"]["middle_block"]["cross_sts"]
    assert [st["blocks"][0]["attn2"]["to_k"]["w"].shape[0] for st in cross] == [768, 1024]
    n = sum(math.prod(shape) for shape in _flatten(p).values())
    assert 1.7e9 < n < 1.72e9, n
    mae = _flatten(seqgen["cond"]["crossattn_audiomae_pooled"])
    assert 8.5e7 < sum(math.prod(shape) for shape in mae.values()) < 8.6e7
    rr = sum(math.prod(shape) for shape in _flatten(p["reranker_clap"]).values())
    assert 1.9e8 < rr < 2.0e8, rr
    assert p["reranker_clap"]["audio_projection"]["lin1"]["w"].shape == (1024, 512)
    assert model.reranker_tok is not None
    batch = model.make_batch("rain", "hello", 2)
    assert "phoneme_idx" not in batch and tuple(batch["clap_ids"].shape) == (2, 512)


def test_build_model_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.build_model(device="cuda")


def test_round_up_duration_matches_jax():
    for d in (0.3, 2.5, 2.51, 7.4, 10.0, 10.2):
        assert at.round_up_duration(d) == jpipe.round_up_duration(d)


def test_build_model_takes_the_jax_parameters_in_order():
    """The port's first five parameters are the JAX package's, by name,
    order and default (device aside: None means the card in the port);
    its own (seed, params, nonzero_init) are keyword-only after them."""
    import inspect

    jp = inspect.signature(jpipe.build_model).parameters
    tp = inspect.signature(at.build_model).parameters
    assert list(tp)[:5] == list(jp) == ["ckpt_path", "config", "device", "model_name",
                                        "weight_quant"]
    assert all(tp[n].default == jp[n].default for n in jp)
    assert tp["model_name"].default == "audioldm2-full"
    assert [n for n, p in tp.items() if p.kind is p.KEYWORD_ONLY] == ["seed", "params",
                                                                      "nonzero_init"]


def test_build_model_defaults_to_audioldm2_full_on_the_card(monkeypatch):
    """build_model() asks for audioldm2-full on the card: without CUDA it
    raises, and the same call on the meta device builds audioldm2-full."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.build_model()
    assert at.build_model(device="meta").cfg.name == "audioldm2-full"


def test_build_model_ckpt_path(tmp_path, capsys):
    """A missing checkpoint warns (the JAX package's words) and draws random
    weights; a file that does not load raises torch.load's error, never
    replaced by random weights; ckpt_path with params= is refused."""
    missing = str(tmp_path / "missing.pth")
    model = at.build_model(missing, model_name="audioldm_16k_crossattn_t5", device="meta")
    assert model.cfg.name == "audioldm_16k_crossattn_t5"
    assert f"WARNING: checkpoint {missing} not found; using random init" in capsys.readouterr().out
    present = tmp_path / "model.pth"
    present.write_bytes(b"\0")
    with pytest.raises(pickle.UnpicklingError):
        at.build_model(str(present), device="meta")
    assert "using random init" not in capsys.readouterr().out
    for path in (str(present), missing):
        with pytest.raises(ValueError, match="ckpt_path or params, not both"):
            at.build_model(path, device="meta", params={})


def test_pipelines_accept_and_ignore_the_jax_keywords(tmodel, tmp_path):
    """latent_t_per_second and config, which the JAX package takes and
    ignores, leave both entry points' waveforms unchanged."""
    from scipy.io import wavfile

    ignored = dict(latent_t_per_second=99.0, config=object())
    kw = dict(seed=3, ddim_steps=4, duration=0.32, duration_bucket=None,
              n_candidate_gen_per_text=1)
    np.testing.assert_array_equal(at.text_to_audio(tmodel, "rain", **kw, **ignored),
                                  at.text_to_audio(tmodel, "rain", **kw))
    sr = tmodel.cfg.preprocessing.sampling_rate
    path = str(tmp_path / "in.wav")
    t = np.arange(int(0.64 * sr)) / sr
    wavfile.write(path, sr, (0.5 * np.sin(2 * np.pi * 200 * t) * 32767).astype(np.int16))
    kw = dict(original_audio_file_path=path, seed=3, ddim_steps=4, duration=0.64,
              n_candidate_gen_per_text=1)
    np.testing.assert_array_equal(
        at.super_resolution_and_inpainting(tmodel, "rain", **kw, **ignored),
        at.super_resolution_and_inpainting(tmodel, "rain", **kw))


def test_seed_everything_seeds_and_returns_a_generator():
    g = at.seed_everything(5, device="cpu")
    assert isinstance(g, torch.Generator) and g.device.type == "cpu"
    a, ta = np.random.rand(3), torch.rand(3)
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=torch.Generator().manual_seed(5)))
    at.seed_everything(5, device="cpu")
    np.testing.assert_array_equal(np.random.rand(3), a)
    assert torch.equal(torch.rand(3), ta)


@pytest.mark.parametrize("name", ["audioldm_16k_crossattn_t5", "audioldm2-full",
                                  "audioldm2-music-665k", "audioldm2-full-large-1150k",
                                  "audioldm_48k", "audioldm2-speech-gigaspeech",
                                  "audioldm2-speech-ljspeech"])
def test_build_model_builds_every_family_the_port_runs(name):
    """Each family the port runs builds at full width on the meta device
    (shapes only), with its parameter count in millions (the reranker's
    198.5 M and, on the families with a sequence generator, the nested
    AudioMAE's 85.6 M included); audioldm2-music-665k has audioldm2-full's
    tree and
    the two speech families one tree (the phoneme encoder and the
    512-token generator in their conditioner)."""
    model = at.build_model(model_name=name, device="meta")
    assert model.cfg.name == name
    shapes = _flatten(model.ldm.params)
    millions = {"audioldm_16k_crossattn_t5": 915.9, "audioldm2-full": 1709.7,
                "audioldm2-music-665k": 1709.7, "audioldm2-full-large-1150k": 2080.8,
                "audioldm_48k": 1073.5, "audioldm2-speech-gigaspeech": 948.0,
                "audioldm2-speech-ljspeech": 948.0}
    assert round(sum(math.prod(s) for s in shapes.values()) / 1e5) / 10 == millions[name]
    if name == "audioldm2-music-665k":
        assert shapes == _flatten(at.build_model(device="meta").ldm.params)
    if name == "audioldm2-speech-ljspeech":
        giga = at.build_model(model_name="audioldm2-speech-gigaspeech", device="meta")
        assert shapes == _flatten(giga.ldm.params)
        assert "/cond/crossattn_audiomae_generated/cond/crossattn_vits_phoneme/pos_emb" in shapes
