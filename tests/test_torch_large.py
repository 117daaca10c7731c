"""The audioldm2-full-large-1150k slice of audioldm2_torch against
audioldm2_tpu on the CPU, float32: the depth-2 UNet with a context-free
(None) cross slot, its launch formula, the HTSAT audio tower, the CLAP
audio embedding and rerank scorer, rerank_and_select, and the tiny
large-1150k pipeline end to end at n_candidate_gen_per_text = 3; plus the
guards that keep the port free of jax and of the JAX package (its own
config and schedule copies, build_model's config handling, an AST scan).

Both packages get the same numpy parameter trees and numpy inputs. Module
tolerance 1e-4 relative to max|want| (float32, summation order only); end
to end, mel MAE < 1e-3 with the same x_T and per-step noise, and the same
chosen candidates."""

import ast
import dataclasses
import os
import re
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
from audioldm2_tpu.config import CLAPConfig, UNetConfig
from audioldm2_tpu.diffusion import schedule as jschedule
from audioldm2_tpu.models import clap as jclap
from audioldm2_tpu.models import htsat as jhtsat
from audioldm2_tpu.models import unet as junet
from audioldm2_torch import config as tconfig
from audioldm2_torch import params as tparams
from audioldm2_torch.diffusion import schedule as tschedule
from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate
from audioldm2_torch.models import clap as tclap
from audioldm2_torch.models import htsat as thtsat
from audioldm2_torch.models import roberta as troberta
from audioldm2_torch.models import unet as tunet
from audioldm2_torch.ops import KERNEL_NAMES
from test_torch_full import TINY_PANN, TINY_ROBERTA, tiny_full_config
from test_torch_int8 import JAX_OP_TOL, _quantized_trees
from test_torch_models import _flatten, count_plain_conv_dispatches, nonzero_tree
from tiny import TINY_T5, tiny_clap_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
TINY_HTSAT = dict(spec_size=64, mel_bins=16, depths=(2, 2), num_heads=(2, 4), window_size=4,
                  embed_dim=16, sample_rate=4800, n_fft=64, hop_size=16, fmin=10.0, fmax=2000.0)
HTSAT_NAME = "HTSAT-tiny16"


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def tiny_reranker() -> CLAPConfig:
    """A tiny HTSAT + 1-layer RoBERTa CLAP, registered in both packages'
    tower registries, at a 4800 Hz CLAP rate (3x the tiny 1600 Hz, as 48 kHz
    is 3x 16 kHz) and a 4096-sample clip (so the tiny 0.32 s candidates are
    repeated twice and zero-padded)."""
    tiny_clap_config()  # registers roberta-tiny (and PANN-tiny) in the JAX registry
    tclap.register_text_tower("roberta-tiny", lambda: troberta.RobertaConfig(**TINY_ROBERTA), 16)
    width = TINY_HTSAT["embed_dim"] * 2
    jclap.register_audio_tower(HTSAT_NAME, lambda: jhtsat.HTSATConfig(**TINY_HTSAT), width)
    tclap.register_audio_tower(HTSAT_NAME, lambda: thtsat.HTSATConfig(**TINY_HTSAT), width)
    return CLAPConfig(amodel=HTSAT_NAME, tmodel="roberta-tiny", sampling_rate=4800, embed_dim=24,
                      clip_samples=4096, text_max_length=16)


def tiny_large_config():
    """audioldm2-full-large-1150k in miniature: the tiny audioldm2-full
    conditioners, context slots (768, T5 width, None), transformer depth 2,
    and the tiny reranker."""
    base = tiny_full_config()
    return dataclasses.replace(
        base, name="tiny-large",
        unet=dataclasses.replace(base.unet, context_dims=(768, TINY_T5.d_model, None),
                                 transformer_depth=2),
        reranker_clap=tiny_reranker())


# ---------------------------------------------------------------------------
# UNet: depth 2 and the None slot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_and_cross_kv"])
def test_large_unet_matches_jax(fused):
    """The tiny depth-2 UNet with slots (c1, c2, None) against JAX's
    apply_unet, with and without fuse_self_qkv and precompute_cross_kv
    (the None slot's attn2 stays unfused and gets no K/V in both)."""
    cfg = tiny_large_config().unet
    jtree = nonzero_tree(junet.init_unet(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([7, 800], np.int32)
    ctxs = [rng.standard_normal((2, 5, 768)).astype(np.float32),
            rng.standard_normal((2, 6, TINY_T5.d_model)).astype(np.float32)]
    masks = [np.ones((2, 5), np.float32), np.ones((2, 6), np.float32)]
    masks[1][0, 3:] = 0.0
    jctx, jm = [jnp.asarray(c) for c in ctxs], [jnp.asarray(m) for m in masks]
    tctx, tm = [_t(c) for c in ctxs], [_t(m) for m in masks]
    ptree = tparams.from_jax_tree(jtree)
    if fused:
        jkv = junet.precompute_cross_kv(jtree, cfg, jctx)
        assert jkv[2] is None and len(jkv[0]) == 2
        want = junet.apply_unet(junet.fuse_self_qkv(jtree), cfg, jnp.asarray(x), jnp.asarray(t),
                                jctx, jm, cross_kv=jkv)
        tkv = tunet.precompute_cross_kv(ptree, cfg, tctx)
        assert tkv[2] is None and len(tkv[0]) == 2
        fused_p = tunet.fuse_self_qkv(ptree)
        none_attn2 = fused_p["middle_block"]["cross_sts"][2]["blocks"][1]["attn2"]
        assert "to_qkv" not in none_attn2
        got = tunet.apply_unet(fused_p, cfg, _t(x), torch.from_numpy(t), tctx, tm, cross_kv=tkv)
    else:
        want = junet.apply_unet(jtree, cfg, jnp.asarray(x), jnp.asarray(t), jctx, jm)
        got = tunet.apply_unet(ptree, cfg, _t(x), torch.from_numpy(t), tctx, tm)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    assert _rel(got, want) < TOL


def test_large_unet_tree_matches_jax():
    cfg = tiny_large_config().unet
    jtree = junet.init_unet(jax.random.PRNGKey(0), cfg)
    ttree = tunet.init_unet(tparams.Init(torch.Generator().manual_seed(0), "cpu"), cfg)
    assert _flatten(ttree) == _flatten(jtree)
    assert len(ttree["middle_block"]["cross_sts"]) == 3
    assert len(ttree["middle_block"]["cross_sts"][2]["blocks"]) == 2


def _large_unet_cfg_128():
    """Widths 128 and 256, head_dim 32 and depth 2 with a None slot, so
    every quantization predicate fires and self-attention takes K2."""
    return UNetConfig(in_channels=4, out_channels=4, model_channels=128, num_res_blocks=1,
                      attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
                      context_dims=(64, None), transformer_depth=2)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_large_launch_formula_matches_kernel_calls(monkeypatch, quant):
    """kernel_launches_per_forward for the depth-2 UNet with a None slot
    equals the calls that reach each kernel wrapper (and K2's dispatch
    rule) in one CPU forward, in bf16-width and in int8."""
    from audioldm2_torch.ops import groupnorm_kernel, lnmm_kernel, nn, resblock_kernel

    cfg = _large_unet_cfg_128()
    calls = dict.fromkeys(KERNEL_NAMES, 0)

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for mod, name in [(resblock_kernel, "gn_silu_conv3x3"), (resblock_kernel, "gn_silu_conv3x3_q"),
                      (lnmm_kernel, "ln_matmul"), (lnmm_kernel, "ln_matmul_q"),
                      (lnmm_kernel, "geglu_matmul"), (lnmm_kernel, "geglu_matmul_q"),
                      (lnmm_kernel, "int8_matmul"), (groupnorm_kernel, "group_norm_silu")]:
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    orig_attention = nn.attention

    def attention(q, k, v, mask=None, bias=None, scale=None):
        if nn.attention_uses_kernel(q.shape, k.shape, mask is not None, bias is not None):
            calls["flash_self_attention"] += 1
        return orig_attention(q, k, v, mask=mask, bias=bias, scale=scale)

    monkeypatch.setattr(nn, "attention", attention)
    count_plain_conv_dispatches(monkeypatch, calls)
    jtree, _, tq = _quantized_trees(cfg)
    ptree = tparams.from_jax_tree(jtree)
    p = tq if quant else tunet.fuse_self_qkv(ptree)
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((2, 8, 8, 4)))
    ctx = [_t(rng.standard_normal((2, 6, 64)))]
    kv = tunet.precompute_cross_kv(ptree, cfg, ctx)
    tunet.apply_unet(p, cfg, x, torch.tensor([5, 6]), ctx, [torch.ones(2, 6)], cross_kv=kv)
    want = tunet.kernel_launches_per_forward(cfg, quant)
    assert calls == want
    # 4 ladders x depth 2 x (self-ST attn1 + attn2, the context slot's attn1, the
    # None slot's attn1 + attn2): the None slot's attn2 reaches K2
    assert want["flash_self_attention"] == 4 * 2 * (2 + 1 + 2)


def test_large_int8_unet_matches_jax():
    """The int8 serving mode of the depth-2 UNet with a None slot (its
    attn2 to_q quantized, to_k/to_v kept) against JAX's, both quantized
    from one f32 tree, to test_torch_int8's int8 bound."""
    cfg = _large_unet_cfg_128()
    jtree, jq, tq = _quantized_trees(cfg)
    none_attn2 = tq["middle_block"]["cross_sts"][1]["blocks"][0]["attn2"]
    assert "wq" in none_attn2["to_q"] and "wq" not in none_attn2["to_k"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 900], np.int32)
    ctx = rng.standard_normal((2, 6, 64)).astype(np.float32)
    mask = np.ones((2, 6), np.float32)
    mask[0, 2:] = 0.0
    jctx = [jnp.asarray(ctx)]
    want = junet.apply_unet(jq, cfg, jnp.asarray(x), jnp.asarray(t), jctx, [jnp.asarray(mask)],
                            cross_kv=junet.precompute_cross_kv(jtree, cfg, jctx))
    kv = tunet.precompute_cross_kv(tparams.from_jax_tree(jtree), cfg, [_t(ctx)])
    got = tunet.apply_unet(tq, cfg, _t(x), torch.from_numpy(t), [_t(ctx)], [_t(mask)],
                           cross_kv=kv)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    assert _rel(got, want) <= JAX_OP_TOL


def test_large_config_launch_counts():
    """The counts chip_smoke.py holds the large path to: 22 ResBlocks (44
    convs), 16 ladders of 4 spatial transformers (self-ST, two context
    slots, the None slot) of 2 blocks each (each transformer's proj_in and
    proj_out plain convs: 128 of the 151); n_gen does not change them."""
    large = at.default_audioldm_config("audioldm2-full-large-1150k")
    none = dict.fromkeys(KERNEL_NAMES, 0)
    assert tunet.kernel_launches_per_forward(large.unet) == {
        **none, "gn_silu_conv3x3": 44, "flash_self_attention": 16 * 2 * 6, "ln_matmul": 352,
        "geglu_matmul": 128, "group_norm_silu": 1, "conv2d": 151}
    assert tunet.kernel_launches_per_forward(large.unet, "int8") == {
        **none, "gn_silu_conv3x3_q": 44, "flash_self_attention": 192, "ln_matmul_q": 352,
        "geglu_matmul_q": 128, "int8_matmul": 16 * 2 * (4 * 2 + 1), "group_norm_silu": 1,
        "conv2d": 151}
    got = kernel_launches_per_generate(large, 200)
    assert got["flash_self_attention"] == 200 * 192 and got["gn_silu_conv3x3"] == 200 * 44 + 22


# ---------------------------------------------------------------------------
# HTSAT, CLAP audio side, rerank
# ---------------------------------------------------------------------------


def test_bicubic_matrix_matches_jax():
    np.testing.assert_array_equal(thtsat.bicubic_matrix(101, 1024),
                                  jhtsat.bicubic_matrix(101, 1024))
    np.testing.assert_array_equal(thtsat._swin_attn_mask(16, 4, 2), jhtsat._swin_attn_mask(16, 4, 2))
    np.testing.assert_array_equal(thtsat._rel_pos_index(8), jhtsat._rel_pos_index(8))


@pytest.fixture(scope="module")
def reranker():
    cfg = tiny_reranker()
    tree = nonzero_tree(jclap.init_clap(jax.random.PRNGKey(5), cfg))
    return cfg, tree, tparams.from_jax_tree(tree)


def test_clap_tree_matches_jax(reranker):
    cfg, tree, _ = reranker
    ttree = tclap.init_clap(tparams.Init(torch.Generator().manual_seed(0), "cpu"), cfg)
    assert _flatten(ttree) == _flatten(tree)
    big = tclap.init_clap(tparams.Init(torch.Generator(), "meta"), at.default_audioldm_config(
        "audioldm2-full-large-1150k").reranker_clap)
    assert big["audio_branch"]["tscam_conv"]["w"].shape == (2, 3, 1024, 527)


def test_htsat_mel_image_and_encode_match_jax(reranker):
    cfg, tree, ptree = reranker
    acfg = jhtsat.HTSATConfig(**TINY_HTSAT)
    wav = np.random.default_rng(6).standard_normal((2, 4096)).astype(np.float32) * 0.3
    interp = jhtsat.bicubic_matrix(4096 // acfg.hop_size + 1, acfg.spec_size * acfg.freq_ratio)
    jb, tb = tree["audio_branch"], ptree["audio_branch"]
    want_img = jhtsat.mel_image(jb, acfg, jnp.asarray(wav), interp)
    got_img = thtsat.mel_image(tb, acfg, _t(wav), interp)
    assert tuple(got_img.shape) == (2, 64, 64, 1)
    assert _rel(got_img, want_img) < TOL
    want = jhtsat.encode(jb, jnp.asarray(wav), acfg)
    got = thtsat.encode(tb, _t(wav), acfg)
    assert tuple(got.shape) == (2, 32)
    assert _rel(got, want) < TOL
    want_ff = jhtsat.forward_features(jb, acfg, want_img)["clipwise_output"]
    got_ff = thtsat.forward_features(tb, acfg, got_img)["clipwise_output"]
    assert _rel(got_ff, want_ff) < TOL


def test_clap_audio_embedding_and_rerank_score_match_jax(reranker):
    cfg, tree, ptree = reranker
    rng = np.random.default_rng(7)
    wav = (rng.standard_normal((3, 512)) * 0.3).astype(np.float32)  # 0.32 s at 1600 Hz
    want48 = jclap.prepare_clap_audio_jnp(jnp.asarray(wav), 1600, cfg)
    got48 = tclap.prepare_clap_audio_device(_t(wav), 1600, cfg)
    assert tuple(got48.shape) == (3, 4096)
    assert _rel(got48, want48) < TOL
    np.testing.assert_allclose(tclap.prepare_clap_audio(wav, 1600, cfg),
                               jclap.prepare_clap_audio(wav, 1600, cfg), atol=1e-5)
    emb = tclap.audio_embedding(ptree, cfg, got48)
    assert _rel(emb, jclap.audio_embedding(tree, cfg, want48)) < TOL
    np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=-1).numpy(), 1.0, atol=1e-6)
    ids = rng.integers(3, 400, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[:, 9:] = 0
    ids[mask == 0] = 1
    want = np.asarray(jclap._rerank_score(tree, cfg, 1600, jnp.asarray(wav), jnp.asarray(ids),
                                          jnp.asarray(mask)))
    got = tclap.rerank_score(ptree, cfg, 1600, _t(wav), torch.from_numpy(ids),
                             torch.from_numpy(mask))
    assert np.all(np.abs(got.numpy()) <= 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=TOL)


@pytest.fixture(scope="module")
def large_models():
    cfg = tiny_large_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jpipe.AudioLDM2(cfg, tree), at.build_model(config=cfg, device="cpu", params=tree)


def _chosen(err: str):
    return [[int(i) for i in re.findall(r"\d+", line.split(":", 1)[1])]
            for line in err.splitlines() if line.startswith("Choose the following indexes")]


def test_rerank_and_select_matches_jax(large_models, capsys):
    """Six candidates of two prompts, candidate i + j * 2 belonging to
    prompt i: the same similarities and the same picks."""
    _, jmodel, tmodel = large_models
    wav = (np.random.default_rng(8).standard_normal((6, 512)) * 0.3).astype(np.float32)
    want = jpipe.rerank_and_select(jmodel, wav, "a dog barks", 2, 3)
    got = at.pipeline.rerank_and_select(tmodel, wav, "a dog barks", 2, 3)
    picks = _chosen(capsys.readouterr().err)
    assert len(picks) == 2 and picks[0] == picks[1]
    np.testing.assert_array_equal(got, want)
    sim = tmodel.last_similarities
    assert sim.shape == (6,) and np.all(np.abs(sim) <= 1.0)
    assert picks[1] == [i + int(np.argmax(sim[i::2])) * 2 for i in range(2)]


def test_tiny_large_text_to_audio_matches_jax(large_models, capsys):
    """text_to_audio at the default n_candidate_gen_per_text = 3 on the tiny
    large-1150k config, JAX's x_T and per-step noise injected into the
    port: the same chosen candidates and a selected-waveform mel MAE < 1e-3."""
    cfg, jmodel, tmodel = large_models
    prompt, bsz, n, steps, lt = "rain on a roof", 2, 3, 4, 16
    shape = (bsz * n, lt, cfg.latent_f_size, cfg.latent_channels)
    x_T = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    keys = {}
    orig = jmodel.ldm.generate

    def generate(batch, key, **kw):
        keys["key"] = key
        return orig(batch, key, x_T=x_T, **kw)

    jmodel.ldm.generate = generate
    kw = dict(seed=11, ddim_steps=steps, duration=0.32, batchsize=bsz, duration_bucket=None)
    want = jpipe.text_to_audio(jmodel, prompt, **kw)
    k, _ = jax.random.split(keys["key"])
    noise = np.stack([np.asarray(jax.random.normal(jax.random.split(sk)[1], shape, jnp.float32))
                      for sk in jax.random.split(k, steps)])
    torig = tmodel.ldm.generate
    tmodel.ldm.generate = lambda batch, gen, **kw: torig(
        batch, gen, x_T=torch.from_numpy(x_T), noise=torch.from_numpy(noise), **kw)
    try:
        got = at.text_to_audio(tmodel, prompt, **kw)
    finally:
        del tmodel.ldm.generate
    picks = _chosen(capsys.readouterr().err)
    assert len(picks) == 2 and picks[0] == picks[1], picks
    assert got.shape == want.shape == (bsz, 1, 512)
    sim = tmodel.last_similarities
    assert sim.shape == (bsz * n,) and float(np.ptp(sim)) > 0
    mel_t = tmodel.mel.mel(got[:, 0]).numpy()
    mel_j = tmodel.mel.mel(np.asarray(want)[:, 0]).numpy()
    assert float(np.abs(mel_j).mean()) > 1e-2
    mae = float(np.abs(mel_t - mel_j).mean())
    assert mae < 1e-3, mae
    assert set(tmodel.last_timings) >= {"tokenize_s", "generate_s", "rerank_s"}


# ---------------------------------------------------------------------------
# The port stands alone: its own config and schedule, no jax, no audioldm2_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jconfig.CHECKPOINT_NAMES)
def test_default_config_matches_jax(name):
    assert tconfig.CHECKPOINT_NAMES == jconfig.CHECKPOINT_NAMES
    got, want = at.default_audioldm_config(name), jconfig.default_audioldm_config(name)
    assert type(got) is tconfig.ModelConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfig.coerce(want) == got


@pytest.mark.parametrize("timesteps,steps", [(1000, 200), (1000, 4), (100, 10)])
def test_schedule_matches_jax(timesteps, steps):
    want = jschedule.DiffusionSchedule.create(timesteps)
    got = tschedule.DiffusionSchedule.create(timesteps)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))
    for g, w in zip(tschedule.make_ddim_params(got, steps, 1.0),
                    jschedule.make_ddim_params(want, steps, 1.0)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("text", ["Dr. Smith's 2 dogs barked at Mr. Jones!",
                                  "  Hello <b>world</b>, ça va?  ", "",
                                  "ENGLISH sgt. capt. LTD. ft.; a\tb\nc"])
def test_phoneme_pipeline_matches_jax(text):
    """The copied VITS phoneme tables and functions: the same symbols, ids,
    pad length and abbreviations; the same phonemes (here the grapheme
    fallback, with no phonemizer installed) and padded ids at batch 1 and 3
    and at a short pad length that cuts the sequence."""
    from audioldm2_torch.utils import text as ttext
    from audioldm2_tpu.utils import text as jtext

    assert ttext.VITS_SYMBOLS == jtext.VITS_SYMBOLS and len(ttext.VITS_SYMBOLS) == 183
    assert ttext._SYMBOL_TO_ID == jtext._SYMBOL_TO_ID and ttext.PAD_LENGTH == jtext.PAD_LENGTH
    assert [(p.pattern, r) for p, r in ttext._ABBREVIATIONS] == [
        (p.pattern, r) for p, r in jtext._ABBREVIATIONS]
    phonemes = ttext.text_to_phonemes(text)
    assert phonemes == jtext.text_to_phonemes(text)
    for batch, pad in ((1, 310), (3, 310), (2, 8)):
        got = ttext.phoneme_ids([phonemes] * batch, pad)
        np.testing.assert_array_equal(got, jtext.phoneme_ids([phonemes] * batch, pad))
        assert got.shape == (batch, pad) and got.dtype == np.int32


def test_build_model_takes_a_jax_config_by_its_fields():
    """A JAX-package config builds that config (not the default one); an
    object of another type raises."""
    cfg = tiny_large_config()
    model = at.build_model(config=cfg, device="cpu", seed=0)
    assert type(model.cfg) is tconfig.ModelConfig and model.cfg.name == "tiny-large"
    assert model.cfg.unet.context_dims == (768, TINY_T5.d_model, None)
    assert type(model.cfg.reranker_clap) is tconfig.CLAPConfig
    assert type(model.cfg.conditioners[0].nested[0].clap) is tconfig.CLAPConfig
    assert model.ldm.params["unet"]["input_blocks"][1]["res"]["in_conv"]["w"].shape[-1] == 32
    for bad in ({"name": "audioldm2-full"}, "audioldm2-full", cfg.unet):
        with pytest.raises(TypeError):
            at.build_model(config=bad, device="cpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "audioldm2_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "audioldm2_tpu")]
    assert not bad, bad


def test_large_rerank_does_not_import_jax():
    """A tiny large-1150k text_to_audio with a rerank (n = 3) in a fresh
    process leaves jax and audioldm2_tpu unimported."""
    cfg = tconfig.coerce(tiny_large_config())
    code = (
        "import sys; import audioldm2_torch as at; from audioldm2_torch.config import *; "
        "from audioldm2_torch.models import clap, htsat, pann, roberta; "
        f"clap.register_audio_tower({HTSAT_NAME!r}, lambda: htsat.HTSATConfig(**{TINY_HTSAT!r}), "
        f"{TINY_HTSAT['embed_dim'] * 2}); "
        f"clap.register_text_tower('roberta-tiny', lambda: roberta.RobertaConfig(**{TINY_ROBERTA!r}),"
        " 16); "
        f"clap.register_audio_tower('PANN-tiny', lambda: pann.PANNConfig(**{TINY_PANN!r}), 24); "
        f"m = at.build_model(config={cfg!r}, device='cpu', seed=0, nonzero_init=True); "
        "w = at.text_to_audio(m, 'rain', ddim_steps=2, duration=0.32, duration_bucket=None); "
        "assert w.shape == (1, 1, 512) and m.last_similarities.shape == (3,); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'audioldm2_tpu')); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Choose the following indexes as the output" in out.stderr
