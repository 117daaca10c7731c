"""The audioldm_48k family of audioldm2_torch against audioldm2_tpu on the
CPU, float32: the FiLM-only conditioning (no cross-attention context at all,
the CLAP text embedding as the UNet's y), the UNet with one context-free slot
and the doubled embedding, the four-level VAE (decode and encode), the
48 kHz vocoder with its odd-padding stage, the launch formulas, the int8
serving mode, the CLAP rerank at the model's own rate, and a tiny 48k
pipeline end to end through text_to_audio (three candidates, reranked) and
super_resolution_and_inpainting.

The tiny config keeps the family's structure: a 4800 Hz model (the rate of
its reranker, so the rerank resamples nothing, as 48 kHz is CLAP's rate),
four VAE levels, and a vocoder whose 5x stage has k - u = 5. Both packages
get the same numpy parameter trees and inputs. Tolerances: modules
max|got - want| <= 1e-5 x max|want| (float32, summation order only); end to
end, mel MAE < 1e-3 with the same x_T and per-step noise, and the same
picks; int8 as test_torch_int8 (JAX_OP_TOL)."""

import dataclasses
import re

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

import audioldm2_torch as at
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.config import (ConditionerSpec, ModelConfig, PreprocessingConfig, UNetConfig,
                                  VAEConfig, VocoderConfig)
from audioldm2_tpu.diffusion import latent_diffusion as jld
from audioldm2_tpu.models import unet as junet
from audioldm2_tpu.models import vae as jvae
from audioldm2_tpu.models import vocoder as jvoc
from audioldm2_torch import params as tparams
from audioldm2_torch.diffusion import latent_diffusion as tld
from audioldm2_torch.models import clap as tclap
from audioldm2_torch.models import unet as tunet
from audioldm2_torch.models import vae as tvae
from audioldm2_torch.models import vocoder as tvoc
from audioldm2_torch.ops import KERNEL_NAMES
from audioldm2_torch.pipeline import latent_inpaint_mask
from test_torch_full import tiny_clap
from test_torch_int8 import JAX_OP_TOL, _quantized_trees
from test_torch_large import _chosen, tiny_reranker
from test_torch_models import _flatten, count_plain_conv_dispatches, nonzero_tree
from test_torch_tts import _injected

torch.set_num_threads(2)

TOL = 1e-5


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def tiny_48k_config() -> ModelConfig:
    """audioldm_48k in miniature: the CLAP (text) conditioner as the only,
    FiLM, condition; UNet slots (None,); a four-level VAE over 32 mel bins
    (latent F = 4); a vocoder of rates (6, 5, 2), kernels (12, 10, 4), hop
    60 at 4800 Hz (10 latent frames a second); the tiny HTSAT reranker at
    4800 Hz."""
    clap = tiny_clap()
    return ModelConfig(
        name="tiny-48k", compute_dtype="float32",
        preprocessing=PreprocessingConfig(sampling_rate=4800, filter_length=128, hop_length=60,
                                          win_length=128, n_mel_channels=32, mel_fmin=20.0,
                                          mel_fmax=2400.0),
        vae=VAEConfig(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2, 4, 8), num_res_blocks=1,
                      mel_bins=32),
        vocoder=VocoderConfig(num_mels=32, upsample_rates=(6, 5, 2),
                              upsample_kernel_sizes=(12, 10, 4), upsample_initial_channel=32,
                              resblock_kernel_sizes=(3, 7),
                              resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), sampling_rate=4800),
        unet=UNetConfig(in_channels=4, out_channels=4, model_channels=32, num_res_blocks=1,
                        attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16,
                        context_dims=(None,), extra_film_condition_dim=clap.embed_dim),
        conditioners=(ConditionerSpec(name="film_clap_cond1", kind="clap", clap=clap),),
        latent_t_size=16, latent_f_size=4, latent_channels=4, latent_t_per_second=10.0,
        reranker_clap=tiny_reranker())


def _film_unet_cfg_128():
    """A 48k-shaped UNet (slots (None,), FiLM y) at widths 128 and 256 and
    head_dim 32, so every quantization predicate fires and self-attention
    takes K2."""
    return UNetConfig(in_channels=4, out_channels=4, model_channels=128, num_res_blocks=1,
                      attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
                      context_dims=(None,), extra_film_condition_dim=24)


@pytest.fixture(scope="module")
def models():
    """The seeded numpy draw of the tree, whatever AUDIOLDM2_FAST_INIT says:
    collecting tests/test_tpu_compile_smoke.py sets it for the whole
    process, and a fast-init tree is cut from a process-wide pool at an
    offset that depends on every draw made before it in that process, so
    the tree (and the rerank's closely spaced similarities) would depend
    on which tests ran earlier in the worker."""
    cfg = tiny_48k_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg, fast=False))
    return cfg, tree, jpipe.AudioLDM2(cfg, tree), at.build_model(config=cfg, device="cpu",
                                                                 params=tree)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def test_init_params_structure_matches_jax():
    """init_params draws the JAX tree's keys and shapes (film_emb from 24
    to the 128-wide time embedding, ResBlock emb projections from the
    doubled 256), the text-mode conditioner CLAP's PANN audio tower and
    projection included."""
    cfg = tiny_48k_config()
    jtree = jax.tree.map(np.asarray, jpipe.init_params(jax.random.PRNGKey(0), cfg))
    ttree = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _flatten(ttree) == _flatten(jtree)
    assert tuple(ttree["unet"]["film_emb"]["w"].shape) == (24, 128)
    assert tuple(ttree["unet"]["input_blocks"][1]["res"]["emb"]["w"].shape) == (256, 32)


@pytest.mark.parametrize("guidance,n_gen", [(3.5, 3), (1.0, 2)])
def test_conditioning_assembly_matches_jax(models, guidance, n_gen):
    """encode_conditioning: no context and no mask at all; y is the CLAP
    text embedding, tiled n_gen times, below the "" embedding tiled over
    the batch on the CFG axis (or alone at guidance 1)."""
    cfg, tree, jmodel, tmodel = models
    jb = jmodel.make_batch("a duck quacks", batchsize=2)
    tb = tmodel.make_batch("a duck quacks", batchsize=2)
    (jy, jctx, jmask), jbsz, jon = jld.encode_conditioning(tree, cfg, jb, n_gen, guidance)
    (ty, tctx, tmask), tbsz = tld.encode_conditioning(tmodel.ldm.params, tmodel.cfg, tb, n_gen,
                                                      guidance)
    # the port's CFG switch (conditioned_eps_fn) is guidance != 1, as JAX's cfg_on
    assert (tctx, tmask, tbsz, guidance != 1.0) == ([], [], jbsz, jon)
    assert jctx == [] and jmask == []
    rows = 2 * n_gen * (2 if guidance != 1.0 else 1)
    assert tuple(ty.shape) == (rows, 24)
    assert _rel(ty, jy) <= TOL
    if guidance != 1.0:  # the unconditional half is one row, repeated
        assert torch.equal(ty[:rows // 2], ty[:1].expand(rows // 2, -1))
    assert tunet.precompute_cross_kv(tunet.fuse_self_qkv(tmodel.ldm.params["unet"]), cfg.unet,
                                     tctx) == [None] * 4


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_film_unet_matches_jax(fused):
    """One FiLM UNet forward (slots (None,), y of width 24) against JAX's
    apply_unet, with and without fuse_self_qkv and the (empty)
    precompute_cross_kv."""
    cfg = tiny_48k_config().unet
    jtree = nonzero_tree(junet.init_unet(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 4, 4)).astype(np.float32)
    y = rng.standard_normal((2, 24)).astype(np.float32)
    t = np.array([7, 800], np.int32)
    p = tparams.from_jax_tree(jtree)
    if fused:
        jkv, tkv = junet.precompute_cross_kv(jtree, cfg, []), tunet.precompute_cross_kv(p, cfg, [])
        assert jkv == tkv == [None] * 4
        want = junet.apply_unet(junet.fuse_self_qkv(jtree), cfg, jnp.asarray(x), jnp.asarray(t),
                                [], [], y=jnp.asarray(y), cross_kv=jkv)
        got = tunet.apply_unet(tunet.fuse_self_qkv(p), cfg, _t(x), torch.from_numpy(t), [], [],
                               y=_t(y), cross_kv=tkv)
    else:
        want = junet.apply_unet(jtree, cfg, jnp.asarray(x), jnp.asarray(t), [], [],
                                y=jnp.asarray(y))
        got = tunet.apply_unet(p, cfg, _t(x), torch.from_numpy(t), [], [], y=_t(y))
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    assert _rel(got, want) <= TOL
    with pytest.raises(ValueError, match="requires y"):
        tunet.apply_unet(p, cfg, _t(x), torch.from_numpy(t), [], [])


def test_four_level_vae_matches_jax():
    """The 48k-shaped VAE (ch_mult (1, 2, 4, 8)): decode of a [2, 8, 4, 4]
    latent to [2, 64, 32, 1], and encode moments of that mel."""
    cfg = tiny_48k_config().vae
    tree = nonzero_tree(jvae.init_vae(jax.random.PRNGKey(5), cfg))
    p = tparams.from_jax_tree(tree)
    z = np.random.default_rng(5).standard_normal((2, 8, 4, 4)).astype(np.float32)
    want = jvae.decode(tree, cfg, jnp.asarray(z))
    got = tvae.decode(p, cfg, _t(z))
    assert tuple(got.shape) == (2, 64, 32, 1)
    assert _rel(got, want) <= TOL
    mel = np.asarray(want)
    for g, w in zip(tvae.encode_moments(p, cfg, _t(mel)), jvae.encode_moments(tree, cfg,
                                                                              jnp.asarray(mel))):
        assert tuple(g.shape) == (2, 8, 4, 4)
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("which", ["tiny", "48k"])
def test_vocoder_matches_jax_with_the_odd_padding_stage(which):
    """A stage with k - u odd (u 5, k 10: padding 2) makes 5L + 1 samples,
    so the waveform is not hop x frames long. The tiny config's (6, 5, 2):
    60 T + 2; the 48k vocoder's five stages and four MRF kernels (at
    narrow channels): 480 T + 16, 491536 for 10 s. Both packages give that
    length and the same samples."""
    if which == "tiny":
        cfg, t_mel, want_len = tiny_48k_config().vocoder, 9, 60 * 9 + 2
    else:
        cfg = dataclasses.replace(jpipe.default_audioldm_config("audioldm_48k").vocoder,
                                  num_mels=16, upsample_initial_channel=64)
        t_mel, want_len = 5, 480 * 5 + 16
    tree = nonzero_tree(jvoc.init_vocoder(jax.random.PRNGKey(6), cfg))
    mel = np.random.default_rng(6).standard_normal((2, t_mel, cfg.num_mels)).astype(np.float32)
    want = jvoc.apply_vocoder(tree, cfg, jnp.asarray(mel))
    got = tvoc.apply_vocoder(tparams.from_jax_tree(tree), cfg, _t(mel))
    assert tuple(got.shape) == tuple(want.shape) == (2, want_len)
    assert _rel(got, want) <= TOL


def test_48k_launch_counts():
    """The counts chip_smoke.py holds the 48k path to, derived from the
    config: 22 ResBlocks (44 K1), 16 ladders of two spatial transformers
    (the self-ST, the None slot) of one block each: K2 on attn1 of both and
    attn2 of both (64, 16 on the None slot's separate q/k/v), K3 on the
    fused QKV of both, the self-ST's attn2 QKV and both GEGLU proj_in (80),
    K4 32, the plain conv 87 (as the t5 UNet's: its 16 ladders hold 32
    spatial transformers); the decoder 28 K1 (four levels of three
    ResBlocks, two mid), K6 once and 12 plain convs (three nin_shortcuts
    and three upsamples over four levels); the encoder 20 K1 and K6 once."""
    cfg = at.default_audioldm_config("audioldm_48k")
    none = dict.fromkeys(KERNEL_NAMES, 0)
    assert tunet.kernel_launches_per_forward(cfg.unet) == {
        **none, "gn_silu_conv3x3": 44, "flash_self_attention": 64, "ln_matmul": 80,
        "geglu_matmul": 32, "group_norm_silu": 1, "conv2d": 87}
    assert tunet.kernel_launches_per_forward(cfg.unet, "int8") == {
        **none, "gn_silu_conv3x3_q": 44, "flash_self_attention": 64, "ln_matmul_q": 80,
        "geglu_matmul_q": 32, "int8_matmul": 16 * 5, "group_norm_silu": 1, "conv2d": 87}
    sa = tunet.self_attention_shapes(cfg.unet, 2, cfg.latent_t_size, cfg.latent_f_size)
    assert sum(f for f, _ in sa.values()) == 48 and sum(s for _, s in sa.values()) == 16
    assert tvae.kernel_launches_per_decode(cfg.vae) == {**none, "gn_silu_conv3x3": 28,
                                                        "group_norm_silu": 1, "conv2d": 12}
    assert tvae.kernel_launches_per_encode(cfg.vae) == {**none, "gn_silu_conv3x3": 20,
                                                        "group_norm_silu": 1}
    got = tld.kernel_launches_per_generate(cfg, 200, encode=True)
    assert got["gn_silu_conv3x3"] == 200 * 44 + 28 + 20 and got["group_norm_silu"] == 202


@pytest.mark.parametrize("quant", [None, "int8"])
def test_film_launch_formula_matches_kernel_calls(monkeypatch, quant):
    """kernel_launches_per_forward for the 48k-shaped UNet equals the calls
    that reach each kernel wrapper (and K2's dispatch rule) in one CPU
    forward, in bf16 width and in int8."""
    from audioldm2_torch.ops import groupnorm_kernel, lnmm_kernel, nn, resblock_kernel

    cfg = _film_unet_cfg_128()
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
    p = tq if quant else tunet.fuse_self_qkv(tparams.from_jax_tree(jtree))
    rng = np.random.default_rng(2)
    tunet.apply_unet(p, cfg, _t(rng.standard_normal((2, 8, 8, 4))), torch.tensor([5, 6]), [], [],
                     y=_t(rng.standard_normal((2, 24))), cross_kv=[None] * 4)
    want = tunet.kernel_launches_per_forward(cfg, quant)
    assert calls == want
    assert want["flash_self_attention"] == 4 * (2 + 2)


def test_48k_int8_unet_matches_jax():
    """The int8 serving mode of the 48k-shaped UNet (the None slot's attn2
    to_q quantized, to_k/to_v kept; the FiLM projections kept) against
    JAX's, both quantized from one f32 tree, to test_torch_int8's bound."""
    cfg = _film_unet_cfg_128()
    jtree, jq, tq = _quantized_trees(cfg)
    none_attn2 = tq["middle_block"]["cross_sts"][0]["blocks"][0]["attn2"]
    assert "wq" in none_attn2["to_q"] and "wq" not in none_attn2["to_k"]
    assert "wq" not in tq["film_emb"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    y = rng.standard_normal((2, 24)).astype(np.float32)
    t = np.array([3, 900], np.int32)
    want = junet.apply_unet(jq, cfg, jnp.asarray(x), jnp.asarray(t), [], [], y=jnp.asarray(y),
                            cross_kv=junet.precompute_cross_kv(jtree, cfg, []))
    got = tunet.apply_unet(tq, cfg, _t(x), torch.from_numpy(t), [], [], y=_t(y),
                           cross_kv=[None] * 4)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    assert _rel(got, want) <= JAX_OP_TOL


# ---------------------------------------------------------------------------
# The pipeline: rerank at the model's rate, text_to_audio, sr/inpainting
# ---------------------------------------------------------------------------


def test_rerank_at_the_clap_rate_matches_jax(models, capsys):
    """At the model's rate the rerank resamples nothing (the branch only the
    48k family reaches): the same similarities and picks as JAX's
    rerank_and_select over six candidates of two prompts."""
    cfg, _, jmodel, tmodel = models
    assert cfg.preprocessing.sampling_rate == cfg.reranker_clap.sampling_rate
    wav = (np.random.default_rng(8).standard_normal((6, 7680)) * 0.3).astype(np.float32)
    x = _t(wav)
    assert tclap.resample_sinc(x, 4800, 4800) is x
    want = jpipe.rerank_and_select(jmodel, wav, "a duck quacks", 2, 3)
    got = at.pipeline.rerank_and_select(tmodel, wav, "a duck quacks", 2, 3)
    picks = _chosen(capsys.readouterr().err)
    assert len(picks) == 2 and picks[0] == picks[1]
    np.testing.assert_array_equal(got, want)
    assert float(np.ptp(tmodel.last_similarities)) > 0


def test_tiny_48k_text_to_audio_matches_jax(models, capsys):
    """text_to_audio at batch 2 and the default three candidates (CFG batch
    12), JAX's x_T and per-step noise injected into the port: the same
    picks, the trimmed length (7680 of the vocoder's 7682) and a mel MAE <
    1e-3 of the kept waveforms."""
    cfg, _, jmodel, tmodel = models
    bsz, n, steps = 2, 3, 4
    x_T = np.random.default_rng(9).standard_normal(
        (bsz * n, 16, cfg.latent_f_size, cfg.latent_channels)).astype(np.float32)
    kw = dict(seed=11, ddim_steps=steps, duration=1.6, batchsize=bsz, duration_bucket=None)
    want, got = _injected(jmodel, tmodel, x_T, steps,
                          lambda pkg, m: pkg.text_to_audio(m, "a duck quacks", **kw))
    picks = _chosen(capsys.readouterr().err)
    assert len(picks) == 2 and picks[0] == picks[1], picks
    assert got.shape == want.shape == (bsz, 1, 7680)
    mel_t = tmodel.mel.mel(got[:, 0]).numpy()
    mel_j = tmodel.mel.mel(np.asarray(want)[:, 0]).numpy()
    assert float(np.abs(mel_j).mean()) > 1e-2
    mae = float(np.abs(mel_t - mel_j).mean())
    assert mae < 1e-3, mae


def test_tiny_48k_sr_end_to_end_matches_jax(models, tmp_path):
    """super_resolution_and_inpainting on the 48k-shaped model at batch 2:
    JAX's public path rebuilt step by step for its random numbers (posterior
    noise, x_T, per-step and mask noise), the port's steps fed them (fbank
    atol 1e-4, scaled latent rel 1e-4, mel MAE < 1e-3)."""
    cfg, _, jmodel, tmodel = models
    sr, duration, steps, seed, prompt = 4800, 1.6, 4, 3, "a duck quacks"
    t = np.arange(int(sr * 2.0)) / sr
    x = 0.4 * np.sin(2 * np.pi * (100 * t + 400 * t ** 2)) + 0.05 * np.random.default_rng(
        0).standard_normal(t.shape)
    path = str(tmp_path / "in.wav")
    wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
    target = int(duration * cfg.latent_t_per_second * cfg.vae.downsample_factor)
    wav_in = at.read_wav_file(path, target * cfg.preprocessing.hop_length, target_sr=sr)
    fb_j = np.asarray(jmodel.mel.fbank(wav_in, target_length=target))
    fb_t = tmodel.mel.fbank(wav_in, target_length=target)
    assert tuple(fb_t.shape) == (1, 128, 32)
    np.testing.assert_allclose(fb_t.numpy(), fb_j, atol=1e-4, rtol=0)
    mel = np.tile(fb_j[:, :, :, None], (2, 1, 1, 1))
    key, k_enc = jax.random.split(jpipe.seed_everything(seed))
    z0_j = jmodel.ldm.encode_mel(k_enc, mel)
    post = np.array(jax.random.normal(k_enc, z0_j.shape, jnp.float32))
    z0_t = tmodel.ldm.encode_mel(None, torch.from_numpy(mel), noise=torch.from_numpy(post))
    assert _rel(z0_t, z0_j) <= 1e-4
    b, h, w, c = z0_j.shape
    mask = latent_inpaint_mask(z0_t.shape, (0.4, 0.6), (1.0, 1.0))
    k_steps, k_init = jax.random.split(key)
    x_T = np.array(jax.random.normal(k_init, (b, h, w, c), jnp.float32))
    pairs = [jax.random.split(k) for k in jax.random.split(k_steps, steps)]
    mask_noise = np.stack([np.array(jax.random.normal(q, (b, h, w, c))) for q, _ in pairs])
    noise = np.stack([np.array(jax.random.normal(n, (b, h, w, c))) for _, n in pairs])
    jbatch = jmodel.make_batch(prompt, batchsize=2)
    jbatch.update(inpaint_mask=mask.numpy(), inpaint_x0=np.asarray(z0_j))
    kw = dict(latent_t_size=h, n_gen=1, guidance=2.5, ddim_steps=steps, use_mask=True)
    wj, mj = jmodel.ldm.generate(jbatch, key, **kw)
    tbatch = tmodel.make_batch(prompt, batchsize=2)
    tbatch.update(inpaint_mask=mask, inpaint_x0=z0_t)
    wt, mt = tmodel.ldm.generate(tbatch, None, x_T=torch.from_numpy(x_T),
                                 noise=torch.from_numpy(noise),
                                 mask_noise=torch.from_numpy(mask_noise), **kw)
    assert wt.shape == wj.shape == (2, 60 * 128 + 2)
    assert float(np.abs(mj).mean()) > 1e-2
    mel_mae = float(np.abs(mt - mj).mean())
    assert mel_mae < 1e-3, mel_mae
    want = jpipe.super_resolution_and_inpainting(
        jmodel, prompt, original_audio_file_path=path, seed=seed, ddim_steps=steps,
        duration=duration, batchsize=2, n_candidate_gen_per_text=1)
    np.testing.assert_array_equal(want, wj[:, None, :int(duration * sr)])
    got = at.super_resolution_and_inpainting(
        tmodel, prompt, original_audio_file_path=path, seed=seed, ddim_steps=steps,
        duration=duration, batchsize=2, n_candidate_gen_per_text=1)
    assert got.shape == (2, 1, 7680) and np.isfinite(got).all() and np.abs(got).max() <= 1.0


def test_transcription_is_accepted_and_ignored(models):
    """A family without a phoneme conditioner takes a transcription and
    ignores it, as in JAX: the same batch keys and the same waveform."""
    _, _, _, tmodel = models
    assert "phoneme_idx" not in tmodel.make_batch("rain", "hello there", 1)
    kw = dict(seed=3, ddim_steps=2, duration=0.8, duration_bucket=None, n_candidate_gen_per_text=1)
    np.testing.assert_array_equal(at.text_to_audio(tmodel, "rain", transcription="hello", **kw),
                                  at.text_to_audio(tmodel, "rain", **kw))


def test_build_model_builds_audioldm_48k_at_full_width():
    """The full-width 48k tree on the meta device: film_emb 512 -> 512,
    ResBlock emb projections from 1024, the UNet's 16 latent channels, the
    four-level VAE over 256 mel bins and the 48 kHz vocoder (1536 initial
    channels, five upsamples, four MRF kernels)."""
    model = at.build_model(model_name="audioldm_48k", device="meta")
    p = model.ldm.params
    assert tuple(p["unet"]["film_emb"]["w"].shape) == (512, 512)
    assert tuple(p["unet"]["input_blocks"][1]["res"]["emb"]["w"].shape) == (1024, 128)
    assert tuple(p["unet"]["input_blocks"][0]["conv"]["w"].shape) == (3, 3, 16, 128)
    assert [st["blocks"][0]["attn2"]["to_k"]["w"].shape[0]
            for st in p["unet"]["middle_block"]["cross_sts"]] == [640]
    assert len(p["vae"]["decoder"]["up"]) == 4
    assert tuple(p["vocoder"]["conv_pre"]["w"].shape) == (7, 256, 1536)
    assert len(p["vocoder"]["ups"]) == 5 and len(p["vocoder"]["resblocks"]) == 20
    assert re.match(r"audioldm_48k", model.cfg.name)
