"""The sr/inpainting slice of audioldm2_torch against audioldm2_tpu on the
CPU, float32: K6's plain version against the Pallas kernel it replaces
(interpret mode), the STFT bases and log-mel fbank, the VAE encoder
(moments, posterior sample), the tiny audioldm2-full sr path end to end,
and the public super_resolution_and_inpainting.

Both packages get the same numpy parameter trees and inputs, and the port
gets the JAX path's random numbers (posterior noise, x_T, per-step and mask
noise) rebuilt from its keys. Tolerances: K6 atol 1e-5; bases atol 1e-7;
fbank atol 1e-4; encoder rel 1e-4; end to end mel MAE < 1e-3."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import audioldm2_torch as at  # noqa: E402
from audioldm2_tpu import pipeline as jpipe  # noqa: E402
from audioldm2_tpu.config import VAEConfig  # noqa: E402
from audioldm2_tpu.models import vae as jvae  # noqa: E402
from audioldm2_tpu.ops import groupnorm_pallas as gp  # noqa: E402
from audioldm2_tpu.ops import stft as jstft  # noqa: E402
from audioldm2_torch import ops  # noqa: E402
from audioldm2_torch import params as tparams  # noqa: E402
from audioldm2_torch.diffusion.latent_diffusion import kernel_launches_per_generate  # noqa: E402
from audioldm2_torch.models import vae as tvae  # noqa: E402
from audioldm2_torch.ops import groupnorm_kernel  # noqa: E402
from audioldm2_torch.ops import nn as tnn  # noqa: E402
from audioldm2_torch.ops import stft as tstft  # noqa: E402
from audioldm2_torch.pipeline import latent_inpaint_mask  # noqa: E402
from test_torch_full import tiny_full_config  # noqa: E402
from test_torch_models import nonzero_tree  # noqa: E402
from tiny import tiny_t5_model_config  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _wav_file(path, sr, seconds, seed=0, silent_head=0.0):
    """A chirp plus noise, written as 16-bit PCM; the first ``silent_head``
    share of it silent."""
    t = np.arange(int(sr * seconds)) / sr
    f0, f1 = 0.02 * sr, 0.3 * sr
    chirp = np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * seconds)))
    x = 0.4 * chirp + 0.05 * np.random.default_rng(seed).standard_normal(t.shape)
    x[:int(len(x) * silent_head)] = 0.0
    wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
    return path


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_silu_plain_matches_pallas_kernel(rng, silu):
    x = rng.standard_normal((2, 8, 4, 256)).astype(np.float32) + 3.0
    scale = rng.standard_normal(256).astype(np.float32)
    bias = rng.standard_normal(256).astype(np.float32)
    b, c = x.shape[0], x.shape[-1]
    s = x.size // (b * c)
    want = pl.pallas_call(
        functools.partial(gp._gn_silu_kernel, groups=32, eps=1e-6, silu=silu),
        out_shape=jax.ShapeDtypeStruct((b, s, c), jnp.float32),
        grid=(b,),
        in_specs=[
            pl.BlockSpec((1, s, c), lambda i: (i, 0, 0)),
            pl.BlockSpec((c,), lambda i: (0,)),
            pl.BlockSpec((c,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((1, s, c), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(x).reshape(b, s, c), scale, bias).reshape(x.shape)
    args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-6, silu)
    got = groupnorm_kernel.group_norm_silu_plain(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the wrapper's CPU route is the plain version, and so is the dispatch point's
    assert torch.equal(groupnorm_kernel.group_norm_silu(*args), got)
    if silu:
        routed = tnn.group_norm_silu({"scale": args[1], "bias": args[2]}, args[0], eps=1e-6)
        assert torch.equal(routed, got)


def test_group_norm_silu_plain_rounds_once_in_bf16(rng):
    """The Pallas kernel's rounding points: f32 statistics, affine and SiLU,
    one rounding to bf16 (JAX's plain silu(group_norm(x)) rounds twice)."""
    x = torch.from_numpy(rng.standard_normal((1, 16, 8, 64)).astype(np.float32)).bfloat16()
    gamma, beta = torch.ones(64), torch.zeros(64)
    got = groupnorm_kernel.group_norm_silu_plain(x, gamma, beta)
    once = groupnorm_kernel.group_norm_silu_plain(x.float(), gamma, beta).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, once)
    assert ops.launch_counts()["group_norm_silu"] == 0


# ---------------------------------------------------------------------------
# STFT / mel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [(16000, 1024, 1024, 64, 0.0, 8000.0),
                                 (1600, 64, 64, 16, 0.0, 800.0), (48000, 2048, 2048, 256, 20.0,
                                                                  24000.0)])
def test_mel_bases_match_jax(cfg):
    sr, n_fft, win, n_mels, fmin, fmax = cfg
    np.testing.assert_allclose(tstft.hann_window_periodic(win), jstft.hann_window_periodic(win),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(tstft.stft_basis(n_fft, win), jstft.stft_basis(n_fft, win),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(tstft.librosa_mel_filters(sr, n_fft, n_mels, fmin, fmax),
                               jstft.librosa_mel_filters(sr, n_fft, n_mels, fmin, fmax),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("target_length", [128, 64])
def test_fbank_matches_jax(tmp_path, target_length):
    """The 16 kHz log-mel of a synthesized chirp (padded to 128 frames, or
    cut to 64), through read_wav_file as the sr path reads it."""
    from audioldm2_tpu.utils.audio_io import read_wav_file

    wav = read_wav_file(_wav_file(str(tmp_path / "in.wav"), 16000, 1.0, silent_head=0.3), 16000)
    want = jstft.MelSpectrogram().fbank(jnp.asarray(wav), target_length=target_length)
    got = tstft.MelSpectrogram().fbank(wav, target_length=target_length)
    assert tuple(got.shape) == (1, target_length, 64)
    assert float(np.asarray(want).min()) < -8  # the log floor and the padding are exercised
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# VAE encoder
# ---------------------------------------------------------------------------


TS4_VAE = VAEConfig(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                    mel_bins=16, downsample_time_stride4_levels=(0,))


@pytest.mark.parametrize("vcfg,shape", [(tiny_t5_model_config().vae, (2, 32, 16, 16, 8)),
                                        (TS4_VAE, (1, 32, 16, 8, 8))])
def test_encode_moments_and_posterior_match_jax(vcfg, shape):
    """encode_moments (quant_conv split, logvar clamp) and sample_posterior
    with the JAX draw injected, on the tiny VAE and a tiny time-stride-4 VAE."""
    b, t, m, lt, lm = shape
    tree = nonzero_tree(jvae.init_vae(jax.random.PRNGKey(3), vcfg))
    mel = (np.random.default_rng(3).standard_normal((b, t, m, 1)) - 4.0).astype(np.float32)
    mean_j, logvar_j = jvae.encode_moments(tree, vcfg, jnp.asarray(mel))
    p = tparams.from_jax_tree(tree)
    mean_t, logvar_t = tvae.encode_moments(p, vcfg, torch.from_numpy(mel))
    assert tuple(mean_t.shape) == (b, lt, lm, vcfg.embed_dim) == tuple(np.shape(mean_j))
    assert _rel(mean_t, mean_j) <= REL and _rel(logvar_t, logvar_j) <= REL
    key = jax.random.PRNGKey(4)
    z_j = jvae.sample_posterior(key, mean_j, logvar_j)
    noise = torch.from_numpy(np.array(jax.random.normal(key, mean_j.shape, jnp.float32)))
    assert _rel(tvae.sample_posterior(mean_t, logvar_t, noise=noise), z_j) <= REL


def test_encode_launch_formula_matches_dispatch_calls(monkeypatch):
    """kernel_launches_per_encode equals the calls that reach each kernel's
    dispatch point in one encode; at full width the 16 kHz encoder runs 8
    ResBlocks (16 K1) and one K6, and the sr path adds them to generate's."""
    vcfg = tiny_t5_model_config().vae
    calls = dict.fromkeys(ops.KERNEL_NAMES, 0)

    def counting(name, fn, cond=lambda *a, **kw: True):
        def wrapped(*a, **kw):
            calls[name] += bool(cond(*a, **kw))
            return fn(*a, **kw)
        return wrapped

    def uses_kernel(q, k, v, mask=None, bias=None, scale=None):
        return tnn.attention_uses_kernel(q.shape, k.shape, mask is not None, bias is not None)

    for attr, name, *cond in (("gn_silu_conv", "gn_silu_conv3x3"),
                              ("group_norm_silu", "group_norm_silu"),
                              ("attention", "flash_self_attention", uses_kernel)):
        monkeypatch.setattr(tnn, attr, counting(name, getattr(tnn, attr), *cond))
    ini = tparams.Init(torch.Generator().manual_seed(0), "cpu")
    tvae.encode_moments(tvae.init_vae(ini, vcfg), vcfg, torch.randn(1, 32, 16, 1))
    assert calls == tvae.kernel_launches_per_encode(vcfg)
    full = at.default_audioldm_config("audioldm2-full")
    enc = tvae.kernel_launches_per_encode(full.vae)
    assert enc == {**dict.fromkeys(ops.KERNEL_NAMES, 0), "gn_silu_conv3x3": 16,
                   "group_norm_silu": 1}
    plain = kernel_launches_per_generate(full, 200, "ddim")
    sr = kernel_launches_per_generate(full, 200, "ddim", encode=True)
    assert {k: sr[k] - plain[k] for k in sr} == enc
    assert kernel_launches_per_generate(full, 200, "plms")["ln_matmul"] == 201 * 144
    assert kernel_launches_per_generate(full, 200, "ddpm")["group_norm_silu"] == 1000 + 1


# ---------------------------------------------------------------------------
# The sr path end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sr_models():
    cfg = tiny_full_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jpipe.AudioLDM2(cfg, tree), at.build_model(config=cfg, device="cpu", params=tree)


def test_tiny_full_sr_end_to_end_matches_jax(sr_models, tmp_path):
    """The tiny audioldm2-full sr path at batch 2: JAX's public
    super_resolution_and_inpainting, rebuilt step by step to get its random
    numbers, against the port's steps fed those numbers (fbank atol 1e-4,
    scaled latent rel 1e-4, mel MAE < 1e-3)."""
    cfg, jmodel, tmodel = sr_models
    sr, duration, steps, seed, prompt = cfg.preprocessing.sampling_rate, 0.64, 4, 3, "a chirp"
    path = _wav_file(str(tmp_path / "in.wav"), sr, 1.0)
    target = int(duration * cfg.latent_t_per_second * cfg.vae.downsample_factor)
    wav_in = at.read_wav_file(path, target * cfg.preprocessing.hop_length, target_sr=sr)
    fb_j = np.asarray(jmodel.mel.fbank(wav_in, target_length=target))
    fb_t = tmodel.mel.fbank(wav_in, target_length=target)
    np.testing.assert_allclose(fb_t.numpy(), fb_j, atol=1e-4, rtol=0)
    mel = np.tile(fb_j[:, :, :, None], (2, 1, 1, 1))

    key, k_enc = jax.random.split(jpipe.seed_everything(seed))
    z0_j = jmodel.ldm.encode_mel(k_enc, mel)
    post = np.array(jax.random.normal(k_enc, z0_j.shape, jnp.float32))
    z0_t = tmodel.ldm.encode_mel(None, torch.from_numpy(mel), noise=torch.from_numpy(post))
    assert _rel(z0_t, z0_j) <= REL
    b, h, w, c = z0_j.shape
    mask = latent_inpaint_mask(z0_t.shape, (0.4, 0.6), (1.0, 1.0))
    assert float(mask.mean()) < 1.0 and tuple(mask.shape) == (b, h, w, 1)

    # DDIM's key schedule (eta 1, masked): x_T, then per step (k_q, k_n)
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
    _, mt = tmodel.ldm.generate(tbatch, None, x_T=torch.from_numpy(x_T),
                                noise=torch.from_numpy(noise),
                                mask_noise=torch.from_numpy(mask_noise), **kw)
    assert float(np.abs(mj).mean()) > 1e-2
    mel_mae = float(np.abs(mt - mj).mean())
    assert mel_mae < 1e-3, mel_mae

    # the steps above are JAX's public sr path
    want = jpipe.super_resolution_and_inpainting(
        jmodel, prompt, original_audio_file_path=path, seed=seed, ddim_steps=steps,
        duration=duration, batchsize=2, n_candidate_gen_per_text=1)
    np.testing.assert_array_equal(want, wj[:, None, :int(duration * sr)])


@pytest.fixture(scope="module")
def t5_model():
    cfg = tiny_t5_model_config()
    return at.build_model(config=cfg, device="cpu", seed=0, nonzero_init=True)


def test_super_resolution_and_inpainting_api(t5_model, tmp_path):
    path = _wav_file(str(tmp_path / "in.wav"), 1600, 0.5)
    kw = dict(original_audio_file_path=path, ddim_steps=4, duration=0.64,
              n_candidate_gen_per_text=1)
    a = at.super_resolution_and_inpainting(t5_model, "a chirp", seed=3, **kw)
    assert a.shape == (1, 1, 1024) and a.dtype == np.float32
    assert np.isfinite(a).all() and np.abs(a).max() <= 1.0 and np.abs(a).max() > 0
    assert set(t5_model.last_timings) >= {"prepare_s", "generate_s", "total_s", "x_realtime"}
    np.testing.assert_array_equal(a, at.super_resolution_and_inpainting(
        t5_model, "a chirp", seed=3, **kw))
    assert np.abs(a - at.super_resolution_and_inpainting(t5_model, "a chirp", seed=4,
                                                          **kw)).max() > 0
    for sampler in ("plms", "ddpm"):
        b = at.super_resolution_and_inpainting(
            t5_model, "a chirp", seed=3, batchsize=2, sampler=sampler,
            **{**kw, "ddim_steps": 2 if sampler == "plms" else 4})
        assert b.shape == (2, 1, 1024) and np.isfinite(b).all()
    # no reranker in the tiny config: three candidates, the first one kept
    with pytest.warns(UserWarning, match="CLAP reranker"):
        c = at.super_resolution_and_inpainting(t5_model, "a chirp",
                                               **{**kw, "n_candidate_gen_per_text": 3})
    assert c.shape == (1, 1, 1024) and "rerank_s" in t5_model.last_timings


def test_sr_and_plms_do_not_import_jax(tmp_path):
    """A CPU call of super_resolution_and_inpainting and of
    text_to_audio(sampler="plms") on the tiny config leaves jax and
    audioldm2_tpu unimported. The tiny config reaches the subprocess as the
    repr of the port's own config classes (tests/tiny.py imports the JAX
    package's)."""
    from audioldm2_torch.config import coerce

    path = _wav_file(str(tmp_path / "in.wav"), 1600, 0.5)
    code = (
        "import sys; import audioldm2_torch as at; from audioldm2_torch.config import *; "
        f"m = at.build_model(config={repr(coerce(tiny_t5_model_config()))}, device='cpu', "
        "seed=0); "
        f"w = at.super_resolution_and_inpainting(m, 'a chirp', original_audio_file_path={path!r}, "
        "ddim_steps=2, duration=0.32, n_candidate_gen_per_text=1); "
        "v = at.text_to_audio(m, 'rain', ddim_steps=2, duration=0.32, duration_bucket=None, "
        "sampler='plms', n_candidate_gen_per_text=1); "
        "assert w.shape == (1, 1, 512) and v.shape == (1, 1, 512); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'audioldm2_tpu')); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_params_carry_unet_ema():
    tree = {"unet": {"w": np.ones(3, np.float32)}, "unet_ema": {"w": np.zeros(3, np.float32)}}
    got = tparams.from_jax_tree(tree)
    assert sorted(got) == ["unet", "unet_ema"] and float(got["unet_ema"]["w"].sum()) == 0.0
