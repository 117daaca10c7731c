"""Audio-to-audio editing: the port's ``ddim.stochastic_encode`` and
``ddim.ddim_decode`` against the JAX package's (CPU, float32).

stochastic_encode in both index modes (DDIM subset, raw DDPM steps) at
several t_index with the same injected noise; ddim_decode at t_start 1, 7
and num_steps over the tiny t5 UNet with classifier-free guidance (both
packages' conditioning of one prompt, the same numpy weights and latent);
the port's ``LatentDiffusionModel.edit`` (encode to t_enc, decode under a
new prompt, VAE decode, vocoder) against the same composition of JAX
functions. Tolerance: max|port - jax| <= 1e-5 * max(1, max|jax|)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audioldm2_torch as at
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.diffusion import ddim as jddim
from audioldm2_tpu.diffusion import latent_diffusion as jld
from audioldm2_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from audioldm2_tpu.models import unet as junet
from audioldm2_tpu.models import vae as jvae
from audioldm2_tpu.models import vocoder as jvoc
from audioldm2_torch.diffusion import ddim as tddim
from audioldm2_torch.diffusion import latent_diffusion as tld
from audioldm2_torch.diffusion.schedule import DiffusionSchedule as TSchedule
from test_torch_models import nonzero_tree
from tiny import tiny_t5_model_config

torch.set_num_threads(2)

TOL = 1e-5
STEPS = 10
LT = 16


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.fixture(scope="module")
def cfg():
    return tiny_t5_model_config()


@pytest.fixture(scope="module")
def models(cfg):
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    return jpipe.AudioLDM2(cfg, tree), at.build_model(config=cfg, device="cpu", params=tree)


def _latent(cfg, seed, b=2):
    shape = (b, LT, cfg.latent_f_size, cfg.latent_channels)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("use_original_steps", [False, True])
@pytest.mark.parametrize("t_index", [0, 3, STEPS - 1])
def test_stochastic_encode_matches_jax(cfg, use_original_steps, t_index):
    if use_original_steps:
        t_index = [0, 417, 999][[0, 3, STEPS - 1].index(t_index)]
    x0, noise = _latent(cfg, 1), _latent(cfg, 2)
    want = jddim.stochastic_encode(None, jnp.asarray(x0), t_index, JSchedule.create(),
                                   STEPS, noise=jnp.asarray(noise),
                                   use_original_steps=use_original_steps)
    got = tddim.stochastic_encode(torch.from_numpy(x0), t_index, TSchedule.create(), STEPS,
                                  noise=torch.from_numpy(noise),
                                  use_original_steps=use_original_steps)
    _close(got, want)


def test_stochastic_encode_draws_from_the_generator_only():
    x0 = torch.zeros((1, 4, 4, 2))
    sched = TSchedule.create()
    a = tddim.stochastic_encode(x0, 5, sched, STEPS, generator=torch.Generator().manual_seed(3))
    b = tddim.stochastic_encode(x0, 5, sched, STEPS, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.abs().max() > 0
    with pytest.raises(ValueError, match="noise or a generator"):
        tddim.stochastic_encode(x0, 5, sched, STEPS)


def _jax_eps_fn(jmodel, cfg, prompt, guidance):
    """JAX's guided eps over its conditioning of ``prompt`` (the model_fn of
    its generate, latent_diffusion.py:119-158, f32)."""
    params = jmodel.ldm.params
    batch = jmodel.make_batch(prompt, batchsize=2)
    (y, contexts, masks), _, cfg_on = jld.encode_conditioning(params, cfg, batch, 1, guidance)
    kv = junet.precompute_cross_kv(params["unet"], cfg.unet, contexts)
    unet_p = junet.fuse_self_qkv(params["unet"])

    def model_fn(x, t):
        return junet.apply_unet(unet_p, cfg.unet, x, t, context_list=contexts,
                                context_mask_list=masks, y=y, cross_kv=kv)

    assert cfg_on
    return jddim.cfg_eps_fn(model_fn, guidance)


@pytest.mark.parametrize("t_start", [1, 7, STEPS])
def test_ddim_decode_matches_jax(cfg, models, t_start):
    jmodel, tmodel = models
    prompt, guidance = "a dog barking in the rain", 3.5
    eps_j = _jax_eps_fn(jmodel, cfg, prompt, guidance)
    eps_t, bsz = tld.guided_eps_fn(tmodel.ldm.params, tmodel.cfg,
                                   tmodel.make_batch(prompt, batchsize=2), 1, guidance)
    assert bsz == 2
    x = _latent(cfg, 4)
    want = jddim.ddim_decode(eps_j, jnp.asarray(x), JSchedule.create(), t_start, STEPS)
    with torch.inference_mode():
        got = tddim.ddim_decode(eps_t, torch.from_numpy(x), TSchedule.create(), t_start, STEPS)
    assert float(np.abs(np.asarray(want) - x).max()) > 1e-2  # the steps moved the latent
    _close(got, want)


def test_ddim_decode_refuses_a_missing_latent():
    with pytest.raises(ValueError, match="x_latent"):
        tddim.ddim_decode(lambda x, t: x, None, TSchedule.create(), 3, STEPS)


@pytest.mark.parametrize("t_enc", [1, 7])
def test_edit_matches_the_jax_composition(cfg, models, t_enc):
    """encode to t_enc, denoise under a new prompt, decode: the port's one
    call against JAX's functions in the same order."""
    jmodel, tmodel = models
    z0, noise = _latent(cfg, 5), _latent(cfg, 6)
    prompt, guidance = "a violin melody", 3.5
    eps_j = _jax_eps_fn(jmodel, cfg, prompt, guidance)
    params = jmodel.ldm.params
    z_t = jddim.stochastic_encode(None, jnp.asarray(z0), t_enc, JSchedule.create(), STEPS,
                                  noise=jnp.asarray(noise))
    z = jddim.ddim_decode(eps_j, z_t, JSchedule.create(), t_enc, STEPS) / params["scale_factor"]
    mel_j = jvae.decode(params["vae"], cfg.vae, z)
    wav_j = jvoc.apply_vocoder(params["vocoder"], cfg.vocoder, mel_j[..., 0])
    wav, mel = tmodel.ldm.edit(tmodel.make_batch(prompt, batchsize=2), None,
                               torch.from_numpy(z0), t_enc, ddim_steps=STEPS, guidance=guidance,
                               noise=torch.from_numpy(noise))
    assert float(np.abs(np.asarray(mel_j)).mean()) > 1e-2
    _close(mel, mel_j)
    _close(wav, wav_j)


def test_edit_refuses_a_batch_of_another_size(models):
    _, tmodel = models
    with pytest.raises(ValueError, match="conditions 1 latents"):
        tmodel.ldm.edit(tmodel.make_batch("rain", batchsize=1), None,
                        torch.zeros((2, LT, 4, 4)), 3, ddim_steps=STEPS,
                        noise=torch.zeros((2, LT, 4, 4)))


def test_edit_runs_t_enc_unet_forwards(models, monkeypatch):
    _, tmodel = models
    calls = []
    real = tld.unet.apply_unet
    monkeypatch.setattr(tld.unet, "apply_unet", lambda *a, **k: calls.append(1) or real(*a, **k))
    tmodel.ldm.edit(tmodel.make_batch("rain", batchsize=1), torch.Generator().manual_seed(0),
                    torch.zeros((1, LT, tmodel.cfg.latent_f_size, tmodel.cfg.latent_channels)),
                    4, ddim_steps=STEPS)
    assert len(calls) == 4
