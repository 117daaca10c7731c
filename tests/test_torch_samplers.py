"""The port's samplers against the JAX package's on the CPU, float32: DDIM,
PLMS and ancestral DDPM, with and without the inpainting mask, and EMA
weights in generate.

JAX's threefry and torch's Philox never agree, so each test rebuilds the
JAX sampler's key schedule and hands the port the same numbers through
x_T, noise and mask_noise:
  DDIM: key -> (key, k_init); split(key, n); per step (k_q, k_n);
  PLMS: key -> (key, k_init); split(key, n); per step k is the mask key;
  DDPM: key -> (key, k_init); split(key, 1000); per step (k_n, k_q).
Bound: max|port - JAX| / max|JAX| <= 1e-4 (float32, summation order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import audioldm2_torch as at  # noqa: E402
from audioldm2_tpu import pipeline as jpipe  # noqa: E402
from audioldm2_tpu.diffusion import ddim as jddim  # noqa: E402
from audioldm2_tpu.diffusion import ddpm_ancestral as jddpm  # noqa: E402
from audioldm2_tpu.diffusion import plms as jplms  # noqa: E402
from audioldm2_tpu.diffusion.schedule import DiffusionSchedule  # noqa: E402
from audioldm2_torch.diffusion import ddim as tddim  # noqa: E402
from audioldm2_torch.diffusion import ddpm_ancestral as tddpm  # noqa: E402
from audioldm2_torch.diffusion import plms as tplms  # noqa: E402
from audioldm2_torch.diffusion.latent_diffusion import unet_forwards  # noqa: E402
from test_torch_models import _eps_pair, nonzero_tree  # noqa: E402
from tiny import tiny_t5_model_config  # noqa: E402

torch.set_num_threads(2)

REL = 1e-4
SCHED = DiffusionSchedule.create()
SHAPE = (2, 8, 8, 4)
STEPS = 10


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _normals(keys, shape):
    """normal(k, shape) for each key of a [n, 2] key array, stacked."""
    return np.array(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))


def _halves(keys):
    """(split(k)[0], split(k)[1]) for each key."""
    pairs = jax.vmap(jax.random.split)(keys)
    return pairs[:, 0], pairs[:, 1]


def _mask_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    mask = np.ones(SHAPE[:3] + (1,), np.float32)
    mask[:, 3:6] = 0.0
    return mask, x0


def _jax_noise(sampler, key, masked):
    """The per-step (noise, mask_noise) the JAX sampler draws from ``key``."""
    n = SCHED.num_timesteps if sampler == "ddpm" else STEPS
    step_keys = jax.random.split(jax.random.split(key)[0], n)
    if sampler == "plms":
        return None, _normals(step_keys, SHAPE) if masked else None
    first, second = _halves(step_keys)
    k_noise, k_mask = (second, first) if sampler == "ddim" else (first, second)
    return _normals(k_noise, SHAPE), _normals(k_mask, SHAPE) if masked else None


def _run(sampler, masked, x_T, key):
    eps_j, eps_t = _eps_pair()
    mask, x0 = _mask_inputs() if masked else (None, None)
    jm = dict(mask=None if mask is None else jnp.asarray(mask),
              x0=None if x0 is None else jnp.asarray(x0))
    noise, mask_noise = _jax_noise(sampler, key, masked)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in
         dict(mask=mask, x0=x0, mask_noise=mask_noise, x_T=x_T).items()}
    if sampler == "ddim":
        want = jddim.ddim_sample(eps_j, key, SHAPE, SCHED, num_steps=STEPS, eta=1.0,
                                 x_T=jnp.asarray(x_T), **jm)
        got = tddim.ddim_sample(eps_t, SHAPE, SCHED, num_steps=STEPS, eta=1.0,
                                noise=torch.from_numpy(noise), **t)
    elif sampler == "plms":
        want = jplms.plms_sample(eps_j, key, SHAPE, SCHED, num_steps=STEPS,
                                 x_T=jnp.asarray(x_T), **jm)
        got = tplms.plms_sample(eps_t, SHAPE, SCHED, num_steps=STEPS, **t)
    else:
        want = jddpm.ddpm_sample(eps_j, key, SHAPE, SCHED, x_T=jnp.asarray(x_T), **jm)
        got = tddpm.ddpm_sample(eps_t, SHAPE, SCHED, noise=torch.from_numpy(noise), **t)
    return got, want


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("sampler", ["ddim", "plms", "ddpm"])
def test_sampler_matches_jax(sampler, masked):
    x_T = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    got, want = _run(sampler, masked, x_T, jax.random.PRNGKey(5))
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    assert _rel(got, want) <= REL, _rel(got, want)
    if masked:  # the kept region ends at the q-sampled x0 of t = the last step
        mask, x0 = _mask_inputs()
        kept = np.broadcast_to(mask, SHAPE) == 1
        assert np.abs(got.numpy()[kept] - x0[kept]).max() < 0.2


@pytest.mark.parametrize("sampler", ["ddim", "plms", "ddpm"])
def test_model_calls_per_trajectory(sampler):
    """DDIM calls the model once per step, PLMS once more (its first step
    evaluates twice), DDPM once per schedule step; the launch formula
    (unet_forwards) says the same."""
    calls = []

    def eps(x, t):
        calls.append(int(t[0]))
        return 0.1 * x

    kw = dict(generator=torch.Generator().manual_seed(0))
    if sampler == "ddim":
        tddim.ddim_sample(eps, SHAPE, SCHED, num_steps=STEPS, **kw)
    elif sampler == "plms":
        tplms.plms_sample(eps, SHAPE, SCHED, num_steps=STEPS, **kw)
    else:
        tddpm.ddpm_sample(eps, SHAPE, SCHED, **kw)
    assert len(calls) == unet_forwards(tiny_t5_model_config(), STEPS, sampler)
    assert calls[0] == (999 if sampler == "ddpm" else 901) and calls[-1] in (0, 1)


def test_injected_noise_needs_one_entry_per_step():
    eps = _eps_pair()[1]
    mask, x0 = (torch.from_numpy(a) for a in _mask_inputs())
    with pytest.raises(ValueError, match="mask_noise"):
        tplms.plms_sample(eps, SHAPE, SCHED, num_steps=STEPS, mask=mask, x0=x0,
                          mask_noise=torch.zeros((STEPS - 1,) + SHAPE))
    with pytest.raises(ValueError, match="noise"):
        tddpm.ddpm_sample(eps, SHAPE, SCHED, noise=torch.zeros((10,) + SHAPE))


# ---------------------------------------------------------------------------
# generate: samplers and EMA weights on the tiny t5 model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ema_models():
    cfg = tiny_t5_model_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(11)
    tree["unet_ema"] = jax.tree.map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype)
        if a.dtype == np.float32 else a, tree["unet"])
    return cfg, jpipe.AudioLDM2(cfg, tree), at.build_model(config=cfg, device="cpu", params=tree)


def _generate_pair(models, **kw):
    cfg, jmodel, tmodel = models
    lt = 16
    x_T = np.random.default_rng(7).standard_normal(
        (1, lt, cfg.latent_f_size, cfg.latent_channels)).astype(np.float32)
    args = dict(latent_t_size=lt, n_gen=1, guidance=3.5, ddim_steps=4, ddim_eta=0.0, **kw)
    _, mj = jmodel.ldm.generate(jmodel.make_batch("rain on a roof"), jax.random.PRNGKey(0),
                                x_T=x_T, **args)
    _, mt = tmodel.ldm.generate(tmodel.make_batch("rain on a roof"), None,
                                x_T=torch.from_numpy(x_T), **args)
    return mt, mj


def test_use_ema_matches_jax(ema_models):
    """generate(use_ema=True) denoises with params["unet_ema"] (carried over
    by build_model from the JAX tree) in both packages; the EMA UNet moves
    the output, and a tree without it raises."""
    _, _, tmodel = ema_models
    assert "unet_ema" in tmodel.ldm.params
    mt, mj = _generate_pair(ema_models, use_ema=True)
    assert float(np.abs(mt - mj).mean()) < 1e-3
    plain, _ = _generate_pair(ema_models)
    assert float(np.abs(plain - mt).mean()) > 1e-3
    tmodel.ldm.params, saved = ({k: v for k, v in tmodel.ldm.params.items() if k != "unet_ema"},
                                tmodel.ldm.params)
    try:
        with pytest.raises(ValueError, match="unet_ema"):
            at.text_to_audio(tmodel, "rain", ddim_steps=4, duration=0.32, duration_bucket=None,
                             use_ema=True, n_candidate_gen_per_text=1)
    finally:
        tmodel.ldm.params = saved


def test_plms_generate_matches_jax(ema_models):
    """The plms sampler through generate (no mask, so nothing random after
    x_T): the tiny t5 model against JAX, mel MAE < 1e-3."""
    mt, mj = _generate_pair(ema_models, sampler="plms")
    assert float(np.abs(mj).mean()) > 1e-2
    assert float(np.abs(mt - mj).mean()) < 1e-3


def test_text_to_audio_takes_the_samplers(ema_models):
    _, _, tmodel = ema_models
    kw = dict(seed=3, ddim_steps=4, duration=0.32, duration_bucket=None,
              n_candidate_gen_per_text=1)
    a = at.text_to_audio(tmodel, "rain", sampler="plms", **kw)
    b = at.text_to_audio(tmodel, "rain", sampler="ddim", **kw)
    assert a.shape == b.shape == (1, 1, 512)
    assert np.isfinite(a).all() and np.abs(a).max() <= 1.0 and np.abs(a - b).max() > 0
    with pytest.raises(ValueError, match="sampler"):
        at.text_to_audio(tmodel, "rain", sampler="euler", **kw)
