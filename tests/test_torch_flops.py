"""The port's FLOP count (audioldm2_torch/ops/flops.py, a copy that reads
the port's config) equal to the JAX package's for every function, all
seven checkpoint families and batches 1, 2 and 6 (exact: the same float
arithmetic on the same config values)."""

import pytest

from audioldm2_tpu import config as jconfig
from audioldm2_tpu.ops import flops as jflops
from audioldm2_torch import config as tconfig
from audioldm2_torch.ops import flops as tflops

FAMILIES = jconfig.CHECKPOINT_NAMES
BATCHES = (1, 2, 6)


def _cfgs(name):
    return jconfig.default_audioldm_config(name), tconfig.default_audioldm_config(name)


def test_seven_families():
    assert len(FAMILIES) == 7 and tuple(tconfig.CHECKPOINT_NAMES) == tuple(FAMILIES)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", FAMILIES)
def test_model_counts_match_jax(name, batch):
    jc, tc = _cfgs(name)
    assert tflops.default_context_lens(tc) == jflops.default_context_lens(jc)
    lt = jc.latent_t_size
    assert tflops.unet_step_flops(tc, batch, lt) == jflops.unet_step_flops(jc, batch, lt)
    lens = jflops.default_context_lens(jc)
    for count_kv in (False, True):
        assert (tflops.unet_forward_flops(tc.unet, batch, lt, tc.latent_f_size, lens, count_kv)
                == jflops.unet_forward_flops(jc.unet, batch, lt, jc.latent_f_size, lens,
                                             count_kv))
    assert (tflops.vae_decode_flops(tc.vae, batch, lt, tc.latent_f_size)
            == jflops.vae_decode_flops(jc.vae, batch, lt, jc.latent_f_size))
    t_mel = lt * jc.vae.downsample_factor
    assert (tflops.vocoder_flops(tc.vocoder, batch, t_mel)
            == jflops.vocoder_flops(jc.vocoder, batch, t_mel))
    assert tflops.unet_step_flops(tc, batch, lt) > 0


@pytest.mark.parametrize("batch", BATCHES)
def test_block_counts_match_jax(batch):
    cases = [
        ("conv2d_flops", (batch, 64, 8, 3, 3, 128, 256)),
        ("linear_flops", (batch * 1024, 640, 1920)),
        ("attention_flops", (batch, 10, 1024, 128, 64)),
        ("conv1d_flops", (batch, 1000, 7, 64, 1024)),
        ("_resblock_flops", (batch, 32, 4, 384, 640, 512)),
        ("_vae_resblock_flops", (batch, 256, 16, 512, 256)),
        ("_st_flops", (batch, 256, 384, 2, 128, 1024, 12, True)),
        ("_st_flops", (batch, 256, 384, 1, None, None, 12, False)),
    ]
    for fn, args in cases:
        assert getattr(tflops, fn)(*args) == getattr(jflops, fn)(*args), fn
