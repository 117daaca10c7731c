"""The Hopper kernels against their plain PyTorch versions on the card.

Run on a machine with an NVIDIA GPU (and no JAX, hence no tests/conftest.py):
    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
Without CUDA every test here skips (decided inside the ``cuda`` fixture,
never at import, so every worker collects the same tests).

Bound: max|kernel - plain| / max|plain| <= 2e-2 in bf16 and <= 1e-4 in
f32, with TF32 off so the f32 plain path is a full-precision oracle."""

import numpy as np
import pytest
import torch

from audioldm2_torch import ops
from audioldm2_torch.ops import attention_kernel, lnmm_kernel, resblock_kernel

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (see the module docstring for the command on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, shape, dt, device, scale=1.0, offset=0.0):
    return (torch.randn(shape, generator=g, device=device) * scale + offset).to(dt)


def _check(got, want, dt):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err / want.float().abs().max().item() <= TOL[dt], err


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,T,F,c1,c2,cout,offset", [
    (2, 8, 4, 128, 0, 128, 0.0),
    (1, 5, 3, 64, 32, 96, 0.0),     # concat with a group straddling the split
    (1, 5, 3, 60, 36, 96, 0.0),     # channels not a multiple of 8: scalar loads
    (1, 33, 7, 256, 0, 70, 0.0),    # ragged M and N tiles
    (1, 64, 64, 128, 0, 128, 10.0),  # offset input: GroupNorm cancellation
])
def test_gn_silu_conv3x3_kernel(cuda, dt, B, T, F, c1, c2, cout, offset):
    g = torch.Generator(device=cuda).manual_seed(0)
    x1 = _rand(g, (B, T, F, c1), dt, cuda, offset=offset)
    x2 = _rand(g, (B, T, F, c2), dt, cuda) if c2 else None
    cin = c1 + c2
    args = (x1, x2, _rand(g, (cin,), torch.float32, cuda), _rand(g, (cin,), torch.float32, cuda),
            _rand(g, (3, 3, cin, cout), dt, cuda, scale=cin ** -0.5 / 3),
            _rand(g, (cout,), torch.float32, cuda), 32, 1e-6)
    _check(resblock_kernel.gn_silu_conv3x3(*args), resblock_kernel.gn_silu_conv3x3_plain(*args), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,T,H,D", [(2, 1024, 8, 32), (1, 100, 3, 64), (1, 65, 2, 128)])
def test_flash_self_attention_kernel(cuda, dt, B, T, H, D):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_rand(g, (B, T, H, D), dt, cuda) for _ in range(3))
    args = (q, k, v, D ** -0.5)
    _check(attention_kernel.flash_self_attention(*args),
           attention_kernel.self_attention_plain(*args), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("C,N,with_bias", [(320, 200, True), (320, 200, False), (100, 36, True),
                                           (640, 1920, False)])
def test_ln_matmul_kernel(cuda, dt, C, N, with_bias):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = _rand(g, (2, 64, C), dt, cuda, offset=3.0)
    args = (x, _rand(g, (C,), torch.float32, cuda), _rand(g, (C,), torch.float32, cuda),
            _rand(g, (C, N), dt, cuda, scale=0.05),
            _rand(g, (N,), torch.float32, cuda) if with_bias else None, 1e-5)
    _check(lnmm_kernel.ln_matmul(*args), lnmm_kernel.ln_matmul_plain(*args), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("M,F,N", [(130, 160, 96), (128, 2560, 640), (50, 20, 12)])
def test_geglu_matmul_kernel(cuda, dt, M, F, N):
    g = torch.Generator(device=cuda).manual_seed(3)
    args = (_rand(g, (M, 2 * F), dt, cuda), _rand(g, (F, N), dt, cuda, scale=F ** -0.5),
            _rand(g, (N,), torch.float32, cuda), _rand(g, (M, N), dt, cuda))
    _check(lnmm_kernel.geglu_matmul(*args), lnmm_kernel.geglu_matmul_plain(*args), dt)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 4, 4, 64, device=cuda)
    w = torch.randn(3, 3, 64, 64, device=cuda)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(TypeError):
        resblock_kernel.gn_silu_conv3x3(x.half(), None, ones, zeros, w, zeros)
    with pytest.raises(ValueError):
        resblock_kernel.gn_silu_conv3x3(x, None, ones, zeros, torch.randn(1, 1, 64, 64,
                                                                          device=cuda), zeros)
    with pytest.raises(ValueError):
        resblock_kernel.gn_silu_conv3x3(x, x.transpose(1, 2), ones, zeros,
                                        torch.randn(3, 3, 128, 64, device=cuda), zeros)
    q = torch.randn(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        attention_kernel.flash_self_attention(q, q, q, 0.25)
    with pytest.raises(ValueError):
        lnmm_kernel.ln_matmul(x, ones, zeros, torch.randn(32, 8, device=cuda))


def test_launch_counters_count_launches(cuda):
    ops.reset_launch_counts()
    q = torch.randn(1, 64, 2, 32, device=cuda)
    attention_kernel.flash_self_attention(q, q, q, 0.2)
    attention_kernel.flash_self_attention(q, q, q, 0.2)
    attention_kernel.self_attention_plain(q, q, q, 0.2)
    counts = ops.launch_counts()
    assert counts["flash_self_attention"] == 2
    assert counts["gn_silu_conv3x3"] == counts["ln_matmul"] == counts["geglu_matmul"] == 0


def test_tiny_slice_on_the_card_matches_cpu(cuda):
    """The whole tiny t5 slice in f32 on the card (its kernels where the
    shapes take them) against the same slice on the CPU (plain versions)."""
    import audioldm2_torch as at
    from audioldm2_torch import params as tparams
    from tiny import tiny_t5_model_config

    cfg = tiny_t5_model_config()
    tree = tparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu", nonzero=True)
    x_T = torch.randn((1, 16, cfg.latent_f_size, cfg.latent_channels),
                      generator=torch.Generator().manual_seed(1))
    mels = []
    for dev in ("cpu", cuda):
        model = at.build_model(config=cfg, device=dev, params=tparams.map_tree(np.asarray, tree))
        batch = model.make_batch("a dog barking")
        _, mel = model.ldm.generate(batch, None, latent_t_size=16, ddim_steps=4, ddim_eta=0.0,
                                    x_T=x_T.to(dev))
        mels.append(mel)
    assert float(np.abs(mels[0] - mels[1]).mean()) < 1e-3
