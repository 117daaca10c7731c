"""The inverse half of the port's ops/stft.py against the JAX package's
(CPU, f32): the synthesis basis and the window envelope (numpy, equal),
frame_signal, istft, stft_full and griffin_lim with the initial phase
injected (JAX draws it from a key, the port takes it or a generator).
Tolerance: max|port - jax| <= TOL * max(1, max|jax|), TOL 1e-5 for one
transform; the phase, where its bin carries energy, within 1e-3 rad modulo
2 pi (atan2 at +-pi may land on either side); Griffin-Lim 1e-3: each round
feeds the phase of the last, so the f32 summation-order differences of the
transforms grow with the rounds (at 1024 / 160 / 1024 on these inputs,
measured 2.0e-6 after 1 round, 2.6e-5 after 20, 4.0e-4 after 30; at
64 / 16 / 64 at most 4.2e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioldm2_tpu.ops import stft as jstft
from audioldm2_torch.ops import stft as tstft

torch.set_num_threads(2)

GEOMS = [(64, 16, 64), (1024, 160, 1024), (64, 16, 48)]  # filter, hop, win


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _signal(n, seed=0, b=2):
    """A chirp plus a little noise per row."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / n
    rows = [np.sin(2 * np.pi * (20 + 200 * (i + 1) * t) * t) + 0.05 * rng.standard_normal(n)
            for i in range(b)]
    return (0.5 * np.stack(rows)).astype(np.float32)


@pytest.mark.parametrize("f,h,w", GEOMS)
def test_bases_equal_jax(f, h, w):
    np.testing.assert_array_equal(tstft.inverse_stft_basis(f, w), jstft.inverse_stft_basis(f, w))
    for frames in (1, 7, 101):
        np.testing.assert_array_equal(tstft.window_sumsquare(w, f, h, frames),
                                      jstft.window_sumsquare(w, f, h, frames))


def test_frame_signal_matches_jax():
    x = _signal(300)
    want = jstft.frame_signal(jnp.asarray(x), 64, 16)
    got = tstft.frame_signal(torch.from_numpy(x), 64, 16)
    assert got.shape == (2, 1 + (300 - 64) // 16, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("f,h,w", GEOMS)
def test_stft_full_and_istft_match_jax(f, h, w):
    x = _signal(h * 40)
    basis = jstft.stft_basis(f, w)
    mag_j, ph_j = jstft.stft_full(jnp.asarray(x), jnp.asarray(basis), f, h)
    mag_t, ph_t = tstft.stft_full(torch.from_numpy(x), torch.from_numpy(basis), f, h)
    _close(mag_t, mag_j, 1e-5)
    # the phase where the bin carries energy (elsewhere atan2 of rounding noise)
    live = np.asarray(mag_j) > 1e-3 * float(np.asarray(mag_j).max())
    d = (ph_t.numpy() - np.asarray(ph_j) + np.pi) % (2 * np.pi) - np.pi
    assert float(np.abs(d[live]).max()) <= 1e-3
    rng = np.random.default_rng(1)
    mag = np.abs(rng.standard_normal(np.shape(mag_j))).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, np.shape(mag_j)).astype(np.float32)
    want = jstft.istft(jnp.asarray(mag), jnp.asarray(ph), f, h, w)
    got = tstft.istft(torch.from_numpy(mag), torch.from_numpy(ph), f, h, w)
    assert got.shape == (2, h * (mag.shape[-1] - 1))
    _close(got, want, 1e-5)


def test_istft_inverts_stft_full():
    """With its own magnitude and phase the inverse gives the signal back
    (away from the edges)."""
    f, h, w = 64, 16, 64
    x = _signal(h * 64)
    mag, ph = tstft.stft_full(torch.from_numpy(x), torch.from_numpy(tstft.stft_basis(f, w)), f, h)
    y = tstft.istft(mag, ph, f, h, w)
    np.testing.assert_allclose(y.numpy()[:, f:-f], x[:, f:y.shape[1] - f], atol=1e-4)


@pytest.mark.parametrize("n_iters", [1, 5, 30])
@pytest.mark.parametrize("f,h,w", GEOMS[:2])
def test_griffin_lim_matches_jax(f, h, w, n_iters):
    x = _signal(h * 40, seed=2)
    mag, _ = jstft.stft_full(jnp.asarray(x), jnp.asarray(jstft.stft_basis(f, w)), f, h)
    key = jax.random.PRNGKey(3)
    phase0 = jax.random.uniform(key, mag.shape, jnp.float32, -np.pi, np.pi)  # stft.py:418-419
    want = jstft.griffin_lim(mag, f, h, w, n_iters=n_iters, key=key)
    got = tstft.griffin_lim(torch.tensor(np.asarray(mag)), f, h, w, n_iters=n_iters,
                            phase=torch.tensor(np.asarray(phase0)))
    _close(got, want, 1e-3)


def test_griffin_lim_draws_its_phase_from_the_generator():
    mag = torch.rand((1, 33, 12))
    a = tstft.griffin_lim(mag, 64, 16, 64, n_iters=2, generator=torch.Generator().manual_seed(0))
    b = tstft.griffin_lim(mag, 64, 16, 64, n_iters=2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == (1, 16 * 11)
    with pytest.raises(ValueError, match="initial phase or a generator"):
        tstft.griffin_lim(mag, 64, 16, 64)
