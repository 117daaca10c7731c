"""The port's training data pipeline (``audioldm2_torch/utils/data.py``)
and Kaldi fbank against the JAX package's, on the CPU.

The same temp wav files and manifest as ``test_data.py``'s fixture (four
noise clips at 1600 Hz and one corrupt file) go through both
``AudioDataset``s with one seed. Tolerances: the log-mel fbank within
1e-5, the normalized Kaldi fbank within 1e-4; token and phoneme ids,
example order and sampler indices identical.
"""

import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

from audioldm2_torch.config import coerce
from audioldm2_torch.ops.stft import KaldiFbank as TKaldi
from audioldm2_torch.ops.stft import _kaldi_mel_banks as t_banks
from audioldm2_torch.utils import data as tdata
from audioldm2_tpu.ops.stft import KaldiFbank as JKaldi
from audioldm2_tpu.ops.stft import _kaldi_mel_banks as j_banks
from audioldm2_tpu.utils import data as jdata
from tiny import tiny_t5_model_config


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("audio")
    sr = 1600
    entries = []
    rng = np.random.default_rng(0)
    for i in range(4):
        wav = (0.3 * rng.standard_normal(sr * 2)).astype(np.float32)
        p = str(tmp_path / f"a{i}.wav")
        wavfile.write(p, sr, (wav * 32767).astype(np.int16))
        entries.append({"wav": p, "caption": f"sound number {i}",
                        "transcription": "hello world" if i == 2 else "",
                        "labels": "dog,bark" if i % 2 else "rain"})
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav")
    entries.insert(1, {"wav": bad, "caption": "corrupt"})
    meta = str(tmp_path / "meta.json")
    with open(meta, "w") as f:
        json.dump({"data": entries}, f)
    return meta, entries


def _datasets(meta, seed=0):
    kw = dict(metadata_paths=[meta], sampling_rate=1600, duration=0.64,
              add_ons=("kaldi_fbank", "phoneme_and_text"))
    cfg = tiny_t5_model_config()
    return (jdata.AudioDataset(jdata.DatasetConfig(**kw), cfg, seed=seed),
            tdata.AudioDataset(tdata.DatasetConfig(**kw), coerce(cfg), seed=seed))


def _same_batch(jb, tb):
    assert jb.keys() == tb.keys()
    assert jb["text"] == tb["text"]
    np.testing.assert_allclose(tb["fbank"], np.asarray(jb["fbank"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb["ta_kaldi_fbank"], np.asarray(jb["ta_kaldi_fbank"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(tb["waveform"], jb["waveform"])
    for k in jb:
        if k.endswith(("_ids", "_mask")) or k == "phoneme_idx":
            np.testing.assert_array_equal(tb[k], jb[k])
            assert tb[k].dtype == jb[k].dtype, k


def test_batches_match_jax_in_order_and_values(manifest):
    """Two epochs of shuffled batches of 2 (random crops included, the
    corrupt entry retried onto the next file): the same examples in the
    same order, the same arrays within the tolerances."""
    jds, tds = _datasets(manifest[0], seed=3)
    jit, tit = jds.batches(2), tds.batches(2)
    for _ in range(4):
        _same_batch(next(jit), next(tit))


def test_example_shapes_and_phonemes(manifest):
    jds, tds = _datasets(manifest[0])
    ex = tds.example(3)  # the entry with a transcription
    assert ex["fbank"].shape == (64, 16, 1) and ex["fbank"].dtype == np.float32
    assert ex["waveform"].shape == (1024,)
    assert ex["ta_kaldi_fbank"].shape == (1024, 128)
    assert ex["phoneme_idx"].shape == (310,)
    np.testing.assert_array_equal(ex["phoneme_idx"], jds.example(3)["phoneme_idx"])
    assert ex["phoneme_idx"][1] != 0  # more than the end mark


def test_corrupt_file_skipped(manifest):
    jds, tds = _datasets(manifest[0])
    ex = tds.example(1)  # the corrupt entry: the retry lands on the next file
    assert np.isfinite(ex["fbank"]).all() and ex["text"] == "sound number 1"
    assert ex["text"] == jds.example(1)["text"]


def test_collate_keys_and_shapes(manifest):
    _, tds = _datasets(manifest[0])
    batch = next(tds.batches(2, shuffle=False))
    assert set(batch) == {"fbank", "waveform", "ta_kaldi_fbank", "phoneme_idx", "text", "t5_ids",
                          "t5_mask", "t5_uncond_ids", "t5_uncond_mask", "clap_ids", "clap_mask",
                          "clap_uncond_ids", "clap_uncond_mask"}
    assert batch["fbank"].shape == (2, 64, 16, 1)
    assert batch["ta_kaldi_fbank"].shape == (2, 1024, 128)
    assert batch["t5_ids"].shape == (2, 16) and batch["t5_uncond_ids"].shape == (1, 16)
    assert batch["clap_ids"].shape == (2, 512)
    assert all(isinstance(v, (np.ndarray, list)) for v in batch.values())


def test_full_width_mel_has_the_reference_frame_count(manifest):
    """At audioldm_16k_crossattn_t5's 16 kHz and hop 160 a 10.24 s clip is
    1024 frames (the reference's duration * sr / hop), whose 256-frame
    latent the UNet takes; the JAX package's latent_t_per_second *
    downsample_factor would give 1048."""
    import audioldm2_torch as at

    cfg = at.default_audioldm_config("audioldm_16k_crossattn_t5")
    ds = tdata.AudioDataset(tdata.DatasetConfig(metadata_paths=[manifest[0]]), cfg)
    assert ds.target_frames == 1024 and ds.segment_samples == 163840
    assert ds.target_frames // cfg.vae.downsample_factor == cfg.latent_t_size


@pytest.mark.parametrize("seed", [0, 7])
def test_balanced_sampler_matches_jax(manifest, seed):
    entries = manifest[1]
    js, ts = jdata.BalancedSampler(entries, seed=seed), tdata.BalancedSampler(entries, seed=seed)
    np.testing.assert_array_equal(ts.weights, js.weights)
    for n in (5, 17):
        np.testing.assert_array_equal(ts.sample(n), js.sample(n))


def _chirp(sr=16000, seconds=2.0, noise=0.3):
    """A linear chirp over most of the band plus noise, peak 0.5."""
    t = np.arange(int(sr * seconds)) / sr
    f0, f1 = 0.01 * sr, 0.45 * sr
    x = np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * seconds)))
    x = x + noise * np.random.default_rng(0).standard_normal(t.shape)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)[None]


def test_kaldi_fbank_matches_jax():
    """The mel banks within 1e-7; the log-fbank within 1e-4 plus 1e-4 of
    its value and the normalized fbank within 1e-4, on a chirp with noise.
    The log-fbank is held partly relative to its value because the f32 DFT's
    rounding grows where preemphasis leaves the least power (the lowest mel
    bins): JAX's own f32 result lies 2.5e-2 from an f64 computation at
    such a bin of a bare chirp."""
    np.testing.assert_allclose(t_banks(128, 512, 16000.0), j_banks(128, 512, 16000.0),
                               rtol=0, atol=1e-7)
    wav = _chirp()
    tk, jk = TKaldi(), JKaldi()
    got, want = tk(wav).numpy(), np.asarray(jk(jax.numpy.asarray(wav)))
    assert got.shape == want.shape == (1, 198, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    got = tk.normalized(torch.from_numpy(wav)).numpy()
    want = np.asarray(jk.normalized(jax.numpy.asarray(wav)))
    assert got.shape == want.shape == (1, 1024, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
