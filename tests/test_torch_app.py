"""The port's demo (audioldm2_torch/app.py) against the repo's root app.py
(the JAX package's), without gradio: the rates, choices and default, the
background image's pixels, the waveform frames, the renderer ladder at
batch 1 and batch 3 (no ffmpeg: audio tuples), the model cache, text2audio
on a tiny model, the UI on a stand-in gradio (the share button inert) and
main() without gradio."""

import dataclasses
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import app as japp  # noqa: E402
from audioldm2_torch import app as tapp  # noqa: E402
from audioldm2_torch import config as tconfig  # noqa: E402
from audioldm2_torch import pipeline as tpipe  # noqa: E402
from tiny import tiny_t5_model_config  # noqa: E402


def test_choices_default_and_rates_match_the_root_app():
    assert tapp.MODEL_CHOICES == japp.MODEL_CHOICES
    assert tapp.DEFAULT_CHECKPOINT == japp.DEFAULT_CHECKPOINT == "audioldm_48k"
    for name in japp.MODEL_CHOICES + ["audioldm2-full-large-1150k", "audioldm2-speech-ljspeech"]:
        assert tapp.family_rates(name) == japp.family_rates(name)
    for name in tapp.MODEL_CHOICES:
        assert tconfig.default_audioldm_config(name).name == name
    assert tconfig.default_audioldm_config("audioldm_crossattn_flant5").unet.context_dims == (1024,)
    assert tapp.EXAMPLES == japp.EXAMPLES


def test_bg_image_pixels_match(tmp_path):
    from PIL import Image

    a = np.asarray(Image.open(tapp.make_bg_image(str(tmp_path / "t.png"), width=64, height=32)))
    b = np.asarray(Image.open(japp.make_bg_image(str(tmp_path / "j.png"), width=64, height=32)))
    assert a.shape == (32, 64, 3) and np.array_equal(a, b)


@pytest.mark.parametrize("progress", [0.0, 0.37, 1.0])
def test_waveform_frames_match(progress):
    wav = np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    bg = np.full((80, 200, 3), 7, np.uint8)
    for kw in (dict(), dict(bg=bg)):
        got = tapp.waveform_frame(wav, width=200, height=80, bars=20, progress=progress, **kw)
        want = japp.waveform_frame(wav, width=200, height=80, bars=20, progress=progress, **kw)
        assert got.shape == (80, 200, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("bs", [1, 3])
def test_render_outputs_without_ffmpeg(monkeypatch, bs):
    monkeypatch.setattr(tapp.shutil, "which", lambda name: None)
    monkeypatch.setattr(japp.shutil, "which", lambda name: None)
    wav = (np.random.default_rng(1).uniform(-1.2, 1.2, (bs, 1, 800))).astype(np.float32)
    assert tapp.make_waveform_video(16000, wav[0, 0]) is None
    got, want = tapp.render_outputs(16000, wav), japp.render_outputs(16000, wav)
    if bs == 1:
        got, want = [got], [want]
    assert len(got) == len(want) == bs
    for (sr, a), (sr_j, b) in zip(got, want):
        assert sr == sr_j == 16000 and a.dtype == np.int16 and np.array_equal(a, b)


def test_model_cache_builds_once_per_name(monkeypatch):
    built = []
    monkeypatch.setattr(tpipe, "build_model",
                        lambda model_name="audioldm2-full", **kw: built.append(model_name)
                        or object())
    cache = tapp.ModelCache()
    a = cache.get("audioldm_crossattn_flant5")
    assert cache.get("audioldm_crossattn_flant5") is a and built == ["audioldm_crossattn_flant5"]
    b = cache.get("audioldm_48k")
    assert b is not a and cache.get("audioldm_48k") is b
    assert built == ["audioldm_crossattn_flant5", "audioldm_48k"]
    monkeypatch.setattr(tapp, "MODELS", cache)
    assert tapp.get_model("audioldm_48k") is b and len(built) == 2


def test_text2audio_on_a_tiny_model(monkeypatch):
    """text2audio builds through the cache (build_model stubbed to the tiny
    t5 config on the CPU), generates at 200 DDIM steps and renders."""
    cfg = dataclasses.replace(tiny_t5_model_config(), latent_t_per_second=51.2)
    real_build, real_t2a = tpipe.build_model, tpipe.text_to_audio
    built, steps = [], []
    monkeypatch.setattr(tpipe, "build_model", lambda model_name="", **kw: built.append(
        model_name) or real_build(config=cfg, device="cpu", seed=0, nonzero_init=True))
    monkeypatch.setattr(tpipe, "text_to_audio", lambda m, t, **kw: steps.append(
        kw["ddim_steps"]) or real_t2a(m, t, **kw))
    monkeypatch.setattr(tapp, "MODELS", tapp.ModelCache())
    monkeypatch.setattr(tapp.shutil, "which", lambda name: None)
    torch.manual_seed(0)
    sr, audio = tapp.text2audio("rain on a roof", duration=0.64, n_candidates=1,
                                model_name="audioldm_crossattn_flant5")
    assert sr == 16000 and audio.dtype == np.int16 and audio.shape == (1024,)
    assert np.abs(audio).max() > 0 and steps == [200]
    tapp.text2audio("wind", duration=0.64, n_candidates=1, model_name="audioldm_crossattn_flant5")
    assert built == ["audioldm_crossattn_flant5"]


def test_ui_on_a_stand_in_gradio_keeps_share_inert(monkeypatch):
    gr = mock.MagicMock()
    del gr.make_waveform
    monkeypatch.setitem(sys.modules, "gradio", gr)
    monkeypatch.setattr(tapp.shutil, "which", lambda name: None)
    tapp.build_ui()
    clicks = gr.Button.return_value.click.call_args_list
    assert mock.call(None, [], []) in clicks
    assert all("js" not in c.kwargs and "_js" not in c.kwargs for c in clicks)
    submit = [c for c in clicks if c.args and c.args[0] is tapp.text2audio]
    assert len(submit) == 1 and submit[0].kwargs["api_name"] == "text2audio"
    assert gr.Audio.called and not gr.Video.called  # no ffmpeg, no make_waveform
    assert tapp.main() == 0
    assert gr.Blocks.return_value.__enter__.return_value.launch.called


def test_main_without_gradio(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio raises ImportError
    assert tapp.main() == 1
    assert "gradio is not installed" in capsys.readouterr().out
