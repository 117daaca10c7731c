"""The port's CLI (``python -m audioldm2_torch``) against the JAX package's
(audioldm2_tpu/cli.py) on the CPU.

The parser action by action (option strings, dests, defaults, choices,
types); ``main()`` with both packages' build_model, text_to_audio and
super_resolution_and_inpainting stubbed (recording their arguments and
returning a waveform made from the prompt): the same folders and file
names, the same model names built (the TTS switch) and the same calls, for
a ``-tl`` list with ``prompt|name`` lines and a batch of 2, the TTS switch,
the sr mode and the 48k family; ``-d auto`` without CUDA raises; and one
real run of the port's CLI on a tiny t5 model with ``-d cpu``."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audioldm2_torch import cli as tcli
from audioldm2_torch import pipeline as tpipe
from audioldm2_tpu import cli as jcli
from audioldm2_tpu import pipeline as jpipe
from tiny import tiny_t5_model_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("option_strings", "dest", "default", "choices", "type", "nargs", "required", "const")


def test_parser_matches_jax_action_by_action():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    assert len(jp._actions) == len(tp._actions) == 17  # --help and 16 options
    for ja, ta in zip(jp._actions, tp._actions):
        for field in FIELDS:
            assert getattr(ta, field) == getattr(ja, field), (ja.dest, field)
    argv = ["-t", "rain", "--model_name", "audioldm_48k", "-b", "2", "-gs", "2.5", "-dur", "5",
            "-n", "1", "--sampler", "plms", "--seed", "3", "-d", "cpu", "--ddim_steps", "7"]
    assert vars(tp.parse_args(argv)) == vars(jp.parse_args(argv))
    assert vars(tp.parse_args([])) == vars(jp.parse_args([]))


@pytest.mark.parametrize("argv", [["--model_name", "audioldm3"], ["--sampler", "euler"],
                                  ["--mode", "edit"], ["-b", "two"]])
def test_parser_refuses_what_jax_refuses(argv, capsys):
    for parser in (jcli.build_parser(), tcli.build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(argv)


def _stub(monkeypatch, pipe, cli, calls):
    """Record build_model's model name and each generation call; the
    waveform [b, 1, n] is a tone whose pitch follows the prompt's length."""
    monkeypatch.setattr(cli, "get_time", lambda: "01_01_2026_00_00_00")
    monkeypatch.setattr(pipe, "build_model",
                        lambda ckpt_path=None, model_name="audioldm2-full", **kw:
                        calls.append(("build", model_name, ckpt_path)) or model_name)

    def gen(kind):
        def fn(model, text, **kw):
            calls.append((kind, model, text, sorted(kw.items())))
            n = int(kw["duration"] * 16000)
            t = np.arange(n) / 16000.0
            wav = 0.5 * np.sin(2 * np.pi * (100 + len(text)) * t).astype(np.float32)
            return np.tile(wav, (kw["batchsize"], 1, 1))
        return fn

    monkeypatch.setattr(pipe, "text_to_audio", gen("t2a"))
    monkeypatch.setattr(pipe, "super_resolution_and_inpainting", gen("sr"))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            sr, data = wavfile.read(os.path.join(d, n))
            out[rel] = (sr, data.shape, data.dtype.str)
    return out


def _both(monkeypatch, tmp_path, argv):
    """Run both CLIs on ``argv`` (``{out}`` their own output folder);
    returns ({file: (rate, shape, dtype)}, calls) of each."""
    runs = []
    for tag, pipe, cli in (("jax", jpipe, jcli), ("torch", tpipe, tcli)):
        calls = []
        _stub(monkeypatch, pipe, cli, calls)
        out = str(tmp_path / tag)
        args = [a.replace("{out}", out) for a in argv]
        if cli is tcli:
            args += ["-d", "cpu"]
        assert cli.main(args) == 0
        runs.append((_files(out), calls))
    return runs


def test_main_text_list_names_and_folders(monkeypatch, tmp_path):
    lst = tmp_path / "prompts.lst"
    long = "a very long prompt " * 10
    lst.write_text(f"A dog barking|dog\nRain on a roof\n{long}\n")
    (jf, jc), (tf, tc) = _both(monkeypatch, tmp_path, [
        "-tl", str(lst), "-s", "{out}", "--model_name", "audioldm_16k_crossattn_t5", "-b", "2",
        "-dur", "0.5", "-n", "1", "--ddim_steps", "3"])
    assert tf == jf
    assert sorted(tf) == sorted(
        os.path.join("01_01_2026_00_00_00", f"{stem}_{i}.wav") for i in (0, 1)
        for stem in ("dog", "Rain on a roof", long[:128]))
    assert tc == jc and jc[0] == ("build", "audioldm_16k_crossattn_t5", None)
    assert [c[2] for c in tc[1:]] == ["A dog barking", "Rain on a roof", long]


def test_main_tts_switch(monkeypatch, tmp_path):
    (jf, jc), (tf, tc) = _both(monkeypatch, tmp_path, [
        "--transcription", "hello there", "-s", "{out}", "--model_name", "audioldm2-full",
        "--ddim_steps", "2"])
    assert tf == jf
    assert list(tf) == [os.path.join("01_01_2026_00_00_00",
                                     "A female reporter is speaking full of emotion-TTS-"
                                     "hello there.wav")]
    assert tc == jc and tc[0][1] == "audioldm2-speech-gigaspeech"
    kw = dict(tc[1][3])
    assert kw["duration"] == 10 and kw["transcription"] == "hello there"  # audioldm2-*: 10 s


def test_main_sr_mode_and_48k(monkeypatch, tmp_path):
    wav = tmp_path / "in.wav"
    wavfile.write(str(wav), 48000, np.zeros(4800, np.int16))
    (jf, jc), (tf, tc) = _both(monkeypatch, tmp_path, [
        "--mode", "sr_inpainting", "-f", str(wav), "-t", "a chirp", "-s", "{out}",
        "--model_name", "audioldm_48k", "-dur", "0.25", "-n", "2"])
    assert tf == jf == {os.path.join("01_01_2026_00_00_00", "a chirp.wav"):
                        (48000, (4000,), "<i2")}
    assert tc == jc and tc[1][0] == "sr"
    assert dict(tc[1][3])["original_audio_file_path"] == str(wav)


def test_main_sr_mode_refuses_a_missing_file(monkeypatch, tmp_path):
    _stub(monkeypatch, tpipe, tcli, [])
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tcli.main(["--mode", "sr_inpainting", "-f", str(tmp_path / "none.wav"), "-s",
                   str(tmp_path), "-d", "cpu"])


def test_device_auto_needs_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-d auto"):
        tcli.resolve_device("auto")
    calls = []
    _stub(monkeypatch, tpipe, tcli, calls)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-t", "rain", "-s", str(tmp_path)])
    assert calls == []  # refused before any model is built
    assert tcli.resolve_device("cpu") == torch.device("cpu")
    assert tcli.resolve_device("cuda:1") == torch.device("cuda", 1)


def test_device_auto_picks_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tcli.resolve_device("auto") == torch.device("cuda", 0)


def test_cli_runs_a_tiny_model_on_the_cpu(monkeypatch, tmp_path, capsys):
    """build_model stubbed to the tiny t5 config on the device the CLI chose;
    the rest of main is real."""
    real = tpipe.build_model
    seen = []

    def tiny(ckpt_path=None, model_name="audioldm2-full", device=None, **kw):
        seen.append(device)
        # 51.2 latent frames a second: the 2.5 s bucket is 128 frames, which
        # the tiny UNet's halvings take
        cfg = dataclasses.replace(tiny_t5_model_config(), latent_t_per_second=51.2)
        return real(config=cfg, device=device, seed=0, nonzero_init=True)

    monkeypatch.setattr(tpipe, "build_model", tiny)
    monkeypatch.setattr(tcli, "get_time", lambda: "now")
    assert tcli.main(["-t", "rain on a roof", "-s", str(tmp_path), "--model_name",
                      "audioldm_16k_crossattn_t5", "-dur", "0.64", "-n", "1", "--ddim_steps",
                      "2", "-d", "cpu"]) == 0
    assert seen == [torch.device("cpu")]
    assert "audioldm_16k_crossattn_t5 on cpu" in capsys.readouterr().out
    sr, data = wavfile.read(str(tmp_path / "now" / "rain on a roof.wav"))
    assert sr == 16000 and data.dtype == np.int16 and data.shape == (1024,)  # 0.64 s at 1600 Hz


def test_python_m_refuses_auto_without_cuda():
    """``python -m audioldm2_torch`` in a fresh process on this CPU-only
    machine: -d auto fails before any model is built, importing no jax."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: -d auto would run")
    code = ("import sys; sys.argv = ['audioldm2_torch', '-t', 'x', '-s', sys.argv[1]]; "
            "import audioldm2_torch.cli as c\n"
            "try:\n    c.main(sys.argv[1:])\nexcept RuntimeError as e:\n    print('REFUSED', e)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'audioldm2_tpu'))\n"
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code, "/nonexistent"], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "REFUSED -d auto" in out.stdout
