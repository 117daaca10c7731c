"""Gradio web demo of the port: the counterpart of the repo's root
``app.py`` (the JAX package's demo, itself the reference ``app.py``'s
surface) on :mod:`audioldm2_torch.pipeline`, on the CUDA card.

    python -m audioldm2_torch.app        # needs gradio

The same model dropdown, lazy model cache keyed by name, per-family rates,
waveform -> video renderer ladder (gradio's ``make_waveform`` where the
installed gradio has it, then an ffmpeg render of PIL frames, then plain
``(sample_rate, int16)`` audio), ``text2audio`` at 200 DDIM steps, and the
Blocks UI. The community-share button is drawn and stays inert: it has no
callback (the reference leaves its share script unwired too).

gradio is not a dependency: ``main()`` exits with a message when it is
missing, and the pure-python pieces are tested without it
(tests/test_torch_app.py).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import warnings
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_CHECKPOINT = "audioldm_48k"  # reference app.py:12

# Dropdown entries as the reference spells them (app.py:263-265); the
# config factory dispatches on substrings so the middle alias resolves to
# the t5 family preset.
MODEL_CHOICES = ["audioldm_48k", "audioldm_crossattn_flant5", "audioldm2-full"]


class ModelCache:
    """Holds the last model built, keyed by checkpoint name: a request for
    the same name returns it, another name replaces it (reference
    app.py:26-29). Models are built by the port's ``build_model`` on the
    card (random weights unless a checkpoint is found)."""

    def __init__(self):
        self.name: Optional[str] = None
        self.model = None

    def get(self, model_name: str):
        if self.model is None or model_name != self.name:
            from audioldm2_torch.pipeline import build_model

            self.model = None  # free the old model's memory before the build
            self.model = build_model(model_name=model_name)
            self.name = model_name
        return self.model


MODELS = ModelCache()


def get_model(model_name: str):
    """The demo's model for ``model_name``, from its one cache."""
    return MODELS.get(model_name)


def family_rates(model_name: str) -> Tuple[float, int]:
    """(latent_t_per_second, sample_rate) per family — reference
    app.py:32-37."""
    if "48k" in model_name:
        return 12.8, 48000
    return 25.6, 16000


# ---------------------------------------------------------------------------
# waveform -> video artifacts
# ---------------------------------------------------------------------------


def make_bg_image(path: str, width: int = 1000, height: int = 400) -> str:
    """Generate the gradient background the reference ships as ``bg.png``
    (the file itself is binary repo data we do not copy)."""
    from PIL import Image

    top = np.array([22, 26, 40], np.float32)
    bottom = np.array([60, 30, 90], np.float32)
    ramp = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    img = (top * (1 - ramp) + bottom * ramp).astype(np.uint8)
    img = np.broadcast_to(img, (height, width, 3)).copy()
    Image.fromarray(img).save(path)
    return path


def waveform_frame(
    wav: np.ndarray,
    width: int = 1000,
    height: int = 400,
    bars: int = 100,
    progress: float = 1.0,
    bg: Optional[np.ndarray] = None,
) -> np.ndarray:
    """One video frame: amplitude bars over the background, with the bars
    left of ``progress`` highlighted (the sweep the reference's
    gr.make_waveform renders). Pure numpy/PIL — unit-testable."""
    if bg is None:
        ramp = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
        frame = np.stack(
            [22 + 38 * ramp, 26 + 4 * ramp, 40 + 50 * ramp], axis=-1
        ).astype(np.uint8)
        frame = np.broadcast_to(frame, (height, width, 3)).copy()
    else:
        frame = bg.copy()
    mono = np.abs(np.asarray(wav, np.float32)).reshape(-1)
    seg = len(mono) // bars
    amps = mono[: seg * bars].reshape(bars, seg).max(axis=1)
    amps = amps / max(float(amps.max()), 1e-6)
    bar_w = width // bars
    mid = height // 2
    lit = int(round(progress * bars))
    for i, a in enumerate(amps):
        h = max(2, int(a * (height // 2 - 10)))
        x0, x1 = i * bar_w + 1, (i + 1) * bar_w - 1
        color = (255, 255, 255) if i < lit else (140, 140, 150)
        frame[mid - h : mid + h, x0:x1] = color
    return frame


def make_waveform_video(
    sample_rate: int, wav: np.ndarray, out_path: Optional[str] = None, fps: int = 10
) -> Optional[str]:
    """Render the reference's output artifact (waveform video with the
    audio track) without gradio internals. Returns the mp4 path, or None
    when ffmpeg is unavailable (callers fall back to raw audio)."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return None
    import wave as wave_mod

    from PIL import Image

    tmp = tempfile.mkdtemp(prefix="audioldm2_vid_")
    wav = np.asarray(wav, np.float32).reshape(-1)
    dur = len(wav) / sample_rate
    n_frames = max(int(dur * fps), 1)
    for f in range(n_frames):
        frame = waveform_frame(wav, progress=(f + 1) / n_frames)
        Image.fromarray(frame).save(os.path.join(tmp, f"f{f:05d}.png"))
    wav_path = os.path.join(tmp, "audio.wav")
    with wave_mod.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
    out_path = out_path or os.path.join(tmp, "out.mp4")
    subprocess.run(
        [
            ffmpeg, "-y", "-framerate", str(fps),
            "-i", os.path.join(tmp, "f%05d.png"),
            "-i", wav_path, "-c:v", "libx264", "-pix_fmt", "yuv420p",
            "-c:a", "aac", "-shortest", out_path,
        ],
        check=True,
        capture_output=True,
    )
    return out_path


def render_outputs(sample_rate: int, waveform: np.ndarray):
    """waveform [bs, 1, samples] -> list of display artifacts: videos when
    renderable (gr.make_waveform, then our ffmpeg path), else audio tuples
    — collapsing to the bare artifact for bs==1 like reference app.py:51-53."""
    outs: List[object] = []
    for wave in waveform:
        video = None
        try:  # 1) gradio's own renderer (gradio < 5, with ffmpeg)
            import gradio as gr
        except ImportError:
            gr = None
        if gr is not None and hasattr(gr, "make_waveform"):
            bg = os.path.join(tempfile.gettempdir(), "audioldm2_bg.png")
            try:
                if not os.path.exists(bg):
                    make_bg_image(bg)
                video = gr.make_waveform((sample_rate, wave[0]), bg_image=bg)
            except Exception as e:  # a UI boundary: the next rung renders instead
                warnings.warn(f"gradio.make_waveform failed ({e!r}); trying ffmpeg")
        if video is None:  # 2) our renderer
            try:
                video = make_waveform_video(sample_rate, wave[0])
            except (OSError, ImportError, subprocess.CalledProcessError) as e:
                warnings.warn(f"the ffmpeg render failed ({e!r}); returning audio")
        if video is None:  # 3) raw audio
            outs.append((sample_rate, (np.clip(wave[0], -1, 1) * 32767).astype(np.int16)))
        else:
            outs.append(video)
    return outs[0] if len(outs) == 1 else outs


def text2audio(
    text: str,
    duration: float = 10.0,
    guidance_scale: float = 3.5,
    random_seed: int = 45,
    n_candidates: int = 3,
    model_name: str = DEFAULT_CHECKPOINT,
):
    """Reference app.py:16-54: build or reuse the model, generate at 200
    DDIM steps, render."""
    from audioldm2_torch.pipeline import text_to_audio

    model = get_model(model_name)
    _, sample_rate = family_rates(model_name)
    waveform = text_to_audio(
        model,
        text,
        seed=int(random_seed),
        duration=float(duration),
        guidance_scale=float(guidance_scale),
        ddim_steps=200,
        n_candidate_gen_per_text=int(n_candidates),
    )  # [bs, 1, samples]
    return render_outputs(sample_rate, waveform)


# ---------------------------------------------------------------------------
# UI (reference app.py:160-379)
# ---------------------------------------------------------------------------

CSS = """
        a { color: inherit; text-decoration: underline; }
        .gradio-container { font-family: 'IBM Plex Sans', sans-serif; }
        .gr-button { color: white; border-color: #000000; background: #000000; white-space: nowrap; }
        input[type='range'] { accent-color: #000000; }
        .dark input[type='range'] { accent-color: #dfdfdf; }
        .container { max-width: 730px; margin: auto; padding-top: 1.5rem; }
        #gallery { min-height: 22rem; margin: 0 auto 15px auto; border-bottom-right-radius: .5rem !important; border-bottom-left-radius: .5rem !important; }
        #advanced-btn { font-size: .7rem !important; line-height: 19px; margin: 12px 0; padding: 2px 8px; border-radius: 14px !important; }
        .footer { margin-bottom: 45px; margin-top: 35px; text-align: center; border-bottom: 1px solid #e5e5e5; }
        .footer > p { font-size: .8rem; display: inline-block; padding: 0 10px; transform: translateY(10px); background: white; }
        .dark .footer { border-color: #303030; }
        .dark .footer > p { background: #0b0f19; }
        .acknowledgments h4 { margin: 1.25em 0 .25em 0; font-weight: bold; font-size: 115%; }
        #share-btn-container { display: flex; padding: 0 0.5rem !important; background-color: #000000; justify-content: center; align-items: center; border-radius: 9999px !important; width: 13rem; margin-top: 10px; margin-left: auto; }
        #share-btn { all: initial; color: #ffffff; font-weight: 600; cursor: pointer; font-family: 'IBM Plex Sans', sans-serif; margin-left: 0.5rem !important; padding: 0.25rem 0 !important; right: 0; }
        #generated_id { min-height: 700px; }
"""

HEADER_HTML = """
    <div style="text-align: center; max-width: 700px; margin: 0 auto;">
      <h1 style="font-weight: 900; margin-bottom: 7px; line-height: normal;">
        AudioLDM 2: A General Framework for Audio, Music, and Speech Generation
      </h1>
      <p style="margin-bottom: 10px; font-size: 94%">
        <a href="https://arxiv.org/abs/2301.12503">[Paper]</a>
        <a href="https://audioldm.github.io/audioldm2">[Project page]</a>
      </p>
    </div>
"""

FOOTER_HTML = """
    <div class="footer" style="text-align: center; max-width: 700px; margin: 0 auto;">
      <p>Follow the latest updates of AudioLDM 2 on the
        <a href="https://github.com/haoheliu/AudioLDM2" target="_blank">Github repo</a>
      </p><br>
      <p>Model by <a href="https://twitter.com/LiuHaohe" target="_blank">Haohe Liu</a>;
         PyTorch + CUDA port served by audioldm2_torch.</p><br>
    </div>
"""

TIPS_HTML = """
    <div class="acknowledgements">
      <p>Essential tricks for enhancing the quality of your generated audio:</p>
      <p>1. Use more adjectives to describe your sound — "A man is speaking
         clearly and slowly in a large room" beats "A man is speaking".</p>
      <p>2. Try different random seeds; they can affect generation quality
         significantly.</p>
      <p>3. Prefer general terms like 'man' or 'woman' over specific names.</p>
    </div>
"""

ACK_HTML = """
    <div class="acknowledgments">
      <p>The model was built with data from
        <a href="http://research.google.com/audioset/">AudioSet</a>,
        <a href="https://freesound.org/">Freesound</a> and the
        <a href="https://sound-effects.bbcrewind.co.uk/">BBC Sound Effects library</a>.</p>
    </div>
"""

# Community-share chrome (the role of the reference's share_btn.py:1-27;
# simple SVG icons of the JAX package's demo, not the reference artwork).
COMMUNITY_ICON_HTML = """<svg id="share-btn-share-icon" width="1em" height="1em" viewBox="0 0 24 24" aria-hidden="true">
  <circle cx="6" cy="12" r="3" fill="#FF9D00"/>
  <circle cx="18" cy="5" r="3" fill="#FFD21E"/>
  <circle cx="18" cy="19" r="3" fill="#FFD21E"/>
  <path d="M8.6 10.6 15.4 6.6 M8.6 13.4 15.4 17.4" stroke="#FF9D00" stroke-width="2"/>
</svg>"""

LOADING_ICON_HTML = """<svg id="share-btn-loading-icon" style="display:none;" class="animate-spin" width="1em" height="1em" viewBox="0 0 24 24" aria-hidden="true">
  <circle cx="12" cy="12" r="10" stroke="white" stroke-width="4" fill="none" opacity="0.25"/>
  <path d="M12 2 A10 10 0 0 1 22 12" stroke="white" stroke-width="4" fill="none" opacity="0.75"/>
</svg>"""

EXAMPLES = [
    ["A cat is meowing for attention.", 10, 3.5, 45, 3, DEFAULT_CHECKPOINT],
    ["Birds singing sweetly in a blooming garden.", 10, 3.5, 45, 3, DEFAULT_CHECKPOINT],
    ["A modern synthesizer creating futuristic soundscapes.", 10, 3.5, 45, 3, DEFAULT_CHECKPOINT],
    ["The vibrant beat of Brazilian samba drums.", 10, 3.5, 45, 3, DEFAULT_CHECKPOINT],
]


def build_ui():
    """Construct the Blocks app (importable for tests/serving)."""
    import gradio as gr

    can_video = shutil.which("ffmpeg") is not None or hasattr(gr, "make_waveform")

    with gr.Blocks(css=CSS) as iface:
        gr.HTML(HEADER_HTML)
        with gr.Group():
            with gr.Column():
                textbox = gr.Textbox(
                    value="A forest of wind chimes singing a soothing melody in the breeze.",
                    max_lines=1,
                    label=(
                        "Input your text here. Your text is important for the "
                        "audio quality. Please ensure it is descriptive by "
                        "using more adjectives."
                    ),
                    elem_id="prompt-in",
                )
                with gr.Accordion(
                    "Click to modify detailed configurations", open=False
                ):
                    seed = gr.Number(
                        value=45,
                        label=(
                            "Changing this value (any integer number) will "
                            "lead to a different generation result."
                        ),
                    )
                    duration = gr.Slider(
                        5, 15, value=10, step=2.5, label="Duration (seconds)"
                    )
                    guidance_scale = gr.Slider(
                        0, 6, value=3.5, step=0.5,
                        label=(
                            "Guidance scale (larger => better quality and "
                            "relevancy to text; smaller => better diversity)"
                        ),
                    )
                    n_candidates = gr.Slider(
                        1, 3, value=3, step=1,
                        label=(
                            "Automatic quality control: number of candidates "
                            "generated per prompt, best kept by CLAP rerank."
                        ),
                    )
                    model_name = gr.Dropdown(
                        MODEL_CHOICES, value=DEFAULT_CHECKPOINT, label="Model"
                    )
                outputs = (
                    gr.Video(label="Output", elem_id="output-video")
                    if can_video
                    else gr.Audio(label="Output")
                )
                btn = gr.Button("Submit")

            with gr.Group(elem_id="share-btn-container", visible=False):
                gr.HTML(COMMUNITY_ICON_HTML + LOADING_ICON_HTML)
                share_button = gr.Button(
                    "Share to community", elem_id="share-btn"
                )
                # inert, as the reference's live behaviour: no callback
                share_button.click(None, [], [])

            btn.click(
                text2audio,
                inputs=[textbox, duration, guidance_scale, seed, n_candidates,
                        model_name],
                outputs=[outputs],
                api_name="text2audio",
            )

            gr.HTML(FOOTER_HTML)
            gr.Examples(
                EXAMPLES,
                fn=text2audio,
                inputs=[textbox, duration, guidance_scale, seed, n_candidates,
                        model_name],
                outputs=[outputs],
                cache_examples=False,
            )
            gr.HTML(TIPS_HTML)
            with gr.Accordion("Additional information", open=False):
                gr.HTML(ACK_HTML)
    return iface


def main():
    try:
        import gradio  # noqa: F401
    except ImportError:
        print("gradio is not installed; `pip install gradio` to run the web demo")
        return 1
    build_ui().launch()
    return 0


if __name__ == "__main__":
    sys.exit(main())
