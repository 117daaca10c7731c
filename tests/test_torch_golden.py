"""The full-width golden: params.draw_tree, the maker (tests/torch_golden.py)
and the checker (audioldm2_torch.tools.golden_parity).

- draw_tree gives both packages the same tree, bitwise, on all seven
  families at tiny width; no floating leaf is all zero; a leaf's values
  depend on its path and shape alone.
- The maker and the checker end to end at tiny width into a temporary
  file: the port passes at mel MAE < 1e-3 (f32, CPU); a perturbed weight
  raises on the digest, a perturbed x_T fails the comparison, and the
  command (f32 only) exits 1 on it.
- The committed golden (audioldm2_torch/assets/golden_fullwidth.npz) loads,
  each case's config digest is the port's published config's, its shapes
  are the config's, and the families that share a config share its digest;
  every case has an f32 limit under the 1e-3 bar.
- Each new mode (sr, edit, PLMS, the audio-in variants, int8) has a tiny
  golden made by the maker; a moved mask noise, encode noise or posterior
  noise fails its case, and one int8 value changed raises on the digest.
- ``slow``: the port on the CPU at full width against every committed case.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

import audioldm2_torch as at
from audioldm2_torch import config as tconfig, params as tparams
from audioldm2_torch.tools import golden_parity as gp
from audioldm2_tpu import pipeline as jpipe
from test_torch_48k import tiny_48k_config
from test_torch_audio_cond import _mae_spec
from test_torch_full import tiny_full_config
from test_torch_large import tiny_large_config, tiny_reranker
from test_torch_models import _flatten
from test_torch_tts import tiny_tts_config
from tiny import tiny_t5_model_config
import torch_golden

torch.set_num_threads(2)

TINY = {
    "audioldm_16k_crossattn_t5": tiny_t5_model_config,
    "audioldm2-full": tiny_full_config,
    "audioldm2-music-665k": tiny_full_config,
    "audioldm2-full-large-1150k": tiny_large_config,
    "audioldm_48k": tiny_48k_config,
    "audioldm2-speech-gigaspeech": tiny_tts_config,
    "audioldm2-speech-ljspeech": tiny_tts_config,
}


def _leaves(tree):
    return dict(tparams.tree_paths(tree))


def _tiny(family):
    return dataclasses.replace(TINY[family](), name=family)


# ---------------------------------------------------------------------------
# (a) draw_tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(TINY))
def test_draw_tree_builds_equal_trees_in_both_packages(family):
    """The drawn tree fed to JAX's AudioLDM2 and to the port's build_model
    gives equal trees, bitwise; the same fill over JAX's own fast-init
    structure gives the same tree; no floating leaf is all zero."""
    cfg = _tiny(family)
    tree = tparams.draw_tree(tconfig.coerce(cfg), seed=0)
    jleaves = {p: np.asarray(v) for p, v in
               _leaves(jpipe.AudioLDM2(cfg, tree).ldm.params).items()}
    tleaves = {p: v.numpy() for p, v in _leaves(
        at.build_model(config=cfg, params=tree, device="cpu").ldm.params).items()}
    assert sorted(jleaves) == sorted(tleaves)
    for p in jleaves:
        assert jleaves[p].dtype == tleaves[p].dtype == np.float32, p
        assert np.array_equal(jleaves[p], tleaves[p]), p
        assert np.any(tleaves[p]), f"{p} is all zero"
    from_jax = tparams.fill_tree(jpipe.init_params(jax.random.PRNGKey(0), cfg, fast=True), 0)
    assert _flatten(from_jax) == _flatten(tree)
    assert tparams.tree_digest(from_jax) == tparams.tree_digest(tree)


def test_a_leaf_does_not_change_when_leaves_are_added():
    """Adding the reranker's leaves (drawn before and after nothing else)
    leaves every other leaf's values as they were; another seed changes
    them; the digest follows the values."""
    base = tiny_t5_model_config()
    more = dataclasses.replace(base, reranker_clap=tiny_reranker())
    a = _leaves(tparams.draw_tree(tconfig.coerce(base), 0))
    b = _leaves(tparams.draw_tree(tconfig.coerce(more), 0))
    assert set(a) < set(b) and any(p.startswith("reranker_clap/") for p in set(b) - set(a))
    for p in a:
        assert np.array_equal(a[p], b[p]), p
    c = _leaves(tparams.draw_tree(tconfig.coerce(base), 1))
    assert not np.array_equal(a["unet/out_conv/w"], c["unet/out_conv/w"])
    assert tparams.draw_leaf(0, "x/w", (3, 4)).tobytes() == \
        tparams.draw_leaf(0, "x/w", (3, 4)).tobytes()


def test_draw_leaf_scales_by_role():
    """Weights at std 1/sqrt(fan_in), scales about 1, biases about 0."""
    w = tparams.draw_leaf(0, "unet/input_blocks/1/res/in_conv/w", (3, 3, 64, 256))
    assert abs(w.std() * np.sqrt(3 * 3 * 64) - 1.0) < 0.05
    s = tparams.draw_leaf(0, "unet/out_norm/scale", (4096,))
    assert abs(s.mean() - 1.0) < 0.01 and s.min() > 0.8
    b = tparams.draw_leaf(0, "unet/out_norm/bias", (4096,))
    assert abs(b.mean()) < 0.01 and 0.03 < b.std() < 0.07
    assert float(tparams.draw_leaf(0, "scale_factor", ())) > 0.8


# ---------------------------------------------------------------------------
# (b) maker and checker end to end at tiny width
# ---------------------------------------------------------------------------

def tiny_mae_full_config():
    """tiny_full_config with its nested AudioMAE at the 768-wide, 3-block
    ViT of tests/test_torch_audio_cond.py (pooled 8 x 8: 8 tokens), so the
    mae variant's tokens fill the 768 slot."""
    cfg = tiny_full_config()
    seqgen = cfg.conditioners[0]
    nested = tuple(_mae_spec() if ns.kind == "audiomae_pooled" else ns for ns in seqgen.nested)
    return dataclasses.replace(
        cfg, conditioners=(dataclasses.replace(seqgen, nested=nested),) + cfg.conditioners[1:])


def tiny_int8_t5_config():
    """The tiny t5 model with a UNet of widths 128 and 256, so every int8
    quantization predicate fires."""
    cfg = tiny_t5_model_config()
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, model_channels=128,
                                                             num_head_channels=32))


T5 = "audioldm_16k_crossattn_t5"
# name -> (the tiny config's factory, the case)
TINY_CASES = {
    "t5": (tiny_t5_model_config, gp.Case(T5, 4, 1, "A dog barking.", duration=0.32, xt_seed=7)),
    "k48": (tiny_48k_config, gp.Case("audioldm_48k", 4, 3, "Waves on rocks.", duration=1.6,
                                     xt_seed=8)),
    "tts": (tiny_tts_config, gp.Case("audioldm2-speech-gigaspeech", 4, 1, "A man speaking.",
                                     transcription="The quick brown fox.", duration=0.32,
                                     xt_seed=9)),
    "sr": (tiny_t5_model_config, gp.Case(T5, 4, 1, "A chirp.", duration=0.32, guidance=2.5,
                                         xt_seed=10, mode="sr")),
    "edit": (tiny_t5_model_config, gp.Case(T5, 4, 1, "A violin.", duration=0.32, xt_seed=11,
                                           mode="edit", batchsize=2, t_enc=2, wave_seed=3)),
    "plms": (tiny_t5_model_config, gp.Case(T5, 4, 1, "Birds chirping.", duration=0.32,
                                           xt_seed=12, sampler="plms")),
    "mae": (tiny_mae_full_config, gp.Case("audioldm2-full", 4, 1, "", duration=0.32,
                                          xt_seed=13, batchsize=2, variant="mae",
                                          wave_seed=5)),
    "clapaudio": (tiny_48k_config, gp.Case("audioldm_48k", 4, 1, "", duration=1.6, xt_seed=14,
                                           variant="clapaudio", wave_seed=6)),
    "int8": (tiny_int8_t5_config, gp.Case(T5, 4, 1, "Rain on a roof.", duration=0.32,
                                          xt_seed=15, weight_quant="int8")),
}


def _tiny_case_cfg(name):
    fn, case = TINY_CASES[name]
    return dataclasses.replace(fn(), name=case.family)


@pytest.fixture(scope="module")
def tiny_golden(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("golden") / "tiny.npz")
    torch_golden.save({name: torch_golden.make_case(name, case, _tiny_case_cfg(name),
                                                    eps0=case.mode != "edit")
                       for name, (_, case) in TINY_CASES.items()}, path)
    return path


@pytest.mark.parametrize("name", list(TINY_CASES))
def test_port_passes_the_tiny_golden(tiny_golden, name):
    golden = gp.load(tiny_golden)
    case = TINY_CASES[name][1]
    d = gp.check(name, "cpu", golden=golden, cfg=_tiny_case_cfg(name))
    assert gp.f32_ok(d), d
    assert d["mel_mean_abs"] > 1e-2, d  # a live request, not a silent one
    assert ("eps0_rel" in d) == ("eps0_unet_rel" in d) == (case.mode != "edit"), d
    assert d["decode_mel_mae"] < 1e-4, d
    assert d["vocoder_wav_mae"] < 1e-5, d
    assert all(d[k] < 1e-4 for k in d if k.startswith(("ctx", "seq", "y_"))), d
    if case.weight_quant:
        # the int8 kernels' bf16 rounding of each activation: the port lies
        # within INT8_SPREAD_FACTOR x JAX's own one-ulp spread, which is
        # far above an f32 request's (the tiny t5 case's mel MAE)
        assert d["int8_leaves"] > 0 and d["int8_ulp_mel_mae"] > 1e-4, d
        assert d["mel_mae"] < gp.INT8_SPREAD_FACTOR * d["int8_ulp_mel_mae"], d
    else:
        assert d["mel_mae"] < gp.MEL_MAE_TOL, d
        assert d["latent_rel"] < 1e-4 and d["wav_mae"] < 1e-4, d
        assert all(d[k] < 1e-4 for k in d if k.startswith(("eps0", "z0_rel", "z_t_rel"))), d
    if name == "k48":
        assert d["same_pick"] and d["scores_max"] < 1e-4, d
    if name == "tts":
        assert "seq_rel" in d, d
    if case.mode != "generate":
        assert "z0_rel" in d and d["mel_in_max"] < 1e-4, d
    if case.mode == "edit":
        assert "z_t_rel" in d, d
    if case.variant == "mae":
        assert d["fbank_max"] < 5e-4, d  # the kaldi fbank's f32 DFT order (test_torch_audio_cond)


@pytest.mark.parametrize("name,key,fails", [
    ("sr", "mask_noise", "mel_mae"), ("sr", "posterior_noise", "z0_rel"),
    ("edit", "encode_noise", "z_t_rel")])
def test_checker_fails_a_moved_draw(tiny_golden, name, key, fails):
    """A stored draw moved by 0.5 fails the case: the blend's q-sample
    noise and the edit's encode noise the mel, the posterior noise the
    encode's own limit."""
    golden = gp.load(tiny_golden)
    golden[name][key] = golden[name][key] + np.float32(0.5)
    d = gp.check(name, "cpu", golden=golden, cfg=_tiny_case_cfg(name), stages=False)
    assert not gp.f32_ok(d), d
    if fails == "z0_rel":
        assert d["z0_rel"] >= gp.z0_limit(name), d
    else:
        assert d[fails] > 1e-2 and d["mel_mae"] >= gp.MEL_MAE_TOL, d


def test_checker_raises_on_one_int8_value(tiny_golden, monkeypatch):
    """One int8 value of the served UNet tree changed raises on the stored
    digest, before the request."""
    from audioldm2_torch.diffusion import latent_diffusion as tld

    served = tld.served_unet

    def moved(unet_p, cfg):
        q = served(unet_p, cfg)
        wq = next(a for _, a in sorted(tparams.tree_paths(q)) if a.dtype == torch.int8)
        wq[(0,) * wq.dim()] ^= 1
        return q

    monkeypatch.setattr(tld, "served_unet", moved)
    with pytest.raises(ValueError, match="int8 UNet tree"):
        gp.check("int8", "cpu", golden=gp.load(tiny_golden), cfg=_tiny_case_cfg("int8"))


def test_checker_fails_on_a_perturbed_weight_or_x_T(tiny_golden):
    """A weight changed by one ulp raises on the digest; x_T moved by 0.5
    fails the mel comparison."""
    cfg = _tiny_case_cfg("t5")
    golden = gp.load(tiny_golden)
    tree = tparams.draw_tree(tconfig.coerce(cfg), 0)
    w = tree["unet"]["out_conv"]["w"]
    w.flat[0] = np.nextafter(w.flat[0], np.float32(np.inf))
    with pytest.raises(ValueError, match="digest"):
        gp.build("t5", "cpu", golden, tree=tree, cfg=cfg)
    golden["t5"]["x_T"] = golden["t5"]["x_T"] + np.float32(0.5)
    d = gp.run(gp.build("t5", "cpu", golden, cfg=cfg), "t5", golden, stages=False)
    assert d["mel_mae"] >= gp.MEL_MAE_TOL, d


def test_cli_runs_f32_and_fails_a_perturbed_case(tiny_golden, tmp_path, monkeypatch, capsys):
    """The command runs the stored cases in f32 only: ok and exit 0 on the
    tiny golden, ok false and exit 1 once x_T is moved; it takes no dtype."""
    import json

    monkeypatch.setattr(gp, "case_config", lambda case, compute_dtype="float32",
                        weight_quant=None: dataclasses.replace(
                            _tiny_case_cfg("t5"), compute_dtype=compute_dtype,
                            weight_quant=weight_quant))
    monkeypatch.setattr(gp, "GOLDEN", tiny_golden)
    assert gp.main(["--device", "cpu", "--case", "t5"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["ok"] and d["dtype"] == "float32" and d["weight_quant"] is None, d
    assert d["mel_mae_limit"] == gp.MEL_MAE_TOL, d  # no reading for a tiny case: the bar
    with np.load(tiny_golden) as z:
        moved = {k: z[k] for k in z.files}
    moved["t5/x_T"] = moved["t5/x_T"] + np.float32(0.5)
    path = str(tmp_path / "moved.npz")
    np.savez(path, **moved)
    monkeypatch.setattr(gp, "GOLDEN", path)
    assert gp.main(["--device", "cpu", "--case", "t5"]) == 1
    assert not json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"]
    with pytest.raises(SystemExit):
        gp.main(["--device", "cpu", "--dtype", "bfloat16"])


def test_checker_raises_on_other_ids(tiny_golden):
    golden = gp.load(tiny_golden)
    golden["t5"]["ids/t5_ids"] = golden["t5"]["ids/t5_ids"] + 1
    model = gp.build("t5", "cpu", golden, cfg=_tiny_case_cfg("t5"))
    with pytest.raises(ValueError, match="t5_ids"):
        gp.run(model, "t5", golden)


# ---------------------------------------------------------------------------
# (c) the committed golden
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return gp.load()


def test_golden_holds_every_case(golden):
    import os

    assert sorted(golden) == sorted(gp.CASES)
    assert os.path.getsize(gp.GOLDEN) < 32 * 2**20


# SHA-256 over the arrays and metadata of the five text-to-audio cases as
# first stored
TEXT_TO_AUDIO_CASES = ("t5_headline", "full", "large", "k48", "tts")
TEXT_TO_AUDIO_DIGEST = "d02a6ed7a9f88cd37bbd0ad05fbc0ea829f70386deeeeec4b2dc6447a22ff48e"


def test_the_text_to_audio_cases_are_as_first_stored(golden):
    """Adding cases left the first five bit for bit as they were made."""
    import hashlib

    h = hashlib.sha256()
    for name in TEXT_TO_AUDIO_CASES:
        for key in sorted(k for k in golden[name] if k != "meta"):
            a = np.ascontiguousarray(golden[name][key])
            h.update(f"{name}/{key}|{a.shape}|{a.dtype.str}|".encode())
            h.update(a.tobytes())
        h.update(json.dumps(golden[name]["meta"], sort_keys=True).encode())
    assert h.hexdigest() == TEXT_TO_AUDIO_DIGEST


@pytest.mark.parametrize("name", list(gp.CASES))
def test_golden_case_matches_the_port_config(golden, name):
    g, case = golden[name], gp.CASES[name]
    meta = g["meta"]
    assert gp.stored_case(meta) == case
    cfg = gp.case_config(case)
    assert meta["config_digest"] == gp.config_digest(dataclasses.replace(cfg, weight_quant=None))
    assert meta["config_digest"] == gp.config_digest(gp.variant_config(dataclasses.replace(
        at.default_audioldm_config(case.family), compute_dtype="float32"), case.variant))
    lt = gp.latent_t_size(cfg, case)
    rows = case.batchsize * case.n_gen
    latent = (lt, cfg.latent_f_size, cfg.latent_channels)
    assert meta["latent_t"] == lt and meta["steps"] == case.steps
    assert ("x_T" in g) == (case.mode != "edit")
    if "x_T" in g:
        assert g["x_T"].shape == (rows,) + latent
        assert np.array_equal(g["x_T"], gp.x_T(cfg, case))
    kept = 1 if case.n_gen > 1 else rows
    assert g["latent"].shape == (kept,) + latent
    frames = gp.mel_frames(cfg, case)
    assert g["mel"].shape == (rows, frames, cfg.preprocessing.n_mel_channels, 1)
    hop = cfg.preprocessing.hop_length
    assert g["wav"].shape[0] == kept and frames * hop <= g["wav"].shape[1] < (frames + 1) * hop
    slots = [d for d in cfg.unet.context_dims if d is not None]
    assert [g[f"ctx{i}"].shape[-1] for i in range(len(slots))] == slots
    for i in range(len(slots)):
        assert g[f"ctx{i}"].shape[0] == g[f"mask{i}"].shape[0] == 2 * rows
    assert ("y" in g) == (cfg.unet.extra_film_condition_dim is not None)
    assert ("scores" in g) == (case.n_gen > 1)
    assert ("ta_kaldi_fbank" in g) == (case.variant == "mae")
    if case.variant == "mae":
        assert g["ta_kaldi_fbank"].shape == (case.batchsize, 1024, 128)
    enc = (case.batchsize, lt, cfg.latent_f_size, cfg.vae.embed_dim)
    assert ("z0" in g) == ("mel_in" in g) == ("posterior_noise" in g) == (case.mode != "generate")
    if case.mode != "generate":
        assert g["mel_in"].shape == (case.batchsize, frames, cfg.preprocessing.n_mel_channels, 1)
        assert g["z0"].shape == g["posterior_noise"].shape == enc
    assert ("mask_noise" in g) == ("mask" in g) == (case.mode == "sr")
    if case.mode == "sr":
        want = at.pipeline.latent_inpaint_mask(enc, gp.SR_TIME_MASK, gp.SR_FREQ_MASK).numpy()
        assert np.array_equal(g["mask"], want) and 0 < g["mask"].mean() < 1
        assert g["mask_noise"].shape == (case.steps, rows) + latent
    assert ("z_t" in g) == ("encode_noise" in g) == (case.mode == "edit")
    if case.mode == "edit":
        assert g["z_t"].shape == g["encode_noise"].shape == enc and 0 < case.t_enc < case.steps
    assert ("unet_int8_digest" in meta) == ("int8_ulp_mel_mae" in meta) == \
        (case.weight_quant == "int8")
    for k in ("latent", "mel", "wav") + (("x_T",) if "x_T" in g else ()):
        assert g[k].dtype == np.float32 and np.isfinite(g[k]).all(), k
    assert np.abs(g["mel"]).mean() > 1e-2  # a live request


def test_every_case_has_an_f32_limit_under_the_bar(golden):
    """Each f32 case has a limit under the 1e-3 bar; an int8 case, whose
    kernels round each activation to bf16, is held to INT8_SPREAD_FACTOR x
    JAX's own one-ulp spread, stored with it."""
    assert sorted(gp.F32_MEL_MAE_LIMIT) == sorted(n for n, c in gp.CASES.items()
                                                   if c.weight_quant is None)
    for name, limit in gp.F32_MEL_MAE_LIMIT.items():
        assert 0 < gp.f32_limit(name) == limit < gp.MEL_MAE_TOL
    for name in set(gp.CASES) - set(gp.F32_MEL_MAE_LIMIT):
        spread = golden[name]["meta"]["int8_ulp_mel_mae"]
        assert 1e-4 < spread < 1e-2
        assert gp.f32_limit(name, spread) == gp.INT8_SPREAD_FACTOR * spread
    assert sorted(gp.Z0_REL_LIMIT) == sorted(n for n, c in gp.CASES.items()
                                             if c.mode != "generate")
    for name, limit in gp.Z0_REL_LIMIT.items():
        assert 0 < gp.z0_limit(name) == limit < gp.Z0_REL_TOL
    assert gp.f32_limit("a case without a reading") == gp.MEL_MAE_TOL
    assert gp.z0_limit("a case without a reading") == gp.Z0_REL_TOL
    assert not gp.f32_ok({"case": "full", "mel_mae": 1.5 * gp.F32_MEL_MAE_LIMIT["full"]})
    assert not gp.f32_ok({"case": "k48", "mel_mae": 0.0, "same_pick": False})
    assert not gp.f32_ok({"case": "sr_large", "mel_mae": 0.0,
                          "z0_rel": 1.5 * gp.Z0_REL_LIMIT["sr_large"]})


@pytest.mark.parametrize("variant,family", [("mae", "audioldm2-full"),
                                            ("clapaudio", "audioldm_48k")])
def test_a_variant_has_one_config_digest_in_both_packages(variant, family):
    """variant_config on the JAX package's and on the port's published
    config gives the same config digest, and another than the family's."""
    from audioldm2_tpu.config import default_audioldm_config as jax_config

    port = gp.variant_config(at.default_audioldm_config(family), variant)
    want = gp.config_digest(gp.variant_config(jax_config(family), variant))
    assert gp.config_digest(port) == want
    assert want != gp.config_digest(at.default_audioldm_config(family))
    kinds = [s.kind for s in port.conditioners]
    if variant == "mae":
        assert kinds == ["audiomae_pooled", "flan_t5"]
        assert port.conditioners[0].audiomae.embed_dim == port.unet.context_dims[0]
    else:
        assert kinds == ["clap"] and port.conditioners[0].clap.embed_mode == "audio"


def test_case_waves():
    """The sr case's sine is bench.py's; the edit and audio-in cases get one
    chirp a batch row, distinct, each at the case's rate and length; a
    text-only case none."""
    sr_case, edit, mae = gp.CASES["sr_large"], gp.CASES["edit_t5"], gp.CASES["mae_full"]
    sine = gp.case_waves(sr_case, 16000)
    t = np.linspace(0, 10.0, 160000, dtype=np.float32)
    assert np.array_equal(sine, (0.3 * np.sin(2 * np.pi * 440 * t))[None].astype(np.float32))
    for case in (edit, mae):
        w = gp.case_waves(case, 16000)
        assert w.shape == (2, 160000) and w.dtype == np.float32
        assert np.abs(w).max() == np.float32(0.5) and not np.array_equal(w[0], w[1])
        assert np.array_equal(w, gp.case_waves(case, 16000))
    assert gp.case_waves(gp.CASES["clapaudio_48k"], 48000).shape == (1, 480000)
    assert gp.case_waves(gp.CASES["full"], 16000) is None


@pytest.mark.parametrize("family,shares", list(gp.SHARED_CONFIGS.items()))
def test_shared_config_families_share_the_golden(golden, family, shares):
    cfg = dataclasses.replace(at.default_audioldm_config(family), compute_dtype="float32")
    case = next(n for n, c in gp.CASES.items() if c.family == shares)
    assert gp.config_digest(cfg) == golden[case]["meta"]["config_digest"]


# ---------------------------------------------------------------------------
# slow: the port at full width on the CPU against the committed golden
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", list(gp.CASES))
def test_port_matches_the_golden_at_full_width(golden, name):
    torch.set_num_threads(8)
    d = gp.check(name, "cpu", golden=golden)
    print(d)
    if gp.CASES[name].weight_quant is None:
        assert d["mel_mae"] < gp.MEL_MAE_TOL, d
    assert gp.f32_ok(d), d


@pytest.mark.slow
def test_t5_distance_is_f32_rounding():
    """The golden's largest f32 gap is the T5 context (about 1e-4 relative
    on t5_headline). On the t5 family's drawn FLAN-T5 encoder at full width,
    the port's f32 output lies no further from JAX's f32 output, at 1, 2, 4,
    8 and 24 layers, than twice JAX's own f32 output lies from its f64 run:
    the gap grows with depth as rounding does, which a different formula
    would not."""
    from audioldm2_torch.models import t5 as tt5
    from audioldm2_torch.utils import text as ttext
    from audioldm2_tpu.models import t5 as jt5
    import jax.numpy as jnp

    torch.set_num_threads(8)
    cfg = at.default_audioldm_config("audioldm_16k_crossattn_t5")
    spec = cfg.conditioners[0]
    shapes = tparams.init_params(cfg, torch.Generator().manual_seed(0), "meta")
    tree = tparams.fill_tree(shapes["cond"][spec.name]["t5"], 0, f"cond/{spec.name}/t5")
    ids, mask = map(np.asarray, ttext.t5_tokenizer(spec.flan_t5.max_length)(
        [gp.CASES["t5_headline"].prompt, ""]))
    keep = gp.context_length(mask)
    for depth in (1, 2, 4, 8, 24):
        t5cfg = dataclasses.replace(spec.flan_t5, num_layers=depth)
        sub = {**tree, "blocks": tree["blocks"][:depth]}

        def jax_out(dt):
            with jax.enable_x64(dt == jnp.float64):
                p = jax.tree.map(lambda a: jnp.asarray(a, dt), sub)
                out = jt5.apply_t5_encoder(p, t5cfg, jnp.asarray(ids), jnp.asarray(mask))
                return np.asarray(out, np.float64)[:, :keep]

        with torch.inference_mode():
            port = tt5.apply_t5_encoder(tparams.from_jax_tree(sub), t5cfg, torch.as_tensor(ids),
                                        torch.as_tensor(mask)).double().numpy()[:, :keep]
        j32, j64 = jax_out(jnp.float32), jax_out(jnp.float64)
        rounding, gap = gp.rel(j32, j64), gp.rel(port, j32)
        print(f"{depth} layers: port f32 - JAX f32 {gap:.2e}, JAX f32 - JAX f64 {rounding:.2e}")
        assert gap <= 2 * rounding, (depth, gap, rounding)
