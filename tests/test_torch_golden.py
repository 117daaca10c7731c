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
- ``slow``: the port on the CPU at full width against every committed case.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import audioldm2_torch as at
from audioldm2_torch import config as tconfig, params as tparams
from audioldm2_torch.tools import golden_parity as gp
from audioldm2_tpu import pipeline as jpipe
from test_torch_48k import tiny_48k_config
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

TINY_CASES = {
    "t5": ("audioldm_16k_crossattn_t5",
           gp.Case("audioldm_16k_crossattn_t5", 4, 1, "A dog barking.", duration=0.32,
                   xt_seed=7)),
    "k48": ("audioldm_48k", gp.Case("audioldm_48k", 4, 3, "Waves on rocks.", duration=1.6,
                                    xt_seed=8)),
    "tts": ("audioldm2-speech-gigaspeech",
            gp.Case("audioldm2-speech-gigaspeech", 4, 1, "A man speaking.",
                    transcription="The quick brown fox.", duration=0.32, xt_seed=9)),
}


@pytest.fixture(scope="module")
def tiny_golden(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("golden") / "tiny.npz")
    torch_golden.save({name: torch_golden.make_case(name, case, _tiny(fam), eps0=True)
                       for name, (fam, case) in TINY_CASES.items()}, path)
    return path


@pytest.mark.parametrize("name", list(TINY_CASES))
def test_port_passes_the_tiny_golden(tiny_golden, name):
    golden = gp.load(tiny_golden)
    d = gp.check(name, "cpu", golden=golden, cfg=_tiny(TINY_CASES[name][0]))
    assert d["mel_mae"] < gp.MEL_MAE_TOL and gp.f32_ok(d), d
    assert d["mel_mean_abs"] > 1e-2, d  # a live request, not a silent one
    assert d["latent_rel"] < 1e-4 and d["wav_mae"] < 1e-4, d
    assert d["eps0_rel"] < 1e-4 and d["eps0_unet_rel"] < 1e-4, d
    assert d["decode_mel_mae"] < 1e-4, d
    assert d["vocoder_wav_mae"] < 1e-5, d
    assert all(d[k] < 1e-4 for k in d if k.startswith(("ctx", "seq", "y_"))), d
    if name == "k48":
        assert d["same_pick"] and d["scores_max"] < 1e-4, d
    if name == "tts":
        assert "seq_rel" in d, d


def test_checker_fails_on_a_perturbed_weight_or_x_T(tiny_golden):
    """A weight changed by one ulp raises on the digest; x_T moved by 0.5
    fails the mel comparison."""
    fam, _ = TINY_CASES["t5"]
    cfg = _tiny(fam)
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
                            _tiny(case.family), compute_dtype=compute_dtype,
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
    model = gp.build("t5", "cpu", golden, cfg=_tiny(TINY_CASES["t5"][0]))
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
    assert os.path.getsize(gp.GOLDEN) < 12 * 2**20


@pytest.mark.parametrize("name", list(gp.CASES))
def test_golden_case_matches_the_port_config(golden, name):
    g, case = golden[name], gp.CASES[name]
    meta = g["meta"]
    assert gp.stored_case(meta) == case
    cfg = gp.case_config(case)
    assert meta["config_digest"] == gp.config_digest(cfg)
    assert meta["config_digest"] == gp.config_digest(
        dataclasses.replace(at.default_audioldm_config(case.family), compute_dtype="float32"))
    lt = gp.latent_t_size(cfg, case)
    assert meta["latent_t"] == lt and meta["steps"] == case.steps
    assert g["x_T"].shape == (case.n_gen, lt, cfg.latent_f_size, cfg.latent_channels)
    assert np.array_equal(g["x_T"], gp.x_T(cfg, case))
    assert g["latent"].shape == (1,) + g["x_T"].shape[1:]
    frames = lt * cfg.vae.downsample_factor
    assert g["mel"].shape == (case.n_gen, frames, cfg.preprocessing.n_mel_channels, 1)
    hop = cfg.preprocessing.hop_length
    assert g["wav"].shape[0] == 1 and frames * hop <= g["wav"].shape[1] < (frames + 1) * hop
    slots = [d for d in cfg.unet.context_dims if d is not None]
    assert [g[f"ctx{i}"].shape[-1] for i in range(len(slots))] == slots
    for i in range(len(slots)):
        assert g[f"ctx{i}"].shape[0] == g[f"mask{i}"].shape[0] == 2 * case.n_gen
    assert ("y" in g) == (cfg.unet.extra_film_condition_dim is not None)
    assert ("scores" in g) == (case.n_gen > 1)
    for k in ("x_T", "latent", "mel", "wav"):
        assert g[k].dtype == np.float32 and np.isfinite(g[k]).all(), k
    assert np.abs(g["mel"]).mean() > 1e-2  # a live request


def test_every_case_has_an_f32_limit_under_the_bar():
    assert sorted(gp.F32_MEL_MAE_LIMIT) == sorted(gp.CASES)
    for name, limit in gp.F32_MEL_MAE_LIMIT.items():
        assert 0 < gp.f32_limit(name) == limit < gp.MEL_MAE_TOL
    assert gp.f32_limit("a case without a reading") == gp.MEL_MAE_TOL
    assert not gp.f32_ok({"case": "full", "mel_mae": 1.5 * gp.F32_MEL_MAE_LIMIT["full"]})
    assert not gp.f32_ok({"case": "k48", "mel_mae": 0.0, "same_pick": False})


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
