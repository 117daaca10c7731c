"""Checkpoint loading in audioldm2_torch against audioldm2_tpu (CPU).

The reference's key layout comes from ``audioldm2_torch.tools.
reference_layout``, which inverts the converters; it is held against the JAX
package's converter, which was proven against the reference's own
``state_dict()`` for all seven families (docs/KEY_COVERAGE.md). Then the
port's converter is held bitwise to the JAX package's on the same state
dicts, at every family's published depths with narrowed widths (both
converters take depths from the config, widths from the arrays; the CLAP
towers keep RoBERTa's 12 layers and HTSAT-base's depths, which both
converters assume), and at full published width with leaves that take no
memory. End to end: one ``.pth`` into both packages' ``build_model``.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import audioldm2_torch as at
from audioldm2_torch import config as tconfig
from audioldm2_torch import convert as tconvert
from audioldm2_torch import pipeline as tpipe
from audioldm2_torch.models import clap as tclap
from audioldm2_torch.models import htsat as thtsat
from audioldm2_torch.models import roberta as troberta
from audioldm2_torch.tools import reference_layout as rl
from audioldm2_torch.utils import checkpoint as tckpt
from audioldm2_tpu import config as jconfig
from audioldm2_tpu import pipeline as jpipe
from audioldm2_tpu.models import clap as jclap
from audioldm2_tpu.models import htsat as jhtsat
from audioldm2_tpu.models import roberta as jroberta
from audioldm2_tpu.utils import checkpoint as jckpt
from test_torch_models import nonzero_tree
from tiny import TINY_T5, tiny_t5_model_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = tconfig.CHECKPOINT_NAMES
# "tree leaves" of docs/KEY_COVERAGE.md: the JAX package's init_params tree,
# which its converter reproduced exactly from the reference's state_dict()
KEY_COVERAGE_LEAVES = {
    "audioldm_16k_crossattn_t5": 2196, "audioldm2-full": 3608, "audioldm2-music-665k": 3608,
    "audioldm2-full-large-1150k": 5304, "audioldm2-speech-gigaspeech": 2866,
    "audioldm2-speech-ljspeech": 2866, "audioldm_48k": 2561,
}
NARROW_HTSAT, NARROW_ROBERTA = "HTSAT-narrow", "roberta-narrow"


def _register_narrow_towers():
    """HTSAT at BASE's depths and RoBERTa at 12 layers, narrowed, in both
    packages."""
    jclap.register_audio_tower(NARROW_HTSAT, lambda: jhtsat.HTSATConfig(embed_dim=8), 64)
    tclap.register_audio_tower(NARROW_HTSAT, lambda: thtsat.HTSATConfig(embed_dim=8), 64)
    narrow = dict(hidden_size=16, num_layers=12, num_heads=2, intermediate_size=32)
    jclap.register_text_tower(NARROW_ROBERTA, lambda: jroberta.RobertaConfig(**narrow), 16)
    tclap.register_text_tower(NARROW_ROBERTA, lambda: troberta.RobertaConfig(**narrow), 16)


def _narrow_spec(spec):
    r = dataclasses.replace
    kw = {}
    if spec.flan_t5 is not None:
        kw["flan_t5"] = r(spec.flan_t5, d_model=32, d_kv=8, d_ff=64, num_heads=4)
    if spec.clap is not None:
        kw["clap"] = r(spec.clap, amodel=NARROW_HTSAT, tmodel=NARROW_ROBERTA)
    if spec.phoneme is not None:
        kw["phoneme"] = r(spec.phoneme, hidden_channels=16, filter_channels=32)
    if spec.audiomae is not None:
        kw["audiomae"] = r(spec.audiomae, embed_dim=32, num_heads=2)
    if spec.sequence_gen is not None:
        kw["sequence_gen"] = r(spec.sequence_gen,
                               gpt2=r(spec.sequence_gen.gpt2, n_embd=64, n_head=4))
    return r(spec, nested=tuple(_narrow_spec(n) for n in spec.nested), **kw)


def narrow_config(name: str):
    """The JAX package's config of family ``name`` at its published depths
    (UNet levels, blocks and transformer depth, VAE levels, vocoder stages,
    T5 24 layers, GPT-2 12, RoBERTa 12, HTSAT-base's, AudioMAE 12, the
    phoneme encoder 6) with narrowed widths."""
    _register_narrow_towers()
    cfg = jconfig.default_audioldm_config(name)
    r = dataclasses.replace
    return r(cfg, unet=r(cfg.unet, model_channels=32, num_head_channels=16),
             vae=r(cfg.vae, ch=16), vocoder=r(cfg.vocoder, upsample_initial_channel=64),
             conditioners=tuple(_narrow_spec(s) for s in cfg.conditioners),
             reranker_clap=r(cfg.reranker_clap, amodel=NARROW_HTSAT, tmodel=NARROW_ROBERTA))


_TREES = {}


def jax_tree(name: str):
    """The JAX package's init_params tree of the narrowed family (fast
    init: numpy leaves), built once."""
    if name not in _TREES:
        _TREES[name] = jpipe.init_params(jax.random.PRNGKey(0), narrow_config(name), fast=True)
    return _TREES[name]


def flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def assert_trees_equal(got, want, rtol=None, where=lambda path: True):
    """Same paths; leaves of the same dtype and shape, bitwise equal (or
    within ``rtol`` on the paths ``where`` selects)."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))[:10]
    for k in w:
        if w[k] is None:
            assert g[k] is None, k
            continue
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        if rtol is not None and where(k):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=k)
        else:
            assert np.array_equal(a, b), k


def numpy_sd(tree, cfg, **options):
    """The tool's state dict of ``tree`` with numpy values, as
    ``state_dict_to_numpy`` of a loaded checkpoint gives."""
    sd = rl.reference_state_dict(tree, tconfig.coerce(cfg), **options)
    return tconvert.state_dict_to_numpy(sd)


def both_convert(sd, cfg):
    return (tpipe.convert_state_dict(dict(sd), tconfig.coerce(cfg)),
            jpipe.convert_state_dict(dict(sd), cfg))


# ---------------------------------------------------------------------------
# The tool against the JAX package's converter; the port's against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_norm", [False, True], ids=["weight", "weight_g_v"])
@pytest.mark.parametrize("name", FAMILIES)
def test_jax_converter_inverts_reference_layout(name, weight_norm):
    """JAX's convert_state_dict of the tool's state dict gives the tree back,
    bitwise (the vocoder's weight-norm fold at rtol 1e-6), with the
    skip-class keys ignored."""
    cfg, tree = narrow_config(name), jax_tree(name)
    sd = numpy_sd(tree, cfg, weight_norm=weight_norm, skip_keys=True)
    assert "betas" in sd and any(k.endswith(".position_ids") for k in sd)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    assert any(k.endswith(".weight_g") for k in sd) == weight_norm
    got = jpipe.convert_state_dict(sd, cfg)
    assert_trees_equal(got, tree, rtol=1e-6 if weight_norm else None,
                       where=lambda path: path.startswith("/vocoder/"))


@pytest.mark.parametrize("weight_norm", [False, True], ids=["weight", "weight_g_v"])
@pytest.mark.parametrize("name", FAMILIES)
def test_port_converter_matches_jax(name, weight_norm):
    cfg = narrow_config(name)
    sd = numpy_sd(jax_tree(name), cfg, weight_norm=weight_norm, skip_keys=True)
    got, want = both_convert(sd, cfg)
    assert_trees_equal(got, want)


@pytest.mark.parametrize("stored", ["shared_and_embed_tokens", "embed_tokens_only"])
def test_t5_tied_embedding_forms(stored):
    """The checkpoint stores T5's tied embedding under both names; a state
    dict with only encoder.embed_tokens converts the same, in both
    packages."""
    cfg, tree = narrow_config("audioldm_16k_crossattn_t5"), jax_tree("audioldm_16k_crossattn_t5")
    sd = numpy_sd(tree, cfg)
    key = "cond_stage_models.0.model.shared.weight"
    assert key in sd and "cond_stage_models.0.model.encoder.embed_tokens.weight" in sd
    if stored == "embed_tokens_only":
        del sd[key]
    got, want = both_convert(sd, cfg)
    assert_trees_equal(got, want)
    assert_trees_equal(got, tree)


@pytest.fixture(scope="module")
def tiny_tree():
    return nonzero_tree(jpipe.init_params(jax.random.PRNGKey(0), tiny_t5_model_config()))


def _with_ema(tree):
    """``tree`` with a distinct ``unet_ema`` (every UNet leaf plus 1)."""
    return {**tree, "unet_ema": jax.tree.map(lambda a: a + np.float32(1), tree["unet"])}


def test_ema_shadows_convert_to_unet_ema(tiny_tree):
    cfg = tiny_t5_model_config()
    tree = _with_ema(tiny_tree)
    sd = numpy_sd(tree, cfg, ema=True)
    assert sd["model_ema.diffusion_modelout2bias"].shape == tree["unet"]["out_conv"]["b"].shape
    got, want = both_convert(sd, cfg)
    assert_trees_equal(got, want)
    assert_trees_equal(got["unet_ema"], tree["unet_ema"])
    assert_trees_equal(got["unet"], tree["unet"])


def test_incomplete_ema_warns_and_is_left_out(tiny_tree):
    cfg = tiny_t5_model_config()
    sd = numpy_sd(_with_ema(tiny_tree), cfg, ema=True)
    del sd["model_ema.diffusion_modelout2bias"]
    with pytest.warns(UserWarning, match="model_ema.* keys present but incomplete"):
        got = tpipe.convert_state_dict(dict(sd), tconfig.coerce(cfg))
    with pytest.warns(UserWarning, match="model_ema.* keys present but incomplete"):
        want = jpipe.convert_state_dict(dict(sd), cfg)
    assert "unet_ema" not in got and "unet_ema" not in want
    assert_trees_equal(got, want)


def test_ambiguous_ema_shadow_is_refused(tiny_tree):
    """Two live names that flatten alike leave a shadow unattributable:
    both packages raise."""
    cfg = tiny_t5_model_config()
    sd = numpy_sd(tiny_tree, cfg, ema=True)
    one = np.zeros((1,), np.float32)
    sd.update({"model.extra.1.0b": one, "model.extra.10.b": one, "model_ema.extra10b": one})
    with pytest.raises(ValueError, match="matches multiple live parameters") as t_err:
        tpipe.convert_state_dict(dict(sd), tconfig.coerce(cfg))
    with pytest.raises(ValueError, match="matches multiple live parameters") as j_err:
        jpipe.convert_state_dict(dict(sd), cfg)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("key,named", [
    ("model.diffusion_model.middle_block.1.proj_in.weight", None),
    ("first_stage_model.decoder.up.0.block.1.conv2.bias", None),
    # without .weight, the fold looks for the weight-norm form
    ("first_stage_model.vocoder.resblocks.1.convs2.2.weight",
     "first_stage_model.vocoder.resblocks.1.convs2.2.weight_g"),
    ("cond_stage_models.0.model.encoder.block.1.layer.1.DenseReluDense.wo.weight", None),
])
def test_missing_key_raises_the_same_key_error(tiny_tree, key, named):
    """A key the converters read, removed: both raise KeyError naming the
    same key."""
    cfg = tiny_t5_model_config()
    sd = numpy_sd(tiny_tree, cfg)
    del sd[key]
    with pytest.raises(KeyError) as t_err:
        tpipe.convert_state_dict(dict(sd), tconfig.coerce(cfg))
    with pytest.raises(KeyError) as j_err:
        jpipe.convert_state_dict(dict(sd), cfg)
    assert t_err.value.args == j_err.value.args == (named or key,)


def test_scale_factor_is_optional(tiny_tree):
    """Without scale_factor both packages take 1.0."""
    cfg = tiny_t5_model_config()
    sd = numpy_sd(nonzero_tree({**tiny_tree, "scale_factor": np.float32(0.25)}), cfg)
    assert float(sd.pop("scale_factor")) == 0.25
    got, want = both_convert(sd, cfg)
    assert_trees_equal(got, want)
    assert got["scale_factor"].dtype == np.float32 and float(got["scale_factor"]) == 1.0


@pytest.mark.parametrize("name", FAMILIES)
def test_production_structure_without_memory(name):
    """At each family's published config: the tree build_model(device=
    "meta") gives, as zero-stride numpy leaves, completed by the tool (the
    nested AudioMAE encoder the port does not draw) and written in the
    reference layout, converts in both packages to the same paths and
    shapes, with docs/KEY_COVERAGE.md's leaf count."""
    meta = at.build_model(model_name=name, device="meta").ldm.params

    def zeros(t):
        return np.broadcast_to(np.zeros((), torch.empty(0, dtype=t.dtype).numpy().dtype),
                               tuple(t.shape))

    tree = rl.complete(jax.tree.map(zeros, meta, is_leaf=lambda x: isinstance(x, torch.Tensor)),
                       tconfig.default_audioldm_config(name))
    sd = numpy_sd(tree, jconfig.default_audioldm_config(name))
    got, want = both_convert(sd, jconfig.default_audioldm_config(name))
    g, w, t = flat(got), flat(want), flat(tree)
    assert sorted(g) == sorted(w) == sorted(t)
    assert all(np.shape(g[k]) == np.shape(w[k]) == np.shape(t[k]) for k in g)
    assert len(g) == KEY_COVERAGE_LEAVES[name]
    n_filled = len([k for k in t if "crossattn_audiomae_pooled" in k])
    assert n_filled == (0 if name in ("audioldm_48k", "audioldm_16k_crossattn_t5") else 150)


# ---------------------------------------------------------------------------
# build_model(ckpt_path) end to end
# ---------------------------------------------------------------------------


def test_one_pth_into_both_build_models(tiny_tree, tmp_path):
    """One .pth (wrapped as {"state_dict": ...}, with skip-class keys) into
    the JAX package's build_model and the port's: the same trees, and the
    same mel and waveform from the same x_T (bar: mel MAE < 1e-3)."""
    cfg = tiny_t5_model_config()
    path = str(tmp_path / "tiny.pth")
    rl.save_pth(path, rl.reference_state_dict(tiny_tree, tconfig.coerce(cfg), skip_keys=True))
    jmodel = jpipe.build_model(path, config=cfg)
    tmodel = at.build_model(path, config=cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(tmodel.ldm.params))
    assert_trees_equal(jax.tree.map(lambda t: t.numpy(), tmodel.ldm.params),
                       jax.tree.map(np.asarray, jmodel.ldm.params))
    assert_trees_equal(jax.tree.map(lambda t: t.numpy(), tmodel.ldm.params), tiny_tree)
    prompt = "a dog barking in the rain"
    jbatch, tbatch = jmodel.make_batch(prompt, batchsize=2), tmodel.make_batch(prompt, batchsize=2)
    lt = 16
    x_T = np.random.default_rng(7).standard_normal(
        (2, lt, cfg.latent_f_size, cfg.latent_channels)).astype(np.float32)
    kw = dict(latent_t_size=lt, n_gen=1, guidance=3.5, ddim_steps=4, ddim_eta=0.0)
    wj, mj = jmodel.ldm.generate(jbatch, jax.random.PRNGKey(0), x_T=x_T, **kw)
    wt, mt = tmodel.ldm.generate(tbatch, None, x_T=torch.from_numpy(x_T), **kw)
    assert float(np.abs(mj).mean()) > 1e-2
    assert float(np.abs(mt - mj).mean()) < 1e-3
    np.testing.assert_allclose(wt, wj, atol=1e-4)


def _int8_config():
    """The tiny t5 config with a UNet wide enough (128, 256) that every
    quantization predicate fires."""
    cfg = tiny_t5_model_config()
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, model_channels=128, num_head_channels=32, context_dims=(TINY_T5.d_model,)))


def test_int8_model_from_file_equals_model_from_params(tmp_path):
    cfg = _int8_config()
    tree = nonzero_tree(jpipe.init_params(jax.random.PRNGKey(1), cfg))
    path = str(tmp_path / "int8.pth")
    rl.save_pth(path, rl.reference_state_dict(tree, tconfig.coerce(cfg)), wrapped=False)
    kw = dict(config=cfg, device="cpu", weight_quant="int8")
    from_file, from_params = at.build_model(path, **kw), at.build_model(params=tree, **kw)
    assert from_file.cfg.weight_quant == "int8"
    call = dict(seed=5, ddim_steps=2, duration=0.32, duration_bucket=None,
                n_candidate_gen_per_text=1)
    a = at.text_to_audio(from_file, "rain", **call)
    assert np.isfinite(a).all() and np.abs(a).max() > 0
    np.testing.assert_array_equal(a, at.text_to_audio(from_params, "rain", **call))


@pytest.mark.parametrize("name", ["audioldm2-full", "audioldm2-speech-gigaspeech"])
def test_port_drawn_tree_round_trips_through_a_file(name, tmp_path):
    """What chip_smoke.py does at full width, here narrowed: the port's own
    drawn tree, completed and written by the tool, loads through
    build_model(ckpt_path) leaf for leaf (torch.equal), the filled AudioMAE
    encoder included, and the JAX package's loader reads the same file to
    the same tree."""
    jcfg = narrow_config(name)
    cfg = tconfig.coerce(jcfg)
    drawn = at.build_model(config=cfg, device="cpu", seed=3, nonzero_init=True).ldm.params
    path = str(tmp_path / f"{name}.pth")
    full = rl.complete(drawn, cfg, seed=4)
    rl.save_pth(path, rl.reference_state_dict(full, cfg))
    loaded = at.build_model(path, config=cfg, device="cpu").ldm.params
    want, got = flat(full), flat(loaded)
    assert sorted(got) == sorted(want)
    assert len(want) - len(flat(drawn)) == 150
    for k, v in want.items():
        assert torch.equal(got[k], torch.as_tensor(v)) and got[k].is_contiguous(), k
    assert_trees_equal(jax.tree.map(lambda t: t.numpy(), loaded),
                       jpipe.load_checkpoint_params(path, jcfg))


def test_build_model_loads_onto_the_device_asked_for(tiny_tree, tmp_path, monkeypatch):
    """The card by default: without one, build_model(ckpt_path) raises before
    reading the file; on "meta" it builds shapes only."""
    cfg = tiny_t5_model_config()
    path = str(tmp_path / "tiny.pth")
    rl.save_pth(path, rl.reference_state_dict(tiny_tree, tconfig.coerce(cfg)))
    meta = at.build_model(path, config=cfg, device="meta")
    assert all(t.is_meta for t in jax.tree.leaves(meta.ldm.params))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tpipe, "load_checkpoint_params",
                        lambda *a: pytest.fail("read the file without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.build_model(path, config=cfg)


# ---------------------------------------------------------------------------
# The .npz format and the converter's entry point
# ---------------------------------------------------------------------------


def _npz_tree():
    rng = np.random.default_rng(0)
    return {"a": {"w": rng.standard_normal((3, 2)).astype(np.float32), "none": None},
            "layers": [{"b": np.arange(4, dtype=np.int64)}, {"b": np.zeros((0,), np.float32)}],
            "scale_factor": np.asarray(0.5, np.float32), "flag": np.asarray(True)}


@pytest.mark.parametrize("tree", ["small", "tiny_t5"])
def test_npz_round_trips_between_packages(tree, tiny_tree, tmp_path):
    tree = _npz_tree() if tree == "small" else tiny_tree
    jckpt.save_npz(str(tmp_path / "jax.npz"), tree)
    tckpt.save_npz(str(tmp_path / "port.npz"), tree)
    from_jax = tckpt.load_npz(str(tmp_path / "jax.npz"))
    from_port = jckpt.load_npz(str(tmp_path / "port.npz"))
    assert_trees_equal(from_jax, tree)
    assert_trees_equal(from_port, tree)
    assert_trees_equal(tckpt.load(str(tmp_path / "port.npz")), tree)


def test_npz_tree_serves_through_params(tiny_tree, tmp_path):
    cfg = tiny_t5_model_config()
    path = str(tmp_path / "tiny.npz")
    jckpt.save_npz(path, tiny_tree)
    model = at.build_model(config=cfg, device="cpu", params=tckpt.load_npz(path))
    assert_trees_equal(jax.tree.map(lambda t: t.numpy(), model.ldm.params), tiny_tree)


@pytest.mark.parametrize("path", ["ckpt_dir", "ckpt.pth", "ckpt.npz.tmp"])
def test_only_npz_is_read_or_written(path, tmp_path):
    path = str(tmp_path / path)
    with pytest.raises(ValueError, match="orbax"):
        tckpt.save(path, _npz_tree())
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load(path)
    with pytest.raises(ValueError, match="orbax"):
        tckpt.convert_reference_checkpoint(str(tmp_path / "missing.pth"),
                                           "audioldm2-full", path)
    assert not os.path.exists(path)


@pytest.mark.parametrize("named", [False, True], ids=["inferred", "model_name"])
def test_convert_entry_point_matches_jax_conversion(named, tiny_tree, tmp_path, monkeypatch,
                                                    capsys):
    """python -m audioldm2_torch.convert (through main(argv)) writes an .npz
    that the JAX package's load_npz reads equal to its own conversion of
    the same .pth (the family's config patched to the tiny one)."""
    cfg = tiny_t5_model_config()
    monkeypatch.setattr(tconfig, "default_audioldm_config", lambda name: tconfig.coerce(cfg))
    pth = str(tmp_path / "audioldm_16k_crossattn_t5-tiny.pth")
    rl.save_pth(pth, rl.reference_state_dict(tiny_tree, tconfig.coerce(cfg), skip_keys=True))
    out = str(tmp_path / "out.npz")
    argv = [pth, out] + (["--model_name", "audioldm_16k_crossattn_t5"] if named else [])
    assert tconvert.main(argv) == 0
    printed = capsys.readouterr().out
    assert "as family 'audioldm_16k_crossattn_t5'" in printed
    assert f"ok: wrote {len(jax.tree.leaves(tiny_tree))} arrays" in printed
    assert_trees_equal(jckpt.load_npz(out), jpipe.load_checkpoint_params(pth, cfg))


def test_convert_entry_point_needs_a_family(tmp_path):
    with pytest.raises(SystemExit, match="cannot infer the checkpoint family"):
        tconvert.main([str(tmp_path / "model.pth"), str(tmp_path / "out.npz")])


@pytest.mark.parametrize("module", ["convert.py", "convert_cond.py", "convert_htsat.py",
                                    "utils/checkpoint.py", "tools/reference_layout.py"])
def test_loader_modules_import_neither_jax_nor_the_jax_package(module):
    path = os.path.join(REPO, "audioldm2_torch", module)
    tree = ast.parse(open(path).read(), filename=path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert names and not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "audioldm2_tpu")]
