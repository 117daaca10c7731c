"""The port's dp x tp mesh rules (``audioldm2_torch/parallel/mesh.py``)
against the JAX package's (``audioldm2_tpu/parallel/mesh.py``).

- ``param_spec`` gives JAX's ``_param_spec`` axes leaf for leaf, and
  ``sharded_leaf_count`` JAX's count, on the narrowed trees of all seven
  families (test_torch_convert's, JAX's fast init);
- ``shard_params`` at tp 2 and ``unshard_params`` give the tree back bit
  for bit, with the UNet's GEGLU ``proj_in`` cut as [a_r | gate_r] and
  T5's ``rel_bias`` whole on every rank;
- a renamed tree makes ``ShardedGenerator`` raise at tp > 1;
- the one-process mesh, the batch and replicated helpers."""

import jax
import numpy as np
import pytest
import torch

import audioldm2_torch as at
from audioldm2_torch import params as tparams
from audioldm2_torch.parallel import mesh as tmesh
from audioldm2_torch.parallel import serve as tserve
from audioldm2_tpu.parallel import mesh as jmesh
from test_torch_convert import FAMILIES, jax_tree
from tiny import tiny_t5_model_config


def _jax_keys(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


@pytest.mark.parametrize("name", FAMILIES)
def test_param_spec_matches_jax_leaf_for_leaf(name):
    tree = jax_tree(name)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) > 1000
    split = 0
    for path, leaf in flat:
        want = tuple(jmesh._param_spec(path, leaf))
        got = tmesh.param_spec(_jax_keys(path), leaf)
        assert got == want, (_jax_keys(path), got, want)
        split += "tp" in got
    assert tmesh.sharded_leaf_count(tree) == jmesh.sharded_leaf_count(tree) == split > 0


def _torch_tree(name):
    return tparams.from_jax_tree(jax_tree(name))


def _flat(tree):
    return dict(tmesh.leaves_with_paths(tree))


@pytest.mark.parametrize("name", ["audioldm_16k_crossattn_t5", "audioldm2-full-large-1150k"])
def test_shard_at_tp2_and_join_back_bit_for_bit(name):
    tree = _torch_tree(name)
    shards = [tmesh.shard_params(tree, tmesh.Mesh(dp=1, tp=2, rank=r)) for r in range(2)]
    back = tmesh.unshard_params(shards)
    want, got = _flat(tree), _flat(back)
    parts = [_flat(s) for s in shards]
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype and torch.equal(got[path], leaf), path
    cut = {p for p, leaf in want.items() if parts[0][p].shape != leaf.shape}
    assert cut and all(p[0] == "unet" or (p[0] == "cond" and p[2] == "t5") for p in cut)
    # the UNet's GEGLU projection: each rank [a_r | gate_r], not a or gate
    blk = ("unet", "middle_block", "self_st", "blocks", 0, "ff", "proj_in", "w")
    w = want[blk]
    f = w.shape[1] // 2
    for r, part in enumerate(parts):
        assert torch.equal(part[blk], torch.cat([w[:, r * f // 2:(r + 1) * f // 2],
                                                 w[:, f + r * f // 2:f + (r + 1) * f // 2]], 1))
    # T5's relative-position table stays whole on both ranks
    t5 = [p for p in want if p[-1] == "rel_bias" and p[0] == "cond"]
    assert t5 and all(torch.equal(part[p], want[p]) for part in parts for p in t5)


def test_leaves_outside_the_tp_modules_stay_whole():
    """The rules match the sequence generator's and the CLAP towers' q/k/v;
    those modules compute replicated, so their leaves are not cut, though
    sharded_leaf_count counts them as JAX's does."""
    tree = _torch_tree("audioldm2-full")
    shard = _flat(tmesh.shard_params(tree, tmesh.Mesh(dp=1, tp=2, rank=1)))
    matched = [p for p, leaf in _flat(tree).items() if "tp" in tmesh.param_spec(p, leaf)]
    outside = [p for p in matched if not tmesh.tp_computed(p)]
    assert {p[0] if p[0] != "cond" else p[1] for p in outside} == {
        "reranker_clap", "crossattn_audiomae_generated"}
    assert all(shard[p] is _flat(tree)[p] for p in outside)


def _renamed(tree):
    names = {"to_q", "to_k", "to_v", "to_out", "proj_in", "proj_out", "q", "k", "v", "o",
             "wi_0", "wi_1", "wo"}
    if isinstance(tree, dict):
        return {(k + "_renamed" if k in names else k): _renamed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_renamed(v) for v in tree]
    return tree


def test_renamed_tree_raises_at_tp2():
    cfg = at.config.coerce(tiny_t5_model_config())
    model = at.build_model(config=cfg, device="cpu", seed=0)
    assert tserve.ShardedGenerator(model, mesh=tmesh.Mesh(dp=1, tp=2)).n_sharded > 0
    model.ldm.params = _renamed(model.ldm.params)
    assert tmesh.sharded_leaf_count(model.ldm.params) == 0
    with pytest.raises(RuntimeError, match="matched 0 tensors"):
        tserve.ShardedGenerator(model, mesh=tmesh.Mesh(dp=1, tp=2))
    assert tserve.ShardedGenerator(model, mesh=tmesh.Mesh(dp=2, tp=1)).n_sharded == 0


def test_one_process_mesh_and_helpers():
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.dp, mesh.tp, mesh.dp_rank, mesh.tp_rank) == (1, 1, 0, 0)
    with pytest.raises(RuntimeError, match="initialize torch.distributed"):
        tmesh.make_mesh(2, device="cpu")
    x = torch.arange(12.0).reshape(6, 2)
    m = tmesh.Mesh(dp=3, tp=2, rank=5)  # JAX's reshape(dp, tp): rank 5 is (2, 1)
    assert (m.dp_rank, m.tp_rank) == (2, 1)
    assert torch.equal(tmesh.batch_sharding(m, x), x[4:6])
    assert torch.equal(tmesh.replicated(m, x), x)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.batch_sharding(tmesh.Mesh(dp=4, tp=1), x)


def test_shard_params_at_tp1_is_the_tree():
    tree = {"unet": {"a": {"to_q": {"w": torch.ones(4, 4)}}}}
    assert tmesh.shard_params(tree, tmesh.Mesh(dp=2, tp=1, rank=1)) is tree
    assert np.array_equal(tmesh.param_spec(("unet", "a", "to_q", "w"), torch.ones(4, 4)),
                          (None, "tp"))
