"""The port's sharded train step (``audioldm2_torch/parallel/train.py``:
``dryrun``, ``make_train_step(..., mesh=)``) on gloo ranks on the CPU, in
f32.

``dryrun(2, tp=(1, 2), device="cpu")`` runs JAX's dry-run UNet (ch 32,
mult (1, 2), one attention level, heads of 16, context 32) one AdamW step
at dp 2 and at tp 2, in one spawn of two ranks with a time limit of its
own, and holds each against the single-process step on the same global
batch and draws: the loss within 1e-5 and every updated leaf within 1e-5
relative (``train.DRYRUN_TOL``; Adam's eps at ``DRYRUN_ADAM_EPS``, see
there). JAX's own dry run (tests/test_training.py) checks only that its
loss is finite."""

import numpy as np
import pytest

from audioldm2_torch.parallel import mesh as tmesh
from audioldm2_torch.parallel import train as ttrain
from audioldm2_torch.models import unet as tunet
from audioldm2_tpu.parallel import mesh as jmesh
from audioldm2_tpu.parallel import train as jtrain


@pytest.fixture(scope="module")
def records():
    return {rec["mesh"]: rec for rec in ttrain.dryrun(2, tp=(1, 2), device="cpu", timeout=240.0)}


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)])
def test_sharded_step_matches_the_single_process_step(records, layout):
    rec = records[layout]
    assert np.isfinite(rec["loss"]) and rec["loss"] > 0.1
    assert abs(rec["loss"] - rec["ref_loss"]) <= ttrain.DRYRUN_TOL
    assert rec["leaf_rel"] <= ttrain.DRYRUN_TOL, rec
    assert rec["n_leaves"] > 300


def test_dryrun_unet_is_jax_dryrun_unet(records):
    """The dry run's UNet and the rules' count on it are JAX's."""
    import jax

    from audioldm2_torch.params import Init
    import torch

    cfg = ttrain.dryrun_unet_config()
    jtree = jax.tree.map(np.asarray, jtrain.unet_m.init_unet(jax.random.PRNGKey(0), cfg))
    ttree = tunet.init_unet(Init(torch.Generator().manual_seed(0), "cpu"), cfg)
    jshapes = {tuple(str(getattr(k, "key", getattr(k, "idx", None))) for k in p): leaf.shape
               for p, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tshapes = {tuple(map(str, p)): tuple(leaf.shape) for p, leaf in tmesh.leaves_with_paths(ttree)}
    assert jshapes == tshapes
    n = jmesh.sharded_leaf_count(jtree)
    assert n == tmesh.sharded_leaf_count(ttree) == records[(1, 2)]["n_sharded"] > 0
