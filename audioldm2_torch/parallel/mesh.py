"""The dp x tp device mesh and the Megatron sharding rules, over
``torch.distributed``.

Port of ``audioldm2_tpu/parallel/mesh.py``. The JAX package builds one
``jax.sharding.Mesh`` with axes ("dp", "tp"), places every leaf by a
``PartitionSpec`` that its rules pick from the key path, and lets GSPMD
insert the collectives. The port runs one process per rank: a
:class:`Mesh` holds the rank's coordinates and one process group per axis,
:func:`shard_params` cuts each leaf to the rank's slice by the same rules,
and the model code calls the collectives of ``parallel.collectives``
explicitly. The rank layout is JAX's ``devices.reshape(dp, tp)``: global
rank = dp_rank * tp + tp_rank.

The rules match leaves all over the tree (``param_spec`` is JAX's
``_param_spec`` rule for rule, and ``sharded_leaf_count`` counts what they
match), but only two modules compute on the slices: the UNet (``unet``)
and the top-level FLAN-T5 conditioners (``cond.<name>.t5``). Every other
leaf the rules match (the CLAP towers, GPT-2 and the conditioners nested in
the sequence generator) stays whole on each rank, and its module computes
replicated; the output is the same either way.

The rules split the stored float weights. The int8 serving mode quantizes
once a call, after the split (``models.unet.quantize_st_linears``, which
asks :func:`split_axis` how each leaf was cut): a column-split leaf's int8
slice keeps its columns' scales, a row-split leaf's takes the whole
weight's scales (a max all-reduce over tp), so every rank holds the slices
of the whole tree's quantization.

The backend is the caller's: ``make_mesh`` never swaps one for another.
NCCL refuses two ranks on one device, so with more ranks than cards it
raises unless the caller asked for gloo.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from audioldm2_torch.params import leaves_with_paths  # noqa: F401  (the package's tree walk)

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a dp x tp mesh. ``dp_group`` joins the ranks of
    this rank's tp coordinate (the data-parallel replicas of its slice),
    ``tp_group`` the ranks of its dp coordinate (the slices of one
    replica); both None on a one-process mesh."""

    dp: int
    tp: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    dp_group: Any = None
    tp_group: Any = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def _device(device, rank: int) -> torch.device:
    """``device``, with a card's index rank % device_count where it names
    none; None is the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              backend: Optional[str] = None, device=None) -> Mesh:
    """The dp x tp mesh over the ranks of the initialized default process
    group (one process per rank; ``n_devices`` must equal its world size),
    or a one-process mesh when there is no group and ``n_devices`` is 1 or
    None. ``tp`` defaults to JAX's: 2 when the count is even and above 1.
    ``backend`` (default: the default group's) is the axis groups'; the
    rank's device is ``device``, else the card ``rank % device_count``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise RuntimeError(f"make_mesh({n_devices}): initialize torch.distributed with "
                               f"{n_devices} ranks first (parallel.launch.spawn does)")
        if tp not in (None, 1):
            raise ValueError(f"make_mesh: tp={tp} needs {tp} ranks")
        return Mesh(1, 1, 0, _device(device, 0))
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh({n}): the process group has {world} ranks (one per device)")
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if n % tp:
        raise ValueError(f"make_mesh: tp={tp} does not divide {n} ranks")
    backend = backend or dist.get_backend()
    dev = _device(device, rank)
    if backend == "nccl" and dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"make_mesh: {world} ranks on {torch.cuda.device_count()} card(s): NCCL "
                         "refuses two ranks on one device; pass backend='gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dp = n // tp
    dp_group = tp_group = None
    for d in range(dp):  # every rank creates every group, in one order
        g = dist.new_group([d * tp + t for t in range(tp)], backend=backend)
        if d == rank // tp:
            tp_group = g
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)], backend=backend)
        if t == rank % tp:
            dp_group = g
    return Mesh(dp, tp, rank, dev, backend, dp_group, tp_group)


# ---------------------------------------------------------------------------
# The rules (JAX mesh.py:39-75, rule for rule)
# ---------------------------------------------------------------------------


def param_spec(path: Sequence, leaf) -> Spec:
    """Megatron specs by key path (dict keys and list indices, root first):
    (None, "tp") splits the columns of a [K, N] weight, ("tp", None) its
    rows, ("tp",) a column-split bias, () keeps the leaf whole.
    Column-split: attention q/k/v (``to_q``/``to_k``/``to_v``, T5's
    ``attn.q/k/v``) and the FF's input (``ff.proj_in``, T5's ``ff.wi_0``/
    ``wi_1``); row-split: attention out (``to_out``, T5's ``attn.o``) and
    the FF's output (``ff.proj_out``, ``ff.wo``); the rest whole."""
    keys = [str(k) for k in path]
    name = ".".join(keys)
    leafname = keys[-1] if keys else ""
    ndim = getattr(leaf, "ndim", 0)

    def spec_for_linear(col: bool) -> Spec:
        if leafname == "w" and ndim == 2:
            return (None, "tp") if col else ("tp", None)
        if leafname == "b" and ndim == 1 and col:
            return ("tp",)
        return ()

    if any(s in name for s in (".to_q.", ".to_k.", ".to_v.")) or name.endswith(
            (".to_q.w", ".to_k.w", ".to_v.w")):
        return spec_for_linear(col=True)
    if ".attn." in name and leafname == "w":
        if any(name.endswith(s + ".w") for s in ("q", "k", "v")):
            return (None, "tp")
        if name.endswith("o.w"):
            return ("tp", None)
    if ".to_out." in name:
        return spec_for_linear(col=False)
    if ".ff.proj_in." in name or ".ff.wi_0." in name or ".ff.wi_1." in name:
        return spec_for_linear(col=True)
    if ".ff.proj_out." in name or ".ff.wo." in name:
        return spec_for_linear(col=False)
    return ()


def sharded_leaf_count(params) -> int:
    """How many leaves :func:`param_spec` tp-splits. The rules match by key
    name, so a renamed tree would silently run tp > 1 replicated; callers
    that ask for tensor parallelism check that this is not zero
    (``ShardedGenerator`` does)."""
    return sum(1 for path, leaf in leaves_with_paths(params) if "tp" in param_spec(path, leaf))


def tp_computed(path: Sequence) -> bool:
    """Whether the port computes the module of this path on tp slices: the
    UNet, and a top-level FLAN-T5 conditioner."""
    return bool(path) and (path[0] == "unet" or (
        path[0] == "cond" and len(path) > 2 and path[2] == "t5"))


def _is_geglu_in(path: Sequence) -> bool:
    """The UNet's GEGLU projection [C, 2F], whose columns are [a | gate]."""
    return path[0] == "unet" and ".ff.proj_in." in ".".join(map(str, path))


def _split(path, leaf, spec, tp: int, r: int):
    axis = spec.index("tp")
    if _is_geglu_in(path):  # cut a and gate each over F: [a_r | gate_r]
        a, gate = torch.chunk(leaf, 2, dim=axis)
        return torch.cat([torch.chunk(a, tp, dim=axis)[r], torch.chunk(gate, tp, dim=axis)[r]],
                         dim=axis)
    return torch.chunk(leaf, tp, dim=axis)[r].contiguous()


def _join(path, parts, spec):
    axis = spec.index("tp")
    if _is_geglu_in(path):
        halves = [torch.chunk(p, 2, dim=axis) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=axis)
    return torch.cat(parts, dim=axis)


def _rebuild(tree, fn, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, prefix + (i,)) for i, v in enumerate(tree))
    return tree if tree is None else fn(prefix, tree)


def _sharded(path, leaf) -> Optional[Spec]:
    spec = param_spec(path, leaf)
    return spec if "tp" in spec and tp_computed(path) and isinstance(leaf, torch.Tensor) else None


def split_axis(path: Sequence, leaf) -> Optional[int]:
    """The axis along which :func:`shard_params` cuts the leaf at ``path``
    (in a whole model tree), or None where every rank holds it whole. The
    UNet's fused self-attention QKV (``to_qkv``, which ``models.unet.
    fuse_self_qkv`` makes once a call from the rank's q, k and v slices)
    splits as the column-split q, k and v it was fused from."""
    spec = _sharded(tuple("to_q" if k == "to_qkv" else k for k in path), leaf)
    return None if spec is None else spec.index("tp")


def shard_params(tree, mesh: Mesh, prefix: tuple = ()):
    """The rank's tree: each leaf that the rules split and that a tp module
    computes, cut to the rank's tp slice (the UNet's GEGLU ``proj_in`` cut
    in both halves, so each slice is [a_r | gate_r]); every other leaf as
    it is (the same tensor). ``prefix`` is the path of ``tree`` in a whole
    model tree (("unet",) for a UNet tree alone). The counterpart of JAX's
    ``param_shardings``."""
    if mesh.tp == 1:
        return tree

    def cut(path, leaf):
        full = prefix + path
        spec = _sharded(full, leaf)
        return leaf if spec is None else _split(full, leaf, spec, mesh.tp, mesh.tp_rank)

    return _rebuild(tree, cut)


def unshard_params(shards: Sequence, prefix: tuple = ()):
    """The whole tree from the tp ranks' trees (in tp-rank order), the
    inverse of :func:`shard_params`: split leaves joined, the rest taken
    from the first."""
    trees = list(shards)
    if len(trees) == 1:
        return trees[0]
    flat = [dict(leaves_with_paths(t)) for t in trees]

    def join(path, leaf):
        full = prefix + path
        spec = param_spec(full, leaf)
        if "tp" not in spec or not tp_computed(full) or not isinstance(leaf, torch.Tensor):
            return leaf
        return _join(full, [f[path] for f in flat], spec)

    return _rebuild(trees[0], join)


def gather_params(tree, mesh: Mesh, prefix: tuple = ()):
    """The whole tree on every rank from each rank's tp slices
    (``collectives.all_gather`` over the tp group, then
    :func:`unshard_params`)."""
    from audioldm2_torch.parallel import collectives

    if mesh.tp == 1:
        return tree
    parts = {}
    for path, leaf in leaves_with_paths(tree):  # one order on every rank
        if _sharded(prefix + path, leaf) is not None:
            parts[path] = collectives.all_gather(leaf, mesh, mesh.tp_group, mesh.tp)

    def join(path, leaf):
        if path not in parts:
            return leaf
        return _join(prefix + path, parts[path], param_spec(prefix + path, leaf))

    return _rebuild(tree, join)


def batch_sharding(mesh: Mesh, x):
    """The rank's rows of a batch-leading array (its dp share; the same on
    every tp rank of one replica)."""
    b = x.shape[0]
    if b % mesh.dp:
        raise ValueError(f"batch_sharding: {b} rows do not divide over dp={mesh.dp}")
    rows = b // mesh.dp
    return x[mesh.dp_rank * rows:(mesh.dp_rank + 1) * rows]


def replicated(mesh: Mesh, x):
    """A whole copy of ``x`` on the rank's device."""
    return x.to(mesh.device) if isinstance(x, torch.Tensor) else x
