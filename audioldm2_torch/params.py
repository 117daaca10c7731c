"""Parameter trees of the port: nested dicts and lists of tensors with the
JAX package's keys, shapes and layouts.

:func:`from_jax_tree` converts the JAX package's numpy tree (the output of
``audioldm2_tpu.pipeline.init_params`` or ``convert_state_dict``) leaf for
leaf, which is how both packages get the same weights. :func:`init_params`
draws a tree of the same structure directly on the device with a
``torch.Generator``: drawing ~0.8 B values with numpy on the host is the
slow path the JAX package documents (``ops/nn.py:41-47``).
:func:`draw_tree` fills the same structure with numpy values keyed by each
leaf's path, which any machine rebuilds without JAX (:func:`tree_digest`).
"""

from __future__ import annotations

import functools
import hashlib
import math
import zlib
from typing import Any, Dict

import numpy as np
import torch

from audioldm2_torch.config import ModelConfig


def from_jax_tree(tree: Any, device="cpu", dtype: torch.dtype = torch.float32) -> Any:
    """numpy (or jax) array leaves -> torch tensors on ``device``; floating
    leaves are cast to ``dtype``, integer leaves keep their type, and
    non-array leaves (ints, strings) pass through."""
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_tree(v, device, dtype) for v in tree)
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        a = np.asarray(tree)
        # the array as it lies in memory (a leaf converted from a checkpoint is
        # a transposed view of the loaded tensor) to the device, then one
        # contiguous copy there, which owns its memory
        t = torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)
        if t.is_floating_point():
            t = t.to(dtype)
        return t.clone(memory_format=torch.contiguous_format)
    return tree


def map_tree(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast float32 leaves to ``dtype`` (the JAX package's cast_tree)."""
    return map_tree(lambda t: t.to(dtype) if t.dtype == torch.float32 else t, tree)


class Init:
    """Leaf initializers with the JAX package's shapes and distributions
    (``ops/nn.py:112-159``), drawn from one generator on one device.

    ``nonzero=True`` also draws the leaves the JAX init sets to zero (every
    ResBlock ``out_conv``, every spatial-transformer ``proj_out``, the UNet
    ``out_conv``). With them zero the UNet's output is identically zero, and
    every kernel-against-plain comparison downstream of it is trivially
    equal."""

    def __init__(self, generator: torch.Generator, device, nonzero: bool = False):
        self.g = generator
        self.device = torch.device(device)
        self.nonzero = nonzero

    def fork(self, name: str) -> "Init":
        """An Init on a generator of its own, seeded from this one's seed and
        ``name``. Drawing from the fork does not advance this generator, so
        every leaf this one draws is what it would be without the fork."""
        seed = (self.g.initial_seed() * 1_000_003 + zlib.crc32(name.encode())) % 2**63
        return Init(torch.Generator(device=self.g.device).manual_seed(seed), self.device,
                    self.nonzero)

    def _uniform(self, shape, bound: float) -> torch.Tensor:
        r = torch.rand(shape, generator=self.g, device=self.device, dtype=torch.float32)
        return r.mul_(2 * bound).sub_(bound)

    def randn(self, shape, std: float = 1.0) -> torch.Tensor:
        r = torch.randn(shape, generator=self.g, device=self.device, dtype=torch.float32)
        return r.mul_(std) if std != 1.0 else r

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=torch.float32)

    def _kaiming(self, shape, fan_in: int) -> torch.Tensor:
        return self._uniform(shape, math.sqrt(1.0 / fan_in) * math.sqrt(3.0))

    def conv(self, kh, kw, cin, cout, zero: bool = False,
             bias: bool = True) -> Dict[str, torch.Tensor]:
        if zero and not self.nonzero:
            return {"w": self.zeros((kh, kw, cin, cout)), "b": self.zeros((cout,))}
        fan_in = kh * kw * cin
        p = {"w": self._kaiming((kh, kw, cin, cout), fan_in)}
        if bias:
            p["b"] = self._kaiming((cout,), fan_in)
        return p

    def conv1d(self, k, cin, cout, zero: bool = False) -> Dict[str, torch.Tensor]:
        if zero and not self.nonzero:
            return {"w": self.zeros((k, cin, cout)), "b": self.zeros((cout,))}
        fan_in = k * cin
        return {"w": self._kaiming((k, cin, cout), fan_in), "b": self._kaiming((cout,), fan_in)}

    def linear(self, cin, cout, bias: bool = True) -> Dict[str, torch.Tensor]:
        p = {"w": self._kaiming((cin, cout), cin)}
        if bias:
            p["b"] = self._kaiming((cout,), cin)
        return p

    def norm(self, c) -> Dict[str, torch.Tensor]:
        return {"scale": torch.ones((c,), device=self.device), "bias": self.zeros((c,))}


# The draw keyed by leaf path (draw_tree): one pool of uniform values from
# PCG64's raw stream, which numpy keeps stable across versions, converted
# with exact arithmetic only, so every machine fills it alike. Its odd length
# keeps a leaf's rows from lining up with the pool's period.
DRAW_POOL_SIZE = (1 << 22) + 1
DRAW_ONE_NAMES = frozenset({"scale", "var", "scale_factor"})
DRAW_SMALL_STD = 0.05


@functools.lru_cache(maxsize=2)
def _draw_pool(seed: int) -> np.ndarray:
    """DRAW_POOL_SIZE float32 values, uniform on [-sqrt 3, sqrt 3) (mean 0,
    variance 1): the top 24 bits k of each raw 64-bit word as
    ((k + 0.5) / 2**23 - 1) * sqrt 3."""
    raw = np.random.PCG64(np.random.SeedSequence([int(seed), 0xA2D7])).random_raw(
        DRAW_POOL_SIZE)
    u = ((raw >> np.uint64(40)).astype(np.float64) + 0.5) / float(1 << 23) - 1.0
    return (u * math.sqrt(3.0)).astype(np.float32)


def draw_leaf(seed: int, path: str, shape) -> np.ndarray:
    """The float32 values of the leaf at ``path`` ("unet/out_conv/w") of
    ``shape``: a cyclic copy of the seed's pool from an offset hashed from
    (path, shape), scaled by the leaf's role:

    - two or more dimensions (a weight; the JAX layouts put the output
      features last): std 1 / sqrt(fan_in), fan_in the product of all but
      the last dimension, so each layer keeps its activations O(1);
    - a multiplicative scale (a norm's ``scale``, a running ``var``, the
      latent ``scale_factor``): 1 + 0.05 x (mean 1, always positive);
    - any other vector or scalar (biases, running means, logit scales):
      0.05 x.

    No leaf is all zero, so the UNet's zero-initialized output convs and
    ``proj_out`` leaves (see :class:`Init`) are live."""
    shape = tuple(int(s) for s in shape)
    pool = _draw_pool(seed)
    n = math.prod(shape)
    digest = hashlib.sha256(f"{path}|{shape}".encode()).digest()
    off = int.from_bytes(digest[:8], "little") % pool.size
    out = np.empty(n, np.float32)
    first = min(n, pool.size - off)
    out[:first] = pool[off:off + first]
    filled = first
    while filled < n:
        c = min(pool.size, n - filled)
        out[filled:filled + c] = pool[:c]
        filled += c
    if len(shape) >= 2:
        out *= np.float32(1.0 / math.sqrt(math.prod(shape[:-1])))
    elif path.rsplit("/", 1)[-1] in DRAW_ONE_NAMES:
        out *= np.float32(DRAW_SMALL_STD)
        out += np.float32(1.0)
    else:
        out *= np.float32(DRAW_SMALL_STD)
    return out.reshape(shape)


def leaves_with_paths(tree: Any, prefix: tuple = ()):
    """(path, leaf) of every non-container, non-None node of a tree of
    dicts, lists and tuples, the path a tuple of keys and indices, in sorted
    key order (JAX's flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def tree_paths(tree: Any):
    """(path, leaf) of every leaf, the keys and list indices joined by "/"."""
    for path, leaf in leaves_with_paths(tree):
        yield "/".join(map(str, path)), leaf


def fill_tree(tree: Any, seed: int = 0, prefix: str = "") -> Any:
    """A copy of ``tree`` (any nest of dicts, lists and tuples over arrays or
    tensors: numpy, JAX, torch, ``"meta"``) with each floating leaf replaced
    by :func:`draw_leaf`'s numpy values at its path and shape; other leaves
    pass through."""
    if isinstance(tree, dict):
        return {k: fill_tree(v, seed, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fill_tree(v, seed, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    dtype = getattr(tree, "dtype", None)
    floating = (dtype.is_floating_point if isinstance(dtype, torch.dtype)
                else dtype is not None and np.dtype(dtype).kind == "f")
    return draw_leaf(seed, prefix, tree.shape) if floating else tree


def draw_tree(cfg: ModelConfig, seed: int = 0) -> Dict:
    """The parameter tree of ``cfg`` as numpy float32 arrays in the JAX
    package's keys and layouts, every value a function of (seed, the leaf's
    path, its shape) alone (:func:`draw_leaf`): numpy only, no torch or JAX
    random state, at memory-copy speed. The same tree feeds both packages
    (``audioldm2_tpu.pipeline.AudioLDM2(cfg, tree)`` and
    ``build_model(params=tree)``), and any machine rebuilds it to the same
    :func:`tree_digest`. The structure is the port's own init on the
    ``"meta"`` device (shapes only)."""
    return fill_tree(init_params(cfg, torch.Generator().manual_seed(0), "meta"), seed)


def tree_digest(tree: Any) -> str:
    """SHA-256 over the leaves in sorted path order: each leaf's path, shape,
    dtype and bytes (numpy, JAX or CPU torch leaves)."""
    h = hashlib.sha256()
    for path, leaf in sorted(tree_paths(tree), key=lambda pl: pl[0]):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(f"{path}|{a.shape}|{a.dtype.str}|".encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                nonzero: bool = False) -> Dict:
    """Random tree with the JAX ``pipeline.init_params`` structure: the
    UNet, VAE, vocoder, every conditioner (nested ones included) and, when
    ``cfg.reranker_clap`` is set, the DDPM-level CLAP reranker read by the
    rerank of ``n_candidate_gen_per_text > 1``."""
    from audioldm2_torch.models import clap, conditioners, unet, vae, vocoder

    ini = Init(generator, device, nonzero=nonzero)
    tree = {
        "unet": unet.init_unet(ini, cfg.unet),
        "vae": vae.init_vae(ini, cfg.vae),
        "vocoder": vocoder.init_vocoder(ini, cfg.vocoder),
        "cond": {spec.name: conditioners.init_conditioner(ini, spec) for spec in cfg.conditioners},
        "scale_factor": torch.tensor(1.0, device=ini.device),
    }
    if cfg.reranker_clap is not None:
        tree["reranker_clap"] = clap.init_clap(ini, cfg.reranker_clap)
    return tree
