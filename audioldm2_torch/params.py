"""Parameter trees of the port: nested dicts and lists of tensors with the
JAX package's keys, shapes and layouts.

:func:`from_jax_tree` converts the JAX package's numpy tree (the output of
``audioldm2_tpu.pipeline.init_params`` or ``convert_state_dict``) leaf for
leaf, which is how both packages get the same weights. :func:`init_params`
draws a tree of the same structure directly on the device with a
``torch.Generator``: drawing ~0.8 B values with numpy on the host is the
slow path the JAX package documents (``ops/nn.py:41-47``).
"""

from __future__ import annotations

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
