"""Attentional feature fusion (DAF, AFF, iAFF), CLAP's fusion gates, in
PyTorch.

Port of ``audioldm2_tpu/models/feature_fusion.py`` (Dai et al., WACV
2021). The shipped checkpoints run CLAP without fusion and no path of
either package calls these; they are here for the config's ``aff_2d``
family. Channels-last ([..., C]); the 1x1 convs are linears and the
BatchNorms run on stored statistics.
"""

from __future__ import annotations

import torch

from audioldm2_torch.ops import nn
from audioldm2_torch.params import Init


def _bn(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return (x - p["mean"]) * torch.rsqrt(p["var"] + eps) * p["scale"] + p["bias"]


def _att_init(ini: Init, channels: int, inter: int):
    def bn(c):
        return {"scale": torch.ones((c,), device=ini.device), "bias": ini.zeros((c,)),
                "mean": ini.zeros((c,)), "var": torch.ones((c,), device=ini.device)}
    return {"conv1": ini.linear(channels, inter), "bn1": bn(inter),
            "conv2": ini.linear(inter, channels), "bn2": bn(channels)}


def _att(p, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(_bn(p["bn1"], nn.linear(p["conv1"], x)))
    return _bn(p["bn2"], nn.linear(p["conv2"], h))


def init_aff(ini: Init, channels: int = 64, r: int = 4, iterative: bool = False):
    inter = channels // r
    names = ("local", "global", "local2", "global2") if iterative else ("local", "global")
    return {n: _att_init(ini, channels, inter) for n in names}


def _gate(p_local, p_global, xa: torch.Tensor) -> torch.Tensor:
    """sigmoid(local_att(xa) + global_att(the mean of xa over its spatial axes))."""
    spatial = tuple(range(1, xa.dim() - 1))
    return torch.sigmoid(_att(p_local, xa) + _att(p_global, xa.mean(dim=spatial, keepdim=True)))


def daf(x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """DirectAddFuse."""
    return x + residual


def aff(p, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """AFF: 2 x w + 2 residual (1 - w)."""
    wei = _gate(p["local"], p["global"], x + residual)
    return 2.0 * x * wei + 2.0 * residual * (1.0 - wei)


def iaff(p, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """iAFF: two gating rounds. The second reuses ``global`` (not
    ``global2``), as the reference does, so that its checkpoints load."""
    wei = _gate(p["local"], p["global"], x + residual)
    xi = x * wei + residual * (1.0 - wei)
    wei2 = _gate(p["local2"], p["global"], xi)
    return x * wei2 + residual * (1.0 - wei2)
