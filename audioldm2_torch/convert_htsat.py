"""Checkpoint conversion for the HTSAT Swin audio tower
(reference ``clap/open_clip/htsat.py:777-1250``).

The port's copy of ``audioldm2_tpu/convert_htsat.py``: the depths come from
``cfg`` (``BASE`` unless given), the widths from the arrays."""

from __future__ import annotations

from typing import Dict

import numpy as np

from audioldm2_torch import convert
from audioldm2_torch.models.htsat import BASE, HTSATConfig


def convert_htsat(sd: Dict[str, np.ndarray], prefix: str = "", cfg: HTSATConfig = BASE) -> dict:
    layers = []
    for i_layer, depth in enumerate(cfg.depths):
        lp = f"{prefix}layers.{i_layer}"
        blocks = []
        for j in range(depth):
            bp = f"{lp}.blocks.{j}"
            blocks.append(
                {
                    "norm1": convert.norm_p(sd, bp + ".norm1"),
                    "attn": {
                        "qkv": convert.linear_p(sd, bp + ".attn.qkv"),
                        "proj": convert.linear_p(sd, bp + ".attn.proj"),
                        "rel_bias": sd[bp + ".attn.relative_position_bias_table"],
                    },
                    "norm2": convert.norm_p(sd, bp + ".norm2"),
                    "mlp": {
                        "fc1": convert.linear_p(sd, bp + ".mlp.fc1"),
                        "fc2": convert.linear_p(sd, bp + ".mlp.fc2"),
                    },
                }
            )
        layer = {"blocks": blocks}
        if i_layer < len(cfg.depths) - 1:
            layer["downsample"] = {
                "norm": convert.norm_p(sd, f"{lp}.downsample.norm"),
                "reduction": convert.linear_p(
                    sd, f"{lp}.downsample.reduction", bias=False
                ),
            }
        layers.append(layer)

    return {
        "bn0": {
            "scale": sd[prefix + "bn0.weight"],
            "bias": sd[prefix + "bn0.bias"],
            "mean": sd[prefix + "bn0.running_mean"],
            "var": sd[prefix + "bn0.running_var"],
        },
        "patch_embed": {
            "proj": convert.conv2d_p(sd, prefix + "patch_embed.proj"),
            "norm": convert.norm_p(sd, prefix + "patch_embed.norm"),
        },
        "layers": layers,
        "norm": convert.norm_p(sd, prefix + "norm"),
        "tscam_conv": convert.conv2d_p(sd, prefix + "tscam_conv"),
        "head": convert.linear_p(sd, prefix + "head"),
    }
