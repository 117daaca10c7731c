"""KL-VAE decoder over mel spectrograms, in PyTorch.

Port of the decode path of ``audioldm2_tpu/models/vae.py``: GroupNorm(32,
eps 1e-6) + SiLU ResNet blocks through the K1 dispatch point, single-head
mid-block attention over all T*M positions (head width 512, which the plain
attention path takes, as XLA does in the JAX package), nearest-2x
upsampling. Activations are [B, T, M, C]. ``init_vae`` draws the whole
tree (encoder included) so it matches the JAX structure; the encoder's
apply path is not ported yet.
"""

from __future__ import annotations

import torch

from audioldm2_tpu.config import VAEConfig
from audioldm2_torch.ops import KERNEL_NAMES, nn
from audioldm2_torch.params import Init

GN_EPS = 1e-6


def _resblock_init(ini: Init, cin, cout):
    p = {
        "norm1": ini.norm(cin),
        "conv1": ini.conv(3, 3, cin, cout),
        "norm2": ini.norm(cout),
        "conv2": ini.conv(3, 3, cout, cout),
    }
    if cin != cout:
        p["nin_shortcut"] = ini.conv(1, 1, cin, cout)
    return p


def _attnblock_init(ini: Init, c):
    return {"norm": ini.norm(c), "q": ini.conv(1, 1, c, c), "k": ini.conv(1, 1, c, c),
            "v": ini.conv(1, 1, c, c), "proj_out": ini.conv(1, 1, c, c)}


def init_encoder(ini: Init, cfg: VAEConfig):
    ch, mults = cfg.ch, cfg.ch_mult
    p = {"conv_in": ini.conv(3, 3, cfg.in_channels, ch)}
    in_mults = (1,) + tuple(mults)
    down = []
    block_in = ch
    for i, mult in enumerate(mults):
        block_in = ch * in_mults[i]
        block_out = ch * mult
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blocks.append(_resblock_init(ini, block_in, block_out))
            block_in = block_out
        level = {"block": blocks}
        if i != len(mults) - 1:
            if i in cfg.downsample_time_stride4_levels:
                level["downsample_ts4"] = ini.conv(5, 5, block_in, block_in)
            else:
                level["downsample"] = ini.conv(3, 3, block_in, block_in)
        down.append(level)
    p["down"] = down
    p["mid"] = {"block_1": _resblock_init(ini, block_in, block_in),
                "attn_1": _attnblock_init(ini, block_in),
                "block_2": _resblock_init(ini, block_in, block_in)}
    z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
    p["norm_out"] = ini.norm(block_in)
    p["conv_out"] = ini.conv(3, 3, block_in, z_out)
    return p


def init_decoder(ini: Init, cfg: VAEConfig):
    ch, mults = cfg.ch, cfg.ch_mult
    block_in = ch * mults[-1]
    p = {"conv_in": ini.conv(3, 3, cfg.z_channels, block_in)}
    p["mid"] = {"block_1": _resblock_init(ini, block_in, block_in),
                "attn_1": _attnblock_init(ini, block_in),
                "block_2": _resblock_init(ini, block_in, block_in)}
    up = [None] * len(mults)
    for i in reversed(range(len(mults))):
        block_out = ch * mults[i]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_resblock_init(ini, block_in, block_out))
            block_in = block_out
        level = {"block": blocks}
        if i != 0:
            if (i - 1) in cfg.downsample_time_stride4_levels:
                level["upsample_ts4"] = ini.conv(5, 5, block_in, block_in)
            else:
                level["upsample"] = ini.conv(3, 3, block_in, block_in)
        up[i] = level
    p["up"] = up
    p["norm_out"] = ini.norm(block_in)
    p["conv_out"] = ini.conv(3, 3, block_in, cfg.out_ch)
    return p


def init_vae(ini: Init, cfg: VAEConfig):
    z2 = 2 * cfg.z_channels
    return {
        "encoder": init_encoder(ini, cfg),
        "decoder": init_decoder(ini, cfg),
        "quant_conv": ini.conv(1, 1, z2, 2 * cfg.embed_dim),
        "post_quant_conv": ini.conv(1, 1, cfg.embed_dim, cfg.z_channels),
    }


def _resblock(p, x):
    h = nn.gn_silu_conv(p["norm1"], p["conv1"], x, eps=GN_EPS)
    h = nn.gn_silu_conv(p["norm2"], p["conv2"], h, eps=GN_EPS)
    if "nin_shortcut" in p:
        x = nn.conv2d(p["nin_shortcut"], x)
    return x + h


def _attnblock(p, x):
    b, h, w, c = x.shape
    hn = nn.group_norm(p["norm"], x, eps=GN_EPS)
    q = nn.conv2d(p["q"], hn).reshape(b, h * w, 1, c)
    k = nn.conv2d(p["k"], hn).reshape(b, h * w, 1, c)
    v = nn.conv2d(p["v"], hn).reshape(b, h * w, 1, c)
    out = nn.attention(q, k, v).reshape(b, h, w, c)
    return x + nn.conv2d(p["proj_out"], out)


def apply_decoder(p, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    h = nn.conv2d(p["conv_in"], z)
    h = _resblock(p["mid"]["block_1"], h)
    h = _attnblock(p["mid"]["attn_1"], h)
    h = _resblock(p["mid"]["block_2"], h)
    for i in reversed(range(len(p["up"]))):
        level = p["up"][i]
        for rb in level["block"]:
            h = _resblock(rb, h)
        if "upsample" in level:
            h = nn.conv2d(level["upsample"], nn.nearest_upsample_2d(h))
        elif "upsample_ts4" in level:
            h = nn.conv2d(level["upsample_ts4"], nn.nearest_upsample_2d(h, 4, 2), padding=2)
    h = nn.group_norm_silu(p["norm_out"], h, eps=GN_EPS)
    return nn.conv2d(p["conv_out"], h)


def decode(p, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """z: [B, t, f, embed_dim] -> mel [B, T, M, 1]."""
    z = nn.conv2d(p["post_quant_conv"], z)
    return apply_decoder(p["decoder"], cfg, z)


def kernel_launches_per_decode(cfg: VAEConfig) -> dict:
    """Kernel launches of one decode: two K1 per decoder ResBlock (two
    mid-block ResBlocks, num_res_blocks + 1 per level); the single-head
    mid attention takes K2 only if its width is a kernel head_dim (it is
    512 in every shipped config, so it runs the plain path)."""
    n_res = 2 + len(cfg.ch_mult) * (cfg.num_res_blocks + 1)
    width = cfg.ch * cfg.ch_mult[-1]
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    counts.update(gn_silu_conv3x3=2 * n_res, flash_self_attention=int(width in (32, 64, 128)))
    return counts
