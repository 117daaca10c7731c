"""KL-VAE over mel spectrograms, in PyTorch.

Port of ``audioldm2_tpu/models/vae.py``: GroupNorm(32, eps 1e-6) + SiLU
ResNet blocks through the K1 dispatch point, single-head mid-block
attention over all T*M positions (head width 512, which the plain
attention path takes, as XLA does in the JAX package), the final
GroupNorm+SiLU through K6, asymmetric-padded stride-2 (or time-stride-4)
downsampling in the encoder and nearest upsampling in the decoder (read in
place by the plain conv kernel on a CUDA bf16 decode, as the decoder's other
1x1 and 3x3 convs are; ``decode_plain_conv_shapes``).
Activations are [B, T, M, C]. The encoder serves the sr/inpainting path,
which runs it in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from audioldm2_torch.config import VAEConfig
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


def _downsample(p, x):
    """Pad (0, 1) in T and M, then 3x3 stride 2 VALID."""
    return nn.conv2d(p, F.pad(x, (0, 0, 0, 1, 0, 1)), stride=(2, 2), padding=0)


def _downsample_ts4(p, x):
    """DownsampleTimeStride4: pad (1, 2) in T and M, then 5x5 stride (4, 2)
    VALID."""
    return nn.conv2d(p, F.pad(x, (0, 0, 1, 2, 1, 2)), stride=(4, 2), padding=0)


def apply_encoder(p, cfg: VAEConfig, x: torch.Tensor) -> torch.Tensor:
    h = nn.conv2d(p["conv_in"], x)
    for level in p["down"]:
        for rb in level["block"]:
            h = _resblock(rb, h)
        if "downsample" in level:
            h = _downsample(level["downsample"], h)
        elif "downsample_ts4" in level:
            h = _downsample_ts4(level["downsample_ts4"], h)
    h = _resblock(p["mid"]["block_1"], h)
    h = _attnblock(p["mid"]["attn_1"], h)
    h = _resblock(p["mid"]["block_2"], h)
    h = nn.group_norm_silu(p["norm_out"], h, eps=GN_EPS)
    return nn.conv2d(p["conv_out"], h)


def encode_moments(p, cfg: VAEConfig, x: torch.Tensor):
    """x: [B, T, M, 1] mel -> (mean, logvar), each [B, T/f, M/f, embed_dim];
    logvar clamped to [-30, 20]."""
    moments = nn.conv2d(p["quant_conv"], apply_encoder(p["encoder"], cfg, x))
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def sample_posterior(mean: torch.Tensor, logvar: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + exp(logvar / 2) * noise, the noise drawn from ``generator``
    unless given (as [B, T/f, M/f, embed_dim])."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise.to(mean)


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
            h = nn.upsample_conv2d(level["upsample"], h)
        elif "upsample_ts4" in level:
            h = nn.conv2d(level["upsample_ts4"], nn.nearest_upsample_2d(h, 4, 2), padding=2)
    h = nn.group_norm_silu(p["norm_out"], h, eps=GN_EPS)
    return nn.conv2d(p["conv_out"], h)


def decode(p, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """z: [B, t, f, embed_dim] -> mel [B, T, M, 1]."""
    z = nn.conv2d(p["post_quant_conv"], z)
    return apply_decoder(p["decoder"], cfg, z)


def kl_divergence(mean: torch.Tensor, logvar: torch.Tensor,
                  other_mean: Optional[torch.Tensor] = None,
                  other_logvar: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL of the posterior against N(0, 1) or another diagonal Gaussian,
    summed over all but the batch axis (JAX ``vae.py:227-245``, reference
    distributions.py:36-55)."""
    dims = tuple(range(1, mean.dim()))
    var = torch.exp(logvar)
    if other_mean is None:
        return 0.5 * torch.sum(torch.square(mean) + var - 1.0 - logvar, dim=dims)
    other_var = torch.exp(other_logvar)
    return 0.5 * torch.sum(torch.square(mean - other_mean) / other_var + var / other_var - 1.0
                           - logvar + other_logvar, dim=dims)


def nll(mean: torch.Tensor, logvar: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Negative log likelihood of ``sample`` under the posterior, summed over
    all but the batch axis (JAX ``vae.py:248-255``, reference
    distributions.py:57-66)."""
    return 0.5 * torch.sum(math.log(2.0 * math.pi) + logvar
                           + torch.square(sample - mean) / torch.exp(logvar),
                           dim=tuple(range(1, mean.dim())))


def decode_conv_shapes(cfg: VAEConfig, batch: int, latent_t: int, latent_f: int) -> dict:
    """{(B, T, F, C1, 0, Cout): calls} of the K1 launches of one decode of a
    [batch, latent_t, latent_f] latent, in the (B, T, F, C1, C2, Cout) form
    of unet.conv_shapes: conv1 and conv2 of every ResBlock at its level (x2
    in T and F per upsample, x4 in T for a time-stride-4 one). The calls
    sum to kernel_launches_per_decode(cfg)["gn_silu_conv3x3"]."""
    shapes: dict = {}
    block_in = cfg.ch * cfg.ch_mult[-1]
    t, f = latent_t, latent_f

    def add(cin, cout):
        for key in ((batch, t, f, cin, 0, cout), (batch, t, f, cout, 0, cout)):
            shapes[key] = shapes.get(key, 0) + 1

    add(block_in, block_in)  # mid block_1
    add(block_in, block_in)  # mid block_2
    for i in reversed(range(len(cfg.ch_mult))):
        block_out = cfg.ch * cfg.ch_mult[i]
        for _ in range(cfg.num_res_blocks + 1):
            add(block_in, block_out)
            block_in = block_out
        if i != 0:
            t *= 4 if (i - 1) in cfg.downsample_time_stride4_levels else 2
            f *= 2
    return shapes


def encode_conv_shapes(cfg: VAEConfig, batch: int, t: int, f: int) -> dict:
    """{(B, T, F, C1, 0, Cout): calls} of the K1 launches of one encode of a
    [batch, t, f, 1] mel, as decode_conv_shapes: conv1 and conv2 of every
    ResBlock at its level (/2 in T and F per downsample, /4 in T for a
    time-stride-4 one), then the two mid-block ResBlocks. The calls sum to
    kernel_launches_per_encode(cfg)["gn_silu_conv3x3"]."""
    shapes: dict = {}

    def add(cin, cout):
        for key in ((batch, t, f, cin, 0, cout), (batch, t, f, cout, 0, cout)):
            shapes[key] = shapes.get(key, 0) + 1

    block_in = cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        for _ in range(cfg.num_res_blocks):
            add(block_in, cfg.ch * mult)
            block_in = cfg.ch * mult
        if i != len(cfg.ch_mult) - 1:
            t = (t + 2) // 4 if i in cfg.downsample_time_stride4_levels else t // 2
            f //= 2
    add(block_in, block_in)  # mid block_1
    add(block_in, block_in)  # mid block_2
    return shapes


def _decode_plain_convs(cfg: VAEConfig):
    """(C, Cout, taps, up, upsampling factor of the input) of every conv of
    one decode that goes to ``nn.conv2d`` or ``nn.upsample_conv2d``, in the
    order apply_decoder runs them: post_quant_conv, conv_in, the mid
    attention's q, k, v and proj_out, the ResBlocks' nin_shortcut, the
    upsamples (up 2: read through the nearest 2x; a time-stride-4 one, 5x5
    on a (4, 2) upsample, as up 4), conv_out. Stride 1 throughout."""
    block_in = cfg.ch * cfg.ch_mult[-1]
    convs = [(cfg.embed_dim, cfg.z_channels, 1, 1, (1, 1)),
             (cfg.z_channels, block_in, 3, 1, (1, 1))] + [(block_in, block_in, 1, 1, (1, 1))] * 4
    ut, uf = 1, 1
    for i in reversed(range(len(cfg.ch_mult))):
        block_out = cfg.ch * cfg.ch_mult[i]
        if block_in != block_out:  # the level's first ResBlock
            convs.append((block_in, block_out, 1, 1, (ut, uf)))
        block_in = block_out
        if i != 0:
            ts4 = (i - 1) in cfg.downsample_time_stride4_levels
            convs.append((block_in, block_in, 5 if ts4 else 3, 4 if ts4 else 2, (ut, uf)))
            ut, uf = ut * (4 if ts4 else 2), uf * 2
    return convs + [(block_in, cfg.out_ch, 3, 1, (ut, uf))]


def decode_plain_conv_shapes(cfg: VAEConfig, batch: int, latent_t: int, latent_f: int) -> dict:
    """{(B, Ti, Fi, C, 0, Cout, taps, 1, up, False): calls} of the plain
    conv's launches in one bf16 decode of a [batch, latent_t, latent_f]
    latent, in the form of unet.plain_conv_shapes: every conv of
    ``_decode_plain_convs`` that ``nn.conv2d_uses_kernel`` takes (not the
    5x5 time-stride-4 upsample, nor conv_out onto one channel). The calls
    sum to kernel_launches_per_decode(cfg)["conv2d"]."""
    shapes: dict = {}
    for c, cout, taps, up, (ut, uf) in _decode_plain_convs(cfg):
        if up in (1, 2) and nn.conv2d_uses_kernel((taps, taps, c, cout), (1, 1), ((0, 0),) * 2,
                                                  (c,)):
            key = (batch, latent_t * ut, latent_f * uf, c, 0, cout, taps, 1, up, False)
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def _launches(cfg: VAEConfig, n_res: int) -> dict:
    """Two K1 per ResBlock, one K6 (norm_out); the single-head mid attention
    takes K2 only if its width is a kernel head_dim (it is 512 in every
    shipped config, so it runs the plain path)."""
    width = cfg.ch * cfg.ch_mult[-1]
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    counts.update(gn_silu_conv3x3=2 * n_res, group_norm_silu=1,
                  flash_self_attention=int(width in (32, 64, 128)))
    return counts


def kernel_launches_per_decode(cfg: VAEConfig, compute_dtype: str = "bfloat16") -> dict:
    """Kernel launches of one decode: two mid-block ResBlocks and
    num_res_blocks + 1 per level; in bf16 the plain conv for every conv of
    decode_plain_conv_shapes."""
    counts = _launches(cfg, 2 + len(cfg.ch_mult) * (cfg.num_res_blocks + 1))
    if compute_dtype == "bfloat16":
        counts["conv2d"] = sum(decode_plain_conv_shapes(cfg, 1, 1, 1).values())
    return counts


def kernel_launches_per_encode(cfg: VAEConfig) -> dict:
    """Kernel launches of one encode, in f32 (the sr path's): num_res_blocks
    ResBlocks per level and two mid-block ResBlocks; its convs outside them
    stay cuDNN's."""
    return _launches(cfg, 2 + len(cfg.ch_mult) * cfg.num_res_blocks)
