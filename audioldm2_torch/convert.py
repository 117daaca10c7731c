"""Checkpoint conversion: reference PyTorch state dicts -> parameter trees.

The port's copy of ``audioldm2_tpu/convert.py`` (the same numpy operations
in the same order; a test holds the two bitwise equal on the same state
dicts). The reference ships seven monolithic ``.pth`` checkpoints whose
flat ``state_dict`` covers LDM + UNet + VAE + vocoder + all conditioners
(reference ``pipeline.py:172-174``). This module holds the key-mapping
tables that reshape those tensors into the channels-last layouts both
packages use:

* Conv2d ``[O, I, kh, kw]`` -> HWIO ``[kh, kw, I, O]``
* Conv1d ``[O, I, k]``      -> ``[k, I, O]``
* ConvTranspose1d ``[I, O, k]`` -> ``[k, O, I]`` (kernel-first HOI)
* Linear ``[O, I]``         -> ``[I, O]``
* Norm weight/bias          -> scale/bias

All functions take a dict of numpy arrays (call :func:`state_dict_to_numpy`
on a loaded torch checkpoint first). The transposes are numpy views, so a
converted tree shares memory with the state dict it came from.

    python -m audioldm2_torch.convert <ckpt.pth> <out.npz> [--model_name N]
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from audioldm2_torch.config import (
    FlanT5Config,
    UNetConfig,
    VAEConfig,
    VocoderConfig,
)


def state_dict_to_numpy(sd) -> Dict[str, np.ndarray]:
    """Tensor values -> numpy arrays sharing their memory (other values go
    through ``np.asarray``). A bfloat16 tensor raises ``TypeError``: numpy
    has no bfloat16, and the JAX package's converter has the same limit."""
    out = {}
    for k, v in sd.items():
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# Primitive converters
# ---------------------------------------------------------------------------


def conv2d_p(sd, prefix):
    return {
        "w": sd[prefix + ".weight"].transpose(2, 3, 1, 0),
        "b": sd[prefix + ".bias"],
    }


def conv1d_p(sd, prefix):
    return {
        "w": sd[prefix + ".weight"].transpose(2, 1, 0),
        "b": sd[prefix + ".bias"],
    }


def conv_transpose1d_p(sd, prefix):
    # torch [I, O, k] -> [k, O, I]
    return {
        "w": sd[prefix + ".weight"].transpose(2, 1, 0),
        "b": sd[prefix + ".bias"],
    }


def linear_p(sd, prefix, bias=True):
    p = {"w": sd[prefix + ".weight"].transpose(1, 0)}
    if bias:
        p["b"] = sd[prefix + ".bias"]
    return p


def norm_p(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def fold_weight_norm(sd, prefix):
    """HiFi-GAN convs are stored as weight_g/weight_v; the reference folds
    them at load via remove_weight_norm (utilities/model.py:140-152).
    w = g * v / ||v|| with the norm over all dims except dim 0."""
    key_w = prefix + ".weight"
    if key_w in sd:
        return sd[key_w]
    g = sd[prefix + ".weight_g"]
    v = sd[prefix + ".weight_v"]
    norm = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(axis=1))
    shape = (-1,) + (1,) * (v.ndim - 1)
    return g.reshape(shape) * v / norm.reshape(shape)


def wn_conv1d_p(sd, prefix):
    w = fold_weight_norm(sd, prefix)  # [O, I, k]
    return {"w": w.transpose(2, 1, 0), "b": sd[prefix + ".bias"]}


def wn_conv_transpose1d_p(sd, prefix):
    w = fold_weight_norm(sd, prefix)  # [I, O, k]
    return {"w": w.transpose(2, 1, 0), "b": sd[prefix + ".bias"]}


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _resblock_p(sd, prefix):
    p = {
        "norm1": norm_p(sd, prefix + ".norm1"),
        "conv1": conv2d_p(sd, prefix + ".conv1"),
        "norm2": norm_p(sd, prefix + ".norm2"),
        "conv2": conv2d_p(sd, prefix + ".conv2"),
    }
    if prefix + ".nin_shortcut.weight" in sd:
        p["nin_shortcut"] = conv2d_p(sd, prefix + ".nin_shortcut")
    return p


def _attnblock_p(sd, prefix):
    return {
        "norm": norm_p(sd, prefix + ".norm"),
        "q": conv2d_p(sd, prefix + ".q"),
        "k": conv2d_p(sd, prefix + ".k"),
        "v": conv2d_p(sd, prefix + ".v"),
        "proj_out": conv2d_p(sd, prefix + ".proj_out"),
    }


def convert_vae(sd: Dict[str, np.ndarray], cfg: VAEConfig, prefix: str = "") -> dict:
    """Map reference AutoencoderKL keys (autoencoder.py:18-66) to
    :mod:`audioldm2_torch.models.vae` params. ``prefix`` is e.g.
    ``first_stage_model.`` inside the monolithic checkpoint."""
    n_levels = len(cfg.ch_mult)

    enc = {"conv_in": conv2d_p(sd, prefix + "encoder.conv_in")}
    down = []
    for i in range(n_levels):
        level = {
            "block": [
                _resblock_p(sd, f"{prefix}encoder.down.{i}.block.{j}")
                for j in range(cfg.num_res_blocks)
            ]
        }
        ds_key = f"{prefix}encoder.down.{i}.downsample.conv"
        if ds_key + ".weight" in sd:
            kind = (
                "downsample_ts4"
                if i in cfg.downsample_time_stride4_levels
                else "downsample"
            )
            level[kind] = conv2d_p(sd, ds_key)
        down.append(level)
    enc["down"] = down
    enc["mid"] = {
        "block_1": _resblock_p(sd, prefix + "encoder.mid.block_1"),
        "attn_1": _attnblock_p(sd, prefix + "encoder.mid.attn_1"),
        "block_2": _resblock_p(sd, prefix + "encoder.mid.block_2"),
    }
    enc["norm_out"] = norm_p(sd, prefix + "encoder.norm_out")
    enc["conv_out"] = conv2d_p(sd, prefix + "encoder.conv_out")

    dec = {"conv_in": conv2d_p(sd, prefix + "decoder.conv_in")}
    dec["mid"] = {
        "block_1": _resblock_p(sd, prefix + "decoder.mid.block_1"),
        "attn_1": _attnblock_p(sd, prefix + "decoder.mid.attn_1"),
        "block_2": _resblock_p(sd, prefix + "decoder.mid.block_2"),
    }
    up = []
    for i in range(n_levels):
        level = {
            "block": [
                _resblock_p(sd, f"{prefix}decoder.up.{i}.block.{j}")
                for j in range(cfg.num_res_blocks + 1)
            ]
        }
        us_key = f"{prefix}decoder.up.{i}.upsample.conv"
        if us_key + ".weight" in sd:
            kind = (
                "upsample_ts4"
                if (i - 1) in cfg.downsample_time_stride4_levels
                else "upsample"
            )
            level[kind] = conv2d_p(sd, us_key)
        up.append(level)
    dec["up"] = up
    dec["norm_out"] = norm_p(sd, prefix + "decoder.norm_out")
    dec["conv_out"] = conv2d_p(sd, prefix + "decoder.conv_out")

    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": conv2d_p(sd, prefix + "quant_conv"),
        "post_quant_conv": conv2d_p(sd, prefix + "post_quant_conv"),
    }


# ---------------------------------------------------------------------------
# HiFi-GAN vocoder
# ---------------------------------------------------------------------------


def convert_vocoder(sd: Dict[str, np.ndarray], cfg: VocoderConfig, prefix: str = "") -> dict:
    """Map reference HiFi-GAN Generator keys (hifigan/models.py:112-174),
    folding weight norm. Checkpoint prefix is
    ``first_stage_model.vocoder.``."""
    p = {"conv_pre": wn_conv1d_p(sd, prefix + "conv_pre")}
    ups, resblocks = [], []
    for i in range(len(cfg.upsample_rates)):
        ups.append(wn_conv_transpose1d_p(sd, f"{prefix}ups.{i}"))
        for j, dils in enumerate(cfg.resblock_dilation_sizes):
            idx = i * len(cfg.resblock_kernel_sizes) + j
            if cfg.resblock == "1":
                rb = {
                    "convs1": [
                        wn_conv1d_p(sd, f"{prefix}resblocks.{idx}.convs1.{m}")
                        for m in range(len(dils))
                    ],
                    "convs2": [
                        wn_conv1d_p(sd, f"{prefix}resblocks.{idx}.convs2.{m}")
                        for m in range(len(dils))
                    ],
                }
            else:
                rb = {
                    "convs": [
                        wn_conv1d_p(sd, f"{prefix}resblocks.{idx}.convs.{m}")
                        for m in range(len(dils))
                    ]
                }
            resblocks.append(rb)
    p["ups"] = ups
    p["resblocks"] = resblocks
    p["conv_post"] = wn_conv1d_p(sd, prefix + "conv_post")
    return p


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def _st_block_p(sd, prefix, has_context):
    """BasicTransformerBlock (reference attention.py:370-410)."""
    return {
        "norm1": norm_p(sd, prefix + ".norm1"),
        "attn1": {
            "to_q": linear_p(sd, prefix + ".attn1.to_q", bias=False),
            "to_k": linear_p(sd, prefix + ".attn1.to_k", bias=False),
            "to_v": linear_p(sd, prefix + ".attn1.to_v", bias=False),
            "to_out": linear_p(sd, prefix + ".attn1.to_out.0"),
        },
        "norm2": norm_p(sd, prefix + ".norm2"),
        "attn2": {
            "to_q": linear_p(sd, prefix + ".attn2.to_q", bias=False),
            "to_k": linear_p(sd, prefix + ".attn2.to_k", bias=False),
            "to_v": linear_p(sd, prefix + ".attn2.to_v", bias=False),
            "to_out": linear_p(sd, prefix + ".attn2.to_out.0"),
        },
        "norm3": norm_p(sd, prefix + ".norm3"),
        "ff": {
            "proj_in": linear_p(sd, prefix + ".ff.net.0.proj"),
            "proj_out": linear_p(sd, prefix + ".ff.net.2"),
        },
    }


def _spatial_transformer_p(sd, prefix, depth, has_context):
    return {
        "norm": norm_p(sd, prefix + ".norm"),
        "proj_in": conv2d_p(sd, prefix + ".proj_in"),
        "blocks": [
            _st_block_p(sd, f"{prefix}.transformer_blocks.{d}", has_context)
            for d in range(depth)
        ],
        "proj_out": conv2d_p(sd, prefix + ".proj_out"),
    }


def _unet_resblock_p(sd, prefix):
    p = {
        "in_norm": norm_p(sd, prefix + ".in_layers.0"),
        "in_conv": conv2d_p(sd, prefix + ".in_layers.2"),
        "emb": linear_p(sd, prefix + ".emb_layers.1"),
        "out_norm": norm_p(sd, prefix + ".out_layers.0"),
        "out_conv": conv2d_p(sd, prefix + ".out_layers.3"),
    }
    if prefix + ".skip_connection.weight" in sd:
        p["skip"] = conv2d_p(sd, prefix + ".skip_connection")
    return p


def convert_unet(sd: Dict[str, np.ndarray], cfg: UNetConfig, prefix: str = "model.diffusion_model.") -> dict:
    """Map reference UNetModel keys (openaimodel.py:476-819).

    Walks the same construction order as the reference so that layer indices
    inside each TimestepEmbedSequential line up: [ResBlock, (self-ST,
    cross-ST xN)?, (Down/Upsample)?]."""
    p = {
        "time_embed": {
            "lin1": linear_p(sd, prefix + "time_embed.0"),
            "lin2": linear_p(sd, prefix + "time_embed.2"),
        }
    }
    if cfg.extra_film_condition_dim is not None:
        p["film_emb"] = linear_p(sd, prefix + "film_emb")

    n_ctx = len(cfg.context_dims)
    depth = cfg.transformer_depth

    def sts_at(block_prefix, start_idx):
        """Self-ST + one cross-ST per context at consecutive layer indices."""
        out = {"self_st": _spatial_transformer_p(sd, f"{block_prefix}.{start_idx}", depth, False)}
        out["cross_sts"] = [
            _spatial_transformer_p(sd, f"{block_prefix}.{start_idx + 1 + i}", depth, cfg.context_dims[i] is not None)
            for i in range(n_ctx)
        ]
        return out

    # input blocks
    input_blocks = [{"conv": conv2d_p(sd, prefix + "input_blocks.0.0")}]
    idx = 1
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            bp = f"{prefix}input_blocks.{idx}"
            blk = {"res": _unet_resblock_p(sd, bp + ".0")}
            if ds in cfg.attention_resolutions:
                blk.update(sts_at(bp, 1))
            input_blocks.append(blk)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append(
                {"downsample": conv2d_p(sd, f"{prefix}input_blocks.{idx}.0.op")}
            )
            idx += 1
            ds *= 2
    p["input_blocks"] = input_blocks

    # middle: ResBlock, self-ST, cross-STs, ResBlock
    mid = {"res1": _unet_resblock_p(sd, prefix + "middle_block.0")}
    mid.update(sts_at(prefix + "middle_block", 1))
    mid["res2"] = _unet_resblock_p(sd, f"{prefix}middle_block.{2 + n_ctx}")
    p["middle_block"] = mid

    # output blocks
    output_blocks = []
    idx = 0
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            bp = f"{prefix}output_blocks.{idx}"
            blk = {"res": _unet_resblock_p(sd, bp + ".0")}
            layer = 1
            if ds in cfg.attention_resolutions:
                blk.update(sts_at(bp, 1))
                layer += 1 + n_ctx
            if level and i == cfg.num_res_blocks:
                blk["upsample"] = conv2d_p(sd, f"{bp}.{layer}.conv")
                ds //= 2
            output_blocks.append(blk)
            idx += 1
    p["output_blocks"] = output_blocks

    p["out_norm"] = norm_p(sd, prefix + "out.0")
    p["out_conv"] = conv2d_p(sd, prefix + "out.2")
    return p


# ---------------------------------------------------------------------------
# FLAN-T5 encoder
# ---------------------------------------------------------------------------


def convert_t5_encoder(sd: Dict[str, np.ndarray], cfg: FlanT5Config, prefix: str = "") -> dict:
    """Map HuggingFace T5EncoderModel keys (as stored inside the monolithic
    checkpoint under ``cond_stage_models.<i>.model.``) to
    :mod:`audioldm2_torch.models.t5` params."""
    emb_key = prefix + "shared.weight"
    if emb_key not in sd:
        emb_key = prefix + "encoder.embed_tokens.weight"
    else:
        # T5 ties encoder.embed_tokens to shared; the checkpoint stores both
        tied = sd.get(prefix + "encoder.embed_tokens.weight")
        assert tied is None or tied.shape == sd[emb_key].shape
    blocks = []
    for i in range(cfg.num_layers):
        bp = f"{prefix}encoder.block.{i}.layer"
        blk = {
            "ln1": {"scale": sd[f"{bp}.0.layer_norm.weight"]},
            "attn": {
                "q": linear_p(sd, f"{bp}.0.SelfAttention.q", bias=False),
                "k": linear_p(sd, f"{bp}.0.SelfAttention.k", bias=False),
                "v": linear_p(sd, f"{bp}.0.SelfAttention.v", bias=False),
                "o": linear_p(sd, f"{bp}.0.SelfAttention.o", bias=False),
            },
            "ln2": {"scale": sd[f"{bp}.1.layer_norm.weight"]},
            "ff": {
                "wi_0": linear_p(sd, f"{bp}.1.DenseReluDense.wi_0", bias=False),
                "wi_1": linear_p(sd, f"{bp}.1.DenseReluDense.wi_1", bias=False),
                "wo": linear_p(sd, f"{bp}.1.DenseReluDense.wo", bias=False),
            },
        }
        if i == 0:
            blk["rel_bias"] = sd[
                f"{bp}.0.SelfAttention.relative_attention_bias.weight"
            ]
        blocks.append(blk)
    return {
        "token_embed": sd[emb_key],
        "blocks": blocks,
        "final_ln": {"scale": sd[prefix + "encoder.final_layer_norm.weight"]},
    }


# ---------------------------------------------------------------------------
# GPT-2 (HF Conv1D weights are [in, out] — no transpose)
# ---------------------------------------------------------------------------


def _gpt2_conv1d_p(sd, prefix):
    return {"w": sd[prefix + ".weight"], "b": sd[prefix + ".bias"]}


def convert_gpt2(sd: Dict[str, np.ndarray], n_layer: int = 12, prefix: str = "") -> dict:
    """Map HF GPT2Model keys (as stored under
    ``cond_stage_models.<i>.model.``) to :mod:`audioldm2_torch.models.gpt2`."""
    blocks = []
    for i in range(n_layer):
        bp = f"{prefix}h.{i}"
        blocks.append(
            {
                "ln_1": norm_p(sd, bp + ".ln_1"),
                "attn": {
                    "c_attn": _gpt2_conv1d_p(sd, bp + ".attn.c_attn"),
                    "c_proj": _gpt2_conv1d_p(sd, bp + ".attn.c_proj"),
                },
                "ln_2": norm_p(sd, bp + ".ln_2"),
                "mlp": {
                    "c_fc": _gpt2_conv1d_p(sd, bp + ".mlp.c_fc"),
                    "c_proj": _gpt2_conv1d_p(sd, bp + ".mlp.c_proj"),
                },
            }
        )
    return {
        "wpe": sd[prefix + "wpe.weight"],
        "blocks": blocks,
        "ln_f": norm_p(sd, prefix + "ln_f"),
    }


# ---------------------------------------------------------------------------
# RoBERTa (CLAP text tower)
# ---------------------------------------------------------------------------


def convert_roberta(sd: Dict[str, np.ndarray], num_layers: int = 12, prefix: str = "") -> dict:
    """Map HF RobertaModel keys to :mod:`audioldm2_torch.models.roberta`."""
    layers = []
    for i in range(num_layers):
        lp = f"{prefix}encoder.layer.{i}"
        layers.append(
            {
                "attn": {
                    "q": linear_p(sd, lp + ".attention.self.query"),
                    "k": linear_p(sd, lp + ".attention.self.key"),
                    "v": linear_p(sd, lp + ".attention.self.value"),
                    "out": linear_p(sd, lp + ".attention.output.dense"),
                    "ln": norm_p(sd, lp + ".attention.output.LayerNorm"),
                },
                "ff": {
                    "intermediate": linear_p(sd, lp + ".intermediate.dense"),
                    "output": linear_p(sd, lp + ".output.dense"),
                    "ln": norm_p(sd, lp + ".output.LayerNorm"),
                },
            }
        )
    return {
        "word_embeddings": sd[prefix + "embeddings.word_embeddings.weight"],
        "position_embeddings": sd[prefix + "embeddings.position_embeddings.weight"],
        "token_type_embeddings": sd[prefix + "embeddings.token_type_embeddings.weight"],
        "emb_ln": norm_p(sd, prefix + "embeddings.LayerNorm"),
        "layers": layers,
        "pooler": linear_p(sd, prefix + "pooler.dense"),
    }


def convert_clap(sd: Dict[str, np.ndarray], prefix: str = "") -> dict:
    """Map reference CLAP keys (clap/open_clip/model.py:419-574). ``prefix``
    is e.g. ``cond_stage_models.<i>.model.`` or ``clap.model.`` (the DDPM-
    level reranker, ddpm.py:114-120)."""
    params = {
        "text_branch": convert_roberta(sd, prefix=prefix + "text_branch."),
        "text_projection": {
            "lin1": linear_p(sd, prefix + "text_projection.0"),
            "lin2": linear_p(sd, prefix + "text_projection.2"),
        },
        "audio_projection": {
            "lin1": linear_p(sd, prefix + "audio_projection.0"),
            "lin2": linear_p(sd, prefix + "audio_projection.2"),
        },
        # MLPLayers heads feeding the contrastive mlp_loss branch
        # (model.py:485-545 build, :714-716 use; training-only but shipped in
        # every checkpoint)
        "text_transform": {
            "lin1": linear_p(sd, prefix + "text_transform.sequential.0"),
            "lin2": linear_p(sd, prefix + "text_transform.sequential.3"),
        },
        "audio_transform": {
            "lin1": linear_p(sd, prefix + "audio_transform.sequential.0"),
            "lin2": linear_p(sd, prefix + "audio_transform.sequential.3"),
        },
        "logit_scale_a": sd[prefix + "logit_scale_a"],
        "logit_scale_t": sd[prefix + "logit_scale_t"],
    }
    # The depths are fixed, as in the JAX package: 12 RoBERTa layers (the
    # default of convert_roberta) and HTSAT-base's; the CLAPConfig is not
    # read, so a PANN or bert/bart tower, or other depths, do not convert.
    from audioldm2_torch import convert_htsat

    params["audio_branch"] = convert_htsat.convert_htsat(sd, prefix=prefix + "audio_branch.")
    return params


# ---------------------------------------------------------------------------
def expand_ema_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Invert the reference LitEma shadow-buffer naming back to ``model.*``.

    The reference registers each EMA shadow under the source parameter name
    with the dots removed (``modules/ema.py:15-18``:
    ``s_name = name.replace('.', '')``), so ``model_ema.*`` keys cannot be
    parsed on their own — but the same state_dict carries the live
    ``model.*`` params, so the mapping is recovered by dot-stripping those.
    Returns ``{"model.<name>": shadow_value}`` for every shadow that matches
    a live param; the ``decay``/``num_updates`` counters are dropped.
    """
    rev: Dict[str, str] = {}
    ambiguous = set()
    for k in sd:
        if k.startswith("model."):
            name = k[len("model."):]
            flat = name.replace(".", "")
            if flat in rev:
                # Two live names flatten identically (e.g. 'a.10.b' vs
                # 'a.1.0b'): the shadow is unattributable. Last-write-wins
                # would silently map it to the wrong parameter.
                ambiguous.add(flat)
            rev[flat] = k
    out = {}
    for k in list(sd):
        if not k.startswith("model_ema."):
            continue
        flat = k[len("model_ema."):]
        if flat in ("decay", "num_updates"):
            sd[k]  # touch for coverage-tracking dicts
            continue
        if flat in ambiguous:
            raise ValueError(
                f"EMA shadow '{k}' matches multiple live parameters after "
                "dot-stripping (LitEma's naming is not invertible for this "
                "geometry); refusing to guess."
            )
        src = rev.get(flat)
        if src is not None:
            out[src] = sd[k]
    return out


# ---------------------------------------------------------------------------
# One-command conversion entry (the output is an .npz; the JAX package's
# orbax directories are not read or written by the port).
# ---------------------------------------------------------------------------


def _infer_model_name(pth_path: str) -> str:
    """Match a shipped checkpoint family from the filename (longest match
    wins so 'audioldm2-full-large-1150k' beats 'audioldm2-full')."""
    import os as _os

    from audioldm2_torch.config import CHECKPOINT_NAMES

    base = _os.path.basename(pth_path)
    hits = [n for n in CHECKPOINT_NAMES if n in base]
    if not hits:
        raise SystemExit(
            f"cannot infer the checkpoint family from {base!r}; pass "
            f"--model_name (one of {', '.join(CHECKPOINT_NAMES)})"
        )
    return max(hits, key=len)


def main(argv=None) -> int:
    import argparse

    from audioldm2_torch.utils import checkpoint as ckpt_io

    p = argparse.ArgumentParser(
        prog="python -m audioldm2_torch.convert",
        description="Convert a reference AudioLDM2 .pth checkpoint into an .npz "
        "parameter tree (the JAX package's .npz format).",
    )
    p.add_argument("pth_path", help="reference monolithic .pth checkpoint")
    p.add_argument("out_path", help="output .npz file")
    p.add_argument(
        "--model_name", default=None,
        help="checkpoint family (default: inferred from the filename)",
    )
    args = p.parse_args(argv)
    name = args.model_name or _infer_model_name(args.pth_path)
    print(f"converting {args.pth_path} as family {name!r} -> {args.out_path}")
    ckpt_io.convert_reference_checkpoint(args.pth_path, name, args.out_path)
    leaves = ckpt_io.array_leaves(ckpt_io.load(args.out_path))
    n = sum(int(np.size(a)) for a in leaves)
    print(f"ok: wrote {len(leaves)} arrays, {n/1e6:.1f}M parameters")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
