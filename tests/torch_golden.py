"""Make the port's full-width golden with the JAX package on the CPU.

    python tests/torch_golden.py [--case NAME ...] [--out PATH] [--work DIR]

For each case of ``audioldm2_torch.tools.golden_parity.CASES`` (all by
default) this builds the family's published config (the case's variant,
``golden_parity.variant_config``) in f32, the tree
``audioldm2_torch.params.draw_tree(cfg, 0)`` gives, JAX's batch from
``make_batch`` (an audio-in case's waveforms, ``golden_parity.case_waves``,
through it) and ``x_T`` from a numpy seed, and runs the program JAX's
``ldm.generate`` runs (``latent_diffusion._generate_impl`` at eta 0, DDIM or
PLMS) with its conditioning and final latent recorded (the module's
``encode_conditioning`` and the sampler wrapped while it traces). An sr case
is ``pipeline.super_resolution_and_inpainting``'s steps: the sine written to
a wav file and read back, its fbank, ``ldm.encode_mel`` with a key split
from ``PRNGKey(xt_seed)``, the latent mask, then the masked generate with
the rest of that key; the draws (the posterior noise, each DDIM step's
q-sample noise of the blend) are JAX's, recomputed from the keys as
``vae.sample_posterior`` and ``ddim.ddim_sample`` split them. An edit case
encodes its chirps the same way, noises the latent with
``ddim.stochastic_encode`` and denoises it with ``ddim_decode``'s
trajectory under the case's prompt (the sampler's place in the program),
as the port's ``LatentDiffusionModel.edit`` composes them. An int8 case
runs JAX's int8 products as its TPU program does (``_int8_as_on_the_tpu``)
and also stores the digest of the UNet tree ``_generate_impl`` serves
(cast, ``fuse_self_qkv``, ``quantize_st_linears``,
``quantize_resblock_convs``) and the request's own one-ulp spread.
A reranked case scores its candidates with JAX's rerank scorer
(``clap.cos_similarity_waveform_text``, as ``pipeline.rerank_and_select``
calls it). Each case runs in a process of its own (the large family holds
about 20 GB) and writes ``DIR/<case>.npz``; the parent merges them, and
every case the work directory lacks from the ``--out`` file as stored, into
``--out`` (default ``audioldm2_torch/assets/golden_fullwidth.npz``), f32,
compressed. Imports both packages: a helper of the tests, not a test.

What a case stores (keys ``<case>/<name>``): ``meta`` (JSON: the Case's
fields, the config digest, latent_t, the tree's seed and digest, the wall,
the JAX version; on an int8 case ``unet_int8_digest``,
``unet_int8_leaves`` and ``int8_ulp_mel_mae``, the mel MAE between the
request and the same request from x_T moved by one ulp), ``ids/<key>`` (the batch's token ids and masks),
``ctx<i>`` / ``mask<i>`` (each cross-attention slot of the CFG batch,
uncond rows first, cut after the last token a mask keeps), ``y`` (FiLM),
``x_T`` (not on edit), ``latent`` (the kept candidate's rows, or every
row, ``latent_rows``), ``mel`` (every candidate), ``wav`` (the kept rows,
``wav_rows``), on a reranked case ``scores`` and ``pick``, on
``t5_headline`` ``eps0``, the first step's guided eps at x_T; on sr and
edit ``mel_in``, ``posterior_noise`` and ``z0`` (the scaled encoding), on
sr ``mask`` and ``mask_noise`` [steps, ...], on edit ``encode_noise`` and
``z_t``; on the mae variant ``ta_kaldi_fbank``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

EPS0_CASES = ("t5_headline",)


@contextlib.contextmanager
def _patched(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def _int8_as_on_the_tpu():
    """JAX's int8 dispatch as on its TPU: each int8 ResBlock conv, ST linear
    and int8 linear goes to its Pallas kernel (in interpret mode, as the JAX
    package's kernel tests run them) wherever the package's own predicates
    send it there on the TPU (``resblock_pallas.supported``,
    ``lnmm_pallas.*_supported``), and to the exact f32 dequant elsewhere.
    Off the TPU the package's dispatch points dequantize every int8 weight
    exactly, skipping the kernels' one bf16 rounding of the activation,
    which the TPU program and the port's kernels make."""
    import functools

    from jax.experimental import pallas as pl

    from audioldm2_tpu.ops import nn as jnn, resblock_pallas

    conv = jnn.gn_silu_conv

    def gn_silu_conv(p_norm, p_conv, x, groups: int = 32, eps: float = 1e-5):
        if "wq" in p_conv and resblock_pallas.supported(x, p_conv["wq"], groups):
            return resblock_pallas.gn_silu_conv3x3_q(
                x, p_norm["scale"], p_norm["bias"], p_conv["wq"], p_conv["ws"], p_conv["b"],
                groups=groups, eps=eps)
        return conv(p_norm, p_conv, x, groups, eps)

    with _patched(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)), \
            _patched(jnn, "_pallas_int8_enabled", lambda: True), \
            _patched(jnn, "gn_silu_conv", gn_silu_conv):
        yield


def _encode_inputs(model, case, cfg, key):
    """JAX's side of an sr or edit case before the sampler: the input mel,
    the encode (``ldm.encode_mel`` with ``key``'s first split), its
    posterior noise, and on sr the mask and the blend's noise of every step,
    on edit the encode noise and the noised latent. Returns (arrays, the
    batch's inpainting entries, the sampler's key, z_t or None)."""
    import jax
    import jax.numpy as jnp

    from audioldm2_torch.tools import golden_parity as gp
    from audioldm2_tpu.diffusion import ddim as jddim
    from audioldm2_tpu.utils.audio_io import read_wav_file, save_wave

    sr, frames = cfg.preprocessing.sampling_rate, gp.mel_frames(cfg, case)
    waves = gp.case_waves(case, sr)
    key, k_enc = jax.random.split(key)
    if case.mode == "sr":
        with tempfile.TemporaryDirectory() as tmp:
            path = save_wave(waves[:, None], tmp, name="input", samplerate=sr)[0]
            wav_in = read_wav_file(path, frames * cfg.preprocessing.hop_length, target_sr=sr)
        fb = np.asarray(model.mel.fbank(wav_in, target_length=frames))
        mel_in = np.tile(fb[..., None], (case.batchsize, 1, 1, 1))
    else:
        mel_in = np.asarray(model.mel.fbank(waves, target_length=frames))[..., None]
    mel_in = mel_in.astype(np.float32)
    z0 = model.ldm.encode_mel(k_enc, mel_in)
    arrays = {"mel_in": mel_in, "z0": np.asarray(z0, np.float32),
              "posterior_noise": np.asarray(jax.random.normal(k_enc, z0.shape, jnp.float32))}
    if case.mode == "edit":
        noise = np.asarray(jax.random.normal(key, z0.shape, jnp.float32))
        z_t = jddim.stochastic_encode(None, z0, case.t_enc, model.ldm.schedule, case.steps,
                                      noise=jnp.asarray(noise))
        arrays.update(encode_noise=noise, z_t=np.asarray(z_t, np.float32))
        return arrays, {}, key, z_t
    b, h, w, c = z0.shape
    mask = np.ones((b, h, w, 1), np.float32)
    (t0, t1), (f0, f1) = gp.SR_TIME_MASK, gp.SR_FREQ_MASK
    mask[:, int(h * t0):int(h * t1)] = 0.0
    mask[:, :, int(w * f0):int(w * f1)] = 0.0
    # ddim_sample's keys with x_T given: (the steps' key, x_T's), each step's
    # split into (the blend's q-sample noise, the step noise)
    k_steps, _ = jax.random.split(key)
    shape = (b * case.n_gen, h, w, c)
    mask_noise = np.stack([
        np.asarray(jax.random.normal(jax.random.split(k)[0], shape, jnp.float32))
        for k in jax.random.split(k_steps, case.steps)])
    arrays.update(mask=mask, mask_noise=mask_noise)
    return arrays, {"inpaint_mask": mask, "inpaint_x0": np.asarray(z0)}, key, None


def make_case(name: str, case, cfg=None, eps0: bool = False) -> dict:
    """One case's arrays (see the module docstring), by the JAX package in
    f32 on the CPU; ``cfg`` defaults to the family's published config."""
    import jax
    import jax.numpy as jnp

    from audioldm2_torch import config as tconfig, params as tparams
    from audioldm2_torch.tools import golden_parity as gp
    from audioldm2_tpu import pipeline as jpipe
    from audioldm2_tpu.config import default_audioldm_config
    from audioldm2_tpu.diffusion import latent_diffusion as jld
    from audioldm2_tpu.diffusion.schedule import make_ddim_params
    from audioldm2_tpu.models import clap as jclap
    from audioldm2_tpu.models import unet as junet

    t_start = time.perf_counter()
    cfg = dataclasses.replace(
        gp.variant_config(cfg or default_audioldm_config(case.family), case.variant),
        compute_dtype="float32", weight_quant=None)
    tree = tparams.draw_tree(tconfig.coerce(cfg), gp.TREE_SEED)
    digest = tparams.tree_digest(tree)
    meta = {**dataclasses.asdict(case), "config_digest": gp.config_digest(cfg)}
    cfg = dataclasses.replace(cfg, weight_quant=case.weight_quant)
    model = jpipe.AudioLDM2(cfg, tree)
    del tree
    ldm = model.ldm
    waves = gp.case_waves(case, cfg.preprocessing.sampling_rate)
    batch = model.make_batch(case.prompt, transcription=case.transcription,
                             batchsize=case.batchsize,
                             waveform=waves if case.variant is not None else None)
    lt = gp.latent_t_size(cfg, case)
    key = jax.random.PRNGKey(case.xt_seed)
    arrays, z_t = {}, None
    if case.mode != "generate":
        arrays, inpaint, key, z_t = _encode_inputs(model, case, cfg, key)
        batch.update(inpaint)
    xt = None if case.mode == "edit" else gp.x_T(cfg, case)
    t0 = int(make_ddim_params(ldm.schedule, case.steps, gp.ETA)[0][-1])
    encode = jld.encode_conditioning
    smod, sname = (jld.plms, "plms_sample") if case.sampler == "plms" else (jld.ddim,
                                                                             "ddim_sample")
    sample = getattr(smod, sname)

    def program(params, batch, key, x_T, z_t):
        got = {}

        def encode_recorded(*a, **kw):
            got["cond"] = encode(*a, **kw)
            return got["cond"]

        def sample_recorded(eps_fn, key, shape, schedule, **kw):
            if eps0:
                got["eps0"] = eps_fn(kw["x_T"], jnp.full((shape[0],), t0, jnp.int32))
            if case.mode == "edit":  # ddim.ddim_decode's trajectory from z_t
                got["z"] = sample(eps_fn, None, z_t.shape, schedule, num_steps=case.steps,
                                  eta=0.0, x_T=z_t, t_start=case.t_enc)
            else:
                got["z"] = sample(eps_fn, key, shape, schedule, **kw)
            return got["z"]

        with _patched(jld, "encode_conditioning", encode_recorded), \
                _patched(smod, sname, sample_recorded):
            wav, mel = jld._generate_impl(
                params, batch, key, cfg=cfg, schedule=ldm.schedule, latent_t_size=lt,
                n_gen=case.n_gen, guidance=float(case.guidance), ddim_steps=case.steps,
                ddim_eta=gp.ETA, use_mask=case.mode == "sr", sampler=case.sampler,
                voc_folded=ldm._voc_folded, x_T=x_T)
        (y, contexts, masks), _, _ = got["cond"]
        return wav, mel, got["z"], y, contexts, masks, got.get("eps0")

    params = {k: v for k, v in ldm.params.items() if k != "unet_ema"}
    jbatch = {k: v for k, v in batch.items()}
    with _int8_as_on_the_tpu() if case.weight_quant == "int8" else contextlib.nullcontext():
        jprogram = jax.jit(program)
        out = jprogram(params, jbatch, key, None if xt is None else jnp.asarray(xt), z_t)
        if case.weight_quant == "int8":
            # the int8 request's own spread: the same program from x_T moved
            # by one ulp (the kernels' bf16 rounding of each activation makes
            # it move by far more than an f32 request does)
            moved = jprogram(params, jbatch, key, jnp.asarray(np.nextafter(xt, np.float32(1e30))),
                             z_t)
            meta["int8_ulp_mel_mae"] = float(np.abs(np.asarray(moved[1]) -
                                                    np.asarray(out[1])).mean())
    wav, mel, z, y, contexts, masks, e0 = jax.tree.map(
        lambda a: None if a is None else np.asarray(a, np.float32), out,
        is_leaf=lambda a: a is None)
    arrays["mel"] = mel
    if xt is not None:
        arrays["x_T"] = xt
    rows = np.arange(z.shape[0], dtype=np.int64)
    if case.n_gen > 1:
        sim = np.asarray(jclap.cos_similarity_waveform_text(
            ldm.params["reranker_clap"], cfg.reranker_clap, wav, case.prompt,
            model.reranker_tok, cfg.preprocessing.sampling_rate), np.float32)
        rows = np.array([int(np.argmax(sim))], np.int64)
        arrays.update(scores=sim, pick=np.asarray(rows[0]))
    arrays.update(latent=z[rows], latent_rows=rows, wav=wav[rows], wav_rows=rows)
    for i, (c, m) in enumerate(zip(contexts, masks)):
        arrays[f"ctx{i}"] = np.ascontiguousarray(c[:, :gp.context_length(m)])
        arrays[f"mask{i}"] = m
    if y is not None:
        arrays["y"] = y
    if e0 is not None:
        arrays["eps0"] = e0
    if case.variant == "mae":
        arrays["ta_kaldi_fbank"] = np.asarray(batch["ta_kaldi_fbank"], np.float32)
    for k, v in gp.batch_ids(batch).items():
        arrays["ids/" + k] = v
    if case.weight_quant == "int8":
        q = junet.quantize_resblock_convs(junet.quantize_st_linears(
            junet.fuse_self_qkv(params["unet"])))
        meta.update(unet_int8_digest=tparams.tree_digest(q), unet_int8_leaves=sum(
            1 for _, a in tparams.tree_paths(q) if a.dtype == jnp.int8))
    meta.update({"latent_t": lt, "eta": gp.ETA, "tree_seed": gp.TREE_SEED,
                 "tree_digest": digest,
                 "made_by": "audioldm2_tpu latent_diffusion._generate_impl, f32, CPU",
                 "jax": jax.__version__, "seconds": round(time.perf_counter() - t_start, 1)})
    arrays["meta"] = np.asarray(json.dumps(meta, sort_keys=True))
    return arrays


def save(cases: dict, path: str) -> None:
    """{case: arrays} -> one compressed npz of ``<case>/<name>`` keys."""
    flat = {f"{c}/{k}": v for c, arrays in cases.items() for k, v in arrays.items()}
    np.savez_compressed(path, **flat)


def _split(path: str) -> dict:
    """{case: {name: array}} of a golden file's ``<case>/<name>`` keys."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            case, name = key.split("/", 1)
            out.setdefault(case, {})[name] = z[key]
    return out


def _one(name: str, work: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from audioldm2_torch.tools import golden_parity as gp

    arrays = make_case(name, gp.CASES[name], eps0=name in EPS0_CASES)
    np.savez(os.path.join(work, f"{name}.npz"), **arrays)
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.loads(str(arrays["meta"])), f"peak RSS {peak:.1f} GiB", flush=True)


def main(argv=None) -> int:
    from audioldm2_torch.tools import golden_parity as gp

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", nargs="*", default=list(gp.CASES),
                    help="the cases to make (default: all); the others are kept from --out")
    ap.add_argument("--out", default=gp.GOLDEN)
    ap.add_argument("--work", default=None, help="per-case files (default: a temp dir); a "
                    "case whose file is there already is not run again")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        _one(args.one, args.work)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        work = args.work or tmp
        os.makedirs(work, exist_ok=True)
        for name in args.case:
            if not os.path.exists(os.path.join(work, f"{name}.npz")):
                subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name,
                                "--work", work], check=True)
        cases = {}
        if os.path.exists(args.out):  # the stored cases, as they are
            for case, arrays in _split(args.out).items():
                if case in gp.CASES:
                    cases[case] = arrays
        for name in gp.CASES:
            path = os.path.join(work, f"{name}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    cases[name] = {k: z[k] for k in z.files}
        save(cases, args.out)
    print(f"{args.out}: {sorted(cases)}, {os.path.getsize(args.out) / 2**20:.2f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
