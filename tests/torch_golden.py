"""Make the port's full-width golden with the JAX package on the CPU.

    python tests/torch_golden.py [--case NAME ...] [--out PATH] [--work DIR]

For each case of ``audioldm2_torch.tools.golden_parity.CASES`` (all by
default) this builds the family's published config in f32, the tree
``audioldm2_torch.params.draw_tree(cfg, 0)`` gives, JAX's batch from
``make_batch`` and ``x_T`` from a numpy seed, and runs the program JAX's
``ldm.generate`` runs (``latent_diffusion._generate_impl``, DDIM at eta 0)
with its conditioning and final latent recorded (the module's
``encode_conditioning`` and ``ddim.ddim_sample`` wrapped while it traces).
A reranked case scores its candidates with JAX's rerank scorer
(``clap.cos_similarity_waveform_text``, as ``pipeline.rerank_and_select``
calls it). Each case runs in a process of its own (the large family holds
about 20 GB) and writes ``DIR/<case>.npz``; the parent merges them into
``--out`` (default ``audioldm2_torch/assets/golden_fullwidth.npz``), f32,
compressed. Imports both packages: a helper of the tests, not a test.

What a case stores (keys ``<case>/<name>``): ``meta`` (JSON: the Case's
fields, the config digest, latent_t, the tree's seed and digest, the wall,
the JAX version), ``ids/<key>`` (the batch's token ids and masks),
``ctx<i>`` / ``mask<i>`` (each cross-attention slot of the CFG batch,
uncond rows first, cut after the last token a mask keeps), ``y`` (FiLM),
``x_T``, ``latent`` (the kept candidate's rows, ``latent_rows``), ``mel``
(every candidate), ``wav`` (the kept candidate, ``wav_rows``), on a
reranked case ``scores`` and ``pick``, and on ``t5_headline`` ``eps0``, the
first step's guided eps at x_T.
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

    t_start = time.perf_counter()
    cfg = dataclasses.replace(cfg or default_audioldm_config(case.family),
                              compute_dtype="float32", weight_quant=None)
    tree = tparams.draw_tree(tconfig.coerce(cfg), gp.TREE_SEED)
    digest = tparams.tree_digest(tree)
    model = jpipe.AudioLDM2(cfg, tree)
    del tree
    ldm = model.ldm
    batch = model.make_batch(case.prompt, transcription=case.transcription, batchsize=1)
    xt = gp.x_T(cfg, case)
    lt = gp.latent_t_size(cfg, case)
    t0 = int(make_ddim_params(ldm.schedule, case.steps, gp.ETA)[0][-1])
    encode, sample = jld.encode_conditioning, jld.ddim.ddim_sample

    def program(params, batch, x_T):
        got = {}

        def encode_recorded(*a, **kw):
            got["cond"] = encode(*a, **kw)
            return got["cond"]

        def sample_recorded(eps_fn, key, shape, schedule, **kw):
            if eps0:
                got["eps0"] = eps_fn(kw["x_T"], jnp.full((shape[0],), t0, jnp.int32))
            got["z"] = sample(eps_fn, key, shape, schedule, **kw)
            return got["z"]

        with _patched(jld, "encode_conditioning", encode_recorded), \
                _patched(jld.ddim, "ddim_sample", sample_recorded):
            wav, mel = jld._generate_impl(
                params, batch, jax.random.PRNGKey(0), cfg=cfg, schedule=ldm.schedule,
                latent_t_size=lt, n_gen=case.n_gen, guidance=float(case.guidance),
                ddim_steps=case.steps, ddim_eta=gp.ETA, use_mask=False, sampler="ddim",
                voc_folded=ldm._voc_folded, x_T=x_T)
        (y, contexts, masks), _, _ = got["cond"]
        return wav, mel, got["z"], y, contexts, masks, got.get("eps0")

    params = {k: v for k, v in ldm.params.items() if k != "unet_ema"}
    jbatch = {k: v for k, v in batch.items()}
    out = jax.jit(program)(params, jbatch, jnp.asarray(xt))
    wav, mel, z, y, contexts, masks, e0 = jax.tree.map(
        lambda a: None if a is None else np.asarray(a, np.float32), out,
        is_leaf=lambda a: a is None)
    arrays = {"x_T": xt, "mel": mel}
    rows = np.array([0], np.int64)
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
    for k, v in gp.batch_ids(batch).items():
        arrays["ids/" + k] = v
    meta = {**dataclasses.asdict(case), "config_digest": gp.config_digest(cfg),
            "latent_t": lt, "eta": gp.ETA, "tree_seed": gp.TREE_SEED, "tree_digest": digest,
            "made_by": "audioldm2_tpu latent_diffusion._generate_impl, f32, CPU",
            "jax": jax.__version__, "seconds": round(time.perf_counter() - t_start, 1)}
    arrays["meta"] = np.asarray(json.dumps(meta, sort_keys=True))
    return arrays


def save(cases: dict, path: str) -> None:
    """{case: arrays} -> one compressed npz of ``<case>/<name>`` keys."""
    flat = {f"{c}/{k}": v for c, arrays in cases.items() for k, v in arrays.items()}
    np.savez_compressed(path, **flat)


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
    ap.add_argument("--case", nargs="*", default=list(gp.CASES))
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
