"""Hold the port's requests to the JAX package's at full published width.

    python -m audioldm2_torch.tools.golden_parity [--device cuda|cpu] [--case NAME ...]

``audioldm2_torch/assets/golden_fullwidth.npz`` holds one request per case
of :data:`CASES`, made by the JAX package on the CPU in f32
(``tests/torch_golden.py``) on the weights :func:`params.draw_tree` gives
for seed 0: the batch's token ids, each conditioning output the UNet reads,
``x_T``, the final latent, the mel, the waveform and, on a reranked case,
the CLAP scores and the pick. :func:`check` rebuilds the tree with numpy
alone (raising if its :func:`params.tree_digest` is not the stored one),
builds the port's model on ``device``, checks that its ``make_batch`` gives
the stored ids (raising if not), runs ``ldm.generate`` from the stored
``x_T`` at eta 0 and returns each quantity's distance to the golden. The
module imports no JAX. The command runs each case in f32 (TF32 off on the
card), prints one JSON line a case with ``ok``: the mel MAE under
:func:`f32_limit` and, on a reranked case, the golden's pick; it exits 1 if
a case is not ok. Other modes (bf16, int8) go through :func:`check`, whose
caller sets their bound.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                      "golden_fullwidth.npz")
TREE_SEED = 0
ETA = 0.0
# the round's bar for the port in f32 against the JAX package
MEL_MAE_TOL = 1e-3


@dataclasses.dataclass(frozen=True)
class Case:
    family: str
    steps: int
    n_gen: int
    prompt: str
    transcription: str = ""
    duration: float = 10.0  # latent 256 (16 kHz) / 128 (48 kHz): a 10.24 s waveform
    guidance: float = 3.5
    xt_seed: int = 0


CASES: Dict[str, Case] = {
    # bench.py's headline geometry
    "t5_headline": Case("audioldm_16k_crossattn_t5", 200, 1, "A dog barking in the distance.",
                        xt_seed=1),
    # CLAP + FLAN-T5 + GPT-2 (8 tokens) + the nested AudioMAE
    "full": Case("audioldm2-full", 10, 1, "Rain on a tin roof.", xt_seed=2),
    # depth-2 transformers and the context-free third slot
    "large": Case("audioldm2-full-large-1150k", 10, 1, "A violin melody in a large hall.",
                  xt_seed=3),
    # FiLM, the four-level VAE, the 48 kHz vocoder and the CLAP rerank
    "k48": Case("audioldm_48k", 10, 3, "Waves crashing on rocks.", xt_seed=4),
    # the phoneme encoder and the 512-token GPT-2
    "tts": Case("audioldm2-speech-gigaspeech", 10, 1, "A man speaking clearly.",
                transcription="The quick brown fox jumps over the lazy dog, twice.",
                xt_seed=5),
}
# Each case's f32 limit on the mel MAE: 4x the port's reading on the CPU
# (tests/test_torch_golden.py::test_port_matches_the_golden_at_full_width:
# 2.31e-5, 3.07e-5, 4.67e-5, 2.94e-6, 2.08e-6), rounded up. The H100 read
# 0.88-1.27x those (chip_smoke.py's golden path), so an f32 request keeps
# 3x room, while a bar of MEL_MAE_TOL alone sits 20-480x above them.
F32_MEL_MAE_LIMIT = {"t5_headline": 9.3e-5, "full": 1.3e-4, "large": 1.9e-4, "k48": 1.2e-5,
                     "tts": 8.4e-6}
# families whose configs are another case's, field for field but the name
SHARED_CONFIGS = {"audioldm2-music-665k": "audioldm2-full",
                  "audioldm2-speech-ljspeech": "audioldm2-speech-gigaspeech"}


def f32_limit(case_name: str) -> float:
    """The mel MAE an f32 request of the case must stay under: its
    F32_MEL_MAE_LIMIT, never above the round's bar MEL_MAE_TOL (a case
    without a reading, as the tests' tiny goldens, gets the bar)."""
    return min(MEL_MAE_TOL, F32_MEL_MAE_LIMIT.get(case_name, MEL_MAE_TOL))


def f32_ok(d: Dict) -> bool:
    """Whether an f32 request's distances (:func:`run`'s) pass: the mel MAE
    under :func:`f32_limit` and the golden's pick."""
    return d["mel_mae"] < f32_limit(d["case"]) and d.get("same_pick", True)


def stored_case(meta: Dict) -> Case:
    """The Case a golden entry was made for, from its metadata."""
    return Case(**{f.name: meta[f.name] for f in dataclasses.fields(Case)})


def case_config(case: Case, compute_dtype: str = "float32", weight_quant: Optional[str] = None):
    """The case's family at its published width in ``compute_dtype``."""
    from audioldm2_torch.config import default_audioldm_config

    return dataclasses.replace(default_audioldm_config(case.family),
                               compute_dtype=compute_dtype, weight_quant=weight_quant)


def config_digest(cfg) -> str:
    """SHA-256 of every config field but ``name``, as sorted JSON: equal for
    the JAX package's and the port's configs of one family, and for two
    families that share a config."""
    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "name"}
    return hashlib.sha256(json.dumps(fields, sort_keys=True, default=str).encode()).hexdigest()


def latent_t_size(cfg, case: Case) -> int:
    return int(case.duration * cfg.latent_t_per_second)


def x_T(cfg, case: Case) -> np.ndarray:
    """The case's initial latent [n_gen, T, F, C], a numpy normal draw."""
    shape = (case.n_gen, latent_t_size(cfg, case), cfg.latent_f_size, cfg.latent_channels)
    return np.random.default_rng(case.xt_seed).standard_normal(shape, dtype=np.float32)


def batch_ids(batch) -> Dict[str, np.ndarray]:
    """The token ids and masks of a batch (``*_ids``, ``*_mask``,
    ``phoneme_idx``), as int64 numpy arrays."""
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).astype(np.int64)
            for k, v in batch.items() if k.endswith(("_ids", "_mask")) or k == "phoneme_idx"}


def context_length(mask) -> int:
    """Tokens up to the last one any row's mask keeps: the part of a
    cross-attention context the UNet reads."""
    keep = np.nonzero(np.asarray(mask).any(axis=0))[0]
    return int(keep[-1]) + 1 if keep.size else 0


def load(path: Optional[str] = None) -> Dict[str, Dict]:
    """case -> {"meta": dict, quantity: array} from the golden file
    (default :data:`GOLDEN`)."""
    out: Dict[str, Dict] = {}
    with np.load(path or GOLDEN, allow_pickle=False) as z:
        for key in z.files:
            case, name = key.split("/", 1)
            out.setdefault(case, {})[name] = z[key]
    for d in out.values():
        d["meta"] = json.loads(str(d["meta"]))
    return out


def rel(got, want) -> float:
    """max|got - want| / max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@contextlib.contextmanager
def recorded(module, name: str, out: list, arg: Optional[int] = None):
    """Append what each call of ``module.name`` returns (or its positional
    argument ``arg``) to ``out`` while inside."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        got = fn(*args, **kw)
        out.append(got if arg is None else args[arg])
        return got

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def build(case_name: str, device, golden: Dict, compute_dtype: str = "float32",
          weight_quant: Optional[str] = None, tree=None, cfg=None):
    """The case's model on ``device`` from :func:`params.draw_tree`'s tree
    (or ``tree``, already drawn), which must have the stored digest; ``cfg``
    (default: the family's published config) must have the stored config
    digest."""
    from audioldm2_torch import config as config_m, params as params_m
    from audioldm2_torch.pipeline import build_model

    meta = golden[case_name]["meta"]
    if cfg is None:
        cfg = case_config(stored_case(meta), compute_dtype, weight_quant)
    else:
        cfg = dataclasses.replace(config_m.coerce(cfg), compute_dtype=compute_dtype,
                                  weight_quant=weight_quant)
    if config_digest(dataclasses.replace(cfg, compute_dtype="float32", weight_quant=None)) \
            != meta["config_digest"]:
        raise ValueError(f"{case_name}: the port's {cfg.name} config is not the golden's")
    if tree is None:
        tree = params_m.draw_tree(cfg, meta["tree_seed"])
    digest = params_m.tree_digest(tree)
    if digest != meta["tree_digest"]:
        raise ValueError(f"{case_name}: the drawn tree's digest {digest} is not the golden's "
                         f"{meta['tree_digest']}")
    return build_model(config=cfg, params=tree, device=device)


def run(model, case_name: str, golden: Dict, around_generate: Callable = contextlib.nullcontext,
        stages: bool = True) -> Dict:
    """One request of the case on ``model`` against the golden: the ids
    (raising if they differ), then ``ldm.generate`` (inside
    ``around_generate()``) from the stored x_T. Returns the distances: the
    GPT-2 sequence (``seq_rel``; where there is one), each context slot
    (``ctx{i}_rel``), the FiLM y (``y_rel``), the final latent
    (``latent_rel``), all max|d| / max|golden|; ``mel_mae``, ``mel_max``
    (max |d|), ``wav_mae``; the scores (``scores_max``) and ``same_pick`` on
    a reranked case; with ``stages``, each stage on the golden's own input
    (``eps0_rel``: the first step's guided eps at x_T where stored, and
    ``eps0_unet_rel`` the same on the golden's conditioning, the UNet alone;
    ``decode_mel_mae``: the VAE decode of the golden latent;
    ``vocoder_wav_mae``: the vocoder on the golden mel). Conditioning runs
    no kernel, so it is compared outside the generate's count."""
    from audioldm2_torch import pipeline
    from audioldm2_torch.diffusion import latent_diffusion as ld
    from audioldm2_torch.diffusion.schedule import make_ddim_params

    g = golden[case_name]
    case = stored_case(g["meta"])
    cfg = model.cfg
    dev = model.device
    batch = model.make_batch(case.prompt, transcription=case.transcription, batchsize=1)
    ids = batch_ids(batch)
    for k, v in ids.items():
        want = g.get("ids/" + k)
        if want is None or want.shape != v.shape or not np.array_equal(want, v):
            raise ValueError(f"{case_name}: make_batch's {k} is not the golden's (tokenizer "
                             "fallback or phonemizer differs)")
    xt = torch.from_numpy(g["x_T"]).to(dev)
    conds, latents = [], []
    t0 = time.perf_counter()
    with around_generate(), recorded(ld, "encode_conditioning", conds), \
            recorded(ld, "decode_latent", latents, arg=2):
        wav, mel = model.ldm.generate(batch, None, latent_t_size(cfg, case), n_gen=case.n_gen,
                                      guidance=case.guidance, ddim_steps=case.steps,
                                      ddim_eta=ETA, x_T=xt)
    d: Dict = {"case": case_name, "family": case.family, "dtype": cfg.compute_dtype,
               "weight_quant": cfg.weight_quant, "steps": case.steps, "n_gen": case.n_gen,
               "generate_s": round(time.perf_counter() - t0, 3)}
    (y, contexts, masks), _ = conds[0]
    # every conditioner but CLAP's (FiLM) fills the next context slot; the
    # generated sequence (its slot's cond rows) is compared first, so that a
    # drift in the token loop is named as such
    slots = [s.kind for s in cfg.conditioners if s.kind != "clap"]
    if "sequence_gen" in slots:
        i = slots.index("sequence_gen")
        d["seq_rel"] = rel(_np(contexts[i])[-case.n_gen:], g[f"ctx{i}"][-case.n_gen:])
    for i, (c, m) in enumerate(zip(contexts, masks)):
        if not np.array_equal(_np(m), g[f"mask{i}"]):
            raise ValueError(f"{case_name}: the context mask of slot {i} is not the golden's")
        want = g[f"ctx{i}"]
        d[f"ctx{i}_rel"] = rel(_np(c)[:, :want.shape[1]], want)
    if y is not None:
        d["y_rel"] = rel(_np(y), g["y"])
    d["latent_rel"] = rel(_np(latents[0])[g["latent_rows"]], g["latent"])
    dm = np.abs(mel - g["mel"])
    d["mel_mae"] = float(dm.mean())
    d["mel_max"] = float(dm.max())
    d["mel_mean_abs"] = float(np.abs(g["mel"]).mean())
    if case.n_gen > 1:
        wav_kept = pipeline.rerank_and_select(model, wav, case.prompt, 1, case.n_gen)
        sim = model.last_similarities
        d["scores"] = [float(s) for s in sim]
        d["scores_max"] = float(np.abs(sim - g["scores"]).max())
        d["pick"] = int(np.argmax(sim))
        d["same_pick"] = d["pick"] == int(g["pick"])
        d["wav_mae"] = float(np.abs(wav_kept[0] - g["wav"][0]).mean())
    else:
        d["wav_mae"] = float(np.abs(wav - g["wav"]).mean())
    if stages:
        with torch.inference_mode():
            p = model.ldm.params
            if "eps0" in g:
                eps_fn, _ = ld.guided_eps_fn(p, cfg, batch, case.n_gen, case.guidance)
                t0_ = int(make_ddim_params(model.ldm.schedule, case.steps, ETA)[0][-1])
                tb = torch.full((xt.shape[0],), t0_, dtype=torch.int32, device=dev)
                d["eps0_rel"] = rel(_np(eps_fn(xt, tb)), g["eps0"])
                # the UNet alone: the same eps on the golden's own conditioning
                n_slots = sum(1 for k in g if k.startswith("ctx"))
                ctx = [torch.from_numpy(g[f"ctx{i}"]).to(dev) for i in range(n_slots)]
                masks = [torch.from_numpy(g[f"mask{i}"][:, :c.shape[1]]).to(dev)
                         for i, c in enumerate(ctx)]
                y_g = torch.from_numpy(g["y"]).to(dev) if "y" in g else None
                eps_g = ld.conditioned_eps_fn(p, cfg, y_g, ctx, masks, case.guidance)
                d["eps0_unet_rel"] = rel(_np(eps_g(xt, tb)), g["eps0"])
            rows = g["latent_rows"]
            _, mel_d = ld.decode_latent(p, cfg, torch.from_numpy(g["latent"]).to(dev))
            d["decode_mel_mae"] = float(np.abs(_np(mel_d) - g["mel"][rows]).mean())
            from audioldm2_torch.models import vocoder
            from audioldm2_torch.params import cast_floating
            voc = cast_floating(p["vocoder"], ld.compute_dtype(cfg))
            mel_g = torch.from_numpy(g["mel"][g["wav_rows"]][..., 0]).to(dev)
            w = vocoder.apply_vocoder(voc, cfg.vocoder, mel_g.to(ld.compute_dtype(cfg)))
            d["vocoder_wav_mae"] = float(np.abs(_np(w) - g["wav"]).mean())
    return d


def check(case_name: str, device="cuda", compute_dtype: str = "float32",
          weight_quant: Optional[str] = None, golden: Optional[Dict] = None,
          stages: bool = True, cfg=None) -> Dict:
    """Rebuild the case's tree (the digest must match), build the port's
    model on ``device`` and return :func:`run`'s distances."""
    golden = load() if golden is None else golden
    model = build(case_name, device, golden, compute_dtype, weight_quant, cfg=cfg)
    return run(model, case_name, golden, stages=stages)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--case", nargs="*", default=None, help="default: every stored case")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    golden = load()
    bad = 0
    for name in args.case or list(golden):
        d = check(name, args.device, golden=golden)
        d["mel_mae_limit"] = f32_limit(name)
        d["ok"] = f32_ok(d)
        bad += not d["ok"]
        print(json.dumps(d), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
