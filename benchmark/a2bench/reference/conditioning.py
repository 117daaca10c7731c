"""The conditioning stages of the reference: the tokenizers, FLAN-T5's
encoder, RoBERTa and CLAP's text embedding, the VITS phoneme pipeline and
text encoder, and the GPT-2 sequence generator.

A frozen copy of ``audioldm2_torch/utils/text.py`` (the hash fallback
tokenizer, the only one without a tokenizer cache, and the phoneme
pipeline), ``models/t5.py``, ``models/roberta.py``, the text half of
``models/clap.py``, ``models/phoneme.py``, ``models/gpt2.py``,
``models/sequence_gen.py`` and ``models/conditioners.py``, in float32.
The sequence generator runs GPT-2 over the whole sequence at every step,
with no KV cache.
"""

from __future__ import annotations

import hashlib
import math
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from a2bench.reference import nn
from a2bench.reference.config import (CLAPConfig, ConditionerSpec, FlanT5Config, GPT2Config,
                                      ModelConfig, PhonemeEncoderConfig, RobertaConfig,
                                      text_tower)

# special ids of each tokenizer family (public HF constants)
SPECIALS = {
    "google/flan-t5-large": dict(vocab_size=32128, pad_id=0, eos_id=1, bos_id=None),
    "roberta-base": dict(vocab_size=50265, pad_id=1, eos_id=2, bos_id=0),
}


def tokenize(family: str, texts: List[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """The deterministic word-hash tokenizer: ([B, max_length] ids, mask)."""
    sp = SPECIALS[family]
    ids = np.full((len(texts), max_length), sp["pad_id"], np.int32)
    mask = np.zeros((len(texts), max_length), np.int32)
    prefix = [] if sp["bos_id"] is None else [sp["bos_id"]]
    for b, text in enumerate(texts):
        words = re.findall(r"\w+|[^\w\s]", text.lower())
        toks = prefix + [200 + int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
                         % (sp["vocab_size"] - 200) for w in words]
        toks = toks[: max_length - 1] + [sp["eos_id"]]
        ids[b, : len(toks)] = toks
        mask[b, : len(toks)] = 1
    return ids, mask


# --- FLAN-T5 encoder ---------------------------------------------------------


def _t5_buckets(length: int, cfg: FlanT5Config) -> np.ndarray:
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]
    nb = cfg.relative_attention_num_buckets // 2
    ret = (rel > 0).astype(np.int32) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(n, 1) / max_exact)
                         / np.log(cfg.relative_attention_max_distance / max_exact)
                         * (nb - max_exact)).astype(np.int32)
    return ret + np.where(n < max_exact, n, np.minimum(large, nb - 1))


def t5_encode(params, cfg: FlanT5Config, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L] ids and mask -> the final hidden states [B, L, d_model]."""
    x = params["token_embed"][ids.long()].float()
    buckets = torch.as_tensor(_t5_buckets(ids.shape[1], cfg), device=x.device).long()
    bias = params["blocks"][0]["rel_bias"].float()[buckets].permute(2, 0, 1)[None]
    eps = cfg.layer_norm_epsilon
    for blk in params["blocks"]:
        h = nn.rms_norm(blk["ln1"], x, eps)
        a = blk["attn"]
        q, k, v = (nn.split_heads(nn.linear(a[n], h), cfg.num_heads) for n in ("q", "k", "v"))
        x = x + nn.linear(a["o"], nn.merge_heads(nn.attention(q, k, v, mask=mask, bias=bias,
                                                              scale=1.0)))
        h = nn.rms_norm(blk["ln2"], x, eps)
        f = blk["ff"]
        u = nn.gelu_tanh(nn.linear(f["wi_0"], h)) * nn.linear(f["wi_1"], h)
        x = x + nn.linear(f["wo"], u)
    return nn.rms_norm(params["final_ln"], x, eps)


# --- RoBERTa and CLAP's text embedding ---------------------------------------


def roberta_pooled(params, cfg: RobertaConfig, ids: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """RoBERTa's pooler output [B, D]."""
    ids = ids.long()
    m = mask.long()
    positions = torch.cumsum(m, dim=1) * m + cfg.pad_token_id
    x = (params["word_embeddings"][ids] + params["position_embeddings"][positions]
         + params["token_type_embeddings"][0]).float()
    x = nn.layer_norm(params["emb_ln"], x, cfg.layer_norm_eps)
    for layer in params["layers"]:
        a = layer["attn"]
        q, k, v = (nn.split_heads(nn.linear(a[n], x), cfg.num_heads) for n in ("q", "k", "v"))
        att = nn.linear(a["out"], nn.merge_heads(nn.attention(q, k, v, mask=mask)))
        x = nn.layer_norm(a["ln"], x + att, cfg.layer_norm_eps)
        f = layer["ff"]
        h = nn.linear(f["output"], nn.gelu(nn.linear(f["intermediate"], x)))
        x = nn.layer_norm(f["ln"], x + h, cfg.layer_norm_eps)
    return torch.tanh(nn.linear(params["pooler"], x[:, 0]))


def project(p, x):
    return nn.linear(p["lin2"], torch.relu(nn.linear(p["lin1"], x)))


def normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def clap_text(params, cfg: CLAPConfig, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The L2-normalized CLAP text embedding [B, embed_dim]."""
    tcfg, _ = text_tower(cfg)
    return normalize(project(params["text_projection"],
                             roberta_pooled(params["text_branch"], tcfg, ids, mask)))


# --- the VITS phoneme pipeline and text encoder ---------------------------------

# VITS's symbol table: a symbol's id is its position ("_", the pad, is 0)
_PAD = "_"
_PUNCTUATION = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
_SPECIAL = "♪☎☒☝⚠"

VITS_SYMBOLS = [_PAD] + list(_PUNCTUATION) + list(_LETTERS) + list(_LETTERS_IPA) + list(_SPECIAL)
_SYMBOL_TO_ID = {s: i for i, s in enumerate(VITS_SYMBOLS)}

_ABBREVIATIONS = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]
END_MARKER = "⚠"  # the last of _SPECIAL
PHONEME_MASK_FILL = -1e4  # VITS's attentions.py fills masked logits with it


def text_to_phonemes(text: str) -> str:
    """english_cleaners2: tags dropped, lowercase, abbreviations expanded,
    then espeak's IPA with stress and punctuation where ``phonemizer`` and
    espeak are installed, else the cleaned graphemes (all in the symbol
    table); runs of white space as one space."""
    text = re.sub(r"<.*?>", "", text).lower()
    for pattern, replacement in _ABBREVIATIONS:
        text = pattern.sub(replacement, text)
    try:
        from phonemizer import phonemize

        phonemes = phonemize(text, language="en-us", backend="espeak", strip=True,
                             preserve_punctuation=True, with_stress=True)
    except Exception:  # any failure of the optional step keeps the graphemes, as the program does
        phonemes = text
    return re.sub(r"\s+", " ", phonemes)


def phoneme_ids(phonemes: str, pad_length: int) -> np.ndarray:
    """[1, pad_length] ids: the phonemes and the end marker, a symbol
    outside the table as the pad symbol, cut at ``pad_length`` and padded
    on the right with 0."""
    seq = [_SYMBOL_TO_ID.get(s, _SYMBOL_TO_ID[_PAD]) for s in phonemes + END_MARKER]
    seq = seq[:pad_length]
    return np.asarray([seq + [0] * (pad_length - len(seq))], np.int32)


def _rel_table(emb_rel: torch.Tensor, window: int, length: int) -> torch.Tensor:
    """[L, L, d]: the relative embedding of j - i, zero where |j - i| > window."""
    pos = torch.arange(length, device=emb_rel.device)
    rel = pos[None, :] - pos[:, None]
    table = emb_rel[0].float()[(rel + window).clamp(0, 2 * window)]
    return torch.where((rel.abs() <= window)[..., None], table, torch.zeros_like(table))


def _rel_attention(p, x: torch.Tensor, keep: torch.Tensor, cfg: PhonemeEncoderConfig):
    """Windowed relative-position attention, one key and one value table
    shared by the heads; x: [B, L, h], keep: [B, 1, L, L]."""
    heads = cfg.n_heads
    scale = 1.0 / math.sqrt(cfg.hidden_channels // heads)
    q, k, v = (nn.split_heads(nn.conv1d(p[n], x, padding=0), heads) for n in "qkv")
    table_k = _rel_table(p["emb_rel_k"], cfg.window_size, x.shape[1])
    table_v = _rel_table(p["emb_rel_v"], cfg.window_size, x.shape[1])
    scores = torch.einsum("bihd,bjhd->bhij", q, k) * scale
    scores = scores + torch.einsum("bihd,ijd->bhij", q, table_k) * scale
    weights = torch.softmax(torch.where(keep, scores, torch.full_like(scores, PHONEME_MASK_FILL)),
                            dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", weights, v)
    out = out + torch.einsum("bhij,ijd->bihd", weights, table_v)
    return nn.conv1d(p["o"], nn.merge_heads(out), padding=0)


def phoneme_encode(params, cfg: PhonemeEncoderConfig, ids: torch.Tensor):
    """The VITS text encoder: [B, pad_length] ids -> (the encoding [B, L, h],
    the mask [B, L], 1 on the first ``length`` positions, ``length`` the
    ids other than the pad). The embedding scaled by sqrt(h), then per layer
    the attention and the kernel-``kernel_size`` conv FFN (padding
    ((k - 1) // 2, k // 2)), each under the mask and followed by its
    post-LayerNorm; the positional embedding added at the output."""
    lengths = (ids != cfg.pad_token_id).sum(dim=-1)
    pos = torch.arange(ids.shape[1], device=ids.device)
    x_mask = (pos[None, :] < lengths[:, None]).float()
    m = x_mask[..., None]
    x = params["emb"].float()[ids.long()] * math.sqrt(cfg.hidden_channels) * m
    keep = (x_mask[:, None, :, None] * x_mask[:, None, None, :]) > 0
    pad = (0, 0, (cfg.kernel_size - 1) // 2, cfg.kernel_size // 2)  # the time axis of [B, L, C]
    for layer in params["layers"]:
        x = nn.layer_norm(layer["ln1"], x + _rel_attention(layer["attn"], x, keep, cfg))
        f = layer["ffn"]
        h = torch.relu(nn.conv1d(f["conv1"], F.pad(x * m, pad), padding=0))
        h = nn.conv1d(f["conv2"], F.pad(h * m, pad), padding=0) * m
        x = nn.layer_norm(layer["ln2"], x + h)
    return x * m + params["pos_emb"].float(), x_mask


# --- GPT-2 sequence generator --------------------------------------------------


def gpt2_hidden(params, cfg: GPT2Config, embeds: torch.Tensor, mask: torch.Tensor):
    """GPT-2 over the whole sequence: hidden states [B, L, D] (positions from
    the mask's running count, causal attention over valid keys)."""
    length = embeds.shape[1]
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0).long()
    x = embeds.float() + params["wpe"][positions].float()
    causal = torch.tril(torch.ones((length, length), dtype=torch.bool, device=x.device))
    keep = causal[None, None] & mask.bool()[:, None, None, :]
    eps = cfg.layer_norm_epsilon
    for blk in params["blocks"]:
        h = nn.layer_norm(blk["ln_1"], x, eps)
        q, k, v = (nn.split_heads(t, cfg.n_head)
                   for t in torch.chunk(nn.linear(blk["attn"]["c_attn"], h), 3, dim=-1))
        x = x + nn.linear(blk["attn"]["c_proj"], nn.merge_heads(nn.attention(q, k, v,
                                                                             mask=keep)))
        h = nn.layer_norm(blk["ln_2"], x, eps)
        x = x + nn.linear(blk["mlp"]["c_proj"], nn.gelu_tanh(nn.linear(blk["mlp"]["c_fc"], h)))
    return nn.layer_norm(params["ln_f"], x, eps)


def sequence_generate(params, spec: ConditionerSpec, batch: Dict) -> torch.Tensor:
    """The generated tokens [B, sequence_gen_length, 768]: GPT-2 continues
    the SOS/condition/EOS prefix of each input condition, one token a step."""
    sg = spec.sequence_gen
    nested = {ns.name: ns for ns in spec.nested}
    seqs, masks = [], []
    for i, key in enumerate(sg.sequence_input_keys):
        kind, val = encode(params["cond"][key], nested[key], batch)
        if kind == "film":
            emb = val[:, None, :]
            m = torch.ones(emb.shape[:2], device=emb.device)
        else:
            emb, m = val
        emb = nn.linear(params["input_linears"][i], emb)
        b = emb.shape[0]
        one = torch.ones((b, 1), device=emb.device)
        seqs.append(torch.cat([params["sos"][i].float().expand(b, 1, 768), emb,
                               params["eos"][i].float().expand(b, 1, 768)], dim=1))
        masks.append(torch.cat([one, m.float(), one], dim=1))
    max_len = sg.max_context - sg.sequence_gen_length
    seq = torch.cat(seqs, dim=1)[:, :max_len]
    mask = torch.cat(masks, dim=1)[:, :max_len]
    b, l_pre, _ = seq.shape
    idx = torch.arange(l_pre, device=seq.device)
    last = (idx[None, :] * mask.long()).amax(dim=1)
    rows = torch.arange(b, device=seq.device)
    g = gpt2_hidden(params["gpt2"], sg.gpt2, seq, mask)[rows, last]
    tokens = [g]
    for i in range(1, sg.sequence_gen_length):
        seq = torch.cat([seq, g[:, None, :]], dim=1)
        mask = torch.cat([mask, torch.ones((b, 1), device=seq.device)], dim=1)
        g = gpt2_hidden(params["gpt2"], sg.gpt2, seq, mask)[:, -1]
        tokens.append(g)
    return torch.stack(tokens, dim=1)


# --- the conditioners ---------------------------------------------------------


def encode(params, spec: ConditionerSpec, batch: Dict):
    """("crossattn", (ctx, mask)) or ("film", emb [B, D]) of one conditioner
    on the batch's ``t5_*`` / ``clap_*`` ids and masks and its
    ``phoneme_idx``."""
    if spec.kind == "flan_t5":
        ctx = t5_encode(params["t5"], spec.flan_t5, batch["t5_ids"], batch["t5_mask"])
        return "crossattn", (ctx, batch["t5_mask"].float())
    if spec.kind == "clap":
        return "film", clap_text(params["clap"], spec.clap, batch["clap_ids"],
                                 batch["clap_mask"])
    if spec.kind == "phoneme":
        return "crossattn", phoneme_encode(params, spec.phoneme, batch["phoneme_idx"])
    if spec.kind == "sequence_gen":
        tokens = sequence_generate(params, spec, batch)
        return "crossattn", (tokens, torch.ones(tokens.shape[:2], device=tokens.device))
    raise ValueError(f"conditioner kind {spec.kind!r} is not in the reference")


def unconditional(params, spec: ConditionerSpec, batch: Dict):
    """The unconditional branch of one conditioner, for one row."""
    if spec.kind == "flan_t5":
        ctx = t5_encode(params["t5"], spec.flan_t5, batch["t5_uncond_ids"],
                        batch["t5_uncond_mask"])
        return "crossattn", (ctx, batch["t5_uncond_mask"].float())
    if spec.kind == "clap":
        return "film", clap_text(params["clap"], spec.clap, batch["clap_uncond_ids"],
                                 batch["clap_uncond_mask"])
    if spec.kind == "sequence_gen":
        dev = batch["clap_ids"].device
        zeros = torch.zeros((1, spec.sequence_gen.sequence_gen_length, 768), device=dev)
        return "crossattn", (zeros, torch.ones(zeros.shape[:2], device=dev))
    raise ValueError(f"conditioner kind {spec.kind!r} is not in the reference")


def token_batch(cfg: ModelConfig, text: str, transcription: str,
                device) -> Dict[str, torch.Tensor]:
    """The prompt's and ""'s token ids and masks, one row each, and where a
    phoneme encoder reads them the transcription's phoneme ids (those of
    "" where there is none)."""
    t5_len = _t5_max_length(cfg.conditioners)
    clap_len = _first_clap(cfg.conditioners).text_max_length
    out = {}
    for name, family, length in (("t5", "google/flan-t5-large", t5_len),
                                 ("clap", "roberta-base", clap_len)):
        if length is None:
            continue
        ids, mask = tokenize(family, [text], length)
        uids, umask = tokenize(family, [""], length)
        out.update({f"{name}_ids": ids, f"{name}_mask": mask, f"{name}_uncond_ids": uids,
                    f"{name}_uncond_mask": umask})
    for s in _walk(cfg.conditioners):
        if s.kind == "phoneme":
            phonemes = text_to_phonemes(transcription) if transcription else ""
            out["phoneme_idx"] = phoneme_ids(phonemes, s.phoneme.pad_length)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def _walk(specs):
    for s in specs:
        yield s
        yield from _walk(s.nested)


def reads_transcription(cfg: ModelConfig) -> bool:
    """Whether a conditioner of ``cfg`` (nested ones included) encodes the
    transcription: a speech configuration."""
    return any(s.kind == "phoneme" for s in _walk(cfg.conditioners))


def _t5_max_length(specs):
    for s in _walk(specs):
        if s.kind == "flan_t5":
            return s.flan_t5.max_length
    return None


def _first_clap(specs) -> CLAPConfig:
    for s in _walk(specs):
        if s.kind == "clap":
            return s.clap
    return CLAPConfig()


def conditioning(params, cfg: ModelConfig, text: str, transcription: str, device):
    """The UNet inputs of one prompt: (y [2, D] or None, contexts
    [[2, L, D]], masks [[2, L]]), the unconditional row first."""
    batch = token_batch(cfg, text, transcription, device)
    y, contexts, masks = None, [], []
    for spec in cfg.conditioners:
        kind, vc = encode(params["cond"][spec.name], spec, batch)
        _, vu = unconditional(params["cond"][spec.name], spec, batch)
        if kind == "film":
            y = torch.cat([vu, vc])
        else:
            contexts.append(torch.cat([vu[0], vc[0]]))
            masks.append(torch.cat([vu[1], vc[1]]))
    return y, contexts, masks
