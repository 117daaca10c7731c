"""Host-side text processing: the tokenizers.

The port's own copy of the tokenizers of ``audioldm2_tpu/utils/text.py``
(HF tokenizer when its cache is present, else the deterministic hash
fallback with the same special ids), so both packages see the same ids,
and of its VITS phoneme pipeline (``text_to_phonemes``, ``phoneme_ids``:
espeak through ``phonemizer`` when it is installed, else the same cleaned
graphemes). ``clap_tokenizer`` gives CLAP's transformer text tower the
CLIP-BPE tokenizer of ``utils/bpe.py``.

Reference behaviors mirrored:
* T5: max_length=128, truncation (reference encoders/modules.py:173-181);
  here always padded to the static max_length.
* CLAP/RoBERTa: padding="max_length", max_length=512 (modules.py:737-745).
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Generic tokenizer wrappers
# ---------------------------------------------------------------------------


def _hf_cache_has(name: str) -> bool:
    """Cheap (no-import) check whether ``name`` could resolve locally:
    either it is a directory path, or the HF hub cache has an entry."""
    import os

    if os.path.isdir(name):
        return True
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get(
            "HF_HOME", os.path.join(os.path.expanduser("~"), ".cache", "huggingface")
        ),
        "hub",
    )
    return os.path.isdir(os.path.join(hub, "models--" + name.replace("/", "--")))


def _try_hf_tokenizer(name: str):
    try:
        import os

        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        # `import transformers` drags in torch (+56 s on this single-core
        # host). When we are offline AND the hub cache has no entry, the
        # load can only fail — skip the import entirely.
        offline = os.environ.get("HF_HUB_OFFLINE", "").strip().lower() not in (
            "", "0", "false", "off",
        )
        if offline and not _hf_cache_has(name):
            return None
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name)
    except Exception:
        return None


class HashWordTokenizer:
    """Deterministic word-hash tokenizer used when the real HF tokenizer is
    unavailable. Stable across processes (hashlib, not hash()).

    Special-token ids MUST follow the named model family's conventions:
    RoBERTa treats id 1 as ``padding_idx`` inside its position-id computation
    (``cumsum(input_ids != 1)``), so a fallback that emits id 1 for a real
    token (or pads with anything other than 1) makes the HF reference and
    this repo's RoBERTa disagree on identical ids — measured 3.3e-2 on the
    normalized CLAP text embedding before this was pinned down."""

    def __init__(self, vocab_size: int, pad_id: int = 0, eos_id: int = 1,
                 bos_id: Optional[int] = None):
        self.vocab_size = vocab_size
        self.pad_id = pad_id
        self.eos_id = eos_id
        self.bos_id = bos_id

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return 200 + h % (self.vocab_size - 200)

    def __call__(self, texts: List[str], max_length: int):
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        prefix = [] if self.bos_id is None else [self.bos_id]
        for b, text in enumerate(texts):
            words = re.findall(r"\w+|[^\w\s]", text.lower())
            toks = prefix + [self._word_id(w) for w in words]
            toks = toks[: max_length - 1] + [self.eos_id]
            ids[b, : len(toks)] = toks
            mask[b, : len(toks)] = 1
        return ids, mask


# HF special-token conventions per tokenizer family (public constants).
_FALLBACK_SPECIALS = {
    "google/flan-t5-large": dict(pad_id=0, eos_id=1),
    "roberta-base": dict(pad_id=1, bos_id=0, eos_id=2),
    "bert-base-uncased": dict(pad_id=0, bos_id=101, eos_id=102),
    "facebook/bart-base": dict(pad_id=1, bos_id=0, eos_id=2),
}

_warned_fallback: set = set()


class TextTokenizer:
    """HF tokenizer if available, hash fallback otherwise. Always emits
    fixed-shape [B, max_length] ids + mask."""

    def __init__(self, hf_name: str, vocab_size: int, max_length: int):
        self.hf_name = hf_name
        self.max_length = max_length
        self.hf = _try_hf_tokenizer(hf_name)
        self.fallback = HashWordTokenizer(
            vocab_size, **_FALLBACK_SPECIALS.get(hf_name, {})
        )
        self.is_exact = self.hf is not None
        if self.hf is None and hf_name not in _warned_fallback:
            _warned_fallback.add(hf_name)
            import sys

            print(
                f"[audioldm2_torch] WARNING: HF tokenizer '{hf_name}' unavailable "
                "(offline, no cache) — using a deterministic hash fallback. "
                "Shapes and padding match, token ids do NOT: generated audio "
                "will differ from a reference run with the real tokenizer.",
                file=sys.stderr,
                flush=True,
            )

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        if self.hf is not None:
            out = self.hf(
                texts,
                max_length=self.max_length,
                padding="max_length",
                truncation=True,
                return_tensors="np",
            )
            return out["input_ids"].astype(np.int32), out["attention_mask"].astype(
                np.int32
            )
        return self.fallback(texts, self.max_length)


def t5_tokenizer(max_length: int = 128) -> TextTokenizer:
    return TextTokenizer("google/flan-t5-large", 32128, max_length)


def roberta_tokenizer(max_length: int = 512) -> TextTokenizer:
    return TextTokenizer("roberta-base", 50265, max_length)


def bert_tokenizer(max_length: int = 512) -> TextTokenizer:
    return TextTokenizer("bert-base-uncased", 30522, max_length)


class _ClipBPETokenizer:
    """The CLIP BPE tokenizer with the (ids, mask) interface; the
    transformer text tower ignores the mask (a causal mask, features at the
    EOT position)."""

    def __init__(self, context_length: int = 77):
        from audioldm2_torch.utils import bpe

        self.tok = bpe.SimpleTokenizer(context_length=context_length)

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(self.tok(texts), np.int32)
        return ids, (ids != 0).astype(np.int32)


def clap_tokenizer(clap_cfg) -> object:
    """Tokenizer matching the CLAP text tower variant
    (reference model.py:497-545: roberta/bert/bart use HF tokenizers,
    "transformer" uses the CLIP BPE tokenizer)."""
    if clap_cfg.tmodel == "transformer":
        return _ClipBPETokenizer()
    if clap_cfg.tmodel == "bert":
        return bert_tokenizer(clap_cfg.text_max_length)
    # roberta and bart share the roberta-base vocab
    return roberta_tokenizer(clap_cfg.text_max_length)


# ---------------------------------------------------------------------------
# VITS phoneme pipeline
# ---------------------------------------------------------------------------

PAD_LENGTH = 310
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


def _expand_abbreviations(text: str) -> str:
    for pattern, replacement in _ABBREVIATIONS:
        text = pattern.sub(replacement, text)
    return text


def text_to_phonemes(text: str) -> str:
    """english_cleaners2 equivalent (reference
    phoneme_encoder/text/cleaners.py:89-100): lowercase, abbreviation
    expansion, espeak IPA phonemization with stress/punctuation. Falls back
    to cleaned graphemes (all in the VITS symbol set) when espeak is
    absent."""
    text = re.sub(r"<.*?>", "", text)  # reference pipeline.py:33-34
    text = text.lower()
    text = _expand_abbreviations(text)
    phonemes = None
    try:
        from phonemizer import phonemize

        phonemes = phonemize(
            text,
            language="en-us",
            backend="espeak",
            strip=True,
            preserve_punctuation=True,
            with_stress=True,
        )
    except Exception:
        phonemes = text  # grapheme fallback
    return re.sub(r"\s+", " ", phonemes)


def phoneme_ids(phonemes: List[str], pad_length: int = PAD_LENGTH) -> np.ndarray:
    """get_vits_phoneme_ids_no_padding equivalent (reference
    latent_diffusion/util.py:28-49): first entry + "⚠" EOS, unknown -> "_",
    right-pad with 0 to 310, tiled to the batch."""
    batchsize = len(phonemes)
    clean = phonemes[0] + "⚠"
    seq = [_SYMBOL_TO_ID.get(s, _SYMBOL_TO_ID[_PAD]) for s in clean][:pad_length]
    seq = seq + [0] * (pad_length - len(seq))
    return np.tile(np.asarray(seq, np.int32)[None, :], (batchsize, 1))
