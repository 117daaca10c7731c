"""CLIP byte-pair-encoding tokenizer, the tokenizer of CLAP's "transformer"
text tower.

Port of ``audioldm2_tpu/utils/bpe.py`` (stdlib ``re`` only): bytes mapped
to unicode characters, the merge ranks of ``bpe_simple_vocab_16e6.txt.gz``
(the port's own copy under ``audioldm2_torch/assets/``, public CLIP data),
``<start_of_text>`` / ``<end_of_text>`` around each text and a fixed
context of 77 tokens, zero-padded.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import List, Optional

import numpy as np

VOCAB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "assets", "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def bytes_to_unicode():
    """Every byte to a printable unicode character (CLIP's table)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return set(zip(word[:-1], word[1:]))


def _clean(text: str) -> str:
    """HTML-unescaped twice, whitespace runs collapsed, stripped."""
    return re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip()).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None, context_length: int = 77):
        bpe_path = bpe_path or VOCAB_PATH
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
        vocab += ["<start_of_text>", "<end_of_text>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<start_of_text>": "<start_of_text>", "<end_of_text>": "<end_of_text>"}
        self.pat = re.compile(
            r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[^\s\w]+|\w+",
            re.IGNORECASE)

    def bpe(self, token: str) -> str:
        """The merges of one pre-token, as space-separated sub-words."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self.cache[token] = " ".join(word)
        return self.cache[token]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in re.findall(self.pat, _clean(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts: List[str]) -> np.ndarray:
        """[B, context_length] int32: SOT, the ids, EOT, zeros; a text too
        long is cut and ends in EOT."""
        sot, eot = self.encoder["<start_of_text>"], self.encoder["<end_of_text>"]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            toks = ([sot] + self.encode(text) + [eot])[:self.context_length]
            toks[-1] = eot
            out[i, :len(toks)] = toks
        return out
