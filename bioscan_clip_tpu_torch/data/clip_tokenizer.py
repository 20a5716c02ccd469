"""CLIP BPE tokenizer: a copy of bioscan_clip_tpu/data/clip_tokenizer.py
(standard library and numpy only).

The reference tokenizes in-forward with open_clip.get_tokenizer('ViT-B-32')
at context length 77 (simple_clip.py:25, 41). This module implements the
same published algorithm: whitespace cleanup + lowercase, byte-to-unicode
mapping, greedy BPE with a merges table, '</w>' word terminators,
<start_of_text>/<end_of_text> specials, truncate/pad to the context length.
Nothing on the serving path uses it (the service feeds the OpenCLIP text
tower BERT-small WordPiece ids, as the JAX service does); it is here for
callers that feed CLIP-BPE ids at context 77.

The BPE merges file (bpe_simple_vocab_16e6.txt.gz, shipped inside CLIP /
open_clip) must be provided via `bpe_path` or the BIOSCAN_CLIP_TPU_BPE env
var: it is data, not code, and is not bundled here.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Optional

import numpy as np


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (the standard GPT-2/CLIP
    construction)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    SOT = "<start_of_text>"
    EOT = "<end_of_text>"

    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or os.environ.get("BIOSCAN_CLIP_TPU_BPE")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merges file not found; pass bpe_path or set "
                "BIOSCAN_CLIP_TPU_BPE to bpe_simple_vocab_16e6.txt.gz"
            )
        self.byte_encoder = bytes_to_unicode()
        if bpe_path.endswith(".gz"):
            merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        else:
            merges = open(bpe_path, encoding="utf-8").read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m.strip()]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend([self.SOT, self.EOT])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            self.SOT: self.SOT,
            self.EOT: self.EOT,
        }
        # the standard library's `re` has no \p{L}: ASCII letter classes
        self.pat = re.compile(
            r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list:
        out = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            out.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return out

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        """Tokenize to (N, context_length) int32 with SOT/EOT, truncating so
        the EOT always survives (open_clip semantics)."""
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder[self.SOT]
        eot = self.encoder[self.EOT]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            toks = [sot] + self.encode(t) + [eot]
            if len(toks) > context_length:
                toks = toks[:context_length]
                toks[-1] = eot
            out[i, : len(toks)] = toks
        return out
