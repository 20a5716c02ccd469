"""Native WordPiece tokenizer (BERT semantics) — no HF download required.

A copy of bioscan_clip_tpu/data/wordpiece.py for the port.

The HDF5 builder pre-tokenizes taxonomy label strings with the bert-small
tokenizer (reference scripts/generate_hdf5_file_5m.py:281-285: padding to
max_length, truncation). This module reimplements the full BERT tokenization
pipeline from a local `vocab.txt` — the last tokenizer in the rebuild that
still depended on a cached HuggingFace artifact (the k-mer DNA tokenizer and
the CLIP BPE are already native).

Pipeline (BertTokenizer parity, tested golden vs `transformers`):
  clean text -> (uncased) lowercase + NFD accent strip -> whitespace split
  -> punctuation split -> CJK char isolation -> greedy longest-match-first
  WordPiece with '##' continuations -> [CLS] ... [SEP] + pad/truncate.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
MAX_INPUT_CHARS_PER_WORD = 100


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # BERT treats all non-letter/number ASCII as punctuation (includes $, ^)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (
        123 <= cp <= 126
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BertTokenizer-compatible encoder over a local vocab.

    `lowercase=True` matches uncased models (prajjwal1/bert-small is
    uncased). `encode_batch` returns the same
    {input_ids, token_type_ids, attention_mask} int32 dict the HDF5 schema
    stores."""

    def __init__(self, vocab, lowercase: bool = True):
        self.vocab = load_vocab(vocab) if isinstance(vocab, str) else dict(vocab)
        self.lowercase = lowercase
        for tok in (PAD, UNK, CLS, SEP):
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing required token {tok}")
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]

    # --- basic tokenization (BasicTokenizer parity) ---

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    def _basic_tokens(self, text: str) -> List[str]:
        text = self._clean(text)
        # CJK chars become standalone tokens
        text = "".join(
            f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text
        )
        tokens: List[str] = []
        for word in text.split():
            if self.lowercase:
                word = self._strip_accents(word.lower())
            # split punctuation into separate tokens
            cur: List[str] = []
            for ch in word:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    # --- WordPiece (greedy longest-match-first) ---

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > MAX_INPUT_CHARS_PER_WORD:
            return [UNK]
        pieces: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._basic_tokens(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, max_length: int = 20) -> List[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]  # room for [CLS]/[SEP] (truncation)
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(
        self, texts: Iterable[str], max_length: int = 20
    ) -> Dict[str, np.ndarray]:
        texts = list(texts)
        input_ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        attention = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_length)
            input_ids[i, : len(ids)] = ids
            attention[i, : len(ids)] = 1
        return {
            "input_ids": input_ids,
            "token_type_ids": np.zeros_like(input_ids),
            "attention_mask": attention,
        }
