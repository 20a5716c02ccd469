"""Host-side tokenizers: DNA barcode k-mer tokenizer and taxonomy label strings.

A copy of bioscan_clip_tpu/data/tokenizers.py for the port (`transformers`
is imported only on the route without a local vocab).

Behavioral parity with the reference pipeline:
- DNA: pad/truncate to 660 chars with 'N', non-overlapping 5-mers (stride 5,
  132 tokens), vocabulary = specials ["<MASK>","<CLS>","<UNK>"] (ids 0/1/2)
  followed by all 4^5 5-mers in lexicographic order (A<C<G<T), unknown
  (non-ACGT-containing) k-mers -> <UNK>; a literal token 0 is prepended as a
  pseudo-CLS, so output length is 133.
  (reference: bioscanclip/model/dna_encoder.py:25-35,
   bioscanclip/util/util.py:48-69 — torchtext build_vocab_from_iterator over
   itertools.product("ACGT", repeat=5) sorts equal-frequency tokens
   lexicographically, which equals base-4 order with A=0,C=1,G=2,T=3.)
- Text label: the string "order family genus species"
  (reference: bioscanclip/util/dataset.py:134-137).

Unlike the reference (per-sample Python loops over the whole split at
dataloader construction, dataset.py:318-326), tokenization here is a
vectorized numpy kernel suitable for streaming: ~1e6 barcodes tokenize in
seconds and can be done shard-by-shard on the host while the device computes.
"""

from __future__ import annotations

import numpy as np

K = 5
MAX_SEQ_CHARS = 660
NUM_KMER_TOKENS = MAX_SEQ_CHARS // K  # 132
SEQ_LEN = NUM_KMER_TOKENS + 1  # 133, includes prepended token 0
MASK_ID = 0
CLS_ID = 1
UNK_ID = 2
NUM_SPECIALS = 3
VOCAB_SIZE = NUM_SPECIALS + 4**K  # 1027

# byte -> base code LUT: A=0, C=1, G=2, T=3, anything else = 4 (invalid).
_BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_LUT[_b] = _i
# The reference pipeline is case-sensitive (barcodes are uppercase in the
# BIOSCAN HDF5 exports); lowercase maps to <UNK> there too, so we leave the
# LUT uppercase-only.

_POW4 = (4 ** np.arange(K - 1, -1, -1)).astype(np.int32)  # [256, 64, 16, 4, 1]


def kmer_vocab() -> dict:
    """The full token->id mapping (for debugging / parity checks)."""
    from itertools import product

    vocab = {"<MASK>": MASK_ID, "<CLS>": CLS_ID, "<UNK>": UNK_ID}
    for i, kmer in enumerate(product("ACGT", repeat=K)):
        vocab["".join(kmer)] = NUM_SPECIALS + i
    return vocab


def _seqs_to_byte_matrix(seqs) -> np.ndarray:
    """Pad/truncate each sequence to MAX_SEQ_CHARS and stack into (N, 660) uint8.

    Equivalent to PadSequence(660) (util.py:48-56): truncate if longer, pad
    with 'N' if shorter.
    """
    n = len(seqs)
    out = np.full((n, MAX_SEQ_CHARS), ord("N"), dtype=np.uint8)
    for i, s in enumerate(seqs):
        if isinstance(s, bytes):
            b = s[:MAX_SEQ_CHARS]
        else:
            b = s.encode("ascii", "replace")[:MAX_SEQ_CHARS]
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def tokenize_dna_batch(seqs) -> np.ndarray:
    """Tokenize a batch of barcode strings/bytes -> (N, 133) int32 token ids.

    Vectorized equivalent of the reference sequence_pipeline
    (dna_encoder.py:25-35): [0, *vocab(KmerTokenizer(PadSequence(x)))].
    """
    mat = _seqs_to_byte_matrix(seqs)  # (N, 660) uint8
    codes = _BASE_LUT[mat]  # (N, 660) values 0..4
    codes = codes.reshape(-1, NUM_KMER_TOKENS, K).astype(np.int32)  # (N,132,5)
    invalid = (codes == 4).any(axis=-1)  # (N, 132)
    vals = (codes * _POW4).sum(axis=-1) + NUM_SPECIALS  # (N, 132)
    toks = np.where(invalid, UNK_ID, vals).astype(np.int32)
    out = np.empty((toks.shape[0], SEQ_LEN), dtype=np.int32)
    out[:, 0] = MASK_ID  # literal token 0 prepended (dna_encoder.py:33)
    out[:, 1:] = toks
    return out


def tokenize_dna(seq) -> np.ndarray:
    """Single-sequence convenience wrapper -> (133,) int32."""
    return tokenize_dna_batch([seq])[0]


def build_label_strings(order, family, genus, species) -> list:
    """Per-record taxonomy string "order family genus species".

    (reference: dataset.py:134-137 — language input is the space-joined
    4-level taxonomy; HDF5 stores its pre-tokenized BERT-small encoding.)
    """

    def _s(x):
        return x.decode("utf-8") if isinstance(x, bytes) else str(x)

    return [
        f"{_s(o)} {_s(f)} {_s(g)} {_s(s)}"
        for o, f, g, s in zip(order, family, genus, species)
    ]


def tokenize_labels_bert_small(strings, max_length: int = 20,
                               vocab_path: str = None):
    """Tokenize label strings with the BERT-small tokenizer, matching the
    HDF5 builder (scripts/generate_hdf5_file_5m.py:281-285: padding to
    max_length=20, truncation).

    Source order: an explicit `vocab_path` (or $BSCAN_BERT_VOCAB) runs the
    NATIVE WordPiece implementation (data/wordpiece.py, golden-tested
    against transformers); otherwise the cached HF tokenizer is used.
    Raises if neither is available — callers that tolerate stub tokens must
    opt in explicitly (write_split_hdf5 `allow_stub_tokens`).

    Returns dict of (N, max_length) int32 arrays:
    input_ids / token_type_ids / attention_mask.
    """
    import os

    vocab_path = vocab_path or os.environ.get("BSCAN_BERT_VOCAB")
    if vocab_path:
        from bioscan_clip_tpu_torch.data.wordpiece import WordPieceTokenizer

        return WordPieceTokenizer(vocab_path).encode_batch(
            strings, max_length=max_length
        )

    from transformers import AutoTokenizer

    # Default to the local cache: zero-egress environments would otherwise
    # burn minutes in HF retry backoff. Set BIOSCAN_CLIP_TPU_ALLOW_DOWNLOAD=1
    # to fetch on a connected machine.
    allow_dl = os.environ.get("BIOSCAN_CLIP_TPU_ALLOW_DOWNLOAD") == "1"
    tok = AutoTokenizer.from_pretrained(
        "prajjwal1/bert-small", local_files_only=not allow_dl
    )
    enc = tok(
        list(strings),
        padding="max_length",
        max_length=max_length,
        truncation=True,
        return_tensors="np",
    )
    return {
        "input_ids": enc["input_ids"].astype(np.int32),
        "token_type_ids": enc["token_type_ids"].astype(np.int32),
        "attention_mask": enc["attention_mask"].astype(np.int32),
    }
