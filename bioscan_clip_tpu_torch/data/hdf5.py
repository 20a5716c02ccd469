"""HDF5 split-file reader and writer for the BIOSCAN-1M/5M export schema.

A copy of bioscan_clip_tpu/data/hdf5.py: the reader (`get_len_dict`,
`hdf5_path_for`, `SplitReader` :31-126) and the writer (`write_split_hdf5`
:129-228), which the dataset builder (`cli/generate_hdf5.py`) and the
test fixtures use. Schema: per-split groups
(`all_keys`, `val_seen`, `val_unseen`, `test_seen`, `test_unseen`,
`seen_keys`, `unseen_keys`/`val_unseen_keys`/`test_unseen_keys`, ...) each
holding `image` (padded JPEG byte rows) + `image_mask` (byte lengths),
`barcode`, `order/family/genus/species`, `sampleid`, `processid` (5M) /
`image_file` (1M), and pre-tokenized `language_tokens_{input_ids,
token_type_ids,attention_mask}`. `h5py` is imported when a file is opened.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bioscan_clip_tpu_torch.data.tokenizers import (
    build_label_strings,
    tokenize_dna_batch,
    tokenize_labels_bert_small,
)

LEVELS = ["order", "family", "genus", "species"]


def get_len_dict(args) -> dict:
    """Split name -> record count (reference dataset.py:278-288)."""
    import h5py

    out = {}
    with h5py.File(hdf5_path_for(args), "r") as f:
        for split in f.keys():
            out[split] = len(f[split]["image"])
    return out


def hdf5_path_for(args) -> str:
    mc = args.model_config
    if getattr(mc, "dataset", None) == "bioscan_5m":
        return args.bioscan_5m_data.path_to_hdf5_data
    return args.bioscan_data.path_to_hdf5_data


class SplitReader:
    """Reader over one split group with batch (sorted-index) fancy reads:
    h5py needs increasing indices, so each read sorts, dedups and inverts
    the permutation, which also makes the disk access sequential."""

    def __init__(self, path: str, split: str):
        self.path = path
        self.split = split
        self._file = None

    @property
    def group(self):
        if self._file is None:  # opened lazily, once per reader
            import h5py

            self._file = h5py.File(self.path, "r", libver="latest")
        return self._file[self.split]

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __len__(self):
        return len(self.group["image"])

    def _take(self, name, idx):
        ds = self.group[name]
        idx = np.asarray(idx)
        order = np.argsort(idx, kind="stable")
        uniq, inv = np.unique(idx[order], return_inverse=True)
        out = ds[uniq][inv]
        unsort = np.empty_like(order)
        unsort[order] = np.arange(len(order))
        return out[unsort]

    def read_images_bytes(self, idx) -> list:
        """Raw JPEG byte strings of the given rows."""
        enc = self._take("image", idx)
        mask = self._take("image_mask", idx)
        return [bytes(e[:m].tobytes()) for e, m in zip(enc, mask)]

    def read_barcodes(self, idx) -> list:
        return list(self._take("barcode", idx))

    def read_dna_tokens(self, idx) -> np.ndarray:
        return tokenize_dna_batch(self.read_barcodes(idx))

    def read_language_tokens(self, idx) -> dict:
        return {
            k: self._take(f"language_tokens_{k}", idx).astype(np.int32)
            for k in ("input_ids", "token_type_ids", "attention_mask")
        }

    def read_label_dicts(self, idx=None) -> list:
        g = self.group
        if idx is None:
            cols = {lvl: g[lvl][:] for lvl in LEVELS}
        else:
            cols = {lvl: self._take(lvl, idx) for lvl in LEVELS}

        def dec(x):
            return x.decode("utf-8") if isinstance(x, bytes) else str(x)

        n = len(next(iter(cols.values())))
        return [
            {lvl: dec(cols[lvl][i]) for lvl in LEVELS} for i in range(n)
        ]

    def read_ids(self, idx) -> list:
        name = "processid" if "processid" in self.group else "image_file"
        return [
            x.decode("utf-8") if isinstance(x, bytes) else str(x)
            for x in self._take(name, idx)
        ]


def write_split_hdf5(
    path: str,
    splits: dict,
    max_image_bytes: Optional[int] = None,
    tokenize_language: bool = True,
    dataset_flavor: str = "bioscan_1m",
    vocab_path: Optional[str] = None,
):
    """Write a schema-compatible split HDF5 (generate_hdf5_file_5m.py).

    splits: {split_name: {"images": [jpeg bytes...], "barcode": [str...],
             "order"/"family"/"genus"/"species": [str...],
             optional "sampleid"/"processid"/"image_file": [str...],
             optional "language_tokens": dict}}.

    Each split's JPEGs are zero-padded to `max_image_bytes` (default: the
    longest) with their lengths in `image_mask`. Without "language_tokens"
    the label strings are tokenized with BERT-small at max_length 20
    (`vocab_path` / $BSCAN_BERT_VOCAB for the native WordPiece, else the
    cached HF tokenizer); without either this raises. The JAX writer's
    `allow_stub_tokens` (ids from Python's per-process salted `hash()`) is
    not copied.
    """
    import h5py

    with h5py.File(path, "w") as f:
        for split, rec in splits.items():
            g = f.create_group(split)
            imgs = rec["images"]
            n = len(imgs)
            maxlen = max_image_bytes or max((len(b) for b in imgs), default=1)
            arr = np.zeros((n, maxlen), dtype=np.uint8)
            mask = np.zeros((n,), dtype=np.int64)
            for i, b in enumerate(imgs):
                bb = np.frombuffer(b, dtype=np.uint8)
                arr[i, : len(bb)] = bb
                mask[i] = len(bb)
            g.create_dataset("image", data=arr)
            g.create_dataset("image_mask", data=mask)

            str_dt = h5py.string_dtype()

            def strings(name, values):
                g.create_dataset(name, data=np.array(values, dtype=object),
                                 dtype=str_dt)

            strings("barcode", rec["barcode"])
            for lvl in LEVELS:
                strings(lvl, rec[lvl])
            strings("sampleid",
                    rec.get("sampleid", [f"sample_{i}" for i in range(n)]))
            if dataset_flavor == "bioscan_5m":
                strings("processid",
                        rec.get("processid", [f"proc_{i}" for i in range(n)]))
            else:
                strings("image_file", rec.get(
                    "image_file", [f"img_{i}.jpg" for i in range(n)]))

            lt = rec.get("language_tokens")
            if lt is None and tokenize_language:
                try:
                    lt = tokenize_labels_bert_small(
                        build_label_strings(rec["order"], rec["family"],
                                            rec["genus"], rec["species"]),
                        vocab_path=vocab_path)
                except (ImportError, OSError) as e:
                    raise RuntimeError(
                        "write_split_hdf5: no BERT-small tokenizer for the "
                        "label strings: pass vocab_path or set "
                        "BSCAN_BERT_VOCAB to a vocab.txt, or cache "
                        "prajjwal1/bert-small for transformers") from e
            if lt is not None:
                for k, v in lt.items():
                    g.create_dataset(f"language_tokens_{k}", data=v)
