"""Build a BIOSCAN split HDF5 from a metadata table + image directory.

A copy of bioscan_clip_tpu/cli/generate_hdf5.py (`build_hdf5`, `main`
:43-148; the reference's scripts/generate_hdf5_file_5m.py). The metadata
`split` column is mapped to meta-split groups (:224-233):
    all_keys               <- key_unseen + train
    val_seen               <- val
    test_seen              <- test
    seen_keys              <- train
    test_unseen            <- test_unseen
    val_unseen             <- val_unseen
    unseen_keys            <- key_unseen
    no_split_and_seen_train<- pretrain + train
    other_heldout          <- other_heldout
Images are the JPEG files' bytes, read in a thread pool and padded to the
longest (:21, :103-144), NaN taxa -> 'not_classified' (:48-61), label
strings tokenized with BERT-small at max_length 20 (:281-285; `--vocab`
or $BSCAN_BERT_VOCAB for the native WordPiece, else the cached HF
tokenizer, else it raises: the JAX CLI's `--allow-stub-tokens` is not
copied). A psutil RAM watchdog aborts above 90% (:126-138). pandas and
psutil are imported inside the functions that need them.

    python -m bioscan_clip_tpu_torch.cli.generate_hdf5 --metadata META.tsv \
        --image-dir DIR --output OUT.hdf5 [--flavor bioscan_1m|bioscan_5m]
        [--threads 16] [--vocab vocab.txt]
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MAP_DICT_5M = {
    "all_keys": ["key_unseen", "train"],
    "val_seen": ["val"],
    "test_seen": ["test"],
    "seen_keys": ["train"],
    "test_unseen": ["test_unseen"],
    "val_unseen": ["val_unseen"],
    "unseen_keys": ["key_unseen"],
    "no_split_and_seen_train": ["pretrain", "train"],
    "other_heldout": ["other_heldout"],
}


def replace_nan_with_not_classified(x):
    if x is None or (isinstance(x, float) and np.isnan(x)) or str(x) == "nan":
        return "not_classified"
    return str(x)


def _check_memory():
    try:
        import psutil
    except ImportError:
        return
    if psutil.virtual_memory().percent > 90:
        raise MemoryError("RAM above 90%; aborting HDF5 build")


def read_image_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def build_hdf5(
    metadata,
    image_dir: str,
    output_path: str,
    map_dict=None,
    image_path_fn=None,
    id_column: str = "processid",
    barcode_column: str = "dna_barcode",
    flavor: str = "bioscan_5m",
    threads: int = 16,
    out=print,
    vocab_path=None,
):
    """Assemble the split HDF5 from a pandas table. `image_path_fn(row) ->
    path` lets callers adapt directory layouts (5M uses chunked dirs)."""
    from bioscan_clip_tpu_torch.data.hdf5 import write_split_hdf5

    map_dict = map_dict or MAP_DICT_5M
    if image_path_fn is None:
        def image_path_fn(row):
            return os.path.join(image_dir, str(row["image_file"]))

    splits = {}
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        for meta_split, sub_splits in map_dict.items():
            df = metadata[metadata["split"].isin(sub_splits)]
            if not len(df):
                out(f"{meta_split}: empty, skipping")
                continue
            _check_memory()
            paths = [image_path_fn(row) for _, row in df.iterrows()]
            rec = {
                "images": list(pool.map(read_image_bytes, paths)),
                "barcode": [str(b) for b in df[barcode_column]],
                "sampleid": [str(s) for s in df.get("sampleid",
                                                    df[id_column])],
            }
            for lvl in ("order", "family", "genus", "species"):
                rec[lvl] = [
                    replace_nan_with_not_classified(v) for v in df[lvl]
                ]
            if flavor == "bioscan_5m":
                rec["processid"] = [str(p) for p in df[id_column]]
            else:
                rec["image_file"] = [str(p) for p in df["image_file"]]
            splits[meta_split] = rec
            out(
                f"{meta_split}: {len(df)} records "
                f"({time.time() - t0:.1f}s elapsed)"
            )

    write_split_hdf5(output_path, splits, dataset_flavor=flavor,
                     vocab_path=vocab_path)
    out(f"wrote {output_path} in {time.time() - t0:.1f}s")


def main(argv=None):
    import pandas as pd

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--metadata", required=True, help="CSV/TSV with split, "
                   "taxonomy, dna_barcode, image_file columns")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--flavor", choices=["bioscan_1m", "bioscan_5m"],
                   default="bioscan_5m")
    p.add_argument("--threads", type=int, default=16)
    p.add_argument("--vocab", default=None, help="vocab.txt for the native "
                   "WordPiece label tokenizer (no HF cache needed)")
    a = p.parse_args(argv)
    sep = "\t" if a.metadata.endswith(".tsv") else ","
    md = pd.read_csv(a.metadata, sep=sep)
    build_hdf5(md, a.image_dir, a.output, flavor=a.flavor,
               threads=a.threads, vocab_path=a.vocab)


if __name__ == "__main__":
    main()
