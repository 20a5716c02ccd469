"""INSECT raw-data preprocessing: res101/att_splits .mat + image folder ->
INSECT_metadata.csv + per-image INSECT_images.hdf5.

A copy of bioscan_clip_tpu/cli/process_insect_dataset.py (the reference's
data/INSECT/process_insect_dataset.py:11-103). The HDF5 holds one uint8
dataset of JPEG bytes per image id under the group "images", which
`data/insect.InsectLoader` reads. scipy, pandas and h5py are imported
inside the functions that need them (the card's machine lacks the last
two).

    python -m bioscan_clip_tpu_torch.cli.process_insect_dataset
        [--res101 res101.mat] [--att-splits att_splits.mat]
        [--image-root INSECT_images] [--out-csv INSECT_metadata.csv]
        [--out-hdf5 INSECT_images.hdf5] [--skip-images]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SPLITS = ("trainval_loc", "train_loc", "val_loc", "test_seen_loc",
          "test_unseen_loc")


def _mat_str_col(arr):
    return np.array([str(x[0][0]) if hasattr(x[0], "__len__")
                     else str(x.item()) for x in arr])


def save_metadata_csv(res101_path, att_splits_path, out_csv):
    """One row per image: bold_ids, ids, 0-based labels, species,
    nucleotides, and a boolean column per split (the .mat's 1-based
    locations)."""
    import pandas as pd
    import scipy.io as sio

    mat = sio.loadmat(res101_path)
    df = pd.DataFrame({
        "bold_ids": _mat_str_col(mat["bold_ids"]),
        "ids": _mat_str_col(mat["ids"]),
        "labels": mat["labels"].ravel() - 1,
        "species": _mat_str_col(mat["species"]),
        "nucleotides": _mat_str_col(mat["nucleotides"]),
    })
    splits = sio.loadmat(att_splits_path)
    n = len(df)
    for split_name in SPLITS:
        loc = set((splits[split_name].ravel() - 1).tolist())
        df[split_name] = [i in loc for i in range(n)]
    df.to_csv(out_csv, index=False)
    return df


def save_images_hdf5(image_root, species, file_names, out_hdf5):
    """Per-image byte datasets under group 'images', keyed by file name
    (process_insect_dataset.py:11-29): images/<species>/<id>.jpg, else
    .JPG."""
    import h5py

    with h5py.File(out_hdf5, "w") as hf:
        g = hf.create_group("images")
        for sp, fn in zip(species, file_names):
            path = os.path.join(image_root, "images", sp, fn + ".jpg")
            if not os.path.exists(path):
                path = os.path.join(image_root, "images", sp, fn + ".JPG")
            with open(path, "rb") as f:
                g.create_dataset(
                    fn, data=np.frombuffer(f.read(), dtype=np.uint8)
                )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--res101", default="res101.mat")
    p.add_argument("--att-splits", default="att_splits.mat")
    p.add_argument("--image-root", default="INSECT_images")
    p.add_argument("--out-csv", default="INSECT_metadata.csv")
    p.add_argument("--out-hdf5", default="INSECT_images.hdf5")
    p.add_argument("--skip-images", action="store_true")
    a = p.parse_args(argv)
    df = save_metadata_csv(a.res101, a.att_splits, a.out_csv)
    print(f"wrote {a.out_csv} ({len(df)} rows)")
    if not a.skip_images:
        save_images_hdf5(
            a.image_root, df["species"].tolist(), df["ids"].tolist(),
            a.out_hdf5,
        )
        print(f"wrote {a.out_hdf5}")


if __name__ == "__main__":
    main()
