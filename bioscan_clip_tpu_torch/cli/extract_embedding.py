"""Per-split embedding export CLI on the card: the reference's
scripts/extract_embedding.py.

A copy of bioscan_clip_tpu/cli/extract_embedding.py on the port: writes
`extracted_features_of_{split}.hdf5` for each of the 9 splits with the 4
taxonomy label lists, the ids, and the three per-modality feature datasets
(extract_embedding.py:145-183). The files are the key databases that
`cli/serve.py` loads (`serve.keys`).

    python -m bioscan_clip_tpu_torch.cli.extract_embedding 'model_config=NAME'

`device` (top-level key, default cuda) as in `cli/inference_and_eval.py`.
"""

from __future__ import annotations

import os
import sys

import numpy as np

SPLIT_NAMES = [
    "train_seen", "val_seen", "val_unseen", "test_seen", "test_unseen",
    "seen_keys", "val_unseen_keys", "test_unseen_keys", "all_keys",
]


def write_split_features(path, split_dict):
    from bioscan_clip_tpu_torch.data import h5file

    str_dt = h5file.STRING
    with h5file.File(path, "w") as f:
        labels = split_dict["label_list"]
        for lvl in ("order", "family", "genus", "species"):
            f.create_dataset(
                lvl,
                data=np.array([lab[lvl] for lab in labels], dtype=object),
                dtype=str_dt,
            )
        if split_dict.get("file_name_list"):
            f.create_dataset(
                "file_name_list",
                data=np.array(split_dict["file_name_list"], dtype=object),
                dtype=str_dt,
            )
        for ft in (
            "encoded_image_feature",
            "encoded_dna_feature",
            "encoded_language_feature",
        ):
            if split_dict.get(ft) is not None:
                f.create_dataset(ft, data=split_dict[ft])


def run(args, out=print):
    from bioscan_clip_tpu_torch.cli.inference_and_eval import load_eval_model
    from bioscan_clip_tpu_torch.data.dataset import (
        load_bioscan_dataloader_all_small_splits,
    )
    from bioscan_clip_tpu_torch.device import resolve_device
    from bioscan_clip_tpu_torch.train.loop import extract_features

    mc = args.model_config
    device = resolve_device(getattr(args, "device", None) or "cuda")
    model = load_eval_model(args, device, out=out)
    mc.batch_size = 24
    loaders = load_bioscan_dataloader_all_small_splits(args)
    folder = os.path.join(
        args.project_root_path, "extracted_embedding", mc.dataset,
        mc.model_output_name,
    )
    os.makedirs(folder, exist_ok=True)
    for name, loader in zip(SPLIT_NAMES, loaders):
        split_dict = extract_features(model, loader)
        path = os.path.join(folder, f"extracted_features_of_{name}.hdf5")
        write_split_features(path, split_dict)
        out(f"Wrote {path}")


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    args = load_config(
        overrides=list(argv if argv is not None else sys.argv[1:])
    )
    return run(args)


if __name__ == "__main__":
    main()
