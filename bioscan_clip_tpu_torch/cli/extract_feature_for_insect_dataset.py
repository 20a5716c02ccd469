"""INSECT embedding extraction into the two BZSL CSVs, on the card.

A copy of bioscan_clip_tpu/cli/extract_feature_for_insect_dataset.py (the
reference's scripts/extract_feature_for_insect_dataset.py) on the port:
every INSECT record at batch 200 (:21) through the model's towers
(`train/loop.extract_features`), then the class-averaged DNA and
per-sample image CSVs under <project_root_path>/extracted_embedding/INSECT
(`retrieval/bzsl.export_bzsl_csvs`), the input of `cli/bzsl_eval.py`.

    python -m bioscan_clip_tpu_torch.cli.extract_feature_for_insect_dataset \\
        'model_config=NAME'

`device` (top-level key, default cuda; an error without CUDA). The
checkpoint is <model_config.ckpt_trained_with_insect_image_dna_text_path>/
best.pth when it exists; `tpu.merge_lora` folds the adapters first.
"""

from __future__ import annotations

import os
import sys

from bioscan_clip_tpu_torch.data.insect import load_insect_dataloader


def run(args, out=print, device=None):
    """-> the (DNA, image) CSV paths."""
    from bioscan_clip_tpu_torch.device import compute_dtype, resolve_device
    from bioscan_clip_tpu_torch.models.clip import (
        load_clip_model,
        maybe_merge_lora,
    )
    from bioscan_clip_tpu_torch.retrieval.bzsl import (
        export_bzsl_csvs,
        res101_class_labels,
    )
    from bioscan_clip_tpu_torch.train.checkpoint import load_pth_into_params
    from bioscan_clip_tpu_torch.train.loop import extract_features

    dev = resolve_device(device or getattr(args, "device", None) or "cuda")
    mc = args.model_config
    mc.batch_size = 200  # (extract_feature_for_insect_dataset.py:21)
    dtype = compute_dtype(dev)

    out("Construct dataloader...")
    all_loader = load_insect_dataloader(args, load_all_in_one=True)

    out("Initialize model...")
    model = load_clip_model(args, device=dev, dtype=dtype)
    folder = getattr(mc, "ckpt_trained_with_insect_image_dna_text_path",
                     None)
    ckpt = os.path.join(folder, "best.pth") if folder else None
    if ckpt and os.path.isfile(ckpt):
        load_pth_into_params(ckpt, model)
        out(f"Loaded {ckpt}")
    model = maybe_merge_lora(args, model, device=dev, dtype=dtype)

    feats = extract_features(model, all_loader)
    labels = res101_class_labels(args.insect_data.path_to_res_101_mat)
    return export_bzsl_csvs(
        os.path.join(args.project_root_path, "extracted_embedding/INSECT"),
        feats["encoded_dna_feature"], feats["encoded_image_feature"],
        labels, out=out)


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    args = load_config(
        overrides=list(argv if argv is not None else sys.argv[1:]))
    return run(args)


if __name__ == "__main__":
    main()
