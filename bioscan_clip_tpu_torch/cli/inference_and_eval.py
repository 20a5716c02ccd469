"""Retrieval evaluation CLI on the card: the reference's
scripts/inference_and_eval.py.

A copy of bioscan_clip_tpu/cli/inference_and_eval.py on the port. Flow
(inference_and_eval.py:786-894): resolve the best/last checkpoint, load the
feature cache (extracted_feature_from_{split}_split.hdf5 + labels json) when
`load_inference=true` finds one, else build the 9 split loaders, extract the
three towers' features of all_keys, seen and unseen and save the cache, then
run the 5 x 6 query x key sweep and write logs/accuracy.json, results.csv,
raw.csv and config.json.

    python -m bioscan_clip_tpu_torch.cli.inference_and_eval \\
        'model_config=NAME' 'inference_and_eval_setting.eval_on=val'

`tpu.mesh_shape` shards each key set of the sweep over this host's cards
(`parallel/mesh.py`, JAX inference_and_eval.py:112).
`device` (top-level key, default cuda; an error without CUDA) picks where
the towers and the searches run; `device=cpu` runs the kernels' plain
versions. `inference_and_eval_setting.retrieval_precision=int8` searches
int8 resident keys (kernel K5) with an fp32 rescore; `default` searches the
fp32 keys in K4's single bf16 pass.
"""

from __future__ import annotations

import json
import os
import sys

FEATURE_TYPES = [
    "encoded_image_feature",
    "encoded_dna_feature",
    "encoded_language_feature",
    "averaged_feature",
    "concatenated_feature",
    "all_key_features",
]


def save_feature_cache(path, labels_path, seen, unseen, keys):
    from bioscan_clip_tpu_torch.data import h5file

    with h5file.File(path, "w") as f:
        for name, split in (("seen", seen), ("unseen", unseen), ("key", keys)):
            g = f.create_group(name)
            for ft in FEATURE_TYPES:
                if split.get(ft) is not None:
                    g.create_dataset(ft, data=split[ft])
    with open(labels_path, "w") as fp:
        json.dump(
            {
                "seen_gt_dict": seen["label_list"],
                "unseen_gt_dict": unseen["label_list"],
                "key_gt_dict": keys["label_list"],
            },
            fp,
            indent=4,
        )


def load_feature_cache(path, labels_path):
    from bioscan_clip_tpu_torch.data import h5file

    seen, unseen, keys = {}, {}, {}
    with h5file.File(path, "r") as f:
        for name, split in (("seen", seen), ("unseen", unseen), ("key", keys)):
            for ft in FEATURE_TYPES:
                if ft in f[name]:
                    split[ft] = f[name][ft][:]
    with open(labels_path) as fp:
        total = json.load(fp)
    seen["label_list"] = total["seen_gt_dict"]
    unseen["label_list"] = total["unseen_gt_dict"]
    keys["label_list"] = total["key_gt_dict"]
    keys["all_key_features_label"] = total["key_gt_dict"] * 3
    return seen, unseen, keys


def load_eval_model(args, device, out=print):
    """The config's model on `device` in its compute dtype, with the
    checkpoint at model_config.ckpt_path (a .pth, or a folder holding
    best.pth / last.pth) when load_ckpt is on, LoRA merged when
    tpu.merge_lora is on."""
    from bioscan_clip_tpu_torch.device import compute_dtype
    from bioscan_clip_tpu_torch.interop.weights import (
        load_into,
        load_reference_pth,
        resolve_reference_ckpt,
    )
    from bioscan_clip_tpu_torch.models.clip import (
        load_clip_model,
        maybe_merge_lora,
    )

    mc = args.model_config
    ckpt_path = getattr(mc, "ckpt_path", None)
    if ckpt_path and os.path.isdir(ckpt_path):
        resolved = resolve_reference_ckpt(ckpt_path)
        if resolved:
            mc.ckpt_path = ckpt_path = resolved
    dtype = compute_dtype(device)
    model = load_clip_model(args, device=device, dtype=dtype)
    if getattr(mc, "load_ckpt", True) and ckpt_path and os.path.isfile(
            ckpt_path):
        load_into(model, load_reference_pth(ckpt_path))
        out(f"Loaded {ckpt_path}")
    return maybe_merge_lora(args, model, device=device, dtype=dtype)


def run(args, out=print):
    from bioscan_clip_tpu_torch.data.dataset import (
        load_bioscan_dataloader_all_small_splits,
    )
    from bioscan_clip_tpu_torch.device import resolve_device
    from bioscan_clip_tpu_torch.parallel.mesh import mesh_from_config
    from bioscan_clip_tpu_torch.retrieval.report import (
        inference_and_print_result,
    )
    from bioscan_clip_tpu_torch.train.loop import extract_features

    args.save_inference = True
    mc = args.model_config
    device = resolve_device(getattr(args, "device", None) or "cuda")

    eval_on = args.inference_and_eval_setting.eval_on
    folder = os.path.join(
        args.project_root_path, "extracted_embedding", mc.dataset,
        mc.model_output_name,
    )
    os.makedirs(folder, exist_ok=True)
    feats_path = os.path.join(
        folder, f"extracted_feature_from_{eval_on}_split.hdf5"
    )
    labels_path = os.path.join(folder, f"labels_{eval_on}.json")

    if (
        os.path.exists(feats_path)
        and os.path.exists(labels_path)
        and getattr(args, "load_inference", False)
    ):
        out("Loading embeddings from file...")
        seen_dict, unseen_dict, keys_dict = load_feature_cache(
            feats_path, labels_path
        )
    else:
        out(f"Initialize model on {device}...")
        model = load_eval_model(args, device, out=out)
        mc.batch_size = 24  # (inference_and_eval.py:846)
        (_, seen_val, unseen_val, seen_test, unseen_test, *_rest,
         all_keys) = load_bioscan_dataloader_all_small_splits(args)
        if eval_on == "val":
            seen_loader, unseen_loader = seen_val, unseen_val
        elif eval_on == "test":
            seen_loader, unseen_loader = seen_test, unseen_test
        else:
            raise ValueError(
                "Invalid value for eval_on; use "
                "'inference_and_eval_setting.eval_on=val' or '=test'"
            )
        keys_dict = extract_features(model, all_keys, for_key_set=True)
        seen_dict = extract_features(model, seen_loader)
        unseen_dict = extract_features(model, unseen_loader)
        save_feature_cache(
            feats_path, labels_path, seen_dict, unseen_dict, keys_dict
        )
        out(f"Saved feature cache to {feats_path}")

    return inference_and_print_result(
        keys_dict, seen_dict, unseen_dict, args=args,
        k_list=list(args.inference_and_eval_setting.k_list), device=device,
        mesh=mesh_from_config(args, device), out=out,
    )


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    argv = argv if argv is not None else sys.argv[1:]
    args = load_config(overrides=list(argv))
    return run(args)


if __name__ == "__main__":
    main()
