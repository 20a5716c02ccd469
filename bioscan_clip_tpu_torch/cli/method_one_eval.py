"""Method 1 on the card: seen/unseen routing by the similarity of an
image to its nearest seen image key, falling back to image -> unseen DNA
key retrieval.

A copy of bioscan_clip_tpu/cli/method_one_eval.py (the reference's
scripts/method_one_eval.py, reimplemented working):
1. the image features of the seen and unseen validation queries;
2. retrieval against the seen image keys -> predictions and similarities;
3. retrieval against the unseen DNA keys (val + test unseen keys) -> the
   fallback predictions (`retrieval/engine.make_prediction`: K4 on the
   card);
4. the routing threshold searched over `num_intervals` points for the
   harmonic mean of seen/unseen top-1 species micro accuracy
   (`retrieval/methods.py`); the accuracies printed.

    python -m bioscan_clip_tpu_torch.cli.method_one_eval 'model_config=NAME'

`device` (top-level key, default cuda; an error without CUDA). The
checkpoint is `model_config.ckpt_path` (a .pth, or a folder holding
best.pth / last.pth) when it exists.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from bioscan_clip_tpu_torch.data.dataset import (
    load_bioscan_dataloader_with_train_seen_and_separate_keys,
)


def load_method_model(args, dev, out=print):
    """The config's model on `dev` in its compute dtype, with the checkpoint
    at `model_config.ckpt_path` overlaid when it exists."""
    from bioscan_clip_tpu_torch.device import compute_dtype
    from bioscan_clip_tpu_torch.interop.weights import resolve_reference_ckpt
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.train.checkpoint import load_pth_into_params

    model = load_clip_model(args, device=dev, dtype=compute_dtype(dev))
    ckpt = getattr(args.model_config, "ckpt_path", None)
    if ckpt and os.path.isdir(ckpt):
        ckpt = resolve_reference_ckpt(ckpt)
    if ckpt and os.path.isfile(ckpt):
        load_pth_into_params(ckpt, model)
        out(f"Loaded {ckpt}")
    return model


def _query_data(model, query_loader, seen_key_dicts, unseen_key_dicts, dev):
    from bioscan_clip_tpu_torch.retrieval.engine import make_prediction
    from bioscan_clip_tpu_torch.train.loop import extract_features

    q = extract_features(model, query_loader)
    seen_keys_feat = np.concatenate(
        [d["encoded_image_feature"] for d in seen_key_dicts], axis=0)
    seen_keys_labels = sum((d["label_list"] for d in seen_key_dicts), [])
    unseen_keys_feat = np.concatenate(
        [d["encoded_dna_feature"] for d in unseen_key_dicts], axis=0)
    unseen_keys_labels = sum((d["label_list"] for d in unseen_key_dicts), [])

    pred_seen, sim_seen = make_prediction(
        q["encoded_image_feature"], seen_keys_feat, seen_keys_labels,
        with_similarity=True, max_k=5, device=dev)
    pred_unseen = make_prediction(
        q["encoded_image_feature"], unseen_keys_feat, unseen_keys_labels,
        max_k=5, device=dev)
    return {
        "pred_labels_from_search_with_seen_keys": pred_seen,
        "pred_similarity_from_search_with_seen_keys": sim_seen.tolist(),
        "pred_labels_from_search_with_unseen_keys": pred_unseen,
        "gt_label": q["label_list"],
    }


def run(args, out=print, searched_threshold=None, num_intervals=1000,
        device=None):
    """-> (seen, unseen) result dicts of `retrieval/methods.py`."""
    from bioscan_clip_tpu_torch.device import resolve_device
    from bioscan_clip_tpu_torch.retrieval.methods import (
        method_1_eval,
        print_acc_for_google_doc,
    )
    from bioscan_clip_tpu_torch.train.loop import extract_features

    dev = resolve_device(device or getattr(args, "device", None) or "cuda")
    mc = args.model_config
    mc.batch_size = 40  # (method_one_eval.py:295)
    k_list = list(args.inference_and_eval_setting.k_list)

    out("Construct dataloader...")
    (_, seen_val, unseen_val, seen_keys, val_unseen_keys,
     test_unseen_keys) = (
        load_bioscan_dataloader_with_train_seen_and_separate_keys(args))

    out("Initialize model...")
    model = load_method_model(args, dev, out=out)
    seen_keys_dict = extract_features(model, seen_keys)
    unseen_key_dicts = [extract_features(model, val_unseen_keys),
                        extract_features(model, test_unseen_keys)]
    seen_query_data, unseen_query_data = (
        _query_data(model, loader, [seen_keys_dict], unseen_key_dicts, dev)
        for loader in (seen_val, unseen_val))

    out("Searching best threshold.")
    seen_out, unseen_out = method_1_eval(
        seen_query_data, unseen_query_data, k_list=k_list,
        searched_threshold=searched_threshold, num_intervals=num_intervals,
        out=out)
    print_acc_for_google_doc(seen_out, unseen_out, k_list=k_list, out=out)
    return seen_out, unseen_out


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    args = load_config(
        overrides=list(argv if argv is not None else sys.argv[1:]))
    return run(args)


if __name__ == "__main__":
    main()
