"""Method 2 on the card: a seen-species classifier on the image tower,
routed by its confidence against image -> unseen DNA key retrieval.

A copy of bioscan_clip_tpu/cli/method_two_fine_tuning_and_eval.py (the
reference's scripts/method_two_fine_tuning_and_eval.py, reimplemented
working):
1. species -> taxonomy and the species index from the train_seen labels
   (:290-316);
2. a linear head over the seen species on the image tower
   (`models/heads.EncoderWithHead`), every weight fine-tuned with AdamW
   (`train/fine_tuning.py`) on train_seen, 5 epochs by default
   (:459-470);
3. the classifier's top-5 softmax confidences and their 4-level labels on
   the seen and unseen validation queries (:39-84);
4. the fallback retrieval against the unseen DNA keys
   (`retrieval/engine.make_prediction`: K4 on the card), and the routing
   threshold searched for the harmonic mean as in method 1.

    python -m bioscan_clip_tpu_torch.cli.method_two_fine_tuning_and_eval \\
        'model_config=NAME'

`device` (top-level key, default cuda; an error without CUDA);
`tpu.mesh_shape` naming several cards raises. train_seen is an eval
loader: its images may come host-transformed (float) or as uint8 frames,
and the step takes either.
"""

from __future__ import annotations

import sys

import numpy as np

from bioscan_clip_tpu_torch.data.dataset import (
    load_bioscan_dataloader_with_train_seen_and_separate_keys,
)


def load_all_seen_species_name_and_create_label_map(train_seen_loader):
    """(species -> index, index -> 4-level labels) from the seen split
    (method_two_fine_tuning_and_eval.py:290-316)."""
    species_to_other = {}
    for batch in train_seen_loader:
        for d in batch["label_dicts"]:
            if d["species"] not in species_to_other:
                species_to_other[d["species"]] = {
                    "order": d["order"], "family": d["family"],
                    "genus": d["genus"]}
    species_to_idx, idx_to_all = {}, {}
    for idx, sp in enumerate(species_to_other):
        species_to_idx[sp] = idx
        idx_to_all[idx] = {"species": sp, **species_to_other[sp]}
    return species_to_idx, idx_to_all


def classifier_predictions(clf, loader, idx_to_all, openclip_norm=False):
    """(top-5 softmax confidences, their 4-level label predictions, the
    ground-truth label dicts) of the classifier on its device."""
    import torch

    from bioscan_clip_tpu_torch.cli.fine_tune_vitb_on_insect import (
        image_input,
    )
    from bioscan_clip_tpu_torch.data.transforms import eval_transform_auto

    dev = next(clf.parameters()).device
    clf.eval()
    confidences, indices, gt = [], [], []
    with torch.inference_mode():
        for batch in loader:
            x = image_input(batch, dev)
            if x.dtype == torch.uint8:
                x = eval_transform_auto(x, normalize=openclip_norm)
            probs = torch.softmax(clf(x).float(), dim=-1)
            vals, idxs = torch.topk(probs, 5, dim=-1)
            confidences.append(vals.cpu().numpy())
            indices.append(idxs.cpu().numpy())
            gt.extend(batch["label_dicts"])
    confidences = np.concatenate(confidences, axis=0)
    pred_labels = []
    for row in np.concatenate(indices, axis=0):
        pred = {lvl: [] for lvl in ("order", "family", "genus", "species")}
        for idx in row:
            info = idx_to_all[int(idx)]
            for lvl in pred:
                pred[lvl].append(info[lvl])
        pred_labels.append(pred)
    return confidences.tolist(), pred_labels, gt


def run(args, out=print, fine_tune_epochs=None, searched_threshold=None,
        num_intervals=1000, device=None):
    """-> (seen, unseen) result dicts of `retrieval/methods.py`."""
    import copy

    import torch

    from bioscan_clip_tpu_torch.cli.fine_tune_vitb_on_insect import (
        image_input,
    )
    from bioscan_clip_tpu_torch.cli.method_one_eval import load_method_model
    from bioscan_clip_tpu_torch.device import compute_dtype, resolve_device
    from bioscan_clip_tpu_torch.models.clip import init_weights
    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.parallel.mesh import mesh_from_config
    from bioscan_clip_tpu_torch.retrieval.engine import make_prediction
    from bioscan_clip_tpu_torch.retrieval.methods import (
        get_final_pred_and_acc,
        print_acc_for_google_doc,
        search_threshold_with_harmonic_mean,
    )
    from bioscan_clip_tpu_torch.train.fine_tuning import (
        create_fine_tune_state,
        label_batch_to_species_idx,
        make_classifier_train_step,
    )
    from bioscan_clip_tpu_torch.train.loop import (
        data_axis,
        draw_step_seed,
        extract_features,
    )

    dev = resolve_device(device or getattr(args, "device", None) or "cuda")
    mc = args.model_config
    mc.batch_size = 40
    k_list = list(args.inference_and_eval_setting.k_list)
    mesh = data_axis(mesh_from_config(args, dev))

    out("Construct dataloader...")
    (train_seen, seen_val, unseen_val, _, val_unseen_keys,
     test_unseen_keys) = (
        load_bioscan_dataloader_with_train_seen_and_separate_keys(args))

    out("Initialize model...")
    model = load_method_model(args, dev, out=out)
    species_to_idx, idx_to_all = (
        load_all_seen_species_name_and_create_label_map(train_seen))
    unique_species = list(species_to_idx)
    out(f"{len(unique_species)}-way classifier")

    # the classifier trains a copy of the image tower: the fallback branch
    # below embeds with the model's own, as JAX does (its classifier's
    # parameters are a copy of the CLIP parameters)
    clf = EncoderWithHead(copy.deepcopy(model.image_encoder), mc.output_dim,
                          len(unique_species), dtype=compute_dtype(dev))
    init_weights(clf.new_linear_layer.to(dev), seed=1)
    state = create_fine_tune_state(clf)
    step = make_classifier_train_step(clf, mesh, modality="image")

    out("fine-tuning classifier head...")
    epochs = fine_tune_epochs if fine_tune_epochs is not None else 5
    for epoch in range(epochs):
        losses = []
        for batch in train_seen:
            db = {"input": image_input(batch, dev),
                  "target": torch.from_numpy(label_batch_to_species_idx(
                      batch["label_dicts"], unique_species)).to(dev)}
            state, loss = step(state, db, draw_step_seed(state.generator))
            losses.append(loss)
        out(f"epoch {epoch}: loss "
            f"{np.mean([x.item() for x in losses]):.4f}")

    # the classifier-confidence branch
    seen_conf, seen_pred_a, seen_gt = classifier_predictions(
        clf, seen_val, idx_to_all)
    unseen_conf, unseen_pred_a, unseen_gt = classifier_predictions(
        clf, unseen_val, idx_to_all)

    # the DNA-retrieval fallback branch
    vu = extract_features(model, val_unseen_keys)
    tu = extract_features(model, test_unseen_keys)
    unseen_keys_feat = np.concatenate(
        [vu["encoded_dna_feature"], tu["encoded_dna_feature"]], axis=0)
    unseen_keys_labels = vu["label_list"] + tu["label_list"]
    seen_pred_b, unseen_pred_b = (
        make_prediction(extract_features(model, q)["encoded_image_feature"],
                        unseen_keys_feat, unseen_keys_labels, max_k=5,
                        device=dev)
        for q in (seen_val, unseen_val))

    splits = [
        {"pred_labels_from_search_with_seen_keys": a,
         "pred_similarity_from_search_with_seen_keys": conf,
         "pred_labels_from_search_with_unseen_keys": b,
         "gt_label": gt}
        for a, conf, b, gt in ((seen_pred_a, seen_conf, seen_pred_b, seen_gt),
                               (unseen_pred_a, unseen_conf, unseen_pred_b,
                                unseen_gt))]
    if searched_threshold is None:
        searched_threshold = search_threshold_with_harmonic_mean(
            splits, k_list=k_list, num_intervals=num_intervals, out=out)
    seen_out, unseen_out = (
        get_final_pred_and_acc(
            s["pred_labels_from_search_with_seen_keys"],
            s["pred_similarity_from_search_with_seen_keys"],
            s["pred_labels_from_search_with_unseen_keys"], s["gt_label"],
            best_threshold=searched_threshold, k_list=k_list)
        for s in splits)
    print_acc_for_google_doc(seen_out, unseen_out, k_list=k_list, out=out)
    return seen_out, unseen_out


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    args = load_config(
        overrides=list(argv if argv is not None else sys.argv[1:]))
    return run(args)


if __name__ == "__main__":
    main()
