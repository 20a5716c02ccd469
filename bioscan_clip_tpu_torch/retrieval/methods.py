"""Method-1/2 seen-unseen routing evaluation.

A copy of bioscan_clip_tpu/retrieval/methods.py (numpy only; the
reference's scripts/method_one_eval.py, whose imports are broken):
- route each of the top-k slots: if the seen-keys similarity (method 1) or
  the classifier confidence (method 2) exceeds a threshold, keep the
  seen-keys prediction, else fall back to the unseen-DNA-keys retrieval
  prediction (method_one_eval.py:59-84);
- the threshold is grid-searched over `num_intervals` points in [0, 1]
  for the harmonic mean of seen/unseen top-1 species micro accuracy
  (:131-157).
"""

from __future__ import annotations

import numpy as np

from bioscan_clip_tpu_torch.retrieval.metrics import (
    LEVELS,
    top_k_macro_accuracy,
    top_k_micro_accuracy,
)


def harmonic_mean_list(values) -> float:
    s = 0.0
    for v in values:
        if v == 0:
            return 0.0
        s += 1.0 / v
    return len(values) / s


def decide_prediction_with_threshold(
    pred_labels_primary, confidence, pred_labels_fallback, threshold
):
    """Per top-k slot: primary prediction if its confidence > threshold else
    fallback (method_one_eval.py:59-84)."""
    final = []
    for rec_idx in range(len(pred_labels_primary)):
        primary = pred_labels_primary[rec_idx]
        fallback = pred_labels_fallback[rec_idx]
        conf = confidence[rec_idx]
        out = {level: [] for level in LEVELS}
        for kth in range(len(conf)):
            src = primary if conf[kth] > threshold else fallback
            for level in LEVELS:
                out[level].append(src[level][kth])
        final.append(out)
    return final


def get_final_pred_and_acc(
    pred_labels_primary, confidence, pred_labels_fallback, gt_labels,
    best_threshold, k_list=None,
):
    k_list = k_list or [1, 3, 5]
    final = decide_prediction_with_threshold(
        pred_labels_primary, confidence, pred_labels_fallback, best_threshold
    )
    micro = top_k_micro_accuracy(final, gt_labels, k_list=k_list)
    macro, per_class = top_k_macro_accuracy(final, gt_labels, k_list=k_list)
    return {
        "final_pred_labels": final,
        "gt_labels": gt_labels,
        "best_threshold": best_threshold,
        "micro_acc": micro,
        "macro_acc": macro,
        "per_class_acc": per_class,
    }


def search_threshold_with_harmonic_mean(
    all_split_data, k_list=None, num_intervals: int = 1000, out=print
):
    """Grid search over thresholds maximizing the harmonic mean of per-split
    top-1 species micro accuracy (method_one_eval.py:131-157)."""
    k_list = k_list or [1, 3, 5]
    thresholds = np.linspace(0, 1, num_intervals)
    best_threshold, max_score = None, float("-inf")
    for threshold in thresholds:
        accs = []
        for split in all_split_data:
            final = decide_prediction_with_threshold(
                split["pred_labels_from_search_with_seen_keys"],
                split["pred_similarity_from_search_with_seen_keys"],
                split["pred_labels_from_search_with_unseen_keys"],
                threshold,
            )
            micro = top_k_micro_accuracy(
                final, split["gt_label"], k_list=k_list
            )
            accs.append(micro[1]["species"])
        hm = harmonic_mean_list(accs)
        if hm > max_score:
            max_score, best_threshold = hm, threshold
    out(
        f"best threshold {best_threshold:.4f} "
        f"(harmonic-mean top-1 species micro acc {max_score:.4f})"
    )
    return best_threshold


def method_1_eval(
    seen_query_data: dict, unseen_query_data: dict, k_list=None,
    searched_threshold=None, num_intervals: int = 1000, out=print,
):
    """Full method-1 routing eval from precomputed prediction dicts
    (method_one_eval.py:170-239). Each *_query_data dict carries
    pred_labels_from_search_with_seen_keys,
    pred_similarity_from_search_with_seen_keys,
    pred_labels_from_search_with_unseen_keys, gt_label."""
    k_list = k_list or [1, 3, 5]
    if searched_threshold is None:
        searched_threshold = search_threshold_with_harmonic_mean(
            [seen_query_data, unseen_query_data], k_list=k_list,
            num_intervals=num_intervals, out=out,
        )
    outs = []
    for split in (seen_query_data, unseen_query_data):
        outs.append(
            get_final_pred_and_acc(
                split["pred_labels_from_search_with_seen_keys"],
                split["pred_similarity_from_search_with_seen_keys"],
                split["pred_labels_from_search_with_unseen_keys"],
                split["gt_label"],
                best_threshold=searched_threshold,
                k_list=k_list,
            )
        )
    return outs[0], outs[1]


def print_acc_for_google_doc(seen_output_dict, unseen_output_dict,
                             k_list=None, out=print):
    """Paste-ready rows incl. per-level harmonic means
    (method_one_eval.py:242-262)."""
    k_list = k_list or [1, 3, 5]
    acc = {"seen": seen_output_dict, "unseen": unseen_output_dict}
    for type_of_acc in ["micro_acc", "macro_acc"]:
        for k in k_list:
            row = ""
            hm_acc = {level: [] for level in LEVELS}
            for split in ["seen", "unseen"]:
                for level in LEVELS:
                    v = acc[split][type_of_acc][k][level]
                    row += " " + str(round(v, 4))
                    hm_acc[level].append(v)
            for level in LEVELS:
                row += " " + str(round(harmonic_mean_list(hm_acc[level]), 4))
            out(row)


def check_for_acc_about_correct_predict_seen_or_unseen(
    final_pred_list, species_list, out=print
):
    """Fraction of queries whose top-k species contain any seen-set species
    (inference_and_eval.py:718-731)."""
    species_set = set(species_list)
    for k in [1, 3, 5]:
        correct = sum(
            1
            for record in final_pred_list
            if any(p in species_set for p in record["species"][:k])
        )
        out(f"for k = {k}: {correct / len(final_pred_list)}")
