"""Retrieval-as-classification metrics: micro/macro top-k.

A copy of bioscan_clip_tpu/retrieval/metrics.py (the port imports nothing
of the JAX package); the numbers are the JAX module's on the same inputs.

Semantics (scripts/inference_and_eval.py:448-511):
- micro: fraction of queries whose ground-truth label at a level appears in
  the top-k predicted labels at that level;
- macro: per-ground-truth-class hit rate, averaged over classes present in
  the query set; also returns the per-class dict;
- harmonic mean over seen/unseen is the model-selection metric of the
  method scripts (method_one_eval.py:121-128).

The inner loops are vectorized with numpy over label-id encodings (the
reference's nested python loops are O(N·k·levels) string comparisons) but
produce byte-identical numbers on the same inputs.
"""

from __future__ import annotations

import numpy as np

LEVELS = ["order", "family", "genus", "species"]


def _encode(pred_list, gt_list, level):
    """Map string labels at `level` to int ids; returns (gt_ids (N,),
    pred_ids (N, max_k))."""
    vocab = {}

    def to_id(s):
        if s not in vocab:
            vocab[s] = len(vocab)
        return vocab[s]

    gt_ids = np.array([to_id(gt[level]) for gt in gt_list], dtype=np.int64)
    max_k = len(pred_list[0][level])
    pred_ids = np.array(
        [[to_id(p) for p in pred[level][:max_k]] for pred in pred_list],
        dtype=np.int64,
    )
    return gt_ids, pred_ids


def top_k_micro_accuracy(pred_list, gt_list, k_list=None):
    k_list = k_list or [1, 3, 5]
    out = {}
    encoded = {lvl: _encode(pred_list, gt_list, lvl) for lvl in LEVELS}
    for k in k_list:
        out[k] = {}
        for level in LEVELS:
            gt_ids, pred_ids = encoded[level]
            hits = (pred_ids[:, :k] == gt_ids[:, None]).any(axis=1)
            out[k][level] = float(hits.mean())
    return out


def top_k_macro_accuracy(pred_list, gt_list, k_list=None):
    k_list = k_list or [1, 3, 5]
    macro_acc, per_class = {}, {}
    for k in k_list:
        macro_acc[k] = {}
        per_class[k] = {}
        for level in LEVELS:
            gt_ids, pred_ids = _encode(pred_list, gt_list, level)
            hits = (pred_ids[:, :k] == gt_ids[:, None]).any(axis=1)
            per_class[k][level] = {}
            accs = []
            # iterate classes in first-appearance order (reference dict order)
            seen_order = []
            seen_set = set()
            for i, g in enumerate(gt_ids):
                if g not in seen_set:
                    seen_set.add(g)
                    seen_order.append((g, gt_list[i][level]))
            for cid, cname in seen_order:
                m = gt_ids == cid
                acc = float(hits[m].mean())
                per_class[k][level][cname] = acc
                accs.append(acc)
            macro_acc[k][level] = float(np.mean(accs))
    return macro_acc, per_class


def harmonic_mean(a: float, b: float) -> float:
    if a + b == 0:
        return 0.0
    return 2 * a * b / (a + b)
