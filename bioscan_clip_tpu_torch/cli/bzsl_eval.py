"""BZSL evaluation on the INSECT dataset: the step the reference hands to
the Fine-Grained-ZSL-with-DNA repository (README.md:220-224: `python
Demo.py --using_bioscan_clip_image_feature --side_info dna_bioscan_clip
--alignment --tuning`).

A copy of bioscan_clip_tpu/cli/bzsl_eval.py (numpy and scipy only): reads
the CSVs that `cli/extract_feature_for_insect_dataset.py` and
`cli/supervised_fine_tune_bioscan_clip_model_on_insect.py` write
(`retrieval/bzsl.py`: DNA class-averaged dim x n_classes, image per-sample
dim x n_samples) and the att_splits / res101 .mat files, fits the Bayesian
zero-shot classifier (`retrieval/bzsl_classifier.py`) on trainval, and
reports per-class seen / unseen / harmonic-mean accuracies into
`bzsl_results.json` beside the CSVs.

    python -m bioscan_clip_tpu_torch.cli.bzsl_eval [--tuning]
        [--embeddings DIR] [key=value config overrides]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def load_bzsl_inputs(embeddings_dir, path_to_att_splits_mat,
                     path_to_res_101_mat):
    """-> (image_feats (N, d), labels (N,), dna_means {class: (d,)},
    trainval_idx, test_seen_idx, test_unseen_idx) — all 0-based."""
    import scipy.io as sio

    img = np.loadtxt(
        os.path.join(embeddings_dir, "image_embedding_from_bioscan_clip.csv"),
        delimiter=",",
    ).T  # (N, d)
    dna = np.loadtxt(
        os.path.join(embeddings_dir, "dna_embedding_from_bioscan_clip.csv"),
        delimiter=",",
    ).T  # (n_classes, d), classes ascending

    res = sio.loadmat(path_to_res_101_mat)
    att = sio.loadmat(path_to_att_splits_mat)
    labels = res["labels"].squeeze().astype(np.int64) - 1
    classes = np.unique(labels)
    assert len(classes) == dna.shape[0], (
        f"DNA CSV rows ({dna.shape[0]}) != #classes ({len(classes)})"
    )
    dna_means = {int(c): dna[i] for i, c in enumerate(np.sort(classes))}

    def idx(key):
        return att[key].squeeze().astype(np.int64) - 1

    return (
        img, labels, dna_means,
        idx("trainval_loc"), idx("test_seen_loc"), idx("test_unseen_loc"),
    )


def run(args, embeddings_dir=None, tuning=False, out=print):
    from bioscan_clip_tpu_torch.retrieval.bzsl_classifier import (
        BZSLClassifier,
        BZSLParams,
        seen_unseen_harmonic_accuracy,
        tune_hyperparameters,
    )

    ins = args.insect_data
    embeddings_dir = embeddings_dir or os.path.join(
        args.project_root_path, "extracted_embedding/INSECT"
    )
    img, labels, dna_means, trainval, test_seen, test_unseen = (
        load_bzsl_inputs(
            embeddings_dir, ins.path_to_att_splits_mat,
            ins.path_to_res_101_mat,
        )
    )
    unseen_classes = sorted(set(int(c) for c in labels[test_unseen]))
    out(
        f"BZSL: {len(trainval)} trainval, {len(test_seen)} test-seen, "
        f"{len(test_unseen)} test-unseen, {len(dna_means)} classes "
        f"({len(unseen_classes)} unseen), d={img.shape[1]}"
    )

    if tuning:
        params, h = tune_hyperparameters(
            img[trainval], labels[trainval], dna_means, out=out
        )
        out(f"tuned params: {params} (val harmonic {h:.4f})")
    else:
        params = BZSLParams()

    clf = BZSLClassifier(params).fit(
        img[trainval], labels[trainval], dna_means, unseen_classes
    )
    test_idx = np.concatenate([test_seen, test_unseen])
    pred = clf.predict(img[test_idx])
    res = seen_unseen_harmonic_accuracy(
        labels[test_idx], pred, unseen_classes
    )
    out(
        f"BZSL accuracy: seen {res['seen']:.4f}  unseen {res['unseen']:.4f}  "
        f"H {res['harmonic']:.4f}"
    )
    res_path = os.path.join(embeddings_dir, "bzsl_results.json")
    with open(res_path, "w") as f:
        json.dump({"params": vars(params), "accuracy": res}, f, indent=2)
    out(f"wrote {res_path}")
    return res


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    argv = list(argv if argv is not None else sys.argv[1:])
    tuning = "--tuning" in argv
    if tuning:
        argv.remove("--tuning")
    emb = None
    if "--embeddings" in argv:
        i = argv.index("--embeddings")
        emb = argv[i + 1]
        del argv[i : i + 2]
    args = load_config(overrides=argv)
    return run(args, embeddings_dir=emb, tuning=tuning)


if __name__ == "__main__":
    main()
