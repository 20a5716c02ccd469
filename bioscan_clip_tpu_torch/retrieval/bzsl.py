"""BZSL (Bayesian zero-shot learning) CSV export for the
Fine-Grained-ZSL-with-DNA pipeline.

A copy of bioscan_clip_tpu/retrieval/bzsl.py (numpy only; the reference's
scripts/extract_feature_for_insect_dataset.py:51-88 and
supervised_fine_tune_...py:144-181):
- `dna_embedding_from_bioscan_clip.csv`: the per-class mean DNA embedding
  over res101 `labels` (1-based -> 0-based, classes ascending),
  transposed (dim x n_classes);
- `image_embedding_from_bioscan_clip.csv`: per-sample image embeddings,
  transposed (dim x n_samples).
"""

from __future__ import annotations

import os

import numpy as np


def res101_class_labels(path_to_res_101_mat) -> np.ndarray:
    import scipy.io as sio

    mat = sio.loadmat(path_to_res_101_mat)
    return mat["labels"].squeeze() - 1


def class_averaged_embeddings(features, labels) -> np.ndarray:
    """Per-class mean feature, classes ascending -> (n_classes, dim)."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    classes.sort()
    return np.stack(
        [features[labels == c].mean(axis=0) for c in classes], axis=0
    )


def export_bzsl_csvs(out_dir, dna_features, image_features, labels,
                     out=print):
    os.makedirs(out_dir, exist_ok=True)
    dna_path = os.path.join(out_dir, "dna_embedding_from_bioscan_clip.csv")
    img_path = os.path.join(out_dir, "image_embedding_from_bioscan_clip.csv")

    class_embed = class_averaged_embeddings(
        np.asarray(dna_features), labels
    ).T  # (dim, n_classes)
    np.savetxt(dna_path, class_embed, delimiter=",")
    out(f"{dna_path} {class_embed.shape}")

    img = np.asarray(image_features, dtype=np.float32).T  # (dim, n_samples)
    np.savetxt(img_path, img, delimiter=",")
    out(f"{img_path} {img.shape}")
    return dna_path, img_path
