"""Host-side visualization and analysis of embeddings (reporting only; no
hot path runs it).

A copy of bioscan_clip_tpu/utils/viz.py (the reference's
scripts/inference_and_eval.py:110-400, 514-631; epoch/eval_epoch.py:70-88;
util/util.py:172-211):
- per-level 2-D embedding maps with order/family/genus filters (UMAP when
  importable, else PCA; matplotlib PNG);
- retrieval image grids with green/red correctness borders;
- the confusion matrix heatmap;
- the mean silhouette score per taxonomic level (sklearn);
- a categorical colormap with shade families.
numpy only at import: umap, sklearn, matplotlib and seaborn are imported
inside the functions that need them (the card's machine lacks them).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

LEVELS = ["order", "family", "genus", "species"]


def project_2d(features: np.ndarray, seed: int = 0) -> np.ndarray:
    """UMAP when available (reference behavior), PCA otherwise."""
    try:
        from umap import UMAP
    except ImportError:
        from sklearn.decomposition import PCA

        return PCA(n_components=2, random_state=seed).fit_transform(features)
    return UMAP(n_components=2, random_state=seed).fit_transform(features)


def categorical_cmap(nc: int, nsc: int, cmap: str = "tab10"):
    """nc base colors x nsc shades each (util.py:172-211)."""
    import matplotlib.colors
    import matplotlib.pyplot as plt

    base = plt.get_cmap(cmap)
    if nc > base.N:
        raise ValueError("Too many categories for colormap.")
    ccolors = base(np.arange(nc, dtype=int))
    cols = np.zeros((nc * nsc, 3))
    for i, c in enumerate(ccolors):
        chsv = matplotlib.colors.rgb_to_hsv(c[:3])
        arhsv = np.tile(chsv, nsc).reshape(nsc, 3)
        arhsv[:, 1] = np.linspace(chsv[1], 0.25, nsc)
        arhsv[:, 2] = np.linspace(chsv[2], 1, nsc)
        cols[i * nsc : (i + 1) * nsc] = matplotlib.colors.hsv_to_rgb(arhsv)
    return matplotlib.colors.ListedColormap(cols)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_path):
    """Write `fig` to `out_path` and close it (-> the path), or hand the
    figure back when no path is given."""
    if not out_path:
        return fig
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    _pyplot().close(fig)
    return out_path


def plot_embeddings(
    features: np.ndarray,
    label_dicts: list,
    level: str = "order",
    filters: Optional[dict] = None,
    out_path: Optional[str] = None,
    max_classes: int = 20,
    seed: int = 0,
):
    """2-D embedding map colored by taxonomy at `level`; `filters`
    restricts to e.g. {'order': 'Diptera'} like
    inference_and_eval_setting.embeddings_filters."""
    plt = _pyplot()
    mask = np.ones(len(label_dicts), dtype=bool)
    if filters:
        for flt_level, value in filters.items():
            if flt_level == level:
                continue
            mask &= np.array(
                [d.get(flt_level) == value for d in label_dicts]
            )
    feats = features[mask]
    labels = [d[level] for d, m in zip(label_dicts, mask) if m]
    if len(feats) < 3:
        return None
    coords = project_2d(feats, seed=seed)

    uniq = list(dict.fromkeys(labels))[:max_classes]
    fig, ax = plt.subplots(figsize=(8, 8))
    cmap = plt.get_cmap("tab20")
    for i, cls in enumerate(uniq):
        sel = np.array([lab == cls for lab in labels])
        ax.scatter(
            coords[sel, 0], coords[sel, 1], s=6,
            color=cmap(i % 20), label=cls, alpha=0.7,
        )
    ax.legend(fontsize=6, markerscale=2, ncol=2)
    ax.set_title(f"Embeddings by {level}")
    return _save(fig, out_path)


def plot_retrieval_grid(
    query_images: list,
    retrieved_images: list,
    correct: np.ndarray,
    out_path: Optional[str] = None,
):
    """Rows = queries; first column the query image, then its top-k
    retrieved images with green/red correctness borders
    (inference_and_eval.py:220-400 semantics)."""
    plt = _pyplot()
    n = len(query_images)
    k = len(retrieved_images[0])
    fig, axes = plt.subplots(n, k + 1, figsize=(1.6 * (k + 1), 1.6 * n))
    axes = np.atleast_2d(axes)
    for i in range(n):
        axes[i, 0].imshow(query_images[i])
        axes[i, 0].set_title("query", fontsize=6)
        for j in range(k):
            ax = axes[i, j + 1]
            ax.imshow(retrieved_images[i][j])
            color = "green" if correct[i][j] else "red"
            for spine in ax.spines.values():
                spine.set_edgecolor(color)
                spine.set_linewidth(3)
        for ax in axes[i]:
            ax.set_xticks([])
            ax.set_yticks([])
    return _save(fig, out_path)


def plot_confusion_matrix(
    gt_labels: list, pred_labels: list, out_path: Optional[str] = None,
    max_classes: int = 30,
):
    """Confusion-matrix heatmap (eval_epoch.py:70-88) over the first
    `max_classes` ground-truth classes."""
    from sklearn.metrics import confusion_matrix

    plt = _pyplot()
    classes = list(dict.fromkeys(gt_labels))[:max_classes]
    cset = set(classes)
    pairs = [
        (g, p) for g, p in zip(gt_labels, pred_labels)
        if g in cset and p in cset
    ]
    if not pairs:
        return None
    cm = confusion_matrix(
        [g for g, _ in pairs], [p for _, p in pairs], labels=classes
    )
    fig, ax = plt.subplots(figsize=(10, 8))
    try:
        import seaborn as sns
    except ImportError:
        ax.imshow(cm, cmap="viridis")
    else:
        sns.heatmap(cm, ax=ax, cmap="viridis")
    ax.set_xlabel("predicted")
    ax.set_ylabel("ground truth")
    return _save(fig, out_path)


def silhouette_scores(features: np.ndarray, label_dicts: list,
                      out=print) -> dict:
    """Mean silhouette score per taxonomic level with two or more classes
    (inference_and_eval.py:407-411)."""
    from sklearn.metrics import silhouette_samples

    scores = {}
    for level in LEVELS:
        gt = [d[level] for d in label_dicts]
        if len(set(gt)) < 2:
            continue
        s = silhouette_samples(features, gt)
        scores[level] = float(np.mean(s))
        out(f"The silhouette score for {level} level is : {scores[level]}")
    return scores
