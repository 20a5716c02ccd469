"""Native Bayesian zero-shot classifier (BZSL) for the INSECT pipeline.

A copy of bioscan_clip_tpu/retrieval/bzsl_classifier.py (numpy and scipy
only).

The reference delegates this step to the external Fine-Grained-ZSL-with-DNA
repository (`README.md:220-224`: `python Demo.py --side_info dna_bioscan_clip
--alignment --tuning`), whose git submodule is EMPTY in the snapshot
(SURVEY.md L8). This module is an upgrade, not a port: it implements the
Bayesian zero-shot model of Badirli et al., "Fine-Grained Zero-Shot Learning
with DNA as Side Information" (NeurIPS 2021) from the paper's equations, so
the documented INSECT workflow (`README.md:164-229`) runs end to end inside
this framework: train -> export embeddings (retrieval/bzsl.py CSVs) ->
classify seen+unseen -> seen/unseen/harmonic accuracies.

Model (the paper's unconstrained variant). Each class j has a Gaussian
likelihood x ~ N(mu_j, Sigma) with a Normal-Inverse-Wishart conjugate prior

    Sigma ~ IW(Psi, m),    mu_j | Sigma ~ N(mu0_j, Sigma / kappa),

so the class posterior predictive is a multivariate Student-t. The zero-shot
element is WHERE the local prior (mu0_j, and the extra scatter in Psi_j)
comes from:

- seen class: its own training data (mean/scatter), prior mean = mean of its
  K nearest seen classes' means in the DNA side-information space (the class
  neighbourhood defines a genus-like local prior);
- unseen class: no image data at all (n_j = 0). Its K nearest seen classes
  (by DNA class-mean cosine similarity) act as *surrogates*: their class
  means are pseudo-observations with prior count kappa_1, giving
  mu0_j = surrogate mean and a between-surrogate scatter term in Psi_j.

Hyperparameters follow the paper's naming: kappa_0 (data prior count),
kappa_1 (surrogate/class-mean prior count), m (IW degrees of freedom,
parameterized as d + m_offset), s (Psi = s * I scale), K (surrogate count).
`tune_hyperparameters` grid-searches them on a seen/unseen validation split
built from the train set, mirroring the external repo's `--tuning` flag.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class BZSLParams:
    kappa_0: float = 0.1
    kappa_1: float = 10.0
    m_offset: float = 25.0  # m = d + m_offset
    s: float = 1.0  # Psi = s * I
    K: int = 2  # surrogate classes per unseen class

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _class_stats(features: np.ndarray, labels: np.ndarray):
    """Per-class count, mean, and scatter (sum of squared deviations)."""
    classes = np.unique(labels)
    d = features.shape[1]
    stats = {}
    for c in classes:
        x = features[labels == c]
        mu = x.mean(axis=0)
        xc = x - mu
        stats[int(c)] = (len(x), mu, xc.T @ xc if len(x) > 1 else np.zeros((d, d)))
    return stats


def _surrogates(side_means: Dict[int, np.ndarray], query: np.ndarray,
                K: int) -> Sequence[int]:
    """K nearest classes by cosine similarity of DNA side-info means."""
    keys = np.array(sorted(side_means))
    M = np.stack([side_means[int(k)] for k in keys])
    M = M / np.maximum(np.linalg.norm(M, axis=1, keepdims=True), 1e-12)
    q = query / max(np.linalg.norm(query), 1e-12)
    sims = M @ q
    order = np.argsort(-sims)
    return [int(keys[i]) for i in order[:K]]


class BZSLClassifier:
    """Fit once, then `log_ppd(X)` / `predict(X)` over all classes.

    fit() inputs:
      train_feats/train_labels: image embeddings + class ids (seen classes)
      dna_means: class id -> DNA side-info embedding for EVERY class
                 (seen + unseen; e.g. class-averaged barcodes,
                 retrieval/bzsl.py:class_averaged_embeddings)
      unseen_classes: ids with no image data
    """

    def __init__(self, params: Optional[BZSLParams] = None):
        self.params = params or BZSLParams()

    def fit(self, train_feats: np.ndarray, train_labels: np.ndarray,
            dna_means: Dict[int, np.ndarray],
            unseen_classes: Sequence[int]):
        p = self.params
        d = train_feats.shape[1]
        stats = _class_stats(train_feats, train_labels)
        seen_dna = {c: dna_means[c] for c in stats if c in dna_means}
        m = d + p.m_offset
        Psi0 = p.s * np.eye(d)

        self.classes_ = []
        locs, scales, dfs = [], [], []
        for c in sorted(set(stats) | set(int(u) for u in unseen_classes)):
            if c in stats:  # seen: conjugate update with its own data
                n, xbar, S = stats[c]
                c_dna = dna_means.get(c)
                # a seen class with no DNA side info falls back to its own
                # mean prior (the same no-neighbour path below)
                neigh = [] if c_dna is None else [
                    k for k in _surrogates(seen_dna, c_dna, p.K + 1)
                    if k != c
                ][: p.K]
                mu0 = (
                    np.mean([stats[k][1] for k in neigh], axis=0)
                    if neigh else xbar
                )
                kap = p.kappa_0
                kn = kap + n
                mn = m + n
                mu_n = (kap * mu0 + n * xbar) / kn
                dev = (xbar - mu0)[:, None]
                Psi_n = Psi0 + S + (kap * n / kn) * (dev @ dev.T)
            else:  # unseen: surrogate class means as pseudo-data
                sur = _surrogates(seen_dna, dna_means[c], p.K)
                mus = np.stack([stats[k][1] for k in sur])
                mu0 = mus.mean(axis=0)
                ns = len(sur)
                # class means carry prior count kappa_1 each
                kap = p.kappa_1 * ns
                kn = kap
                mn = m + ns
                mu_n = mu0
                dev = mus - mu0
                Psi_n = Psi0 + p.kappa_1 * (dev.T @ dev)
            df = mn - d + 1
            if df <= 0:
                df = 1.0
            scale = Psi_n * (kn + 1.0) / (kn * df)
            self.classes_.append(c)
            locs.append(mu_n)
            scales.append(scale)
            dfs.append(df)

        self.locs_ = np.stack(locs)  # (C, d)
        self.dfs_ = np.asarray(dfs, np.float64)  # (C,)
        # Cholesky per class for logdet + whitening
        self.chols_ = np.stack([np.linalg.cholesky(S) for S in scales])
        self.logdets_ = 2.0 * np.log(
            np.stack([np.diagonal(L) for L in self.chols_])
        ).sum(axis=1)
        return self

    def log_ppd(self, X: np.ndarray) -> np.ndarray:
        """(N, C) log posterior-predictive densities (Student-t)."""
        from scipy.linalg import solve_triangular
        from scipy.special import gammaln

        X = np.asarray(X, np.float64)
        N, d = X.shape
        C = len(self.classes_)
        out = np.empty((N, C), np.float64)
        for j in range(C):
            v = self.dfs_[j]
            dev = (X - self.locs_[j]).T  # (d, N)
            z = solve_triangular(self.chols_[j], dev, lower=True)
            maha = (z * z).sum(axis=0)
            out[:, j] = (
                gammaln((v + d) / 2.0)
                - gammaln(v / 2.0)
                - 0.5 * d * np.log(v * np.pi)
                - 0.5 * self.logdets_[j]
                - 0.5 * (v + d) * np.log1p(maha / v)
            )
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        idx = self.log_ppd(X).argmax(axis=1)
        return np.asarray(self.classes_)[idx]


def seen_unseen_harmonic_accuracy(y_true, y_pred, unseen_classes):
    """Per-class-averaged accuracy on seen/unseen + harmonic mean (the BZSL
    reporting convention)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    unseen = set(int(u) for u in unseen_classes)

    def per_class_acc(mask_classes):
        accs = []
        for c in np.unique(y_true):
            if (int(c) in unseen) != mask_classes:
                continue
            m = y_true == c
            if m.any():
                accs.append(float((y_pred[m] == c).mean()))
        return float(np.mean(accs)) if accs else 0.0

    acc_seen = per_class_acc(False)
    acc_unseen = per_class_acc(True)
    h = (
        2 * acc_seen * acc_unseen / (acc_seen + acc_unseen)
        if (acc_seen + acc_unseen) > 0
        else 0.0
    )
    return {"seen": acc_seen, "unseen": acc_unseen, "harmonic": h}


def tune_hyperparameters(
    train_feats, train_labels, dna_means, *,
    grid: Optional[dict] = None, val_fraction: float = 0.2,
    unseen_fraction: float = 0.2, seed: int = 0, out=None,
):
    """Grid-search BZSLParams on a synthetic seen/unseen split of the train
    set (the external repo's `--tuning`): hold out `unseen_fraction` of
    classes entirely (pseudo-unseen) + `val_fraction` of the remaining
    classes' samples (pseudo-seen val); pick the harmonic-mean maximiser."""
    rng = np.random.default_rng(seed)
    classes = np.unique(train_labels)
    n_unseen = max(1, int(len(classes) * unseen_fraction))
    pseudo_unseen = set(
        int(c) for c in rng.choice(classes, size=n_unseen, replace=False)
    )

    fit_mask = np.ones(len(train_labels), bool)
    val_mask = np.zeros(len(train_labels), bool)
    for c in classes:
        idx = np.where(train_labels == c)[0]
        if int(c) in pseudo_unseen:
            fit_mask[idx] = False
            val_mask[idx] = True
        else:
            k = max(1, int(len(idx) * val_fraction))
            take = rng.choice(idx, size=k, replace=False)
            fit_mask[take] = False
            val_mask[take] = True

    grid = grid or {
        "kappa_0": [0.1, 1.0],
        "kappa_1": [10.0, 25.0],
        "m_offset": [5.0, 25.0],
        "s": [0.5, 1.0, 5.0],
        "K": [2, 3],
    }
    best, best_h = None, -1.0
    import itertools

    keys = sorted(grid)
    for combo in itertools.product(*(grid[k] for k in keys)):
        params = BZSLParams(**dict(zip(keys, combo)))
        clf = BZSLClassifier(params).fit(
            train_feats[fit_mask], train_labels[fit_mask], dna_means,
            sorted(pseudo_unseen),
        )
        pred = clf.predict(train_feats[val_mask])
        res = seen_unseen_harmonic_accuracy(
            train_labels[val_mask], pred, sorted(pseudo_unseen)
        )
        if out is not None:
            out(f"{params} -> {res}")
        if res["harmonic"] > best_h:
            best, best_h = params, res["harmonic"]
    return best, best_h
