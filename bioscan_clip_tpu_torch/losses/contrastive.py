"""Multimodal soft-label InfoNCE (the reference's ContrastiveLoss/ClipLoss).

Counterpart of bioscan_clip_tpu/losses/contrastive.py (all of it):
- the soft target label[i, j] = float(labels_i == labels_j): the identity
  for instance labels, multi-positive for BIN labels;
- for every ordered pair (a, b) of present modalities, the cross-entropy of
  logit_scale * a_n @ b_n^T against that target; the mean over the terms;
- torch's CrossEntropyLoss with probability targets does not row-normalize
  the target: loss_row = -sum_j target[j] * log_softmax(logits)[j].
The (B, D) @ (D, B) logits are a plain `torch.matmul`, as the JAX package
leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def construct_label_matrix(labels):
    """(B,) int labels -> (B, B) fp32 equality matrix."""
    return (labels[None, :] == labels[:, None]).to(torch.float32)


def soft_cross_entropy(logits, target_probs):
    """Mean over rows of -sum_j target[j] * log_softmax(logits)[j], in
    fp32 whatever the input dtype."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(target_probs * logp).sum(dim=-1).mean()


def multimodal_contrastive_loss(embeddings: dict, labels,
                                logit_scale=1.0 / 0.07, label_matrix=None):
    """Mean pairwise soft-label InfoNCE over all ordered modality pairs.

    embeddings: {modality: (B, D) tensor or None}, at least two present.
    labels: (B,) int tensor (instance ids or BIN group ids).
    logit_scale: a float, or a 0-d tensor (the learnable scale)."""
    feats = [e for e in embeddings.values() if e is not None]
    if len(feats) < 2:
        raise ValueError("Too less element for calculating the contrastive "
                         "loss.")
    if label_matrix is None:
        label_matrix = construct_label_matrix(labels)
    feats = [f / torch.clamp_min(torch.linalg.vector_norm(f, dim=-1,
                                                          keepdim=True),
                                 1e-12)
             for f in feats]
    terms = []
    for i, a in enumerate(feats):
        for j, b in enumerate(feats):
            if i != j:
                sim = logit_scale * torch.matmul(a.float(), b.float().T)
                terms.append(soft_cross_entropy(sim, label_matrix))
    return sum(terms) / len(terms)
