"""Exact inner-product top-k retrieval over a resident key database.

Counterpart of bioscan_clip_tpu/retrieval/engine.py (`l2norm_np` :36-44,
`PreparedKeys` :138-273, `topk_search` :491-601, `find_k_closest_records`,
`make_prediction` :604-654): the FAISS IndexFlatIP replacement. Keys are
normalized once, uploaded once as fp32, and every search on the card runs
the top-k kernel (`ops/topk.py`), whatever the key count. On the CPU the
same calls run the kernel's plain version.

Not ported yet (each raises and names its ROADMAP.md entry): int8 keys with
their rescore modes, a multi-GPU mesh, and host-slab streaming of key sets
larger than the card's budget.
"""

from __future__ import annotations

import numpy as np
import torch

from bioscan_clip_tpu_torch.device import resolve_device
from bioscan_clip_tpu_torch.ops.topk import topk_search_kernel

LEVELS = ["order", "family", "genus", "species"]
_LATER = "is not ported yet: ROADMAP.md queue 1"


def l2norm_np(x, eps=1e-12):
    """sklearn normalize(norm='l2') parity: zero rows stay zero."""
    x = np.asarray(x, dtype=np.float32)
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, eps)


def device_budget_keys(d: int, device) -> int:
    """Key rows the card holds: 37.5% of its memory (room for queries,
    activations and kernel scratch), from `torch.cuda.mem_get_info`."""
    _, total = torch.cuda.mem_get_info(device)
    return int(0.375 * total / (4 * d))


class PreparedKeys:
    """Key matrix normalized and uploaded once for repeated searches."""

    def __init__(self, keys, device=None, precision: str = "high",
                 normalized: bool = False, mesh=None):
        if precision == "int8":
            raise NotImplementedError(f"int8 resident keys {_LATER}")
        if precision not in ("high", "highest"):
            raise ValueError(f"unknown precision {precision!r}: the port "
                             "searches in full fp32 ('high')")
        if mesh is not None:
            raise NotImplementedError(f"multi-GPU search {_LATER}")
        self.device = resolve_device(device)
        ks = np.asarray(keys, dtype=np.float32)
        if not normalized:
            ks = l2norm_np(ks)
        self.n_keys, self.d = ks.shape
        if self.device.type == "cuda":
            budget = device_budget_keys(self.d, self.device)
            if self.n_keys > budget:
                raise NotImplementedError(
                    f"{self.n_keys} keys exceed the card's budget of "
                    f"{budget}: host-slab streaming {_LATER}"
                )
        self.keys_dev = torch.from_numpy(np.ascontiguousarray(ks)).to(
            self.device)


def topk_search(query_feature, keys_feature, k: int, mesh=None,
                device=None):
    """Exact top-k inner-product search -> (similarities, indices), numpy
    (Bq, k): the FAISS `index.search` contract. `keys_feature` is a raw
    (N, D) array (searched as it is, not normalized) or a `PreparedKeys`."""
    if isinstance(keys_feature, PreparedKeys):
        pk = keys_feature
    else:
        pk = PreparedKeys(keys_feature, device=device, normalized=True,
                          mesh=mesh)
    return topk_search_kernel(query_feature, pk.keys_dev, k)


def find_k_closest_records(input_file_name_list, input_feature_np_array,
                           keys_file_name_list, keys_feature_np_array,
                           k: int = 5, mesh=None, device=None):
    """For each input record, the file names of its k nearest keys by
    inner product (reference util/util.py:159-169)."""
    _, indices = topk_search(input_feature_np_array, keys_feature_np_array,
                             k, mesh=mesh, device=device)
    return {
        input_file_name_list[i]: [keys_file_name_list[j] for j in row]
        for i, row in enumerate(indices)
    }


def make_prediction(query_feature, keys_feature, keys_label,
                    with_similarity: bool = False,
                    with_indices: bool = False, max_k: int = 5, mesh=None,
                    device=None):
    """Reference-parity prediction (inference_and_eval.py:414-445):
    normalize queries and keys, search, and expand neighbour indices into
    per-level label lists. `keys_feature` may be a `PreparedKeys`."""
    qn = l2norm_np(query_feature)
    if isinstance(keys_feature, PreparedKeys):
        kn = keys_feature
    else:
        kn = l2norm_np(keys_feature)
    similarities, indices = topk_search(qn, kn, max_k, mesh=mesh,
                                        device=device)
    pred_list = [
        {level: [keys_label[i][level] for i in row] for level in LEVELS}
        for row in indices
    ]
    out = [pred_list]
    if with_similarity:
        out.append(similarities)
    if with_indices:
        out.append(indices)
    return out[0] if len(out) == 1 else out
