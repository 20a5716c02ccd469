"""Exact inner-product top-k retrieval over a resident key database.

Counterpart of bioscan_clip_tpu/retrieval/engine.py (`l2norm_np` :36-44,
`PreparedKeys` :138-273, `_rescore_exact` :478-488, `topk_search`
:491-601, `find_k_closest_records`, `make_prediction` :604-654): the FAISS
IndexFlatIP replacement. Keys are normalized once and uploaded once, and
every search on the card runs a top-k kernel (`ops/topk.py`), whatever the
key count: K4 over fp32 keys (`precision="high"`, fp32 scores (on the
card the six-product bf16 split, within fp32 rounding of them), or
`"default"`: the
TPU's single bf16 pass, operands rounded to bf16 and summed in fp32, on
the card and on the CPU alike), K5 over per-row int8
codes with fp32 scales (`precision="int8"`, 4x the resident capacity: the
5M x 768 BIOSCAN-5M key set is 3.8 GB). An int8 search oversamples to
max(4k, k + 16) candidates and rescores them on the host against the key
rows kept in the `rescore` dtype ("float32" exact, "bfloat16" half the host
memory, "none" no host copy and the quantized scores returned). On the CPU
the same calls run the kernels' plain versions.

Not ported yet (each raises and names its ROADMAP.md entry): a multi-GPU
mesh, and host-slab streaming of key sets larger than the card's budget.
"""

from __future__ import annotations

import numpy as np
import torch

from bioscan_clip_tpu_torch.device import resolve_device
from bioscan_clip_tpu_torch.ops.topk import (
    quantize_rows_i8,
    topk_search_i8_kernel,
    topk_search_kernel,
)

LEVELS = ["order", "family", "genus", "species"]
_LATER = "is not ported yet: ROADMAP.md queue 1, item"


def l2norm_np(x, eps=1e-12):
    """sklearn normalize(norm='l2') parity: zero rows stay zero."""
    x = np.asarray(x, dtype=np.float32)
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, eps)


def device_budget_keys(d: int, device, bytes_per_elem: int = 4) -> int:
    """Key rows the card holds: 37.5% of its memory (room for queries,
    activations and kernel scratch), from `torch.cuda.mem_get_info`.
    `bytes_per_elem`: 4 for fp32 keys, 1 for int8 codes (4x the rows)."""
    _, total = torch.cuda.mem_get_info(device)
    return int(0.375 * total / (bytes_per_elem * d))


RESCORE_MODES = ("float32", "bfloat16", "none")


class PreparedKeys:
    """Key matrix normalized and uploaded once for repeated searches.

    `precision="int8"`: (N, D) int8 codes and (N,) fp32 scales resident on
    the device (no tile padding: the kernel masks by the key count), and
    the host rows the rescore reads, in the `rescore` dtype: a numpy fp32
    array, a CPU `torch.bfloat16` tensor (round to nearest even, the same
    values as an `ml_dtypes.bfloat16` array), or none."""

    def __init__(self, keys, device=None, precision: str = "high",
                 normalized: bool = False, mesh=None,
                 rescore: str = "float32"):
        if precision not in ("high", "highest", "default", "int8"):
            raise ValueError(f"unknown precision {precision!r}: the port "
                             "searches in fp32 ('high'; on the card the "
                             "six-product bf16 split), one bf16 pass "
                             "('default') or int8")
        if rescore not in RESCORE_MODES:
            raise ValueError(f"unknown rescore mode {rescore!r}")
        if mesh is not None:
            raise NotImplementedError(
                f"multi-GPU search {_LATER} 4 (multi-GPU search)")
        self.device = resolve_device(device)
        self.precision = precision
        self.int8 = precision == "int8"
        self.rescore = rescore
        ks = np.asarray(keys, dtype=np.float32)
        if not normalized:
            ks = l2norm_np(ks)
        self.n_keys, self.d = ks.shape
        if self.device.type == "cuda":
            budget = device_budget_keys(self.d, self.device,
                                        bytes_per_elem=1 if self.int8 else 4)
            if self.n_keys > budget:
                raise NotImplementedError(
                    f"{self.n_keys} keys exceed the card's budget of "
                    f"{budget}: host-slab streaming {_LATER} 3 "
                    "(host-slab streaming)"
                )
        self.host_keys = None
        self.key_scales_dev = None
        if self.int8:
            codes, scales = quantize_rows_i8(ks)
            self.keys_dev = torch.from_numpy(codes).to(self.device)
            self.key_scales_dev = torch.from_numpy(
                np.ascontiguousarray(scales[:, 0])).to(self.device)
            self.host_keys = self._rescore_rows(ks)
        else:
            self.keys_dev = torch.from_numpy(np.ascontiguousarray(ks)).to(
                self.device)

    def _rescore_rows(self, ks):
        """The host copy the int8 rescore reads: fp32 rows, bf16 rows (half
        the host memory), or none."""
        if self.rescore == "none":
            return None
        if self.rescore == "bfloat16":
            return torch.from_numpy(ks).to(torch.bfloat16)
        return ks


def _rescore_exact(q, host_keys, idxs, k: int):
    """fp32 rescore of oversampled int8 candidates: inner products against
    the host key rows (upcast from their storage dtype), stable re-sort,
    truncate to k."""
    if isinstance(host_keys, torch.Tensor):
        cand = host_keys[torch.from_numpy(idxs)].to(torch.float32).numpy()
    else:
        cand = np.asarray(host_keys[idxs], dtype=np.float32)  # (B, ko, D)
    sims = np.einsum("bd,bkd->bk", q, cand)
    sel = np.argsort(-sims, axis=1, kind="stable")[:, :k]
    return (
        np.take_along_axis(sims, sel, axis=1),
        np.take_along_axis(idxs, sel, axis=1),
    )


def topk_search(query_feature, keys_feature, k: int, mesh=None,
                device=None, precision: str = "high",
                rescore: str = "float32"):
    """Exact top-k inner-product search -> (similarities, indices), numpy
    (Bq, k): the FAISS `index.search` contract. `keys_feature` is a raw
    (N, D) array (searched as it is, not normalized; `precision` and
    `rescore` then build its `PreparedKeys`) or a `PreparedKeys`.

    int8 keys: the kernel ranks an oversampled pool of
    min(N, max(4k, k + 16)) candidates by their quantized scores and the
    host rescores them in fp32 (`rescore="none"`: the quantized ranking and
    scores are returned as they are)."""
    q = np.asarray(query_feature, dtype=np.float32)
    if isinstance(keys_feature, PreparedKeys):
        pk = keys_feature
    else:
        pk = PreparedKeys(keys_feature, device=device, normalized=True,
                          mesh=mesh, precision=precision, rescore=rescore)
    if not pk.int8:
        return topk_search_kernel(q, pk.keys_dev, k,
                                  precision=pk.precision)
    k_eff = min(k, pk.n_keys)
    do_rescore = pk.rescore != "none"
    k_search = (min(pk.n_keys, max(4 * k_eff, k_eff + 16)) if do_rescore
                else k_eff)
    vals, idxs = topk_search_i8_kernel(q, pk.keys_dev, pk.key_scales_dev,
                                       k_search)
    if do_rescore:
        vals, idxs = _rescore_exact(q, pk.host_keys, idxs, k_eff)
    return vals, idxs


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
