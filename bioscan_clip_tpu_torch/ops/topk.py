"""Exact fp32 inner-product top-k over a key matrix.

Counterpart of bioscan_clip_tpu/ops/topk_pallas.py (`pallas_topk` :185 and
its numpy wrapper `topk_search_pallas` :320). On CUDA tensors `topk`
launches the hand-written two-pass kernel in `csrc/topk.cu` or raises; on
CPU tensors it runs `topk_reference`, the plain PyTorch version.

Contract (both versions): scores are full-fp32 Q . K^T (never TF32), keys
with index >= n_valid never enter, each row comes out sorted descending,
and among equal values the smaller key index comes first.

`topk.launches` counts kernel launches; `topk_reference.calls` counts the
plain version's calls.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bioscan_clip_tpu_torch.ops import _build

MAX_K = 32  # the kernel keeps per-thread top-k lists of up to 32 entries
REFERENCE_KEY_CHUNK = 65536
QUERY_CHUNK = 1024


def topk_reference(queries, keys, n_valid: int, k: int):
    """Plain PyTorch top-k: chunked fp32 products over keys[:n_valid], each
    chunk stably sorted and merged with the running top-k (the
    `engine._topk_scan` scheme, with a stable sort giving the tie rule)."""
    topk_reference.calls += 1
    vals = idx = None
    for s in range(0, n_valid, REFERENCE_KEY_CHUNK):
        e = min(s + REFERENCE_KEY_CHUNK, n_valid)
        sc = queries @ keys[s:e].T
        v, i = torch.sort(sc, dim=1, descending=True, stable=True)
        v, i = v[:, :k], i[:, :k] + s
        if vals is not None:
            # earlier chunks first: a stable sort keeps their smaller indices
            # ahead of equal values
            v, sel = torch.sort(torch.cat([vals, v], dim=1), dim=1,
                                descending=True, stable=True)
            i = torch.gather(torch.cat([idx, i], dim=1), 1, sel)
            v, i = v[:, :k], i[:, :k]
        vals, idx = v, i
    return vals, idx.to(torch.int32)


topk_reference.calls = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("topk")
    fn = lib.bscan_topk_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
    )
    fn.restype = ctypes.c_int
    plan = lib.bscan_topk_plan
    plan.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    plan.restype = None
    return lib, fn, plan


def topk(queries, keys, n_valid: int, k: int):
    """Top-k of queries (Bq, D) . keys (N, D)^T over keys[:n_valid].
    Returns (values (Bq, k) fp32, indices (Bq, k) int32)."""
    n_valid = int(n_valid)
    n = keys.shape[0]
    if not 1 <= k <= n_valid <= n:
        raise ValueError(f"topk: need 1 <= k ({k}) <= n_valid ({n_valid}) "
                         f"<= N ({n})")
    if queries.device.type == "cpu":
        return topk_reference(queries, keys, n_valid, k)
    for name, t in (("queries", queries), ("keys", keys)):
        if t.device != queries.device:
            raise ValueError(f"topk: {name} on {t.device}, queries on "
                             f"{queries.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"topk: {name} dtype {t.dtype}, expected fp32")
        if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"topk: {name} must be 2-D, contiguous and "
                             "16-byte aligned")
    bq, d = queries.shape
    if keys.shape[1] != d or d % 32:
        raise ValueError(f"topk: widths {d} / {keys.shape[1]} must match "
                         "and be a multiple of 32")
    if k > MAX_K:
        raise ValueError(f"topk: kernel takes k <= {MAX_K}, got {k}")
    dev = queries.device
    lib, fn, plan = _kernel()
    splits, per_split = ctypes.c_int(), ctypes.c_int()
    n_cand = ctypes.c_longlong()
    plan(bq, n, k, torch.cuda.get_device_properties(dev).multi_processor_count,
         ctypes.byref(splits), ctypes.byref(per_split), ctypes.byref(n_cand))
    cand_v = torch.empty(n_cand.value, dtype=torch.float32, device=dev)
    cand_i = torch.empty(n_cand.value, dtype=torch.int32, device=dev)
    out_v = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    err = fn(
        queries.data_ptr(), keys.data_ptr(), bq, n, d, n_valid, k,
        splits.value, per_split.value, cand_v.data_ptr(), cand_i.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "topk launch")
    topk.launches += 1
    return out_v, out_i


topk.launches = 0


def topk_search_kernel(query_feature, keys, k: int, device=None):
    """numpy queries in, numpy out, like `topk_search_pallas`: (sims (Bq, k)
    fp32, indices (Bq, k) int64), k clamped to the key count. `keys` is a
    numpy (N, D) array (uploaded to `device`) or a tensor already resident
    on its device (then `device` is ignored)."""
    if isinstance(keys, torch.Tensor):
        keys_t = keys
    else:
        from bioscan_clip_tpu_torch.device import resolve_device

        keys_t = torch.from_numpy(
            np.ascontiguousarray(keys, dtype=np.float32)
        ).to(resolve_device(device))
    q = np.asarray(query_feature, dtype=np.float32)
    n_keys = keys_t.shape[0]
    k_eff = min(k, n_keys)
    sims = np.empty((q.shape[0], k_eff), np.float32)
    idxs = np.empty((q.shape[0], k_eff), np.int64)
    for s in range(0, q.shape[0], QUERY_CHUNK):
        qc = torch.from_numpy(np.ascontiguousarray(q[s : s + QUERY_CHUNK]))
        v, i = topk(qc.to(keys_t.device), keys_t, n_keys, k_eff)
        sims[s : s + qc.shape[0]] = v.cpu().numpy()
        idxs[s : s + qc.shape[0]] = i.cpu().numpy()
    return sims, idxs
