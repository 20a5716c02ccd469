"""Exact inner-product top-k retrieval over a key database on the card.

Counterpart of bioscan_clip_tpu/retrieval/engine.py (`l2norm_np` :36-44,
`PreparedKeys` :138-273, `_sharded_searcher` :277-321,
`_sharded_searcher_i8` :324-358, `_rescore_exact` :478-488, `topk_search`
:491-601, `find_k_closest_records`, `make_prediction` :604-654): the FAISS
IndexFlatIP replacement. Keys are normalized once and uploaded once, and
every search on the card runs a top-k kernel (`ops/topk.py`), whatever the
key count: K4 over fp32 keys (`precision="high"`, fp32 scores (on the
card the six-product bf16 split, within fp32 rounding of them), or
`"default"`: the TPU's single bf16 pass, operands rounded to bf16 and
summed in fp32, on the card and on the CPU alike), K5 over per-row int8
codes with fp32 scales (`precision="int8"`, 4x the resident capacity: the
5M x 768 BIOSCAN-5M key set is 3.8 GB). An int8 search oversamples to
max(4k, k + 16) candidates and rescores them once, on the host, against
the key rows kept in the `rescore` dtype ("float32" exact, "bfloat16" half
the host memory, "none" no host copy and the quantized scores returned).
On the CPU the same calls run the kernels' plain versions.

Sharded keys (`mesh`, `parallel/mesh.py`): the rows are cut into
`mesh.size` shards of ceil(N / size) rows, as JAX's `shard_pad` does; each
device of the mesh searches its shard, and the shards' lists go through an
all_gather over the process group (or come together from this process's
devices) into an exact merge. Ties take the lower global index, as
`lax.top_k` over the shards' lists in axis order does.

Streamed keys: a shard above the card's budget (`device_budget_keys`, half
of it per slab, since two slabs are resident), or above `max_device_keys`
(the JAX argument, in keys of the whole set), stays on the host and is
searched in slabs (JAX :555-601). On the card two pinned staging buffers
and a copy stream move slab i + 1 while slab i is searched; events order
the copy under the search (from pageable memory a `non_blocking` copy
would be synchronous). int8 codes are quantized once on the host and
streamed (JAX requantizes each slab: the codes are row-local, so they are
the same). Each slab's top-k merges into the running one exactly; int8
oversamples per slab and rescores once, after the merge.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from bioscan_clip_tpu_torch.device import resolve_device
from bioscan_clip_tpu_torch.ops.topk import (
    QUERY_CHUNK,
    quantize_rows_i8,
    topk,
    topk_i8,
)
from bioscan_clip_tpu_torch.parallel.mesh import Mesh

LEVELS = ["order", "family", "genus", "species"]


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


def merge_topk(vals, idxs, k: int):
    """Exact merge of top-k lists (each (Bq, k_i), sorted, in index order
    of their keys) -> the top k: a stable sort keeps the lower index
    first among equal values."""
    if len(vals) == 1:
        return vals[0][:, :k], idxs[0][:, :k]
    v, sel = torch.sort(torch.cat(vals, dim=1), dim=1, descending=True,
                        stable=True)
    return v[:, :k], torch.gather(torch.cat(idxs, dim=1), 1, sel[:, :k])


def _pad_k(v, i, k: int):
    """A shard's list padded to k entries (-inf, index -1), so every
    shard sends the same shape; the merge ranks the pads last."""
    if v.shape[1] == k:
        return v, i
    pad = k - v.shape[1]
    return (torch.cat([v, v.new_full((v.shape[0], pad), -float("inf"))], 1),
            torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1))


class _Shard:
    """Rows [offset, offset + n) of the key set on one device: resident
    (`keys`), or on the host (`host`) and streamed in slabs of `slab`
    rows. int8 scales are always resident (4 bytes a row)."""

    def __init__(self, rows, scales, offset: int, device, slab=None):
        self.offset, self.n, self.device = offset, rows.shape[0], device
        self.slab = slab
        self.scales = (None if scales is None else
                       torch.from_numpy(np.ascontiguousarray(scales)).to(
                           device))
        self.keys = self.host = None
        if slab is None:
            self.keys = torch.from_numpy(np.ascontiguousarray(rows)).to(
                device)
        else:
            self.host = rows

    def slabs(self):
        """(start, stop, keys) of each slab, the keys on the device. On
        the card the next slab's copy runs on a copy stream from a pinned
        staging buffer while the caller searches the one yielded; the
        caller enqueues its search before asking for the next slab."""
        n, slab = self.n, self.slab
        bounds = [(s, min(s + slab, n)) for s in range(0, n, slab)]
        if self.device.type != "cuda":
            for s, e in bounds:
                yield s, e, torch.from_numpy(self.host[s:e])
            return
        dtype = torch.from_numpy(self.host[:1]).dtype
        d = self.host.shape[1]
        compute = torch.cuda.current_stream(self.device)
        copy = torch.cuda.Stream(self.device)
        stage = [torch.empty((slab, d), dtype=dtype, pin_memory=True)
                 for _ in range(2)]
        buf = [torch.empty((slab, d), dtype=dtype, device=self.device)
               for _ in range(2)]
        for t in buf:  # freed only once the copy stream is done with it
            t.record_stream(copy)
        copied, used = [None, None], [None, None]

        def put(j):
            b, (s, e) = j % 2, bounds[j]
            if copied[b] is not None:
                copied[b].synchronize()  # stage[b]'s last copy is done
            stage[b][:e - s].copy_(torch.from_numpy(self.host[s:e]))
            with torch.cuda.stream(copy):
                if used[b] is not None:  # the search still reading buf[b]
                    copy.wait_event(used[b])
                buf[b][:e - s].copy_(stage[b][:e - s], non_blocking=True)
                copied[b] = torch.cuda.Event()
                copied[b].record(copy)

        put(0)
        for j, (s, e) in enumerate(bounds):
            b = j % 2
            compute.wait_event(copied[b])
            yield s, e, buf[b][:e - s]
            used[b] = torch.cuda.Event()
            used[b].record(compute)
            if j + 1 < len(bounds):
                put(j + 1)  # overlaps the search just enqueued

    def search(self, queries, k: int, precision: str):
        """(values, global indices) (Bq, k) on the device, padded past the
        shard's rows. `queries`: chunks of fp32 queries, or of (int8 codes,
        scales), on the device."""
        parts = ([(0, self.n, self.keys)] if self.keys is not None
                 else self.slabs())
        best = None
        for s, e, keys in parts:
            if e == s:  # a shard past the last key
                continue
            kk = min(k, e - s)
            vs, is_ = [], []
            for qc in queries:
                if precision == "int8":
                    v, i = topk_i8(qc[0], qc[1], keys, self.scales[s:e],
                                   e - s, kk)
                else:
                    v, i = topk(qc, keys, e - s, kk, precision)
                vs.append(v)
                is_.append(i.to(torch.int64) + (self.offset + s))
            cur = (torch.cat(vs), torch.cat(is_))
            best = cur if best is None else merge_topk(
                [best[0], cur[0]], [best[1], cur[1]], k)
        if best is None:
            bq = sum((qc[0] if precision == "int8" else qc).shape[0]
                     for qc in queries)
            best = (torch.empty((bq, 0), device=self.device),
                    torch.empty((bq, 0), dtype=torch.int64,
                                device=self.device))
        return _pad_k(*best, k)


class PreparedKeys:
    """Key matrix normalized and placed once for repeated searches: one
    resident shard on `device`, or with `mesh` one shard per mesh entry of
    this process, each resident or streamed from the host
    (`max_device_keys`: the most keys of the whole set held on the
    devices at once, as in JAX; default the cards' budget, no limit on
    the CPU).

    `precision="int8"`: per-row int8 codes and fp32 scales (no tile
    padding: the kernel masks by the key count), and the host rows the
    rescore reads, in the `rescore` dtype: a numpy fp32 array, a CPU
    `torch.bfloat16` tensor (round to nearest even, the same values as an
    `ml_dtypes.bfloat16` array), or none."""

    def __init__(self, keys, device=None, precision: str = "high",
                 normalized: bool = False, mesh=None,
                 rescore: str = "float32", max_device_keys=None):
        if precision not in ("high", "highest", "default", "int8"):
            raise ValueError(f"unknown precision {precision!r}: the port "
                             "searches in fp32 ('high'; on the card the "
                             "six-product bf16 split), one bf16 pass "
                             "('default') or int8")
        if rescore not in RESCORE_MODES:
            raise ValueError(f"unknown rescore mode {rescore!r}")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: a parallel.mesh.Mesh, not {mesh!r}")
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else mesh.devices[0])
        self.precision = precision
        self.int8 = precision == "int8"
        self.rescore = rescore
        ks = np.asarray(keys, dtype=np.float32)
        if not normalized:
            ks = l2norm_np(ks)
        self.n_keys, self.d = ks.shape
        self.host_keys = None
        if self.int8:
            rows, scales = quantize_rows_i8(ks)
            scales = scales[:, 0]
            self.host_keys = self._rescore_rows(ks)
        else:
            rows, scales = ks, None
        size = 1 if mesh is None else mesh.size
        devices = [self.device] if mesh is None else list(mesh.devices)
        first = 0 if mesh is None else mesh.index
        per = -(-self.n_keys // size)  # JAX's shard_pad, without tiles
        self.shards = []
        for j, dev in enumerate(devices):
            lo = min((first + j) * per, self.n_keys)
            hi = min(lo + per, self.n_keys)
            limit = self._limit(dev, devices.count(dev), max_device_keys,
                                size, hi - lo)
            self.shards.append(_Shard(
                rows[lo:hi], None if scales is None else scales[lo:hi], lo,
                dev, slab=limit if hi - lo > (limit or hi - lo) else None))
        self.streaming = any(sh.slab is not None for sh in self.shards)

    def _limit(self, dev, sharing: int, max_device_keys, size: int, rows):
        """The slab of a shard of `rows` keys on `dev`, shared with
        `sharing` other shards: keys beyond it stream."""
        if max_device_keys is not None:
            return max(1, -(-int(max_device_keys) // size))
        if dev.type != "cuda":
            return None
        budget = device_budget_keys(self.d, dev,
                                    bytes_per_elem=1 if self.int8 else 4)
        budget //= sharing
        # streaming keeps two slabs resident
        return None if rows <= budget else max(1, budget // 2)

    def _rescore_rows(self, ks):
        """The host copy the int8 rescore reads: fp32 rows, bf16 rows (half
        the host memory), or none."""
        if self.rescore == "none":
            return None
        if self.rescore == "bfloat16":
            return torch.from_numpy(ks).to(torch.bfloat16)
        return ks

    def search(self, q, k: int):
        """Top-k of fp32 queries (Bq, D) over every shard -> (values
        (Bq, k) fp32, indices (Bq, k) int64), numpy, before any
        rescore."""
        lists = []
        if self.int8:
            q8, qsc = quantize_rows_i8(q)
            qsc = np.ascontiguousarray(qsc[:, 0])
        for sh in self.shards:
            chunks = []
            for s in range(0, q.shape[0], QUERY_CHUNK):
                if self.int8:
                    chunks.append((
                        torch.from_numpy(np.ascontiguousarray(
                            q8[s:s + QUERY_CHUNK])).to(sh.device),
                        torch.from_numpy(qsc[s:s + QUERY_CHUNK]).to(
                            sh.device)))
                else:
                    chunks.append(torch.from_numpy(np.ascontiguousarray(
                        q[s:s + QUERY_CHUNK])).to(sh.device))
            lists.append(sh.search(chunks, k, self.precision))
        if self.mesh is not None and self.mesh.group is not None:
            (v, i), = lists
            parts = [[torch.empty_like(t) for _ in range(self.mesh.size)]
                     for t in (v, i)]
            dist.all_gather(parts[0], v.contiguous(), group=self.mesh.group)
            dist.all_gather(parts[1], i.contiguous(), group=self.mesh.group)
            lists = list(zip(*parts))
        home = lists[0][0].device
        vals, idxs = merge_topk([v.to(home) for v, _ in lists],
                                [i.to(home) for _, i in lists], k)
        return vals.cpu().numpy(), idxs.cpu().numpy()


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
                rescore: str = "float32", max_device_keys=None):
    """Exact top-k inner-product search -> (similarities, indices), numpy
    (Bq, k): the FAISS `index.search` contract. `keys_feature` is a raw
    (N, D) array (searched as it is, not normalized; `mesh`, `precision`,
    `rescore` and `max_device_keys` then build its `PreparedKeys`) or a
    `PreparedKeys`.

    int8 keys: the kernel ranks an oversampled pool of
    min(N, max(4k, k + 16)) candidates (per shard and per slab, merged) by
    their quantized scores and the host rescores them in fp32
    (`rescore="none"`: the quantized ranking and scores are returned as
    they are)."""
    q = np.asarray(query_feature, dtype=np.float32)
    if isinstance(keys_feature, PreparedKeys):
        pk = keys_feature
    else:
        pk = PreparedKeys(keys_feature, device=device, normalized=True,
                          mesh=mesh, precision=precision, rescore=rescore,
                          max_device_keys=max_device_keys)
    k_eff = min(k, pk.n_keys)
    do_rescore = pk.int8 and pk.rescore != "none"
    k_search = (min(pk.n_keys, max(4 * k_eff, k_eff + 16)) if do_rescore
                else k_eff)
    vals, idxs = pk.search(q, k_search)
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
