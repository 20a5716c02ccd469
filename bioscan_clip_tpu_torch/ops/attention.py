"""Fused multi-head attention for the short-sequence towers: the forward,
with optional in-kernel probability dropout, and its backward.

Counterpart of bioscan_clip_tpu/ops/attention.py:
- `mha_packed` (:713, over `_pallas_mha_packed` :425): K1, ViT's packed qkv,
  and with an (N, N) additive score mask K1m (`_packed_mask_kernel` :162,
  OpenCLIP's causal text mask), counted apart in `mha_packed.mask_launches`;
- `mha` (:680, over `_pallas_mha_split` :449) without dropout: K2;
- `mha_dropout`, which `mha(..., dropout_rate > 0)` calls: K2d, the split
  forward with counter-hash probability dropout (`_split_drop_kernel` :195,
  `_split_bias_drop_kernel` :203, `_row_drop` :184); K1 (without a mask,
  33 <= N <= 272), K1m (8 <= N <= 160: below, the FFMA body measured
  faster), K2 and K2d (N <= 272, but for those of
  `SPLIT_MMA_FROM`) on bf16 at head dim 64 share one Hopper body,
  `csrc/mha_fwd_sm90.cu` (TMA and `wgmma`, by the plans of
  `plan_packed_fwd` and `plan_split_fwd`);
- `mha_bwd` (`_pallas_mha_bwd` :321, body `_attend_bwd_one_row` :212): K3,
  dq/dk/dv (+ dbias) with the probabilities and the dropout mask recomputed,
  and with an (N, N) score mask (`has_mask`, :363-367) K3m, the backward of
  K1m, counted apart in `mha_bwd.mask_launches`; on bf16 at head dim 64
  without a key bias, K3 at 33 <= N <= 272 and K3m (no dropout) at
  N <= 144 (but for `BWD_MASK_MMA_FROM`'s small N at large B) run
  `csrc/mha_bwd_sm90.cu` (TMA and `wgmma`, by the plan of `plan_bwd`),
  counted also in `mha_bwd.sm90_launches` and
  `mha_bwd.mask_sm90_launches`.

`mha_packed`, `mha` and `mha_dropout` call `torch.library` custom ops
(`bscan::mha_packed`, `bscan::mha`, `bscan::mha_dropout`) with a registered
backward, as the JAX ops are `jax.custom_vjp`s (:543-677): the forward is
K1/K1m/K2/K2d, the backward K3 or K3m. As ops of the dispatcher their
outputs are what a selective remat policy saves (`ATTENTION_OPS`, JAX's
`attn_ctx`). On a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/mha_fwd.cu`, `csrc/mha_bwd.cu`: bf16 on the tensor cores through
`mma.sync`, the forward above N = 32; fp32 in FFMA; K1, K2, K2d and K3 on
bf16 at head dim 64 and 33 <= N <= 272 (K2 and K2d from N = 1; K1m at
8 <= N <= 160, K3m at N <= 144) without a mask (but K1m and K3m) and
K3 without a key bias on `csrc/mha_fwd_sm90.cu` and
`csrc/mha_bwd_sm90.cu`, TMA and `wgmma`, by the plans of
`plan_packed_fwd`, `plan_split_fwd` and `plan_bwd`) or raises; on
a CPU tensor it runs its plain PyTorch version (`mha_reference`,
`mha_bwd_reference`), which has the same contract. The bf16 kernels read
q/k/v (and g) in 16-byte pieces, so those tensors must start 16-byte
aligned. Autograd never differentiates the plain forward: the CPU backward
is `mha_bwd_reference`, the function the card's K3/K3m is held against.

The dropout hash (`_mix32`, `dropout_keep_2d/4d`, :60-113) is uint32
arithmetic done in int64 tensors and masked to 32 bits; seeds are Python
ints or int64 tensors holding uint32 values.

Each wrapper counts its kernel launches in `<wrapper>.launches` (those on
the Hopper bodies also in `<wrapper>.sm90_launches`: `mha_packed`, `mha`,
`mha_dropout`, `mha_bwd`; K2's and K2d's on the mma.sync body in
`<wrapper>.mma_launches`); K1m's in `mha_packed.mask_launches` and K3m's in
`mha_bwd.mask_launches`, those on the Hopper bodies also in
`mha_packed.mask_sm90_launches` and `mha_bwd.mask_sm90_launches`; the plain
versions count their calls in `<function>.calls`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.ops._device import H100_SMS, sm_count
from bioscan_clip_tpu_torch.ops._launch import launch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_M32 = 0xFFFFFFFF


# --- the counter hash and the dropout masks (JAX attention.py:60-113) -----

def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the constant is split
    into 16-bit halves, so no partial product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """uint32 avalanche mix (murmur3 finalizer), as JAX `_mix32`."""
    x = x & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _keep_threshold(rate: float) -> int:
    """uint32 threshold: u >= thresh keeps the element (P(keep) = 1-rate)."""
    return min(int(rate * 2.0**32), 2**32 - 1)


def keep_scale(rate: float) -> float:
    """The scale of a kept element, rounded as JAX rounds it:
    float32(1) / float32(1.0 - rate), with 1.0 - rate in double."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def u32(x, device=None):
    """A uint32 value (or array) as an int64 tensor on `device`."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64) & _M32
    return torch.as_tensor(np.asarray(x, dtype=np.int64) & _M32,
                           device=device)


def _keep_from_hash(u, rate: float):
    return (u >= _keep_threshold(rate)).to(torch.float32) * keep_scale(rate)


def dropout_keep_2d(seed, b_idx, head, n: int, rate: float, heads: int,
                    device=None):
    """(N, N) fp32 keep/scale mask of one (batch row, head): element (i, j)
    keeps when _mix32(seed ^ _mix32(((b*heads + head)*N + i)*N + j)) >=
    threshold. Row-keyed mode passes the row's own seed and b_idx=0."""
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    idx = (((int(b_idx) * heads + int(head)) * n + i) * n + j) & _M32
    return _keep_from_hash(_mix32(u32(seed, device) ^ _mix32(idx)), rate)


def dropout_keep_4d(seed, batch: int, heads: int, n: int, rate: float,
                    device=None):
    """(B, heads, N, N) fp32 mask with the formula of dropout_keep_2d.
    A scalar seed keys the counter with the batch index; a (B,) seed vector
    is row-keyed (no batch term: row b's mask depends on seed[b] only)."""
    seed = u32(seed, device)
    h = torch.arange(heads, device=device)[:, None, None]
    i = torch.arange(n, device=device)[None, :, None]
    j = torch.arange(n, device=device)[None, None, :]
    if seed.ndim == 1:
        idx = ((h * n + i) * n + j) & _M32
        u = _mix32(seed[:, None, None, None] ^ _mix32(idx)[None])
    else:
        b = torch.arange(batch, device=device)[:, None, None, None]
        idx = (((b * heads + h) * n + i) * n + j) & _M32
        u = _mix32(seed ^ _mix32(idx))
    return _keep_from_hash(u, rate)


# --- plain versions -------------------------------------------------------

def _heads_view(t, heads):
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).float()


def _scores(qh, kh, scale, bias, mask):
    """fp32 scores (B, h, N, N): q . k * scale, then the (B, N) key bias,
    then the (N, N) score mask (JAX `_attend_bwd_one_row` :231-238)."""
    s = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    if mask is not None:
        s = s + mask.float()
    return s


def mha_reference(q, k, v, heads: int, bias=None, scale=None,
                  dropout_rate: float = 0.0, dropout_seed=None, mask=None):
    """Plain attention over (B, N, D) q/k/v (heads-major in D), optional
    (B, N) additive key bias, (N, N) additive score mask and probability
    dropout: fp32 softmax, p times the keep/scale mask, p rounded to v's
    dtype before P.V, output in q's dtype (JAX `_attend_one_row`
    :116-150)."""
    mha_reference.calls += 1
    b, n, d = q.shape
    if scale is None:
        scale = (d // heads) ** -0.5
    s = _scores(_heads_view(q, heads), _heads_view(k, heads), scale, bias,
                mask)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0:
        p = p * dropout_keep_4d(dropout_seed, b, heads, n, dropout_rate,
                                q.device)
    p = p.to(v.dtype).float()
    o = torch.einsum("bhnm,bmhd->bnhd", p, _heads_view(v, heads))
    return o.reshape(b, n, d).to(q.dtype)


mha_reference.calls = 0


def mha_bwd_reference(q, k, v, g, heads: int, bias=None, scale=None,
                      dropout_rate: float = 0.0, dropout_seed=None,
                      mask=None):
    """Plain backward of `mha_reference`, the K3 contract
    (`_attend_bwd_one_row` :212-271): p and dp stay fp32, y = p * keep
    is cast to g's dtype for dv, ds * scale is cast to q's dtype for dq and
    dk. Returns (dq, dk, dv, dbias), dbias the fp32 sum of ds over heads
    and query rows (None without a bias). With `mask` it is the K3m
    contract, the function that kernel is held against."""
    mha_bwd_reference.calls += 1
    b, n, d = q.shape
    if scale is None:
        scale = (d // heads) ** -0.5
    qh, kh, vh, gh = (_heads_view(t, heads) for t in (q, k, v, g))
    p = torch.softmax(_scores(qh, kh, scale, bias, mask), dim=-1)
    dp = torch.einsum("bnhd,bmhd->bhnm", gh, vh)
    y = p
    if dropout_rate > 0:
        keep = dropout_keep_4d(dropout_seed, b, heads, n, dropout_rate,
                               q.device)
        y = p * keep
        dp = dp * keep
    dv = torch.einsum("bhnm,bnhd->bmhd", y.to(g.dtype).float(), gh)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = (ds * scale).to(q.dtype).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", dsc, kh)
    dk = torch.einsum("bhnm,bnhd->bmhd", dsc, qh)
    dbias = None if bias is None else ds.sum(dim=(1, 2))
    return (dq.reshape(b, n, d).to(q.dtype), dk.reshape(b, n, d).to(q.dtype),
            dv.reshape(b, n, d).to(q.dtype), dbias)


mha_bwd_reference.calls = 0


# --- the kernels ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    lib = _build.load("mha_fwd")
    fn = lib.bscan_mha_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    smem = lib.bscan_mha_fwd_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    return lib, fn, smem


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    lib = _build.load("mha_bwd")
    fn = lib.bscan_mha_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
        + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    smem = lib.bscan_mha_bwd_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    return lib, fn, smem


def sm90_entry(lib):
    """(lib, its `bscan_mha_fwd_sm90` with argtypes set): the C entry of a
    library built from `csrc/mha_fwd_sm90.cu` (or a variant of it)."""
    fn = lib.bscan_mha_fwd_sm90
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float] + [ctypes.c_int] * 5
        + [ctypes.c_float] + [ctypes.c_int] * 6
        + [ctypes.c_longlong, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sm90_kernel():
    return sm90_entry(_build.load("mha_fwd_sm90"))


def bwd_sm90_entry(lib):
    """(lib, its `bscan_mha_bwd_sm90` with argtypes set): the C entry of a
    library built from `csrc/mha_bwd_sm90.cu` (or a variant of it)."""
    fn = lib.bscan_mha_bwd_sm90
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float]
        + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
           ctypes.c_int] + [ctypes.c_void_p] * 3
    )
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _bwd_sm90_kernel():
    return bwd_sm90_entry(_build.load("mha_bwd_sm90"))


# --- the forward's plan on the Hopper body (csrc/mha_fwd_sm90.cu,
# `make_plan`): K1 and K1m (`plan_packed_fwd`), K2 and K2d
# (`plan_split_fwd`) ------

SM90_HEAD_DIM = 64
SM90_MIN_N, SM90_MAX_N = 33, 272  # K1's range
# K1m's plan on the sm90 body: up to `kMaxMaskN` (its two consumers' 64 mask
# rows of pad16(N) + 8 fp32 beside the stages fit a block's 227 KB up to
# here), from the least N where the body beat the FFMA body of
# csrc/mha_fwd.cu at every B measured (tools/sweep_k1_sm90.py --crossing,
# D = 768 and 12 heads, B = 1-512, N = 1-160; H100 at 700 W; PERF.md
# section 6): below it one 64-row query tile of 16 key rows does more than
# the FFMA body's few scores, FFMA 1.0-1.4x faster at N = 1-4 and, at the
# launch floor's ~4 us, at N = 5-7 at some B; from N = 8 the sm90 body won
# at every B in three runs (0.11-0.94x).
SM90_MASK_MIN_N, SM90_MASK_MAX_N = 8, 160
# the body's least N (16 key rows), where K2/K2d's range starts: BERT-small's
# N = 20 ran 2.8x (K2, B=256 + bias) and 2.2x (K2d, B=400 + bias) faster
# on it than on the FFMA body, N = 16 2.4x and 2.0x (H100 at 700 W,
# tools/bench_k2.py; PERF.md section 6)
SM90_BODY_MIN_N = 1
_TMA_MAX_BOX = 256          # TMA's largest box dimension
_TILE_ROWS = 64             # wgmma M: the query rows of a consumer
_CONSUMERS = 2              # consumer warpgroups a CTA, one query tile each
_ROW_BYTES = 2 * SM90_HEAD_DIM
_TILE_BYTES = _TILE_ROWS * _ROW_BYTES
_STAGES = 2
_ALIGN, _BARRIER_BYTES = 1024, 64


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How `mha_packed`, `mha` or `mha_dropout` runs (B, N, heads,
    head_dim) on the card.

    `body` is "sm90" (`csrc/mha_fwd_sm90.cu`: bf16, head dim 64; packed
    without a mask (K1) at 33 <= N <= 272, with an (N, N) mask (K1m) at
    1 <= N <= 160 (the plan's from N = 8), split at 1 <= N <= 272),
    "mma" (the bf16 `mma.sync` body of `csrc/mha_fwd.cu`) or "ffma" (its
    fp32 body, also bf16 at N <= 32). The other fields describe the sm90
    launch and are 0 for the other bodies: keys padded to 16
    (`key_rows`), loaded in `kv_loads` TMA boxes of `kv_box` rows per
    tensor; `q_tiles` 64-row query tiles; `items` work items (batch row,
    head, pair of query tiles: one tile per consumer warpgroup; item =
    (b * heads + h) * pairs + pair), CTA c taking items c, c + grid, ...;
    `smem` bytes of dynamic shared memory a CTA (with a key bias, each
    consumer's staged bias row besides; with a mask, each consumer's 64
    staged mask rows of `key_rows` + 8 fp32)."""

    body: str
    b: int
    n: int
    heads: int
    key_rows: int = 0
    kv_box: int = 0
    kv_loads: int = 0
    q_tiles: int = 0
    items: int = 0
    grid: int = 0
    smem: int = 0


def mask_rows_bytes(key_rows: int) -> int:
    """A consumer's staged mask rows on the sm90 body: 64 rows of
    `key_rows` + 8 fp32 (the padding keeps a quad's float2 reads of rows g
    and g + 2 in other banks; `mask_bytes` in the source)."""
    return _TILE_ROWS * (key_rows + 8) * 4


def sm90_fwd_plan(b: int, n: int, heads: int, biased: bool = False,
                  sms: int = H100_SMS, masked: bool = False) -> FwdPlan:
    """The sm90 body's launch at (B, N, heads), for any N it takes
    (SM90_BODY_MIN_N <= N <= 272; with `masked` up to SM90_MASK_MAX_N);
    `biased`: a (B, N) key bias is staged, `masked`: an (N, N) score mask
    (never both). `plan_packed_fwd` and `plan_split_fwd` choose where it
    runs."""
    top = SM90_MASK_MAX_N if masked else SM90_MAX_N
    if not SM90_BODY_MIN_N <= n <= top:
        raise ValueError(f"the sm90 forward takes {SM90_BODY_MIN_N} <= N <= "
                         f"{top}{' with a mask' if masked else ''}, not {n}")
    if biased and masked:
        raise ValueError("the sm90 forward takes a key bias or a score "
                         "mask, not both")
    key_rows = -(-n // 16) * 16
    kv_loads = 1 if key_rows <= _TMA_MAX_BOX else 2
    q_tiles = -(-n // _TILE_ROWS)
    items = b * heads * -(-q_tiles // _CONSUMERS)
    stage = _CONSUMERS * _TILE_BYTES + 2 * key_rows * _ROW_BYTES
    extra = (_CONSUMERS * 4 * key_rows if biased
             else _CONSUMERS * mask_rows_bytes(key_rows) if masked else 0)
    smem = (_ALIGN + _STAGES * stage + _CONSUMERS * _TILE_BYTES
            + _BARRIER_BYTES + extra)
    return FwdPlan("sm90", b, n, heads, key_rows, key_rows // kv_loads,
                   kv_loads, q_tiles, items, min(items, sms), smem)


def _other_body(b, n, heads, dtype) -> FwdPlan:
    return FwdPlan("mma" if dtype == torch.bfloat16 and n > 32 else "ffma",
                   b, n, heads)


def plan_packed_fwd(b: int, n: int, heads: int, hd: int,
                    dtype=torch.bfloat16, masked: bool = False,
                    sms: int = H100_SMS) -> FwdPlan:
    """The body and launch of `mha_packed` at (B, N, heads, head dim): for
    bf16 at head dim 64 the sm90 body without a mask (K1) at 33 <= N <=
    272, and with an (N, N) mask (K1m) at SM90_MASK_MIN_N <= N <=
    SM90_MASK_MAX_N; else the bodies of `csrc/mha_fwd.cu` ("mma" for bf16
    above N = 32, "ffma" otherwise).
    `sms`: the card's SM count, the most persistent CTAs."""
    if dtype == torch.bfloat16 and hd == SM90_HEAD_DIM:
        if not masked and SM90_MIN_N <= n <= SM90_MAX_N:
            return sm90_fwd_plan(b, n, heads, sms=sms)
        if masked and SM90_MASK_MIN_N <= n <= SM90_MASK_MAX_N:
            return sm90_fwd_plan(b, n, heads, sms=sms, masked=True)
    return _other_body(b, n, heads, dtype)


# Where the mma.sync body of csrc/mha_fwd.cu beat the sm90 body on split
# q/k/v: (least N, largest N, biased, dropout, least B * heads), the mma.sync
# body faster (by 1-25%) at that B * heads and at every larger one measured,
# for every measured N of the range (tools/sweep_k2_sm90.py --crossing,
# D = 768 and 12 heads, B = 10-512, N = 33-272; H100 at 700 W; PERF.md
# section 6). There the sm90 body pads 33-40 keys with a bias to 48 key
# rows, or K2d's keep-bit hash, in the consumers alone, outweighs what the
# products gain: K2d at BarcodeBERT's N = 133 from B = 256 (1.03-1.12x).
SPLIT_MMA_FROM = ((33, 33, True, False, 128 * 12),
                  (34, 40, True, False, 256 * 12),
                  (33, 33, True, True, 256 * 12),
                  (34, 40, True, True, 400 * 12),
                  (129, 144, False, True, 256 * 12))


def plan_split_fwd(b: int, n: int, heads: int, hd: int,
                   dtype=torch.bfloat16, biased: bool = False,
                   dropout: bool = False, sms: int = H100_SMS) -> FwdPlan:
    """The body and launch of `mha` (K2) and `mha_dropout` (K2d, with
    `dropout`) over split q, k, v at (B, N, heads, head dim), with a (B,
    N) key bias when `biased`: for bf16 at head dim 64 and N <= 272 the
    sm90 body, but the mma.sync body where `SPLIT_MMA_FROM` measured it
    faster; else the bodies of `csrc/mha_fwd.cu` ("mma" for bf16 above
    N = 32, "ffma" otherwise)."""
    if (dtype == torch.bfloat16 and hd == SM90_HEAD_DIM
            and SM90_BODY_MIN_N <= n <= SM90_MAX_N
            and not any(lo <= n <= hi and bias == biased and drop == dropout
                        and b * heads >= rows
                        for lo, hi, bias, drop, rows in SPLIT_MMA_FROM)):
        return sm90_fwd_plan(b, n, heads, biased, sms)
    return _other_body(b, n, heads, dtype)


# --- K3's plan on the Hopper body (csrc/mha_bwd_sm90.cu, `make_plan`) ----

BWD_SM90_MIN_N, BWD_SM90_MAX_N = 33, 272
# K3m's plan on the sm90 body: up to `kMaxMaskN` (each pass's two consumers'
# 64 mask rows or columns of pad16(N) + 8 fp32 beside the stages fit a
# block's 227 KB up to here; pass A at N = 160 would need 234,560 B), from
# the body's least N (16 key rows), but for `BWD_MASK_MMA_FROM`
BWD_SM90_MASK_MIN_N, BWD_SM90_MASK_MAX_N = 1, 144
# Where the mma.sync passes of csrc/mha_bwd.cu beat K3m's sm90 body: (least
# N, largest N, least B * heads), the mma.sync body faster at that B * heads
# and at every larger one measured for some N of the range
# (tools/sweep_k3_sm90.py --mask, causal mask, D = 768 and 12 heads,
# B = 10-400, N = 1-144 as CUDA graph replays in two rounds; H100 at 700 W;
# PERF.md section 6). Every cell left on the sm90 body measured faster or
# within 2% (the 90th percentile of the spread between a cell's two
# rounds). There a head's one 64-row tile leaves an item's second consumer
# idle and a CTA walks more than one item once B * heads passes the 132
# SMs, while the mma.sync passes run a CTA of a few warps for each (batch
# row, head), many to an SM: at B = 64, N = 20 0.0288 ms against 0.0219;
# from N = 31 up the sm90 body is no slower at every B measured (1.3-5x
# faster from N = 33), and at the training path's B = 10 it is faster at
# every N.
BWD_MASK_MMA_FROM = ((1, 12, 12 * 12), (13, 16, 24 * 12), (17, 24, 40 * 12),
                     (25, 28, 48 * 12), (29, 30, 56 * 12))
_BWD_THREADS = 128 * _CONSUMERS  # two warpgroups; thread 0 also loads
_STATS = 3                               # m, 1 / l, D of every query row


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How `mha_bwd` runs (B, N, heads, head_dim) on the card.

    `body` is "sm90" (`csrc/mha_bwd_sm90.cu`: bf16, head dim 64, no key
    bias; without a mask (K3) at 33 <= N <= 272, with an (N, N) mask (K3m,
    no dropout) at 1 <= N <= 144), "mma" (the bf16
    `mma.sync` passes of `csrc/mha_bwd.cu`) or "ffma" (its fp32 passes).
    The other fields describe the sm90 launches and are 0 for the other
    bodies: N padded to 16 (`key_rows`: K_h and V_h in pass A, Q_h and G_h
    in pass B), loaded in `loads` TMA boxes of `box` rows per tensor;
    `tiles` 64-row tiles (query tiles in pass A, key tiles in pass B);
    `rows` = 64 * tiles, the rows of the (B, heads, 3, rows) statistics;
    `items` work items of either pass (batch row, head, pair of tiles: one
    tile per consumer warpgroup; item = (b * heads + h) * pairs + pair), CTA
    c taking items c, c + grid, ...; `threads` a CTA's; `smem_a`, `smem_b`
    each pass's dynamic shared memory a CTA (with a mask, each consumer's 64
    staged mask rows (pass A) or columns (pass B) of `key_rows` + 8 fp32
    besides)."""

    body: str
    b: int
    n: int
    heads: int
    key_rows: int = 0
    box: int = 0
    loads: int = 0
    tiles: int = 0
    rows: int = 0
    items: int = 0
    grid_a: int = 0
    grid_b: int = 0
    threads: int = 0
    smem_a: int = 0
    smem_b: int = 0


def bwd_sm90_plan(b: int, n: int, heads: int, masked: bool = False,
                  sms: int = H100_SMS) -> BwdPlan:
    """The sm90 body's launches at (B, N, heads), for any N it takes
    (BWD_SM90_MIN_N <= N <= BWD_SM90_MAX_N; with `masked`, an (N, N) score
    mask, 1 <= N <= BWD_SM90_MASK_MAX_N). `plan_bwd` chooses where it
    runs."""
    lo, hi = (1, BWD_SM90_MASK_MAX_N) if masked else (BWD_SM90_MIN_N,
                                                      BWD_SM90_MAX_N)
    if not lo <= n <= hi:
        raise ValueError(f"the sm90 backward takes {lo} <= N <= {hi}"
                         f"{' with a mask' if masked else ''}, not {n}")
    key_rows = -(-n // 16) * 16
    loads = 1 if key_rows <= _TMA_MAX_BOX else 2
    tiles = -(-n // _TILE_ROWS)
    rows = tiles * _TILE_ROWS
    items = b * heads * -(-tiles // _CONSUMERS)
    tiles_bytes = 2 * _CONSUMERS * _TILE_BYTES + 2 * key_rows * _ROW_BYTES
    stage_b = -(-(tiles_bytes + _STATS * rows * 4) // _ALIGN) * _ALIGN
    extra = _CONSUMERS * mask_rows_bytes(key_rows) if masked else 0
    grid = min(items, sms)
    return BwdPlan(
        "sm90", b, n, heads, key_rows, key_rows // loads, loads, tiles, rows,
        items, grid, grid, _BWD_THREADS,
        _ALIGN + _STAGES * tiles_bytes + _BARRIER_BYTES + extra,
        _ALIGN + _STAGES * stage_b + _BARRIER_BYTES + extra)


def plan_bwd(b: int, n: int, heads: int, hd: int, dtype=torch.bfloat16,
             packed: bool = True, masked: bool = False, biased: bool = False,
             need_dbias: bool = False, sms: int = H100_SMS, *,
             dropout: bool = False) -> BwdPlan:
    """The body and launches of `mha_bwd` at (B, N, heads, head dim): the
    sm90 body for bf16 at head dim 64 without a key bias or its gradient,
    in either layout (`packed` qkv or split q/k/v), at 33 <= N <= 272
    without a score mask (K3, with or without `dropout`) and at
    BWD_SM90_MASK_MIN_N <= N <= BWD_SM90_MASK_MAX_N with one (K3m, without
    dropout), but where `BWD_MASK_MMA_FROM` measured the mma.sync body
    faster; else the passes of `csrc/mha_bwd.cu` ("mma" for bf16, "ffma"
    for fp32). `sms`: the card's SM count, the most persistent CTAs of each
    pass."""
    del packed  # both layouts take the same plan
    if (dtype == torch.bfloat16 and hd == SM90_HEAD_DIM and not biased
            and not need_dbias):
        if not masked and BWD_SM90_MIN_N <= n <= BWD_SM90_MAX_N:
            return bwd_sm90_plan(b, n, heads, sms=sms)
        if (masked and not dropout
                and BWD_SM90_MASK_MIN_N <= n <= BWD_SM90_MASK_MAX_N
                and not any(lo <= n <= hi and b * heads >= rows
                            for lo, hi, rows in BWD_MASK_MMA_FROM)):
            return bwd_sm90_plan(b, n, heads, masked=True, sms=sms)
    return BwdPlan("mma" if dtype == torch.bfloat16 else "ffma", b, n, heads)


def _launch_sm90(ptrs, out, row_stride, plan: FwdPlan, scale, bias=None,
                 drop=None, kernel=None, mask=None):
    """The forward on the sm90 body under `plan`: `ptrs` the addresses of
    q, k and v (rows `row_stride` elements apart), `drop` `_drop_args`'
    tuple (None: no dropout), `kernel` (lib, fn) of `sm90_entry` (default:
    this package's library), `mask` the (N, N) fp32 score mask (K1m)."""
    lib, fn = kernel or _sm90_kernel()
    dev = out.device
    _check_smem("mha sm90", plan.smem, plan.n, SM90_HEAD_DIM, dev)
    rows, scalar, thr, kscale, on = drop or _NO_DROP
    launch(lib, fn, "mha sm90 launch", out, *ptrs, out.data_ptr(),
           row_stride, None if bias is None else bias.data_ptr(),
           None if mask is None else mask.data_ptr(),
           None if rows is None else rows.data_ptr(), scalar, thr, kscale,
           on, plan.b, plan.n, plan.heads, SM90_HEAD_DIM, float(scale),
           plan.key_rows, plan.kv_box, plan.kv_loads, plan.q_tiles,
           plan.items, plan.grid, plan.smem)


@functools.lru_cache(maxsize=None)
def _max_smem(device_index: int) -> int:
    lib = _build.load("mha_fwd")
    limit = lib.bscan_max_smem_per_block
    limit.argtypes = [ctypes.c_int]
    limit.restype = ctypes.c_longlong
    return limit(device_index)


def _check_smem(name, need, n, hd, dev):
    """Raise unless a CTA's `need` bytes of shared memory fit the card."""
    if n > 65535 or n < 1:
        raise ValueError(f"{name}: sequence length {n} out of range")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    limit = _max_smem(idx)
    if need > limit:
        raise ValueError(
            f"{name}: N={n}, head_dim={hd} needs {need} bytes of shared "
            f"memory per block; this card allows {limit}"
        )


def _launch_bwd_sm90(plan: BwdPlan, q, k, v, g, scale, drop,
                     packed_qkv=None, scores=(None, None), mask=None):
    """Both passes of K3's sm90 body (K3m with `mask`, the (N, N) fp32
    score mask, under a masked plan); returns dqkv (packed) or (dq, dk,
    dv). `drop`: `_drop_args`' tuple; `scores`: the read-out pointers."""
    lib, fn = _bwd_sm90_kernel()
    dev = g.device
    _check_smem("mha_bwd", max(plan.smem_a, plan.smem_b), plan.n,
                SM90_HEAD_DIM, dev)
    if packed_qkv is not None:
        dqkv = torch.empty_like(packed_qkv)
        ins = (packed_qkv.data_ptr(),) * 3
        outs = (dqkv.data_ptr(),) * 3
    else:
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    stats = torch.empty((plan.b, plan.heads, _STATS, plan.rows),
                        dtype=torch.float32, device=dev)
    rows, scalar, thr, kscale, on = drop
    launch(lib, fn, "mha_bwd sm90 launch", g,
           *ins, g.data_ptr(), None if mask is None else mask.data_ptr(),
           *outs, stats.data_ptr(), plan.b, plan.n, plan.heads,
           SM90_HEAD_DIM, int(packed_qkv is not None), float(scale),
           plan.key_rows, plan.box, plan.loads, plan.tiles, plan.rows,
           plan.items, plan.grid_a, plan.grid_b, plan.smem_a, plan.smem_b,
           None if rows is None else rows.data_ptr(), scalar, thr, kscale,
           on, *scores)
    return dqkv if packed_qkv is not None else (dq, dk, dv)


def bwd_sm90_scores(qkv, g, heads: int, scale=None, mask=None):
    """Test read-out of K3's sm90 body on a packed bf16 qkv at head dim 64,
    without dropout, at 193 <= N <= 208, or with an (N, N) fp32 score `mask`
    (K3m) at 17 <= N <= 32 or 65 <= N <= 80: (s_a, s_b, dqkv), s_a and s_b
    the (B, heads, N, N) fp32 scores q . k * scale (+ mask) as pass A (q in
    wgmma's A role) and pass B (k in the A role) formed them. Not counted
    in `mha_bwd`'s launches."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    if scale is None:
        scale = (d // heads) ** -0.5
    _check_cuda("bwd_sm90_scores", [qkv, g], torch.bfloat16)
    _check_aligned("bwd_sm90_scores", [qkv, g])
    plan = plan_bwd(b, n, heads, d // heads, qkv.dtype,
                    masked=mask is not None)
    if plan.body != "sm90":
        raise ValueError(f"bwd_sm90_scores: (B={b}, N={n}) is not on the "
                         "sm90 body")
    s_a, s_b = (torch.full((b, heads, n, n), float("nan"),
                           device=qkv.device) for _ in range(2))
    dqkv = _launch_bwd_sm90(plan, None, None, None, g, scale, _NO_DROP, qkv,
                            (s_a.data_ptr(), s_b.data_ptr()), mask)
    return s_a, s_b, dqkv


def _launch_bwd(q, k, v, g, heads, scale, drop, packed_qkv=None, bias=None,
                need_dbias=False, mask=None):
    """K3/K3m on the passes of `csrc/mha_bwd.cu` (bf16 `mma.sync`, fp32
    FFMA) at any shape they take; returns dqkv (packed) or (dq, dk, dv,
    dbias)."""
    b, n, d = q.shape
    if b > 65535:
        raise ValueError(f"mha_bwd: batch {b} > 65535; split the batch")
    lib, fn, smem = _bwd_kernel()
    dev = q.device
    _check_smem("mha_bwd", smem(n, d // heads, _DTYPE_CODE[q.dtype]), n,
                d // heads, dev)
    es = q.element_size()
    if packed_qkv is not None:
        p = packed_qkv.data_ptr()
        ins = (p, p + d * es, p + 2 * d * es)
        dqkv = torch.empty_like(packed_qkv)
        o = dqkv.data_ptr()
        outs = (o, o + d * es, o + 2 * d * es)
        row = 3 * d
    else:
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        row = d
    stats = torch.empty((b, heads, n, 3), dtype=torch.float32, device=dev)
    dbias = part = None
    if need_dbias and bias is not None:
        dbias = torch.empty((b, n), dtype=torch.float32, device=dev)
        part = torch.empty((b, heads, n), dtype=torch.float32, device=dev)
    rows, scalar, thr, kscale, on = drop
    launch(lib, fn, "mha_bwd launch", q,
           *ins, g.data_ptr(), None if bias is None else bias.data_ptr(),
           None if mask is None else mask.data_ptr(), *outs,
           None if dbias is None else dbias.data_ptr(), stats.data_ptr(),
           None if part is None else part.data_ptr(),
           b, n, heads, d // heads, row, n * row, row, n * row,
           float(scale), _DTYPE_CODE[q.dtype],
           None if rows is None else rows.data_ptr(), scalar, thr, kscale,
           on)
    return dqkv if packed_qkv is not None else (dq, dk, dv, dbias)


def _check_aligned(name, tensors):
    """The bf16 kernels stage rows in 16-byte pieces: raise unless every
    tensor starts 16-byte aligned (rows of D >= 32 bf16 then are too)."""
    for t in tensors:
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: bf16 inputs must start 16-byte "
                             "aligned")


_NO_DROP = (None, 0, 0, 1.0, 0)


def _drop_args(rate: float, seed, b: int, dev):
    """(row_seeds pointer holder, scalar seed, threshold, scale, drop flag)
    for a kernel launch: a (B,) seed tensor goes as int32 bits on the card;
    a scalar goes by value."""
    if rate <= 0:
        return _NO_DROP
    seed = u32(seed)
    if torch.cuda.is_current_stream_capturing() and (
            seed.ndim == 0 or seed.device != dev):
        raise RuntimeError(
            "attention dropout inside a CUDA graph's capture takes (B,) row "
            "seeds on the card: a host or scalar seed would be read once, "
            "at capture, and replayed unchanged")
    rows = None
    scalar = 0
    if seed.ndim == 1:
        if seed.shape[0] != b:
            raise ValueError(f"dropout seed vector has {seed.shape[0]} rows, "
                             f"the batch {b}")
        rows = torch.where(seed >= 2**31, seed - 2**32, seed).to(
            device=dev, dtype=torch.int32).contiguous()
    elif seed.ndim == 0:
        scalar = int(seed)
    else:
        raise ValueError("dropout seed must be a scalar or a (B,) vector")
    return rows, scalar, _keep_threshold(rate), keep_scale(rate), 1


def _launch_fwd(ptrs, out, b, n, heads, hd, row_stride, scale, dtype, bias,
                rate=0.0, seed=None, mask=None):
    if b > 65535:  # the batch is the grid's z dimension
        raise ValueError(f"mha kernel: batch {b} > 65535; split the batch")
    lib, fn, smem = _fwd_kernel()
    dev = out.device
    _check_smem("mha kernel", smem(n, hd, _DTYPE_CODE[dtype]), n, hd, dev)
    rows, scalar, thr, kscale, drop = _drop_args(rate, seed, b, dev)
    launch(lib, fn, "mha_fwd launch", out,
           *ptrs, None if bias is None else bias.data_ptr(),
           None if mask is None else mask.data_ptr(), out.data_ptr(),
           b, n, heads, hd, row_stride, n * row_stride, float(scale),
           _DTYPE_CODE[dtype],
           None if rows is None else rows.data_ptr(), scalar, thr, kscale,
           drop)


def _check_cuda(name, tensors, dtype):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_heads(name, d, heads, dtype):
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} (kernel takes fp32, bf16)")
    if d % heads:
        raise ValueError(f"{name}: width {d} not divisible by {heads} heads")
    if d // heads not in _HEAD_DIMS:
        raise ValueError(
            f"{name}: head dim {d // heads} (kernel takes {_HEAD_DIMS})"
        )


def _check_split(name, q, k, v, bias):
    b, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q/k/v shapes differ: {q.shape} {k.shape} "
                         f"{v.shape}")
    _check_cuda(name, [q, k, v], q.dtype)
    if bias is not None:
        _check_cuda(f"{name} bias", [bias], torch.float32)
        if bias.device != q.device or tuple(bias.shape) != (b, n):
            raise ValueError(f"{name}: bias must be ({b}, {n}) on {q.device}")


def _packed_forward(qkv, mask, heads, scale):
    d = qkv.shape[-1] // 3
    if qkv.device.type == "cpu":
        return mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                             qkv[..., 2 * d :], heads, scale=scale, mask=mask)
    _check_heads("mha_packed", d, heads, qkv.dtype)
    _check_cuda("mha_packed", [qkv], qkv.dtype)
    _check_aligned("mha_packed", [qkv])
    b, n, d3 = qkv.shape
    if mask is not None:
        _check_cuda("mha_packed mask", [mask], torch.float32)
        if mask.device != qkv.device or tuple(mask.shape) != (n, n):
            raise ValueError(f"mha_packed: mask must be ({n}, {n}) on "
                             f"{qkv.device}")
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    idx = (qkv.device.index if qkv.device.index is not None
           else torch.cuda.current_device())
    plan = plan_packed_fwd(b, n, heads, d // heads, qkv.dtype,
                           mask is not None, sm_count(idx))
    p = qkv.data_ptr()
    ptrs = (p, p + d * qkv.element_size(), p + 2 * d * qkv.element_size())
    if plan.body == "sm90":
        _launch_sm90(ptrs, out, d3, plan, scale, mask=mask)
    else:
        _launch_fwd(ptrs, out, b, n, heads, d // heads, d3, scale, qkv.dtype,
                    None, mask=mask)
    if mask is None:
        mha_packed.launches += 1
        mha_packed.sm90_launches += int(plan.body == "sm90")
    else:
        mha_packed.mask_launches += 1
        mha_packed.mask_sm90_launches += int(plan.body == "sm90")
    return out


def _split_forward(q, k, v, bias, seed, heads, scale, rate):
    if q.device.type == "cpu":
        return mha_reference(q, k, v, heads, bias=bias, scale=scale,
                             dropout_rate=rate, dropout_seed=seed)
    name = "mha_dropout" if rate > 0 else "mha"
    b, n, d = q.shape
    _check_heads(name, d, heads, q.dtype)
    _check_split(name, q, k, v, bias)
    _check_aligned(name, [q, k, v])
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    idx = (q.device.index if q.device.index is not None
           else torch.cuda.current_device())
    plan = plan_split_fwd(b, n, heads, d // heads, q.dtype, bias is not None,
                          rate > 0, sm_count(idx))
    counter = mha_dropout if rate > 0 else mha
    if plan.body == "sm90":
        _launch_sm90(ptrs, out, d, plan, scale, bias,
                     _drop_args(rate, seed, b, q.device))
        counter.sm90_launches += 1
    else:
        _launch_fwd(ptrs, out, b, n, heads, d // heads, d, scale, q.dtype,
                    bias, rate, seed)
        counter.mma_launches += int(plan.body == "mma")
    counter.launches += 1
    return out


# The forwards are `torch.library` custom ops, so autograd and a selective
# checkpoint policy see each attention as one op whose output can be saved
# (JAX's `checkpoint_name(..., "attn_ctx")`); the registered backward is K3 /
# K3m. Where autograd records nothing (no_grad, inference_mode: serving,
# extraction, GradCache stage 1) the forward is called directly, without the
# op's dispatch. The schemas are spelled out: this module's annotations are
# strings.

@torch.library.custom_op(
    "bscan::mha_packed", mutates_args=(),
    schema="(Tensor qkv, Tensor? mask, int heads, float scale) -> Tensor")
def _mha_packed_op(qkv, mask, heads, scale):
    return _packed_forward(qkv, mask, heads, scale)


@_mha_packed_op.register_fake
def _(qkv, mask, heads, scale):
    return qkv.new_empty((*qkv.shape[:-1], qkv.shape[-1] // 3))


def _packed_setup(ctx, inputs, output):
    qkv, mask, heads, scale = inputs
    ctx.save_for_backward(qkv, mask)
    ctx.cfg = (heads, scale)


def _packed_backward(ctx, g):
    qkv, mask = ctx.saved_tensors
    heads, scale = ctx.cfg
    dqkv = mha_bwd(None, None, None, g.contiguous(), heads, scale=scale,
                   packed_qkv=qkv, mask=mask)
    return dqkv, None, None, None


_mha_packed_op.register_autograd(_packed_backward, setup_context=_packed_setup)


@torch.library.custom_op(
    "bscan::mha", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? bias, int heads, "
           "float scale) -> Tensor")
def _mha_op(q, k, v, bias, heads, scale):
    return _split_forward(q, k, v, bias, None, heads, scale, 0.0)


@torch.library.custom_op(
    "bscan::mha_dropout", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor seed, "
           "int heads, float scale, float rate) -> Tensor")
def _mha_dropout_op(q, k, v, bias, seed, heads, scale, rate):
    return _split_forward(q, k, v, bias, seed, heads, scale, rate)


@_mha_op.register_fake
def _(q, k, v, bias, heads, scale):
    return torch.empty_like(q)


@_mha_dropout_op.register_fake
def _(q, k, v, bias, seed, heads, scale, rate):
    return torch.empty_like(q)


def _split_setup(ctx, inputs, output):
    q, k, v, bias = inputs[:4]
    seed = inputs[4] if len(inputs) == 8 else None
    ctx.save_for_backward(q, k, v, bias, seed)
    ctx.cfg = inputs[-3:] if seed is not None else (*inputs[-2:], 0.0)


def _split_backward(ctx, g):
    q, k, v, bias, seed = ctx.saved_tensors
    heads, scale, rate = ctx.cfg
    dq, dk, dv, dbias = mha_bwd(
        q, k, v, g.contiguous(), heads, bias=bias, scale=scale,
        dropout_rate=rate, dropout_seed=seed,
        need_dbias=ctx.needs_input_grad[3],
    )
    rest = (None,) * (len(ctx.needs_input_grad) - 4)
    return (dq, dk, dv, dbias, *rest)


_mha_op.register_autograd(_split_backward, setup_context=_split_setup)
_mha_dropout_op.register_autograd(_split_backward,
                                  setup_context=_split_setup)
# the ops a selective remat policy saves (`models/common._selective`)
ATTENTION_OPS = frozenset({torch.ops.bscan.mha_packed.default,
                           torch.ops.bscan.mha.default,
                           torch.ops.bscan.mha_dropout.default})


def mha_packed(qkv, heads: int, scale=None, mask=None):
    """Attention over a packed (B, N, 3D) qkv (q|k|v along the last axis,
    heads-major in each third: the timm fused-qkv layout) -> (B, N, D).
    `mask`: an optional (N, N) fp32 additive score mask shared across the
    batch (OpenCLIP's causal text mask), added after the scale (K1m).
    Differentiable in qkv: the backward is K3 on the card, K3m with a
    mask."""
    d3 = qkv.shape[-1]
    if d3 % 3:
        raise ValueError(f"mha_packed: last dim {d3} is not 3 * D")
    if scale is None:
        scale = (d3 // 3 // heads) ** -0.5
    if not torch.is_grad_enabled():
        return _packed_forward(qkv, mask, heads, float(scale))
    return _mha_packed_op(qkv, mask, heads, float(scale))


mha_packed.launches = 0
mha_packed.mask_launches = 0
mha_packed.sm90_launches = 0  # the K1 launches of `launches` on the sm90 body
mha_packed.mask_sm90_launches = 0  # K1m's of `mask_launches` on the sm90 body


def mha(q, k, v, heads: int, bias=None, scale=None,
        dropout_rate: float = 0.0, dropout_seed=None):
    """Attention over separate (B, N, D) q/k/v with an optional (B, N)
    fp32 additive key bias (0 / -1e9 padding) -> (B, N, D) in q's dtype.
    `dropout_rate > 0` with a uint32 `dropout_seed` (scalar, or (B,) per-row
    seeds) drops attention probabilities through `mha_dropout` (K2d).
    Differentiable in q, k, v and bias: the backward is K3 on the card."""
    if dropout_rate > 0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        return mha_dropout(q, k, v, heads, dropout_seed, dropout_rate,
                           bias=bias, scale=scale)
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if not torch.is_grad_enabled():
        return _split_forward(q, k, v, bias, None, heads, float(scale), 0.0)
    return _mha_op(q, k, v, bias, heads, float(scale))


mha.launches = 0
mha.sm90_launches = 0  # the K2 launches of `launches` on the sm90 body
mha.mma_launches = 0  # those on the mma.sync body of csrc/mha_fwd.cu


def mha_dropout(q, k, v, heads: int, seed, rate: float, bias=None,
                scale=None):
    """`mha` with attention-probability dropout at `rate` (K2d): the mask
    is the counter hash of `dropout_keep_4d`, computed inside the kernel."""
    if not 0 < rate < 1:
        raise ValueError(f"mha_dropout: rate {rate} outside (0, 1)")
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    # a scalar seed stays on the host (it goes to the kernel by value)
    if not torch.is_grad_enabled():
        return _split_forward(q, k, v, bias, u32(seed), heads, float(scale),
                              float(rate))
    return _mha_dropout_op(q, k, v, bias, u32(seed), heads, float(scale),
                           float(rate))


mha_dropout.launches = 0
mha_dropout.sm90_launches = 0  # the K2d launches on the sm90 body
mha_dropout.mma_launches = 0  # those on the mma.sync body


def mha_bwd(q, k, v, g, heads: int, bias=None, scale=None,
            dropout_rate: float = 0.0, dropout_seed=None, packed_qkv=None,
            need_dbias: bool = False, mask=None):
    """The attention backward (K3). Either q/k/v (B, N, D) or `packed_qkv`
    (B, N, 3D) is given, and g is dL/d(output) (B, N, D). Returns
    (dq, dk, dv, dbias) in the input dtype (dbias fp32 (B, N) when
    `need_dbias` and a bias are given, else None), or the (B, N, 3D) dqkv
    for a packed input. An (N, N) fp32 score `mask`, shared across the
    batch, makes it K3m (counted in `mha_bwd.mask_launches`). K3 with a
    key bias is counted also in `mha_bwd.bias_launches`, K3 on the sm90
    body (`plan_bwd`) in `mha_bwd.sm90_launches`, K3m on it in
    `mha_bwd.mask_sm90_launches`."""
    packed = packed_qkv is not None
    if packed:
        d = packed_qkv.shape[-1] // 3
        q, k, v = (packed_qkv[..., :d], packed_qkv[..., d : 2 * d],
                   packed_qkv[..., 2 * d :])
    b, n, d = q.shape
    if scale is None:
        scale = (d // heads) ** -0.5
    if q.device.type == "cpu":
        dq, dk, dv, dbias = mha_bwd_reference(
            q, k, v, g, heads, bias=bias, scale=scale,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed, mask=mask)
        if packed:
            return torch.cat([dq, dk, dv], dim=-1)
        return dq, dk, dv, (dbias if need_dbias else None)

    _check_heads("mha_bwd", d, heads, q.dtype)
    if g.shape != (b, n, d):
        raise ValueError(f"mha_bwd: g {tuple(g.shape)}, expected {(b, n, d)}")
    if mask is not None:
        _check_cuda("mha_bwd mask", [mask], torch.float32)
        if mask.device != q.device or tuple(mask.shape) != (n, n):
            raise ValueError(f"mha_bwd: mask must be ({n}, {n}) on "
                             f"{q.device}")
    if packed:
        _check_cuda("mha_bwd", [packed_qkv, g], packed_qkv.dtype)
        _check_aligned("mha_bwd", [packed_qkv, g])
    else:
        _check_split("mha_bwd", q, k, v, bias)
        _check_cuda("mha_bwd g", [g], q.dtype)
        _check_aligned("mha_bwd", [q, k, v, g])
    dev = q.device
    drop = _drop_args(dropout_rate, dropout_seed, b, dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    plan = plan_bwd(b, n, heads, d // heads, q.dtype, packed,
                    mask is not None, bias is not None,
                    need_dbias and bias is not None, sm_count(idx),
                    dropout=dropout_rate > 0)
    sm90 = plan.body == "sm90"
    if sm90:
        out = _launch_bwd_sm90(plan, q, k, v, g, scale, drop, packed_qkv,
                               mask=mask)
        if not packed:
            out = (*out, None)
    else:
        out = _launch_bwd(q, k, v, g, heads, scale, drop, packed_qkv, bias,
                          need_dbias, mask)
    if mask is not None:
        mha_bwd.mask_launches += 1
        mha_bwd.mask_sm90_launches += int(sm90)
    else:
        mha_bwd.launches += 1
        mha_bwd.sm90_launches += int(sm90)
        mha_bwd.bias_launches += int(bias is not None)
    return out


mha_bwd.launches = 0
mha_bwd.mask_launches = 0
mha_bwd.sm90_launches = 0  # the K3 launches of `launches` on the sm90 body
mha_bwd.mask_sm90_launches = 0  # K3m's of `mask_launches` on the sm90 body
mha_bwd.bias_launches = 0  # the K3 launches of `launches` with a key bias
