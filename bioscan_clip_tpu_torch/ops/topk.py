"""Exact inner-product top-k over a key matrix: fp32 (K4) and int8 (K5);
and the two kernels of the top-k decomposition probe: the matmul-only
control (K6) and the dispatch floor (K7).

Counterpart of bioscan_clip_tpu/ops/topk_pallas.py (`pallas_topk` :185,
`pallas_topk_i8` :253 and `quantize_rows_i8` :310; the numpy wrapper
`topk_search_pallas` :320 is `retrieval/engine.topk_search`'s job here) and of tools/bench_topk_variants.py (`mm_only` :78,
`tiny` :118). On CUDA tensors `topk`, `topk_i8`, `mm_only` and `tiny` launch
the hand-written kernels in `csrc/topk.cu` or raise; on CPU tensors they run
`topk_reference`, `topk_i8_reference`, `mm_only_reference` and
`tiny_reference`, the plain versions.

Top-k contract (K4, K5 and their plain versions): keys with index >=
n_valid never enter, each row comes out sorted descending, and among equal
values the smaller key index comes first. fp32 scores in "high" precision
("highest" is the same; both are `Precision.HIGHEST` in `pallas_topk`) are
the six-product bf16 split with fp32 sums on the card: each operand split
into three bf16 pieces (`split_bf16_3`), the six products whose piece
indices sum to 2 or less summed in fp32, within fp32 rounding of the full
fp32 product that the plain version computes. It is never TF32. In
"default" precision (the TPU's single bf16 pass, `Precision.DEFAULT`) they
are the products of the operands rounded to bf16 (round to nearest even),
summed in fp32, on either device. int8 scores are the exact integer dot of
the codes times the query scale, then times the key scale, each product
rounded as fp32 (the order of `_topk_i8_kernel`), so K5 equals its plain
version bit for bit.

`mm_only` returns each query's maximum over the valid keys of Q . K^T,
broadcast over 128 columns: K4's products ("high" or "default") or K5's
(the exact integer dots of int8 codes, equal bit for bit to the plain
version and to the TPU's bf16 products of the codes), with a row max in
place of the screen and lists. It runs on the walk `plan_mm_only` chooses:
K4's and K5's Hopper bodies as a row-max launch (their `ROWMAX` flag: the
same walk and products, no screen, lists or seed) from
`MM_SM90_MIN_BQ[mode]` queries up at widths they take (fp32 a multiple of
64, int8 of 128), else the `mma.sync` walks of `csrc/topk.cu`.

K4 has two bodies on the card, chosen by `plan_f32`: the Hopper body
(`csrc/topk_sm90.cu`: keys as `wgmma`'s M side split in registers, queries
split once a call and loaded by TMA, one walk of the keys for up to 256
queries) from `SM90_MIN_BQ[precision]` queries up (17 in "high", every
Bq in "default") at widths that are a multiple of 64, and the `mma.sync`
body of `csrc/topk.cu` below that.

K5 has two bodies too, chosen by `plan_i8`: the Hopper body
(`csrc/topk_i8_sm90.cu`: int8 `wgmma` with the keys as its M side and the
queries as its N side, both TMA tiles of codes loaded by a producer
warpgroup, one walk of the keys for up to 128 queries, each query's
threshold seeded by a first launch) at widths that are a multiple of 128,
and the `mma.sync` body of `csrc/topk.cu` elsewhere and at the few queries
over few keys where it measured faster (`I8_MMA_WINS`).

`<wrapper>.launches` count kernel launches (`topk.launches` the "high"
ones, `topk.default_launches` the "default" ones, of either body;
`topk.sm90_launches` those of K4's Hopper body, `topk.mma_launches` those
of its `mma.sync` body; `topk_i8.sm90_launches` and `topk_i8.mma_launches`
those of K5's two bodies; `mm_only.sm90_launches` and
`mm_only.mma_launches` those of K6 on the Hopper and `mma.sync` walks),
`<plain version>.calls` the plain versions' calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.ops._device import H100_SMS, sm_count
from bioscan_clip_tpu_torch.ops._launch import launch

MAX_K = 32  # K4 keeps lists of up to 32 entries
# K5 keeps lists of up to 64: the engine oversamples int8 searches to
# max(4k, k + 16), so every k <= 16 fits
MAX_K_I8 = 64
REFERENCE_KEY_CHUNK = 65536
QUERY_CHUNK = 1024


def quantize_rows_i8_torch(x):
    """Symmetric per-row int8 quantization of an fp32 (N, D) tensor on its
    device: (N, D) int8 codes, (N,) fp32 scales. Zero rows get scale 1
    (all-zero codes). The arithmetic of the JAX `quantize_rows_i8` (max |x|
    / 127, round half to even), so the same codes and scales, bit for bit."""
    scales = x.abs().amax(dim=1) / 127.0
    scales = torch.where(scales > 0, scales, torch.ones_like(scales))
    codes = torch.clamp(torch.round(x / scales[:, None]), -127, 127)
    return codes.to(torch.int8), scales.contiguous()


def quantize_rows_i8(x):
    """`quantize_rows_i8_torch` on the CPU for host arrays: numpy in,
    (int8 codes, (rows, 1) fp32 scales) out, as the JAX function returns
    them."""
    codes, scales = quantize_rows_i8_torch(
        torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)))
    return codes.numpy(), scales.numpy()[:, None]


def _chunked_topk(scores, n_valid: int, k: int):
    """Top-k over key chunks of `scores(s, e)` (Bq, e - s) for keys
    [s, e) < n_valid: each chunk stably sorted and merged with the running
    top-k (the `engine._topk_scan` scheme, with a stable sort giving the
    tie rule)."""
    vals = idx = None
    for s in range(0, n_valid, REFERENCE_KEY_CHUNK):
        e = min(s + REFERENCE_KEY_CHUNK, n_valid)
        sc = scores(s, e)
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


PRECISIONS = {"high": 0, "highest": 0, "default": 1}


def _bf16_operand(x, precision: str):
    """x as the product sees it: rounded to bf16 in "default" precision."""
    if precision == "default":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def split_bf16_3(x):
    """The three bf16 pieces of an fp32 tensor, as fp32 tensors: hi =
    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to
    nearest even (each difference is exact in fp32). hi + mid + lo is x to
    within 2^-24 |x|; K4's "high" sums the six products of two operands'
    pieces whose indices add up to 2 or less. For the tests; the main path
    never calls it."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16).to(torch.float32)
    mid = (x - hi).to(torch.bfloat16).to(torch.float32)
    lo = (x - hi - mid).to(torch.bfloat16).to(torch.float32)
    return hi, mid, lo


def topk_reference(queries, keys, n_valid: int, k: int,
                   precision: str = "high"):
    """Plain PyTorch top-k: chunked fp32 products over keys[:n_valid], of
    the operands rounded to bf16 in "default" precision."""
    topk_reference.calls += 1
    q = _bf16_operand(queries, precision)
    return _chunked_topk(
        lambda s, e: q @ _bf16_operand(keys[s:e], precision).T, n_valid, k)


topk_reference.calls = 0


def topk_i8_reference(q_i8, q_scales, keys_i8, k_scales, n_valid: int,
                      k: int):
    """Plain PyTorch int8 top-k: chunked products of the codes cast to fp32
    (exact integers: 768 * 127^2 < 2^24, in any summation order), times
    the query scales, then times the key scales."""
    topk_i8_reference.calls += 1
    qf = q_i8.to(torch.float32)
    qsc = q_scales.reshape(-1, 1).to(torch.float32)
    ksc = k_scales.reshape(-1).to(torch.float32)

    def scores(s, e):
        dots = qf @ keys_i8[s:e].to(torch.float32).T
        return (dots * qsc) * ksc[s:e].reshape(1, -1)

    return _chunked_topk(scores, n_valid, k)


topk_i8_reference.calls = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The library's entry points, argument types set."""
    lib = _build.load("topk")
    fn = lib.bscan_topk_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 5
    )
    fn.restype = ctypes.c_int
    fn_i8 = lib.bscan_topk_i8
    fn_i8.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 5
    )
    fn_i8.restype = ctypes.c_int
    smem_i8 = lib.bscan_topk_i8_smem
    smem_i8.argtypes = [ctypes.c_int] * 3
    smem_i8.restype = ctypes.c_longlong
    fn_mm = lib.bscan_mm_only
    fn_mm.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 3
    )
    fn_mm.restype = ctypes.c_int
    smem_mm = lib.bscan_mm_only_smem
    smem_mm.argtypes = [ctypes.c_int] * 3
    smem_mm.restype = ctypes.c_longlong
    smem_f32 = lib.bscan_topk_f32_smem
    smem_f32.argtypes = [ctypes.c_int] * 3
    smem_f32.restype = ctypes.c_int
    fn_tiny = lib.bscan_tiny
    fn_tiny.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn_tiny.restype = ctypes.c_int
    return SimpleNamespace(lib=lib, topk=fn, topk_i8=fn_i8,
                           smem_i8=smem_i8, mm_only=fn_mm, smem_mm=smem_mm,
                           tiny=fn_tiny, smem_f32=smem_f32)


@functools.lru_cache(maxsize=None)
def _sm90_kernel():
    """K4's Hopper body (csrc/topk_sm90.cu), argument types set."""
    return sm90_entry(_build.load("topk_sm90"))


def sm90_entry(lib):
    """The entry points of a library built from csrc/topk_sm90.cu (or one of
    its design variants), argument types set."""
    fn = lib.bscan_topk_f32_sm90
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p] * 5
    )
    fn.restype = ctypes.c_int
    smem = lib.bscan_topk_f32_sm90_smem
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    depth = lib.bscan_topk_f32_sm90_slot_depth
    depth.argtypes = [ctypes.c_int]
    depth.restype = ctypes.c_int
    fn_mm = lib.bscan_mm_only_f32_sm90
    fn_mm.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 3
    )
    fn_mm.restype = ctypes.c_int
    smem_mm = lib.bscan_mm_only_f32_sm90_smem
    smem_mm.argtypes = [ctypes.c_int] * 3
    smem_mm.restype = ctypes.c_longlong
    lib.bscan_error_string.argtypes = [ctypes.c_int]
    lib.bscan_error_string.restype = ctypes.c_char_p
    return SimpleNamespace(lib=lib, topk=fn, smem=smem, slot_depth=depth,
                           mm_only=fn_mm, smem_mm=smem_mm)


@functools.lru_cache(maxsize=None)
def _i8_sm90_kernel():
    """K5's Hopper body (csrc/topk_i8_sm90.cu), argument types set."""
    return i8_sm90_entry(_build.load("topk_i8_sm90"))


def i8_sm90_entry(lib):
    """The entry points of a library built from csrc/topk_i8_sm90.cu (or
    one of its design variants), argument types set."""
    fn = lib.bscan_topk_i8_sm90
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 2
        + [ctypes.c_int] + [ctypes.c_void_p] * 6
    )
    fn.restype = ctypes.c_int
    smem = lib.bscan_topk_i8_sm90_smem
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    seed = lib.bscan_topk_i8_sm90_seed
    seed.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    seed.restype = None
    fn_mm = lib.bscan_mm_only_i8_sm90
    fn_mm.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 3
    )
    fn_mm.restype = ctypes.c_int
    smem_mm = lib.bscan_mm_only_i8_sm90_smem
    smem_mm.argtypes = [ctypes.c_int] * 2
    smem_mm.restype = ctypes.c_longlong
    lib.bscan_error_string.argtypes = [ctypes.c_int]
    lib.bscan_error_string.restype = ctypes.c_char_p
    return SimpleNamespace(lib=lib, topk=fn, smem=smem, seed=seed,
                           mm_only=fn_mm, smem_mm=smem_mm)


# --- K4's plan (the launch checks of csrc/topk.cu's `bscan_topk_f32` and
# csrc/topk_sm90.cu's `bscan_topk_f32_sm90` refuse any other) --------------

MAX_SMEM = 232_448          # a block's opt-in shared memory on Hopper
# the crossing: fewer queries run the mma body ("default" runs the sm90
# body at every Bq: it was faster there at Bq = 1 and 16 too)
SM90_MIN_BQ = {"high": 17, "highest": 17, "default": 1}
_KEY_TILE = 128             # keys per tile, both bodies
_BUF = 32                   # screened scores per query per merge
_CLUSTER = 2                # the mma body's key splits merged before pass 2
_SM90_CHUNK = 64            # depth values per ring chunk of the sm90 body
_SM90_KEY_BYTES = 2 * _KEY_TILE * 32 * 4   # a chunk's keys: two TMA boxes
_SM90_ALIGN, _SM90_BARRIER_BYTES = 1024, 64
_SM90_STAGES = (4, 3, 2)    # ring slots, the most that fit first


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """How `topk` runs (Bq, N, k, precision) on the card.

    `body`: "sm90" (`csrc/topk_sm90.cu`) or "mma" (the `mma.sync` body of
    `csrc/topk.cu`). `qb`: the query block (the sm90 body's wgmma N: 64,
    128 or 256; the mma body's 16, 32 or 64). The key axis: `splits`
    blocks of `tiles_per_split` 128-key tiles, covering every tile of N
    once. `stages`: ring slots; `smem`: a pass-1 block's dynamic shared
    memory; `n_cand`: the candidate entries per buffer that pass 2 reads,
    k per query and sm90 split, or per mma cluster of two splits."""

    body: str
    qb: int
    splits: int
    tiles_per_split: int
    stages: int
    smem: int
    n_cand: int


def _maxk(k: int) -> int:
    return 8 if k <= 8 else 16 if k <= 16 else 32


def lists_bytes(qb: int, maxk: int) -> int:
    """The lists of qb queries (topk_common.cuh `lists_bytes`)."""
    return 4 * qb * (2 * maxk + 2 * _BUF + 3)


def sm90_smem(qb: int, maxk: int, terms: int, stages: int) -> int:
    """csrc/topk_sm90.cu `smem_bytes`: alignment, the ring (keys and query
    pieces), the lists and the barriers."""
    return (_SM90_ALIGN + stages * (_SM90_KEY_BYTES + terms * qb * 2
                                    * _SM90_CHUNK)
            + lists_bytes(qb, maxk) + _SM90_BARRIER_BYTES)


def _sm90_blocks(precision: str):
    return (64, 128, 256) if precision == "default" else (64, 128)


def plan_f32(bq: int, n: int, k: int, precision: str = "high", d: int = 768,
             sms: int = H100_SMS, body: str | None = None) -> F32Plan:
    """K4's body and launch for Bq queries over N keys at width d on a card
    of `sms` SMs: the sm90 body from SM90_MIN_BQ[precision] queries up when
    d % 64 == 0, with the smallest query block that holds Bq (else the
    largest), as many ring stages as fit; else the mma body, its query
    block 16, 32 or 64 from Bq. `body` overrides the choice of body."""
    terms = 3 if PRECISIONS[precision] == 0 else 1
    maxk = _maxk(k)
    n_tiles = -(-n // _KEY_TILE)
    if body is None:
        body = ("sm90" if bq >= SM90_MIN_BQ[precision]
                and d % _SM90_CHUNK == 0 else "mma")
    if body == "mma":
        qb = 16 if bq <= 16 else 32 if bq <= 32 else 64
        q_blocks = -(-bq // qb)
        want = min(max(-(-2 * sms // q_blocks), 1), n_tiles)
        per_split = -(-n_tiles // want)
        clusters = -(-n_tiles // (per_split * _CLUSTER))
        st = 3 if qb == 64 else 4
        smem = (4 * st * (_KEY_TILE + qb) * 32 + 2 * terms * qb * 40
                + lists_bytes(qb, maxk))
        return F32Plan("mma", qb, clusters * _CLUSTER, per_split, st, smem,
                       bq * clusters * k)
    fits = [b for b in _sm90_blocks(precision)
            if sm90_smem(b, maxk, terms, 2) <= MAX_SMEM]
    qb = next((b for b in fits if b >= bq), fits[-1])
    stages = next(s for s in _SM90_STAGES
                  if sm90_smem(qb, maxk, terms, s) <= MAX_SMEM)
    return sm90_plan(bq, n, k, precision, sms, qb, stages)


def sm90_plan(bq: int, n: int, k: int, precision: str, sms: int, qb: int,
              stages: int) -> F32Plan:
    """The sm90 body's launch at query block `qb` and `stages` ring slots:
    about one CTA per SM over the query blocks and key splits, every split
    holding at least one key tile."""
    terms = 3 if PRECISIONS[precision] == 0 else 1
    n_tiles = -(-n // _KEY_TILE)
    q_blocks = -(-bq // qb)
    want = min(max(sms // q_blocks, 1), n_tiles)
    per_split = -(-n_tiles // want)
    splits = -(-n_tiles // per_split)
    return F32Plan("sm90", qb, splits, per_split, stages,
                   sm90_smem(qb, _maxk(k), terms, stages), bq * splits * k)


def _device_sms(dev) -> int:
    return sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


# --- K5's plan (the launch checks of csrc/topk.cu's `bscan_topk_i8` and
# csrc/topk_i8_sm90.cu's `bscan_topk_i8_sm90` refuse any other) ------------

# the seed's launch pays from this many queries up (fewer append few
# scores anyway: at Bq <= 16 the seed's launch cost more than it saved)
I8_SEED_MIN_BQ = 32
# Where the mma.sync body measured faster than the plan's sm90 body, as
# (least N, most Bq), both only while N / 128 <= the card's SMs
# (tools/sweep_k5_sm90.py --crossing, rounds of turns, D = 768, k = 21, N
# = 960-32,768 on 132 SMs; below 960 keys, both launch-bound, taken as at
# 960). There a single query block's sm90 plan gives each key split one
# tile, whose scores fill its lists, and pass 2 reads k candidates a query
# for every tile where mma.sync's clusters of two splits halve them; from
# 19,937 keys (two tiles a split) the sm90 body won at every Bq.
I8_MMA_WINS = ((1, 16), (12_288, 32))
# the largest query block where the seed cannot run (fewer than k whole key
# tiles): each query's first tile then fills its list, and a block of 128
# queries took 0.10 ms at N = 1,920, Bq = 960 against 0.06 at 32
I8_UNSEEDED_MAX_QB = 32
_I8_SM90_BLOCKS = (16, 32, 64, 128)  # the Hopper body's query blocks (N)
_I8_SM90_CHUNK = 128               # depth bytes of its ring chunks
_I8_SM90_ALIGN, _I8_SM90_BARRIER_BYTES = 1024, 128
_I8_SM90_STAGES = (2, 8)           # ring slots: the most that fit
_I8_SEED_TILES = 8                 # whole key tiles in a seed group, at most


@dataclasses.dataclass(frozen=True)
class I8Plan:
    """How `topk_i8` runs (Bq, N, k, D) on the card.

    `body`: "sm90" (`csrc/topk_i8_sm90.cu`) or "mma" (the `mma.sync` body of
    `csrc/topk.cu`). `qb`: the query block (the sm90 body's wgmma N: 16, 32,
    64 or 128; the mma body's 16, 32 or 64). The key axis: `splits` blocks of
    `tiles_per_split` 128-key tiles, covering every tile of N once.
    `stages`: ring slots; `smem`: a pass-1 block's dynamic shared memory;
    `n_cand`: the candidate entries per buffer that pass 2 reads, k per
    query and sm90 split, or per mma cluster of two splits. `seed_groups`:
    the sm90 body's seed, k key groups whose bests start each query's
    threshold (`i8_seed`), or 0 for none."""

    body: str
    qb: int
    splits: int
    tiles_per_split: int
    stages: int
    smem: int
    n_cand: int
    seed_groups: int = 0


def _maxk_i8(k: int) -> int:
    return 8 if k <= 8 else 16 if k <= 16 else 32 if k <= 32 else 64


def i8_sm90_smem(qb: int, maxk: int, stages: int,
                 chunk: int = _I8_SM90_CHUNK) -> int:
    """csrc/topk_i8_sm90.cu `smem_bytes`: alignment, the ring (key and query
    codes in chunks of `chunk` depth bytes, the source's by default), the
    lists, the query scales and the barriers."""
    return (_I8_SM90_ALIGN + stages * (_KEY_TILE + qb) * chunk
            + lists_bytes(qb, maxk) + 4 * qb + _I8_SM90_BARRIER_BYTES)


def i8_seed(n_valid: int, groups: int) -> tuple[int, int]:
    """csrc/topk_i8_sm90.cu `SeedGroups`: the seed's whole key tiles a group
    (0: no seed, fewer than `groups` whole tiles of valid keys) and the
    tiles from one group's first to the next's, over keys[:n_valid]."""
    stride = n_valid // _KEY_TILE // groups if groups else 0
    return min(stride, _I8_SEED_TILES), stride


def i8_mma_smem(qb: int, d: int, maxk: int) -> int:
    """csrc/topk.cu `i8_smem`: the staged query codes (rows padded by 16
    bytes), the ring of key chunks and the lists."""
    dc, stages = (64, 3) if qb == 64 else (128, 4)
    return (qb * (d + 16) + stages * _KEY_TILE * (dc + 16)
            + lists_bytes(qb, maxk))


def _i8_sm90_blocks(maxk: int):
    """The sm90 body's query blocks whose lists fit beside two stages."""
    return [b for b in _I8_SM90_BLOCKS
            if i8_sm90_smem(b, maxk, _I8_SM90_STAGES[0]) <= MAX_SMEM]


def plan_i8(bq: int, n: int, k: int, d: int = 768, sms: int = H100_SMS,
            body: str | None = None) -> I8Plan:
    """K5's body and launch for Bq queries over N keys at width d on a card
    of `sms` SMs: the sm90 body when d % 128 == 0, but where I8_MMA_WINS
    measured the mma body faster, with the smallest query block of 16, 32,
    64 or 128 rows that holds Bq (else 128; at most I8_UNSEEDED_MAX_QB
    where N has fewer than k whole key tiles, so that the seed cannot
    run), as many ring stages as fit, and the seed from I8_SEED_MIN_BQ
    queries up; else the mma body, its query block 16, 32 or 64 from Bq
    (halved while its staged codes do not fit). `body` overrides the
    choice of body."""
    maxk = _maxk_i8(k)
    n_tiles = -(-n // _KEY_TILE)
    if body is None:
        one_tile = n_tiles <= sms  # a split a tile, for Bq <= 32
        body = ("sm90" if d % _I8_SM90_CHUNK == 0 and not (one_tile and any(
            n >= lo and bq <= most for lo, most in I8_MMA_WINS)) else "mma")
    if body == "mma":
        qb = 16 if bq <= 16 else 32 if bq <= 32 else 64
        while qb > 16 and i8_mma_smem(qb, d, maxk) > MAX_SMEM:
            qb //= 2
        q_blocks = -(-bq // qb)
        want = min(max(-(-2 * sms // q_blocks), 1), n_tiles)
        per_split = -(-n_tiles // want)
        clusters = -(-n_tiles // (per_split * _CLUSTER))
        return I8Plan("mma", qb, clusters * _CLUSTER, per_split,
                      3 if qb == 64 else 4, i8_mma_smem(qb, d, maxk),
                      bq * clusters * k)
    fits = _i8_sm90_blocks(maxk)
    if i8_seed(n, k)[0] == 0:
        fits = [b for b in fits if b <= I8_UNSEEDED_MAX_QB]
    qb = next((b for b in fits if b >= bq), fits[-1])
    lo, hi = _I8_SM90_STAGES
    stages = max(s for s in range(lo, hi + 1)
                 if i8_sm90_smem(qb, maxk, s) <= MAX_SMEM)
    return i8_sm90_plan(bq, n, k, sms, qb, stages)


def i8_sm90_plan(bq: int, n: int, k: int, sms: int, qb: int,
                 stages: int) -> I8Plan:
    """The sm90 body's launch at query block `qb` and `stages` ring slots,
    with the seed from I8_SEED_MIN_BQ queries up: about one CTA per SM over
    the query blocks and key splits, every split holding at least one key
    tile."""
    n_tiles = -(-n // _KEY_TILE)
    q_blocks = -(-bq // qb)
    want = min(max(sms // q_blocks, 1), n_tiles)
    per_split = -(-n_tiles // want)
    splits = -(-n_tiles // per_split)
    return I8Plan("sm90", qb, splits, per_split, stages,
                  i8_sm90_smem(qb, _maxk_i8(k), stages), bq * splits * k,
                  k if bq >= I8_SEED_MIN_BQ else 0)


def _check_2d(name, t, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, queries on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be 2-D, contiguous and 16-byte "
                         "aligned")


def topk(queries, keys, n_valid: int, k: int, precision: str = "high"):
    """Top-k of queries (Bq, D) . keys (N, D)^T over keys[:n_valid], both
    fp32. `precision`: "high" (or "highest"), fp32 products (on the card the
    six-product bf16 split, within fp32 rounding of them); "default",
    products of the operands rounded to bf16, summed in fp32 (the TPU's
    single bf16 pass). Returns (values (Bq, k) fp32, indices (Bq, k)
    int32)."""
    n_valid = int(n_valid)
    n = keys.shape[0]
    if precision not in PRECISIONS:
        raise ValueError(f"topk: precision {precision!r}, expected one of "
                         f"{sorted(PRECISIONS)}")
    if not 1 <= k <= n_valid <= n:
        raise ValueError(f"topk: need 1 <= k ({k}) <= n_valid ({n_valid}) "
                         f"<= N ({n})")
    if queries.device.type == "cpu":
        return topk_reference(queries, keys, n_valid, k, precision)
    for name, t in (("queries", queries), ("keys", keys)):
        _check_2d(f"topk: {name}", t, torch.float32, queries.device)
    bq, d = queries.shape
    if keys.shape[1] != d or d % 32:
        raise ValueError(f"topk: widths {d} / {keys.shape[1]} must match "
                         "and be a multiple of 32")
    if k > MAX_K:
        raise ValueError(f"topk: kernel takes k <= {MAX_K}, got {k}")
    dev = queries.device
    mode = PRECISIONS[precision]
    plan = plan_f32(bq, n, k, precision, d, _device_sms(dev))
    if plan.body == "sm90":
        out_v, out_i = _launch_sm90(_sm90_kernel(), queries, keys, n_valid, k,
                                    precision, plan)
        topk.sm90_launches += 1
    else:
        out_v, out_i = _launch_mma(queries, keys, n_valid, k, mode, plan)
        topk.mma_launches += 1
    if mode:
        topk.default_launches += 1
    else:
        topk.launches += 1
    return out_v, out_i


def _outputs(bq, k, n_cand, dev):
    return (torch.empty(n_cand, dtype=torch.float32, device=dev),
            torch.empty(n_cand, dtype=torch.int32, device=dev),
            torch.empty((bq, k), dtype=torch.float32, device=dev),
            torch.empty((bq, k), dtype=torch.int32, device=dev))


def _launch_mma(queries, keys, n_valid, k, mode, plan: F32Plan):
    """K4's mma.sync body (csrc/topk.cu) under `plan`."""
    (bq, d), n, dev = queries.shape, keys.shape[0], queries.device
    kern = _kernel()
    cand_v, cand_i, out_v, out_i = _outputs(bq, k, plan.n_cand, dev)
    launch(kern.lib, kern.topk, "topk launch", queries,
           queries.data_ptr(), keys.data_ptr(), bq, n, d, n_valid, k, mode,
           plan.qb, plan.splits, plan.tiles_per_split, plan.n_cand,
           cand_v.data_ptr(), cand_i.data_ptr(), out_v.data_ptr(),
           out_i.data_ptr())
    return out_v, out_i


def _launch_sm90(kern, queries, keys, n_valid, k, precision, plan: F32Plan):
    """K4's Hopper body under `plan`, through `kern` (`_sm90_kernel()`, or
    a design variant's library with the same entry point): the query
    pieces into a scratch tensor, pass 1, pass 2."""
    (bq, d), n, dev = queries.shape, keys.shape[0], queries.device
    mode = PRECISIONS[precision]
    pieces = torch.empty((1 if mode else 3, bq, d), dtype=torch.bfloat16,
                         device=dev)
    cand_v, cand_i, out_v, out_i = _outputs(bq, k, plan.n_cand, dev)
    launch(kern.lib, kern.topk, "topk sm90 launch", queries,
           queries.data_ptr(), keys.data_ptr(), pieces.data_ptr(), bq, n, d,
           n_valid, k, mode, plan.qb, plan.splits, plan.tiles_per_split,
           plan.stages, plan.smem, plan.n_cand, cand_v.data_ptr(),
           cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr())
    return out_v, out_i


topk.launches = 0
topk.default_launches = 0
topk.sm90_launches = 0
topk.mma_launches = 0


def topk_i8(q_i8, q_scales, keys_i8, k_scales, n_valid: int, k: int):
    """Top-k of int8 query codes (Bq, D) with fp32 scales (Bq,) against
    int8 key codes (N, D) with fp32 scales (N,), over keys[:n_valid].
    Returns (values (Bq, k) fp32, indices (Bq, k) int32)."""
    n_valid = int(n_valid)
    n = keys_i8.shape[0]
    if not 1 <= k <= n_valid <= n:
        raise ValueError(f"topk_i8: need 1 <= k ({k}) <= n_valid "
                         f"({n_valid}) <= N ({n})")
    if k > MAX_K_I8:
        raise ValueError(f"topk_i8: the kernel takes k <= {MAX_K_I8}, got "
                         f"{k} (an int8 search oversamples k to "
                         "max(4k, k + 16), so k <= 16)")
    if q_i8.device.type == "cpu":
        return topk_i8_reference(q_i8, q_scales, keys_i8, k_scales, n_valid,
                                 k)
    dev = q_i8.device
    for name, t in (("queries", q_i8), ("keys", keys_i8)):
        _check_2d(f"topk_i8: {name}", t, torch.int8, dev)
    bq, d = q_i8.shape
    if keys_i8.shape[1] != d or d % 64:
        raise ValueError(f"topk_i8: widths {d} / {keys_i8.shape[1]} must "
                         "match and be a multiple of 64")
    for name, t, rows in (("q_scales", q_scales, bq),
                          ("k_scales", k_scales, n)):
        if (t.device != dev or t.dtype != torch.float32
                or t.numel() != rows or not t.is_contiguous()):
            raise ValueError(f"topk_i8: {name} must be {rows} contiguous "
                             f"fp32 on {dev}")
    plan = plan_i8(bq, n, k, d, _device_sms(dev))
    if plan.body == "sm90":
        out_v, out_i = _launch_i8_sm90(_i8_sm90_kernel(), q_i8, q_scales,
                                       keys_i8, k_scales, n_valid, k, plan)
        topk_i8.sm90_launches += 1
    else:
        out_v, out_i = _launch_i8_mma(q_i8, q_scales, keys_i8, k_scales,
                                      n_valid, k, plan)
        topk_i8.mma_launches += 1
    topk_i8.launches += 1
    return out_v, out_i


def _own_plan(plan, body: str, what: str):
    if not isinstance(plan, I8Plan) or plan.body != body:
        raise ValueError(f"{what}: needs an I8Plan of the {body} body, got "
                         f"{plan!r}")


def _launch_i8_mma(q_i8, q_scales, keys_i8, k_scales, n_valid, k,
                   plan: I8Plan):
    """K5's mma.sync body (csrc/topk.cu) under `plan`."""
    _own_plan(plan, "mma", "topk_i8 mma launch")
    (bq, d), n, dev = q_i8.shape, keys_i8.shape[0], q_i8.device
    kern = _kernel()
    cand_v, cand_i, out_v, out_i = _outputs(bq, k, plan.n_cand, dev)
    launch(kern.lib, kern.topk_i8, "topk_i8 launch", q_i8,
           q_i8.data_ptr(), q_scales.data_ptr(), keys_i8.data_ptr(),
           k_scales.data_ptr(), bq, n, d, n_valid, k, plan.qb, plan.splits,
           plan.tiles_per_split, plan.n_cand, cand_v.data_ptr(),
           cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr())
    return out_v, out_i


def _launch_i8_sm90(kern, q_i8, q_scales, keys_i8, k_scales, n_valid, k,
                    plan: I8Plan):
    """K5's Hopper body under `plan`, through `kern` (`_i8_sm90_kernel()`,
    or a design variant's library with the same entry point): the seed's
    launch (with `plan.seed_groups`, into a (Bq, k) scratch), pass 1 and
    pass 2."""
    _own_plan(plan, "sm90", "topk_i8 sm90 launch")
    (bq, d), n, dev = q_i8.shape, keys_i8.shape[0], q_i8.device
    cand_v, cand_i, out_v, out_i = _outputs(bq, k, plan.n_cand, dev)
    part = torch.empty(bq * plan.seed_groups, dtype=torch.float32,
                       device=dev)
    launch(kern.lib, kern.topk, "topk_i8 sm90 launch", q_i8,
           q_i8.data_ptr(), q_scales.data_ptr(), keys_i8.data_ptr(),
           k_scales.data_ptr(), bq, n, d, n_valid, k, plan.qb, plan.splits,
           plan.tiles_per_split, plan.stages, plan.smem, plan.n_cand,
           plan.seed_groups, part.data_ptr() if plan.seed_groups else None,
           cand_v.data_ptr(), cand_i.data_ptr(), out_v.data_ptr(),
           out_i.data_ptr())
    return out_v, out_i


topk_i8.launches = 0
topk_i8.sm90_launches = 0
topk_i8.mma_launches = 0


MM_MODES = ("high", "default", "int8")


def mm_only_reference(queries, keys, n_valid: int, int8: bool = False,
                      precision: str = "high"):
    """Plain matmul-only control: (Bq, 128) fp32, each row the maximum of
    queries[r] . keys[j] over j < n_valid (-inf when n_valid is 0),
    broadcast over the columns. Chunked fp32 products: int8 codes exactly,
    "default" precision on operands rounded to bf16."""
    mm_only_reference.calls += 1

    def operand(x):
        return x.to(torch.float32) if int8 else _bf16_operand(x, precision)

    qf = operand(queries)
    m = torch.full((queries.shape[0],), -float("inf"), dtype=torch.float32,
                   device=queries.device)
    for s in range(0, int(n_valid), REFERENCE_KEY_CHUNK):
        kc = operand(keys[s : min(s + REFERENCE_KEY_CHUNK, int(n_valid))])
        m = torch.maximum(m, (qf @ kc.T).amax(dim=1))
    return m[:, None].expand(-1, 128).contiguous()


mm_only_reference.calls = 0


# --- K6's plan (the launch checks of csrc/topk.cu's `bscan_mm_only`,
# csrc/topk_sm90.cu's `bscan_mm_only_f32_sm90` and csrc/topk_i8_sm90.cu's
# `bscan_mm_only_i8_sm90` refuse any other) --------------------------------

# the crossing: fewer queries run the mma.sync walk (tools/bench_k4.py
# --kernels k6, both walks at Bq = 1-64 over 1,048,576 keys, D = 768)
MM_SM90_MIN_BQ = {"high": 17, "default": 1, "int8": 1}
_MM_SM90_BLOCKS = {"high": (64, 128), "default": (64, 128, 256),
                   "int8": _I8_SM90_BLOCKS}
_MM_SM90_WIDTH = {"high": _SM90_CHUNK, "default": _SM90_CHUNK,
                  "int8": _I8_SM90_CHUNK}
_MM_SM90_STAGES = {"high": (2, 4), "default": (2, 4), "int8": _I8_SM90_STAGES}


@dataclasses.dataclass(frozen=True)
class MMPlan:
    """How `mm_only` runs (Bq, N, D) in `mode` ("high", "default", "int8")
    on the card.

    `body`: "sm90" (the row-max launch of K4's `csrc/topk_sm90.cu` or K5's
    `csrc/topk_i8_sm90.cu`) or "mma" (the `mma.sync` walks of
    `csrc/topk.cu`). `qb`: the query block (wgmma's N on the sm90 walks;
    16, 32 or 64 on the mma walks). The key axis: `splits` blocks of
    `tiles_per_split` 128-key tiles, covering every tile of N once (the
    mma walks' last cluster of two may hold an empty split). `stages`: ring
    slots; `smem`: a pass-1 block's dynamic shared memory."""

    body: str
    qb: int
    splits: int
    tiles_per_split: int
    stages: int
    smem: int


def mm_sm90_smem(qb: int, mode: str, stages: int) -> int:
    """`rowmax_smem_bytes` of csrc/topk_sm90.cu (fp32) or
    csrc/topk_i8_sm90.cu (int8): alignment, the ring and the barriers; the
    warps' row maxima take the ring's first slot after the walk."""
    if mode == "int8":
        return (_I8_SM90_ALIGN + stages * (_KEY_TILE + qb) * _I8_SM90_CHUNK
                + _I8_SM90_BARRIER_BYTES)
    terms = 3 if mode == "high" else 1
    return (_SM90_ALIGN + stages * (_SM90_KEY_BYTES + terms * qb * 2
                                    * _SM90_CHUNK) + _SM90_BARRIER_BYTES)


def mm_mma_smem(qb: int, d: int, mode: str) -> int:
    """csrc/topk.cu `bscan_mm_only_smem`: the mma.sync walk's ring and
    staged queries (`f32_work_bytes`, `i8_ring_bytes`) and 8 warps' row
    maxima."""
    if mode == "int8":
        dc, stages = (64, 3) if qb == 64 else (128, 4)
        work = qb * (d + 16) + stages * _KEY_TILE * (dc + 16)
    else:
        terms = 3 if mode == "high" else 1
        stages = 3 if qb == 64 else 4
        work = 4 * stages * (_KEY_TILE + qb) * 32 + 2 * terms * qb * 40
    return work + 4 * 8 * qb


def plan_mm_only(bq: int, n: int, d: int = 768, mode: str = "default",
                 sms: int = H100_SMS, body: str | None = None) -> MMPlan:
    """K6's walk and launch for Bq queries over N keys at width d in `mode`
    on a card of `sms` SMs: the sm90 walk from MM_SM90_MIN_BQ[mode] queries
    up at widths it takes (fp32 a multiple of 64, int8 of 128), its query
    block the smallest of the mode's that holds Bq (else the largest), as
    many ring stages as fit; else the mma walk, with the query block and
    key splits of K4's or K5's mma plan. `body` overrides the choice."""
    if mode not in MM_MODES:
        raise ValueError(f"mm_only: mode {mode!r}, expected one of "
                         f"{MM_MODES}")
    if body is None:
        body = ("sm90" if bq >= MM_SM90_MIN_BQ[mode]
                and d % _MM_SM90_WIDTH[mode] == 0 else "mma")
    if body == "mma":
        p = (plan_i8(bq, n, 1, d, sms, body="mma") if mode == "int8" else
             plan_f32(bq, n, 1, mode, d, sms, body="mma"))
        return MMPlan("mma", p.qb, p.splits, p.tiles_per_split, p.stages,
                      mm_mma_smem(p.qb, d, mode))
    blocks = _MM_SM90_BLOCKS[mode]
    qb = next((b for b in blocks if b >= bq), blocks[-1])
    lo, hi = _MM_SM90_STAGES[mode]
    stages = max(s for s in range(lo, hi + 1)
                 if mm_sm90_smem(qb, mode, s) <= MAX_SMEM)
    return mm_sm90_plan(bq, n, mode, sms, qb, stages)


def mm_sm90_plan(bq: int, n: int, mode: str, sms: int, qb: int,
                 stages: int) -> MMPlan:
    """The sm90 walk's launch at query block `qb` and `stages` ring slots:
    about one CTA per SM over the query blocks and key splits (as K4's and
    K5's), every split holding at least one key tile."""
    n_tiles = -(-n // _KEY_TILE)
    q_blocks = -(-bq // qb)
    want = min(max(sms // q_blocks, 1), n_tiles)
    per_split = -(-n_tiles // want)
    splits = -(-n_tiles // per_split)
    return MMPlan("sm90", qb, splits, per_split, stages,
                  mm_sm90_smem(qb, mode, stages))


def _own_mm_plan(plan, body: str, what: str):
    if not isinstance(plan, MMPlan) or plan.body != body:
        raise ValueError(f"{what}: needs an MMPlan of the {body} walk, got "
                         f"{plan!r}")


def mm_only(queries, keys, n_valid: int, int8: bool = False,
            precision: str = "high"):
    """K6, the top-k kernels' matmul-only control: K4's walk and products
    (fp32, in `precision`: "high" or "default") or K5's (int8 codes, exact
    either way), with a running row max in place of the screen and lists,
    on the walk `plan_mm_only` chooses. Returns (Bq, 128) fp32. The JAX
    version's `tile` and `q_block` are Pallas grid parameters; this
    kernel's tiling is its plan's (query blocks x 128 keys, the key axis
    split across blocks)."""
    n_valid = int(n_valid)
    n = keys.shape[0]
    if precision not in ("high", "default"):
        raise ValueError(f"mm_only: precision {precision!r}, expected "
                         "'default' or 'high'")
    if not 0 <= n_valid <= n:
        raise ValueError(f"mm_only: need 0 <= n_valid ({n_valid}) <= N ({n})")
    if queries.device.type == "cpu":
        return mm_only_reference(queries, keys, n_valid, int8=int8,
                                 precision=precision)
    dev = queries.device
    dtype, step = (torch.int8, 64) if int8 else (torch.float32, 32)
    for name, t in (("queries", queries), ("keys", keys)):
        _check_2d(f"mm_only: {name}", t, dtype, dev)
    bq, d = queries.shape
    if keys.shape[1] != d or d % step or n < 1:
        raise ValueError(f"mm_only: widths {d} / {keys.shape[1]} must match "
                         f"and be a multiple of {step}, over N >= 1 keys")
    mode = "int8" if int8 else precision
    plan = plan_mm_only(bq, n, d, mode, _device_sms(dev))
    if plan.body == "sm90":
        out = _launch_mm_sm90(queries, keys, n_valid, mode, plan)
        mm_only.sm90_launches += 1
    else:
        out = _launch_mm_mma(queries, keys, n_valid, mode, plan)
        mm_only.mma_launches += 1
    mm_only.launches += 1
    return out


def _launch_mm_mma(queries, keys, n_valid, mode, plan: MMPlan):
    """K6 on the mma.sync walks (csrc/topk.cu) under `plan`."""
    _own_mm_plan(plan, "mma", "mm_only mma launch")
    (bq, d), n, dev = queries.shape, keys.shape[0], queries.device
    kern = _kernel()
    part = torch.empty(bq * plan.splits, dtype=torch.float32, device=dev)
    out = torch.empty((bq, 128), dtype=torch.float32, device=dev)
    launch(kern.lib, kern.mm_only, "mm_only launch", queries,
           queries.data_ptr(), keys.data_ptr(), bq, n, d, n_valid,
           2 if mode == "int8" else PRECISIONS[mode], plan.qb, plan.splits,
           plan.tiles_per_split, plan.smem, part.data_ptr(), out.data_ptr())
    return out


def _launch_mm_sm90(queries, keys, n_valid, mode, plan: MMPlan):
    """K6 as the row-max launch of K4's Hopper body (fp32: the query
    pieces into a scratch tensor first) or K5's (int8) under `plan`, then
    the max over the key splits."""
    _own_mm_plan(plan, "sm90", "mm_only sm90 launch")
    (bq, d), n, dev = queries.shape, keys.shape[0], queries.device
    part = torch.empty(bq * plan.splits, dtype=torch.float32, device=dev)
    out = torch.empty((bq, 128), dtype=torch.float32, device=dev)
    if mode == "int8":
        kern = _i8_sm90_kernel()
        launch(kern.lib, kern.mm_only, "mm_only sm90 launch", queries,
               queries.data_ptr(), keys.data_ptr(), bq, n, d, n_valid,
               plan.qb, plan.splits, plan.tiles_per_split, plan.stages,
               plan.smem, part.data_ptr(), out.data_ptr())
    else:
        kern = _sm90_kernel()
        pieces = torch.empty((3 if mode == "high" else 1, bq, d),
                             dtype=torch.bfloat16, device=dev)
        launch(kern.lib, kern.mm_only, "mm_only sm90 launch", queries,
               queries.data_ptr(), keys.data_ptr(), pieces.data_ptr(), bq,
               n, d, n_valid, PRECISIONS[mode], plan.qb, plan.splits,
               plan.tiles_per_split, plan.stages, plan.smem,
               part.data_ptr(), out.data_ptr())
    return out


mm_only.launches = 0
mm_only.sm90_launches = 0
mm_only.mma_launches = 0


def tiny_reference(x):
    """Plain x + 1."""
    tiny_reference.calls += 1
    return x + 1.0


tiny_reference.calls = 0


def tiny(x):
    """K7: x + 1 on an fp32 array (the probe's (8, 128)): one launch through
    `ops/_launch.launch`, the floor of a call through this library."""
    if x.is_cpu:
        return tiny_reference(x)
    n = x.numel()
    if x.dtype is not torch.float32 or not x.is_contiguous() or n < 1:
        raise ValueError("tiny: needs a non-empty contiguous fp32 tensor")
    kern = _kernel()
    out = torch.empty_like(x)
    launch(kern.lib, kern.tiny, "tiny launch", x, x.data_ptr(),
           out.data_ptr(), n)
    tiny.launches += 1
    return out


tiny.launches = 0
