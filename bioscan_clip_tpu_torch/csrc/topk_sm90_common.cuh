// The pieces of the top-k Hopper bodies (K4's topk_sm90.cu and K5's
// topk_i8_sm90.cu) that do not depend on the keys' type: the screen of a
// tile's wgmma accumulators against each query's running k-th best, the
// deferred merge of the buffers (K4: topk_common.cuh's merge_row; K5: the
// same merge by warp shuffles), and the dispatch on the query block.
#pragma once

#include <cuda_runtime.h>

#include "topk_common.cuh"

namespace {

// Merge the buffer of every query that holds at least `at` scores (one warp
// a query) and refresh its theta.
template <int NQ, int MAXK>
__device__ __forceinline__ void merge_buffers(const Lists<NQ, MAXK>& L,
                                              int at, int k, int warp,
                                              int lane) {
  for (int r = warp; r < NQ; r += TPB / 32) {
    const int nbuf = min(L.cnt()[r], BUF);
    if (nbuf >= at)
      merge_row<MAXK>(L.lv() + r * MAXK, L.li() + r * MAXK, L.bv() + r * BUF,
                      L.bi() + r * BUF, nbuf, k, L.thv() + r, L.thi() + r,
                      L.cnt() + r, lane);
  }
}

// merge_row (topk_common.cuh) with the buffer and the list in registers:
// lane b holds buffered entry b (n_buf <= BUF = 32), lane l list entries l
// and l + 32. Each entry's rank in the union is counted by shuffles, with
// no shared-memory load in the loops: a list entry's, its place in the list
// plus the buffered entries better than it; a buffered entry's, the list's
// and the buffer's entries better than it (key indices are unique, so the
// ranks are distinct). The entries ranked below k are the new list, its
// k-th entry the threshold: the same list as merge_row's. The loops run
// over all BUF and MAXK slots, unrolled, so that their shuffles issue
// together: a slot past n_buf or k holds (-inf, INT_MAX), and an empty
// list entry (v, INT_MAX), which no entry's rank counts as better than
// itself (a buffered entry beats its query's threshold, so every empty
// entry too).
template <int MAXK>
__device__ __forceinline__ void merge_row_shfl(float* lv, int* li,
                                               const float* bv,
                                               const int* bi, int n_buf,
                                               int k, float* thv, int* thi,
                                               int* cnt, int lane) {
  static_assert(BUF <= 32, "one buffered entry a lane");
  constexpr int LP = (MAXK + 31) / 32;  // list entries a lane
  constexpr unsigned kAll = 0xffffffffu;
  float xv[LP];
  int xi[LP], rx[LP];
#pragma unroll
  for (int p = 0; p < LP; ++p) {
    const int e = lane + 32 * p;
    xv[p] = e < k ? lv[e] : -INFINITY;
    xi[p] = e < k ? li[e] : INT_MAX;
    rx[p] = e;
  }
  const float yv = lane < n_buf ? bv[lane] : -INFINITY;
  const int yi = lane < n_buf ? bi[lane] : INT_MAX;
  int ry = 0;
#pragma unroll
  for (int b = 0; b < BUF; ++b) {
    const float v = __shfl_sync(kAll, yv, b);
    const int i = __shfl_sync(kAll, yi, b);
#pragma unroll
    for (int p = 0; p < LP; ++p) rx[p] += better(v, i, xv[p], xi[p]);
    ry += better(v, i, yv, yi);
  }
#pragma unroll
  for (int p = 0; p < LP; ++p) {
#pragma unroll
    for (int l = 0; l < (MAXK < 32 ? MAXK : 32); ++l) {
      const float v = __shfl_sync(kAll, xv[p], l);
      const int i = __shfl_sync(kAll, xi[p], l);
      ry += better(v, i, yv, yi);
    }
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < LP; ++p)
    if (lane + 32 * p < k && rx[p] < k) {
      lv[rx[p]] = xv[p];
      li[rx[p]] = xi[p];
    }
  if (lane < n_buf && ry < k) {
    lv[ry] = yv;
    li[ry] = yi;
  }
  __syncwarp();
  if (lane == 0) {
    *thv = lv[k - 1];
    *thi = li[k - 1];
    *cnt = 0;
  }
}

// merge_buffers by merge_row_shfl: lane l of warp w reads the count of
// query w + 8 l (NQ / 8 <= 32 queries a warp), and the warp merges the
// queries whose buffers hold at least `at` scores, one after another.
template <int NQ, int MAXK>
__device__ __forceinline__ void merge_buffers_shfl(const Lists<NQ, MAXK>& L,
                                                   int at, int k, int warp,
                                                   int lane) {
  constexpr int W = TPB / 32;
  static_assert(NQ <= 32 * W, "a query a lane");
  const int r = warp + W * lane;
  const bool full = r < NQ && min(L.cnt()[r], BUF) >= at;
  for (unsigned todo = __ballot_sync(0xffffffffu, full); todo;
       todo &= todo - 1) {
    const int q = warp + W * (__ffs(todo) - 1);
    merge_row_shfl<MAXK>(L.lv() + q * MAXK, L.li() + q * MAXK,
                         L.bv() + q * BUF, L.bi() + q * BUF,
                         min(L.cnt()[q], BUF), k, L.thv() + q, L.thi() + q,
                         L.cnt() + q, lane);
  }
}

// The barriers of a screen: every thread of the CTA (K4), or the consumer
// warpgroups alone (K5, named barrier 1 over 256 threads, while its
// producer warpgroup goes on loading).
struct CtaBarrier {
  static __device__ __forceinline__ void sync() { __syncthreads(); }
  static __device__ __forceinline__ bool sync_or(bool p) {
    return __syncthreads_or(p);
  }
};

struct ConsumerBarrier {
  static __device__ __forceinline__ void sync() {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
  static __device__ __forceinline__ bool sync_or(bool p) {
    unsigned r;
    asm volatile(
        "{\n.reg .pred p, q;\n"
        "setp.ne.u32 p, %1, 0;\n"
        "bar.red.or.pred q, 1, 256, p;\n"
        "selp.u32 %0, 1, 0, q;\n}\n"
        : "=r"(r)
        : "r"((unsigned)p)
        : "memory");
    return r != 0u;
  }
};

// Screen a finished tile's scores against each query's threshold theta and
// merge those that beat it into the query's list: csrc/topk.cu's
// screen_tile on the wgmma accumulators. score(j) is the score of query 8
// (j / 4) + 2 t4 + (j % 2) of the block against key `key` + 8 ((j / 2) % 2)
// (`key`: the thread's first key row of the tile, global), j < NQ / 2, with
// j a constant after unrolling (K4: the accumulator itself; K5: its int32
// dot scaled). Each round first marks the pending scores that reach their
// query's theta value, a loop of loads and compares only, so that its loads
// issue together (a score below theta's value cannot beat theta, and theta
// does not change before the round's barrier); only the marked scores are
// checked against theta's key index and appended to their query's buffer.
// A query merges its buffer into its list once it holds MERGE_AT scores
// (the kernel merges the rest after the walk): a theta that rises later
// admits more scores, never fewer, and most tiles then merge nothing. A
// score that does not fit its query's full buffer stays pending (bit j % 32
// of word j / 32) and is screened again after the merge. SHFL: merge by
// merge_buffers_shfl; Sync: the barriers (`warp` counts the threads that
// take part in them, TPB of them). `qvalid`: the caller's bits of the
// scores of queries below bq (query_bits), or null to test each score's.
template <int NQ, int MAXK, int MERGE_AT, bool SHFL = false,
          class Sync = CtaBarrier, class Score>
__device__ __forceinline__ void screen_scores(
    const Score& score, const Lists<NQ, MAXK>& L, int q0, int bq, int key,
    int n_valid, int k, int warp, int lane,
    const unsigned* qvalid = nullptr) {
  // R scores a thread, in W words of pending bits (the last one partly
  // used below 64 queries)
  constexpr int R = NQ / 2, W = (R + 31) / 32;
  const int t4 = lane & 3;
  const float* thv = L.thv();
  unsigned pend[W];
  if (qvalid != nullptr) {
    // of the given queries, the scores of keys key (j % 4 < 2) and key + 8
    // (j % 4 >= 2) below n_valid
    const unsigned keys = (key < n_valid ? 0x33333333u : 0u) |
                          (key + 8 < n_valid ? 0xCCCCCCCCu : 0u);
#pragma unroll
    for (int w = 0; w < W; ++w) pend[w] = qvalid[w] & keys;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) pend[w] = 0u;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int q = 8 * (j >> 2) + 2 * t4 + (j & 1);
      if (q0 + q < bq && key + 8 * ((j >> 1) & 1) < n_valid)
        pend[j >> 5] |= 1u << (j & 31);
    }
  }
  while (true) {
    unsigned any = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      unsigned hit = 0u;
#pragma unroll
      for (int i = 0; i < (R < 32 ? R : 32); ++i) {
        const int j = 32 * w + i;
        if (score(j) >= thv[8 * (j >> 2) + 2 * t4 + (j & 1)]) hit |= 1u << i;
      }
      pend[w] &= hit;
      any |= pend[w];
    }
    if (any) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const unsigned bit = 1u << (j & 31);
        if (!(pend[j >> 5] & bit)) continue;
        const int q = 8 * (j >> 2) + 2 * t4 + (j & 1);
        const int kj = key + 8 * ((j >> 1) & 1);
        const float s = score(j);
        if (!better(s, kj, thv[q], L.thi()[q])) {
          pend[j >> 5] &= ~bit;
        } else {
          const int p = atomicAdd(L.cnt() + q, 1);
          if (p < BUF) {
            L.bv()[q * BUF + p] = s;
            L.bi()[q * BUF + p] = kj;
            pend[j >> 5] &= ~bit;
          }
        }
      }
    }
    Sync::sync();  // the buffers are full or the tile screened
    if constexpr (SHFL)
      merge_buffers_shfl<NQ, MAXK>(L, MERGE_AT, k, warp, lane);
    else
      merge_buffers<NQ, MAXK>(L, MERGE_AT, k, warp, lane);
    any = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) any |= pend[w];
    if (!Sync::sync_or(any != 0u)) break;  // lists and thetas updated
  }
}

// The bits (j % 32 of word j / 32, j < NQ / 2) of a thread's scores whose
// query, 8 (j / 4) + 2 t4 + (j % 2) of the block at q0, lies below bq: the
// `qvalid` of screen_scores, the same for every tile of a CTA.
template <int NQ>
__device__ __forceinline__ void query_bits(unsigned (&bits)[(NQ / 2 + 31) /
                                                            32],
                                           int q0, int bq, int t4) {
  constexpr int R = NQ / 2, W = (R + 31) / 32;
#pragma unroll
  for (int w = 0; w < W; ++w) bits[w] = 0u;
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (q0 + 8 * (j >> 2) + 2 * t4 + (j & 1) < bq)
      bits[j >> 5] |= 1u << (j & 31);
}

// f(Int<nq>{}) for a query block of 64, 128 or 256 rows
template <class F>
cudaError_t by_nq(int nq, const F& f) {
  if (nq == 64) return f(Int<64>{});
  if (nq == 128) return f(Int<128>{});
  return f(Int<256>{});
}

}  // namespace
