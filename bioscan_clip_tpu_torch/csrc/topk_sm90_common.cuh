// The pieces of the top-k Hopper bodies (K4's topk_sm90.cu and K5's
// topk_i8_sm90.cu) that do not depend on the keys' type: the screen of a
// tile's wgmma accumulators against each query's running k-th best (with
// the raise of a flooded tile), the deferred merge of the buffers (K4:
// topk_common.cuh's merge_row; K5: the same merge by warp shuffles), K6's
// running row max in place of them (ROWMAX), and the dispatch on the query
// block.
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

// A score's bits in an order that unsigned compares follow: a larger float
// gives a larger value, and 0 lies below every score's.
__device__ __forceinline__ unsigned order_bits(float s) {
  const unsigned b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float from_order_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? u & 0x7fffffffu : ~u);
}

// A flooded tile's raise (screen_scores, MAXK <= BUF): each query's
// threshold goes up to a value that k of the tile's keys reach, so that
// the appends that follow take at most a few more than k of its scores.
// The tile's 128 keys of a query form BUF = 32 groups, key % 32 (keys c,
// c + 32, c + 64, c + 96), and the raise is the k-th largest group maximum
// of the scores that reach theta: k groups, so k distinct keys, reach it,
// and a key below it is worse than each of them, so not in the top k
// (keys equal to it stay in, whatever their index, so the tie rule is
// left to the merges). When the k best scores lie in k distinct groups,
// as when scores rise or fall with the key index, the raise is the tile's
// k-th best itself. theta becomes (raise, INT_MAX), which a score beats
// when it reaches the raise; a query whose pending scores fill fewer than
// k groups, or whose theta is above the raise, keeps its theta. Steps,
// each ended by a barrier: every buffer is merged (by its query's warp,
// warp q % 8, as merge_buffers* assign them), which frees the buffers, and
// that warp zeroes its queries' buffers as group slots; every pending
// score goes into its group's slot by an atomic max of its order bits (the
// slot of group c of query q at c + 8 (q / 2) mod 32 of q's buffer, so
// that the 32 lanes of a warp touch 32 banks); each query's warp sorts its
// 32 slots across its lanes (bitonic, descending) and raises theta to the
// k-th.
template <int NQ, int MAXK, bool SHFL, class Sync, class Score>
__device__ __forceinline__ bool raise_flooded(
    const Score& score, const unsigned (&pend)[(NQ / 2 + 31) / 32],
    const Lists<NQ, MAXK>& L, int key, int k, int warp, int lane) {
  static_assert(MAXK <= BUF, "k groups of the tile's keys");
  constexpr int R = NQ / 2, WARPS = TPB / 32;
  constexpr unsigned kAll = 0xffffffffu;
  const int t4 = lane & 3;
  unsigned* slot = reinterpret_cast<unsigned*>(L.bv());
  if constexpr (SHFL)
    merge_buffers_shfl<NQ, MAXK>(L, 1, k, warp, lane);
  else
    merge_buffers<NQ, MAXK>(L, 1, k, warp, lane);
  __syncwarp();
  for (int q = warp; q < NQ; q += WARPS) slot[q * BUF + lane] = 0u;
  Sync::sync();  // the buffers are group slots
  const int c0 = key & 31;  // the group of the thread's first key
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (pend[j >> 5] & (1u << (j & 31))) {
      const int q = 8 * (j >> 2) + 2 * t4 + (j & 1);
      const int c = (c0 + 8 * ((j >> 1) & 1) + 8 * (q >> 1)) & 31;
      atomicMax(slot + q * BUF + c, order_bits(score(j)));
    }
  Sync::sync();  // every group maximum is in
  bool raised = false;
  for (int q = warp; q < NQ; q += WARPS) {
    unsigned u = slot[q * BUF + lane];
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        const unsigned o = __shfl_xor_sync(kAll, u, stride);
        const bool high = ((lane & size) == 0) == ((lane & stride) == 0);
        u = high ? max(u, o) : min(u, o);
      }
    const unsigned kth = __shfl_sync(kAll, u, k - 1);
    if (lane == 0 && kth != 0u) {
      const float v = from_order_bits(kth);
      if (v > L.thv()[q]) {
        L.thv()[q] = v;
        L.thi()[q] = INT_MAX;
        raised = true;
      }
    }
  }
  return Sync::sync_or(raised);  // every theta raised; whether any was
}

// How a screen handles flooded tiles (its FLOOD parameter): kFloodNone,
// never raises; kFloodVote, each tile's threads vote after the first
// marking (one barrier) whether any marked more than a quarter of its R
// scores, and then raise inline (K4); kFloodCarry, the walk carries a
// flood state from tile to tile (no barrier), and a flooded tile's screen
// runs out of line (K5 at 128 queries). Each was the one that kept random
// keys at their times in that body (tools/sweep_screen_sm90.py compares
// them).
constexpr int kFloodNone = 0, kFloodVote = 1, kFloodCarry = 2;

// screen_scores' rounds over the pending scores `pend`, from the tile's
// first marking. MODE: kFloodNone, or kFloodVote, or kRaise: raise the
// thresholds after the first marking (the out-of-line flooded screen).
// `flood`: set when the scores took more than one round, or a raise
// raised a threshold.
constexpr int kRaise = -1;

template <int NQ, int MAXK, int MERGE_AT, bool SHFL, class Sync, int MODE,
          class Score>
__device__ __forceinline__ void screen_rounds(
    const Score& score, const Lists<NQ, MAXK>& L,
    unsigned (&pend)[(NQ / 2 + 31) / 32], int key, int k, int warp,
    int lane, bool& flood) {
  constexpr int R = NQ / 2, W = (R + 31) / 32;
  const int t4 = lane & 3;
  const float* thv = L.thv();
  [[maybe_unused]] bool first = MODE != kFloodNone;
  bool overflowed = false;  // the tile's scores took more than one round
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
    if constexpr (MODE != kFloodNone) {
      if (first) {
        first = false;
        bool raise = true;
        if constexpr (MODE == kFloodVote) {
          int marked = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) marked += __popc(pend[w]);
          raise = Sync::sync_or(4 * marked > R);
        }
        if (raise) {
          flood = raise_flooded<NQ, MAXK, SHFL, Sync>(score, pend, L, key, k,
                                                      warp, lane);
          continue;  // mark again against the raised thresholds
        }
      }
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
    overflowed = true;
  }
  if (overflowed) flood = true;
}

// kFloodCarry's flooded tile: its screen, out of line. Its scores and
// pending bits come by value and are copied into registers, so that the
// walk's loop holds only the call. Returns the walk's flood state after
// the tile.
template <class T, int N>
struct ByValue {
  T v[N];
};

template <int NQ, int MAXK, int MERGE_AT, bool SHFL, class Sync>
__device__ __noinline__ bool screen_flooded(
    ByValue<float, NQ / 2> s, ByValue<unsigned, (NQ / 2 + 31) / 32> bits,
    Lists<NQ, MAXK> L, int key, int k, int warp, int lane) {
  constexpr int R = NQ / 2, W = (R + 31) / 32;
  float sc[R];
  unsigned pend[W];
#pragma unroll
  for (int j = 0; j < R; ++j) sc[j] = s.v[j];
#pragma unroll
  for (int w = 0; w < W; ++w) pend[w] = bits.v[w];
  bool flood = false;
  screen_rounds<NQ, MAXK, MERGE_AT, SHFL, Sync, kRaise>(
      [&](int j) { return sc[j]; }, L, pend, key, k, warp, lane, flood);
  return flood;
}

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
// of word j / 32) and is screened again after the merge. With lists of at
// most BUF entries a flooded tile (scores that rise with the key index
// pass whole tiles) raises the thresholds after its first marking
// (raise_flooded), so that a query appends about k of the tile's scores
// and merges once, where 128 appends would merge eight times. FLOOD says
// which tiles raise (kFloodNone, kFloodVote, kFloodCarry above); `flood`
// is kFloodCarry's state, the same in every thread: a tile floods if its
// scores did not fit the buffers in one round, or if its raise raised a
// threshold, and the walk starts flooded (an empty list admits every
// score of the first tile). SHFL: merge by merge_buffers_shfl; Sync: the
// barriers (`warp` counts the threads that take part in them, TPB of
// them). `qvalid`: the caller's bits of the scores of queries below bq
// (query_bits), or null to test each score's.
template <int NQ, int MAXK, int MERGE_AT, int FLOOD, bool SHFL = false,
          class Sync = CtaBarrier, class Score>
__device__ __forceinline__ void screen_scores(
    const Score& score, const Lists<NQ, MAXK>& L, int q0, int bq, int key,
    int n_valid, int k, int warp, int lane, bool& flood,
    const unsigned* qvalid = nullptr) {
  // R scores a thread, in W words of pending bits (the last one partly
  // used below 64 queries)
  constexpr int R = NQ / 2, W = (R + 31) / 32;
  const int t4 = lane & 3;
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
  constexpr int MODE = MAXK <= BUF ? FLOOD : kFloodNone;
  if constexpr (MODE == kFloodCarry) {
    if (flood) {
      ByValue<float, R> s;
      ByValue<unsigned, W> bits;
#pragma unroll
      for (int j = 0; j < R; ++j) s.v[j] = score(j);
#pragma unroll
      for (int w = 0; w < W; ++w) bits.v[w] = pend[w];
      flood = screen_flooded<NQ, MAXK, MERGE_AT, SHFL, Sync>(
          s, bits, L, key, k, warp, lane);
      return;
    }
    screen_rounds<NQ, MAXK, MERGE_AT, SHFL, Sync, kFloodNone>(
        score, L, pend, key, k, warp, lane, flood);
  } else {
    screen_rounds<NQ, MAXK, MERGE_AT, SHFL, Sync, MODE>(score, L, pend, key,
                                                        k, warp, lane, flood);
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

// ---- K6's row max on the Hopper bodies (ROWMAX) --------------------------
//
// A thread keeps the running maxima of its scores in RM registers: after
// each tile it folds the tile's R = NQ / 2 scores (score(j) as in
// screen_scores, keys at n_valid and above masked to `lowest`) over its
// two key rows, then over the 8 row-group lanes of its warp by three
// halvings, each a shuffle a pair of values: a lane keeps one of each pair
// and takes the other lane's maximum of it, so that after the three lanes
// g own disjoint queries. Value u of lane (g, t4) is then the maximum of
// query 32 u + 8 (g / 2) + 2 t4 + g % 2 over the warp's 16 keys of each
// tile so far (NQ = 16: query 8 ((g / 2) % 2) + 2 t4 + g % 2, lanes g and
// g ^ 4 alike). rowmax_write reduces the 8 warps through shared memory.

template <int NQ>
constexpr int kRowMaxRegs = NQ >= 32 ? NQ / 32 : 1;

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

// out[t] = the maximum over lanes l and l ^ mask of in[2 t + b], b the
// lane's mask bit.
template <int N, class T>
__device__ __forceinline__ void halve(const T (&in)[N], T (&out)[N / 2],
                                      int lane, int mask) {
  const bool b = (lane & mask) != 0;
#pragma unroll
  for (int t = 0; t < N / 2; ++t) {
    const T keep = b ? in[2 * t + 1] : in[2 * t];
    const T send = b ? in[2 * t] : in[2 * t + 1];
    out[t] = vmax(keep, __shfl_xor_sync(0xffffffffu, send, mask));
  }
}

// Fold a finished tile into rm: key0 and key1 say whether the thread's
// keys `key` and `key` + 8 lie below n_valid.
template <int NQ, class T, class Score>
__device__ __forceinline__ void fold_rowmax(T (&rm)[kRowMaxRegs<NQ>],
                                            const Score& score, bool key0,
                                            bool key1, T lowest, int lane) {
  constexpr int R = NQ / 2;
  T m[R / 2];  // i = 2 (j / 4) + j % 2: query 8 (i / 2) + 2 t4 + i % 2
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int j = 4 * (i >> 1) + (i & 1);
    m[i] = vmax(key0 ? score(j) : lowest, key1 ? score(j + 2) : lowest);
  }
  T m1[R / 4], m2[R / 8];
  halve<R / 2>(m, m1, lane, 4);
  halve<R / 4>(m1, m2, lane, 8);
  if constexpr (R / 8 >= 2) {
    T m3[R / 16];
    halve<R / 8>(m2, m3, lane, 16);
#pragma unroll
    for (int u = 0; u < R / 16; ++u) rm[u] = vmax(rm[u], m3[u]);
  } else {
    rm[0] = vmax(rm[0], vmax(m2[0], __shfl_xor_sync(0xffffffffu, m2[0], 16)));
  }
}

__device__ __forceinline__ float rowmax_value(float m) { return m; }
__device__ __forceinline__ float rowmax_value(int m) {
  return m == INT_MIN ? -INFINITY : __int2float_rn(m);
}

// The CTA's row maxima: each warp's through `red` (8 x NQ values of shared
// memory), then over the warps: part[query * splits + split] as fp32 (the
// int8 dots converted once; a query whose split holds no valid key,
// -inf). `tid`: the thread's index among the TPB that take part.
template <int NQ, class Sync, class T>
__device__ __forceinline__ void rowmax_write(const T (&rm)[kRowMaxRegs<NQ>],
                                             T* red, T lowest, int q0,
                                             int bq, float* part, int tid) {
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int u = 0; u < kRowMaxRegs<NQ>; ++u) {
    if (NQ >= 32)
      red[warp * NQ + 32 * u + 8 * (g >> 1) + 2 * t4 + (g & 1)] = rm[u];
    else if (g < 4)
      red[warp * NQ + 8 * (g >> 1) + 2 * t4 + (g & 1)] = rm[u];
  }
  Sync::sync();
  for (int i = tid; i < NQ; i += TPB) {
    if (q0 + i >= bq) continue;
    T m = lowest;
#pragma unroll
    for (int w = 0; w < TPB / 32; ++w) m = vmax(m, red[w * NQ + i]);
    part[(long long)(q0 + i) * gridDim.y + blockIdx.y] = rowmax_value(m);
  }
}

// f(Int<nq>{}) for a query block of 64, 128 or 256 rows
template <class F>
cudaError_t by_nq(int nq, const F& f) {
  if (nq == 64) return f(Int<64>{});
  if (nq == 128) return f(Int<128>{});
  return f(Int<256>{});
}

}  // namespace
