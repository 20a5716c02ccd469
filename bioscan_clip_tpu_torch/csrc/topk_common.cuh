// The pieces of the fp32 top-k kernels (K4's two bodies, topk.cu and
// topk_sm90.cu, and K5's) that do not depend on a body's fragments: the
// (value desc, index asc) order, the per-query sorted lists in shared
// memory and their merge, the bf16 split of fp32 values, pass 2, and the
// dynamic shared memory attribute set once per card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int TPB = 256;          // 8 warps a pass-1 block
constexpr int BUF = 32;           // screened scores per query per merge
constexpr int kPass2Threads = 128;

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper

using bscan::allow_smem;
using bscan::kMaxDevices;

using bf16_t = bscan::bf16;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Insert (v, i) into a sorted list; the caller has checked that it beats the
// last entry, which drops out. Constant indices keep the list in registers.
template <int MAXK>
__device__ __forceinline__ void insert(float (&lv)[MAXK], int (&li)[MAXK],
                                       float v, int i) {
  bool placed = false;
#pragma unroll
  for (int p = MAXK - 1; p > 0; --p) {
    if (!placed) {
      if (better(v, i, lv[p - 1], li[p - 1])) {
        lv[p] = lv[p - 1];
        li[p] = li[p - 1];
      } else {
        lv[p] = v;
        li[p] = i;
        placed = true;
      }
    }
  }
  if (!placed) {
    lv[0] = v;
    li[0] = i;
  }
}

template <int MAXK>
__device__ __forceinline__ void init_list(float (&lv)[MAXK], int (&li)[MAXK]) {
#pragma unroll
  for (int p = 0; p < MAXK; ++p) {
    lv[p] = -INFINITY;
    li[p] = INT_MAX;
  }
}

// ---- pass 1's lists (K4 and K5) ------------------------------------------
//
// Per query of the block, in shared memory: its sorted list (MAXK entries),
// its buffer of screened scores (BUF), its threshold (value, index) and the
// buffer's count, each array at a fixed offset from one base, so that a
// block keeps one pointer, not seven.

template <int QB, int MAXK>
struct Lists {
  unsigned char* base;
  __device__ float* lv() const { return reinterpret_cast<float*>(base); }
  __device__ int* li() const {
    return reinterpret_cast<int*>(base) + QB * MAXK;
  }
  __device__ float* bv() const {
    return reinterpret_cast<float*>(base) + 2 * QB * MAXK;
  }
  __device__ int* bi() const {
    return reinterpret_cast<int*>(base) + 2 * QB * MAXK + QB * BUF;
  }
  __device__ float* thv() const {
    return reinterpret_cast<float*>(base) + 2 * QB * (MAXK + BUF);
  }
  __device__ int* thi() const {
    return reinterpret_cast<int*>(base) + 2 * QB * (MAXK + BUF) + QB;
  }
  __device__ int* cnt() const {
    return reinterpret_cast<int*>(base) + 2 * QB * (MAXK + BUF) + 2 * QB;
  }
};

__host__ __device__ constexpr size_t lists_bytes(int qb, int maxk) {
  return sizeof(float) * qb * (2 * maxk + 2 * BUF + 3);
}

// The lists of QB queries at `base`, set to empty: entries (-inf, INT_MAX),
// which every score beats, and no buffered score.
template <int QB, int MAXK>
__device__ __forceinline__ Lists<QB, MAXK> init_lists(unsigned char* base) {
  const Lists<QB, MAXK> L{base};
  for (int i = threadIdx.x; i < QB * MAXK; i += TPB) {
    L.lv()[i] = -INFINITY;
    L.li()[i] = INT_MAX;
  }
  for (int i = threadIdx.x; i < QB; i += TPB) {
    L.thv()[i] = -INFINITY;
    L.thi()[i] = INT_MAX;
    L.cnt()[i] = 0;
  }
  return L;
}

// Merge one query's screened scores (its buffer, n_buf entries) into its
// sorted list of k entries, by one warp: each entry's rank in the union is
// the count of entries better than it (the list's own order, plus a binary
// search of the list for a buffered entry, plus a count over the buffer);
// key indices are unique, so the ranks are distinct, and the entries ranked
// below k are the new list. Then the threshold is its k-th entry.
template <int MAXK>
__device__ __forceinline__ void merge_row(float* lv, int* li, const float* bv,
                                          const int* bi, int n_buf, int k,
                                          float* thv, int* thi, int* cnt,
                                          int lane) {
  constexpr int PER = (MAXK + BUF + 31) / 32;
  float v[PER];
  int ix[PER], rk[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = lane + 32 * j;
    rk[j] = INT_MAX;
    if (e < k + n_buf) {
      int r;
      if (e < k) {
        v[j] = lv[e];
        ix[j] = li[e];
        r = e;
      } else {
        v[j] = bv[e - k];
        ix[j] = bi[e - k];
        int lo = 0, hi = k;  // list entries better than it: a prefix
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (better(lv[mid], li[mid], v[j], ix[j]))
            lo = mid + 1;
          else
            hi = mid;
        }
        r = lo;
      }
      for (int b = 0; b < n_buf; ++b) r += better(bv[b], bi[b], v[j], ix[j]);
      rk[j] = r;
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (rk[j] < k) {
      lv[rk[j]] = v[j];
      li[rk[j]] = ix[j];
    }
  __syncwarp();
  if (lane == 0) {
    *thv = lv[k - 1];
    *thi = li[k - 1];
    *cnt = 0;
  }
}

// x and y (two adjacent k-slots) as TERMS packed bf16 pairs, the lower
// k-slot in the low half. TERMS = 1: each rounded to bf16 (nearest even).
// TERMS = 3: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid).
template <int TERMS>
struct Pieces {
  unsigned p[TERMS];
};

template <int TERMS>
__device__ __forceinline__ Pieces<TERMS> split_bf16(float x, float y) {
  Pieces<TERMS> out;
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    out.p[i] = *reinterpret_cast<const unsigned*>(&h);
    if (i + 1 < TERMS) {
      const float2 f = __bfloat1622float2(h);
      x = __fsub_rn(x, f.x);
      y = __fsub_rn(y, f.y);
    }
  }
  return out;
}

// ---- pass 2 ----------------------------------------------------------------

template <int MAXK>
__global__ void __launch_bounds__(kPass2Threads)
    topk_pass2(const float* __restrict__ cand_v,
               const int* __restrict__ cand_i, int bq, int n_cand, int k,
               float* __restrict__ out_v, int* __restrict__ out_i) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= bq) return;  // whole warps exit together

  float lv[MAXK];
  int li[MAXK];
  init_list<MAXK>(lv, li);
  const float* cv = cand_v + (long long)row * n_cand;
  const int* ci = cand_i + (long long)row * n_cand;
  for (int c = lane; c < n_cand; c += 32) {
    const float v = cv[c];
    const int i = ci[c];
    if (better(v, i, lv[MAXK - 1], li[MAXK - 1])) insert<MAXK>(lv, li, v, i);
  }

  for (int r = 0; r < k; ++r) {
    float bv = lv[0];
    int bi = li[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out_v[(long long)row * k + r] = bv;
      out_i[(long long)row * k + r] = bi;
    }
    if (lv[0] == bv && li[0] == bi) {  // key indices are unique: one owner
#pragma unroll
      for (int p = 0; p < MAXK - 1; ++p) {
        lv[p] = lv[p + 1];
        li[p] = li[p + 1];
      }
      lv[MAXK - 1] = -INFINITY;
      li[MAXK - 1] = INT_MAX;
    }
  }
}

template <int MAXK>
cudaError_t launch_pass2(int bq, int n_cand, int k, const float* cand_v,
                         const int* cand_i, float* out_v, int* out_i,
                         cudaStream_t stream) {
  const int warps_per_block = kPass2Threads / 32;
  const int grid2 = (bq + warps_per_block - 1) / warps_per_block;
  topk_pass2<MAXK><<<grid2, kPass2Threads, 0, stream>>>(
      cand_v, cand_i, bq, n_cand, k, out_v, out_i);
  return cudaGetLastError();
}

// K6's pass 2 (its walks in topk.cu, topk_sm90.cu and topk_i8_sm90.cu):
// one block of 128 threads per query row takes the max over
// its `splits` partial maxima and writes it to all 128 output columns.
__global__ void __launch_bounds__(128)
    mm_only_pass2(const float* __restrict__ part, int splits,
                  float* __restrict__ out) {
  __shared__ float warp_m[4];
  const int row = blockIdx.x;
  float m = -INFINITY;
  for (int s = threadIdx.x; s < splits; s += 128)
    m = fmaxf(m, part[(long long)row * splits + s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_m[threadIdx.x >> 5] = m;
  __syncthreads();
  m = fmaxf(fmaxf(warp_m[0], warp_m[1]), fmaxf(warp_m[2], warp_m[3]));
  out[(long long)row * 128 + threadIdx.x] = m;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<MAXK>{}) for the list size of k: 8, 16, 32 or (up to MAX) 64.
template <int MAX, class F>
cudaError_t by_maxk(int k, const F& f) {
  if (k <= 8) return f(Int<8>{});
  if (k <= 16) return f(Int<16>{});
  if (MAX == 32 || k <= 32) return f(Int<32>{});
  return f(Int<MAX>{});
}

}  // namespace
