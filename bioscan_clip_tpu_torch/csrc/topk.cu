// Exact fp32 inner-product top-k over a resident key matrix.
//
// Replaces `pallas_topk` (bioscan_clip_tpu/ops/topk_pallas.py, kernel
// `_topk_kernel` with the running-top-k merge `_merge_tile`): top-k of
// Q . K^T, keys with index >= n_valid never enter, output sorted descending,
// and among equal values the smaller global key index comes first. Scores are
// full fp32 (FFMA, never TF32): the FAISS IndexFlatIP contract the retrieval
// engine keeps.
//
// What bounds it on an H100: one call reads the whole key matrix (1,048,576 x
// 768 fp32 = 3.22 GB, ~0.96 ms at 3.35 TB/s) and does 2 * Bq * N * 768 fp32
// FLOPs (Bq * 24 us at 67 TFLOP/s FFMA): memory-bound below ~40 queries and
// FFMA-bound above.
// Design: on the TPU the key-tile grid axis ran in order and carried the
// running top-k in VMEM. Here blocks run in parallel and a request brings
// only 1-256 queries, so the KEY axis is split across blocks:
//   pass 1, grid (query blocks of 64, key splits): each block walks its key
//     range in 128-key tiles, computes the (64 x 128) score tile with a
//     register-blocked FFMA product (8 queries x 4 keys per thread, 32-deep
//     shared-memory chunks of Q and K), writes the tile to shared memory,
//     and four threads per query keep sorted top-MAXK lists in registers over
//     interleaved columns; each thread writes its first k entries as
//     candidates (query, split, thread, k).
//   pass 2: one warp per query merges the (splits * 4 * k) candidates: each
//     lane keeps its own sorted list, then k rounds of a warp arg-best pop the
//     winners in order. The comparison is (value desc, index asc) everywhere,
//     which gives the tie rule whatever order candidates arrive in.
// Queries per block (64) amortise each key read over 64 queries, so key
// traffic stays under the FFMA time at Bq=256.

#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>

namespace {

constexpr int QT = 64;          // queries per block
constexpr int KT = 128;         // keys per tile
constexpr int DK = 32;          // depth of one shared-memory chunk
constexpr int TPB = 256;        // threads per pass-1 block
constexpr int QS = QT + 4;      // Q chunk row stride: float4-aligned reads
constexpr int KSS = KT + 1;     // K chunk row stride: conflict-free stores
constexpr int SS = KT + 4;      // score tile row stride: conflict-free scan
constexpr int SCAN = 4;         // scanning threads per query
constexpr int kPass2Threads = 128;

constexpr size_t kPass1Smem = sizeof(float) * (DK * QS + DK * KSS + QT * SS);

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
__global__ void __launch_bounds__(TPB)
    topk_pass1(const float* __restrict__ q, const float* __restrict__ keys,
               int bq, int n, int d, int n_valid, int k, int tiles_per_split,
               float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // DK x QS, transposed Q chunk
  float* kss = qs + DK * QS;     // DK x KSS, transposed K chunk
  float* ss = kss + DK * KSS;    // QT x SS score tile

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int n_tiles = (n + KT - 1) / KT;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);
  const int trow = tid >> 5;     // product: queries trow*8 .. trow*8+7
  const int tcol = tid & 31;     // product: keys tcol + 32*j
  const int sq = tid / SCAN;     // scan: query sq
  const int sl = tid % SCAN;     // scan: columns sl + SCAN*c

  float lv[MAXK];
  int li[MAXK];
#pragma unroll
  for (int p = 0; p < MAXK; ++p) {
    lv[p] = -INFINITY;
    li[p] = INT_MAX;
  }

  for (int t = tile0; t < tile1; ++t) {
    const int key0 = t * KT;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DK) {
      __syncthreads();  // previous chunk (and previous tile's scan) done
      for (int f = tid; f < QT * DK / 4; f += TPB) {
        const int r = f >> 3, c4 = f & 7;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < bq)
          x = *reinterpret_cast<const float4*>(q + (long long)(q0 + r) * d +
                                               d0 + c4 * 4);
        qs[(c4 * 4 + 0) * QS + r] = x.x;
        qs[(c4 * 4 + 1) * QS + r] = x.y;
        qs[(c4 * 4 + 2) * QS + r] = x.z;
        qs[(c4 * 4 + 3) * QS + r] = x.w;
      }
      for (int f = tid; f < KT * DK / 4; f += TPB) {
        const int r = f >> 3, c4 = f & 7;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (key0 + r < n)
          x = *reinterpret_cast<const float4*>(
              keys + (long long)(key0 + r) * d + d0 + c4 * 4);
        kss[(c4 * 4 + 0) * KSS + r] = x.x;
        kss[(c4 * 4 + 1) * KSS + r] = x.y;
        kss[(c4 * 4 + 2) * KSS + r] = x.z;
        kss[(c4 * 4 + 3) * KSS + r] = x.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DK; ++dd) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(qs + dd * QS + trow * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(qs + dd * QS + trow * 8 + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = kss[dd * KSS + tcol + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ss[(trow * 8 + i) * SS + tcol + 32 * j] = acc[i][j];
    __syncthreads();
    if (q0 + sq < bq) {
      const int stop = min(KT, n_valid - key0);  // keys >= n_valid never enter
      for (int c = sl; c < stop; c += SCAN) {
        const float s = ss[sq * SS + c];
        if (better(s, key0 + c, lv[MAXK - 1], li[MAXK - 1]))
          insert<MAXK>(lv, li, s, key0 + c);
      }
    }
  }

  if (q0 + sq < bq) {
    const long long o =
        (((long long)(q0 + sq) * gridDim.y + split) * SCAN + sl) * k;
#pragma unroll
    for (int p = 0; p < MAXK; ++p) {
      if (p < k) {
        cand_v[o + p] = lv[p];
        cand_i[o + p] = li[p];
      }
    }
  }
}

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
#pragma unroll
  for (int p = 0; p < MAXK; ++p) {
    lv[p] = -INFINITY;
    li[p] = INT_MAX;
  }
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
cudaError_t launch(const float* q, const float* keys, int bq, int n, int d,
                   int n_valid, int k, int splits, int tiles_per_split,
                   float* cand_v, int* cand_i, float* out_v, int* out_i,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1<MAXK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPass1Smem);
  if (err != cudaSuccess) return err;
  const dim3 grid1((bq + QT - 1) / QT, splits);
  topk_pass1<MAXK><<<grid1, TPB, kPass1Smem, stream>>>(
      q, keys, bq, n, d, n_valid, k, tiles_per_split, cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_cand = splits * SCAN * k;
  const int warps_per_block = kPass2Threads / 32;
  const int grid2 = (bq + warps_per_block - 1) / warps_per_block;
  topk_pass2<MAXK><<<grid2, kPass2Threads, 0, stream>>>(
      cand_v, cand_i, bq, n_cand, k, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes the wrapper must respect: q (bq, d) and keys (n, d) contiguous fp32,
// 16-byte aligned, d % 32 == 0, 1 <= k <= 32, k <= n_valid <= n.
// cand_v / cand_i hold bq * splits * 4 * k entries. Returns cudaError_t.
int bscan_topk_f32(const float* q, const float* keys, int bq, int n, int d,
                   int n_valid, int k, int splits, int tiles_per_split,
                   float* cand_v, int* cand_i, float* out_v, int* out_i,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % DK != 0 || k < 1 || k > 32 || n_valid > n)
    return (int)cudaErrorInvalidValue;
  if (k <= 8)
    return (int)launch<8>(q, keys, bq, n, d, n_valid, k, splits,
                          tiles_per_split, cand_v, cand_i, out_v, out_i, s);
  if (k <= 16)
    return (int)launch<16>(q, keys, bq, n, d, n_valid, k, splits,
                           tiles_per_split, cand_v, cand_i, out_v, out_i, s);
  return (int)launch<32>(q, keys, bq, n, d, n_valid, k, splits,
                         tiles_per_split, cand_v, cand_i, out_v, out_i, s);
}

// The launch plan for (bq, n, k) on a card with `sm_count` SMs: key splits
// so that about two pass-1 blocks per SM are in flight whatever the number
// of queries, key tiles per split, and the candidate entries (per buffer)
// the wrapper allocates for bscan_topk_f32.
void bscan_topk_plan(int bq, int n, int k, int sm_count, int* splits,
                     int* tiles_per_split, long long* n_cand) {
  const int n_tiles = (n + KT - 1) / KT;
  const int q_blocks = (bq + QT - 1) / QT;
  int want = (2 * sm_count + q_blocks - 1) / q_blocks;
  want = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  *tiles_per_split = (n_tiles + want - 1) / want;
  *splits = (n_tiles + *tiles_per_split - 1) / *tiles_per_split;
  *n_cand = (long long)bq * *splits * SCAN * k;
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
