// Exact fp32 inner-product top-k over a resident key matrix.
//
// Replaces `pallas_topk` (bioscan_clip_tpu/ops/topk_pallas.py, kernel
// `_topk_kernel` with the running-top-k merge `_merge_tile`): top-k of
// Q . K^T, keys with index >= n_valid never enter, output sorted descending,
// and among equal values the smaller global key index comes first. Scores are
// full fp32 (FFMA, never TF32): the FAISS IndexFlatIP contract the retrieval
// engine keeps. In "default" precision (`precision="default"` of
// `pallas_topk`, `Precision.DEFAULT` on the TPU: one bf16 pass with fp32
// sums) each operand is rounded to bf16 (round to nearest even) as it is
// staged, the product of two bf16 values is exact in fp32, and the products
// are summed in fp32: K6's mode 1 tile, with K4's lists, pass 2 and plan.
// The keys stay resident in fp32 either way.
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
//
// The int8 variant (K5) replaces `pallas_topk_i8` (same file, kernel
// `_topk_i8_kernel`, with `_merge_tile`'s running threshold): rows are
// symmetric per-row int8 codes with fp32 scales, and a score is the EXACT
// integer dot of the codes (int32 sums, exact in any order; D * 127^2 <
// 2^24 up to D = 1,040, so the int -> fp32 conversion is exact too) times
// the query
// scale, then times the key scale, each product rounded as fp32
// (`__fmul_rn`), in the order the TPU kernel multiplies them. What bounds
// it on an H100: one call reads N x D int8 codes plus N fp32 scales (0.80 GB
// at N = 1,048,576, D = 768: 0.2417 ms at 3.35 TB/s; 1.1523 ms at N =
// 5,000,000); its 2 * Bq * N * D integer operations take Bq * 0.8 us at the
// 1,979 TOP/s int8 tensor-core peak, so it is bound by bytes at every Bq of
// a request. Design (the K5 section below): pass 1 computes each tile's
// dots with int8 `mma.sync` (m16n8k32) from a `cp.async` ring of key
// chunks, over a query block of 16, 32 or 64 rows chosen from Bq (one
// query no longer pays for 64), with the key axis split across about two
// blocks per SM; it screens each score in registers against its query's
// running k-th best and merges only the scores that beat it into a sorted
// list per query in shared memory (the exactness argument is at
// topk_i8_pass1); the two blocks of a cluster merge their lists through
// distributed shared memory, and K4's pass 2 merges the (splits / 2 * k)
// candidates.
//
// K6 replaces `mm_only` (tools/bench_topk_variants.py, `_mm_only_kernel`),
// the top-k benchmark's matmul-only control: per query, the maximum over
// valid keys (index < n_valid) of Q . K^T, broadcast over 128 output
// columns. Its pass 1 runs K4's (fp32) tile product or the `__dp4a` int8
// tile K5 used before its tensor-core rebuild, and keeps a running row max
// in registers in place of the sorted lists; pass 2 takes the max over the
// key splits. So K4's time minus K6's fp32 time is what K4's lists cost;
// K5 no longer shares K6's int8 product, and K5 minus K6 int8 no longer
// gives the cost of anything. fp32 in "high" precision is FFMA; in "default"
// precision the operands are rounded to bf16 as they are staged (the TPU's
// single bf16 pass: bf16 products are exact in fp32, accumulated in fp32);
// int8 is the exact int32 dot converted to fp32, which equals the TPU's
// bf16 products of the codes summed in fp32 (768 * 127^2 < 2^24). Bound: as
// K4 (fp32) or K5 (int8).
//
// K7 replaces `tiny` (same file, `_tiny_kernel`): x + 1 on (8, 128) fp32,
// the launch-plus-sync floor of a call through this library.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

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

// K6's int8 tile: 64-byte depth chunks held as 32-bit words of 4 codes
constexpr int DKB = 64;         // int8 depth of one shared-memory chunk
constexpr int DKW = DKB / 4;    // the same in 32-bit words
constexpr int QSW = QT + 4;     // Q chunk row stride (words): int4 reads

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

// One scanning thread's pass over the (QT x KT) score tile in shared memory:
// query row sq, columns sl + SCAN * c; keys >= n_valid never enter.
template <int MAXK>
__device__ __forceinline__ void scan_tile(const float* ss, int sq, int sl,
                                          int key0, int n_valid,
                                          float (&lv)[MAXK], int (&li)[MAXK]) {
  const int stop = min(KT, n_valid - key0);
  for (int c = sl; c < stop; c += SCAN) {
    const float s = ss[sq * SS + c];
    if (better(s, key0 + c, lv[MAXK - 1], li[MAXK - 1]))
      insert<MAXK>(lv, li, s, key0 + c);
  }
}

// A scanning thread's first k entries as candidates (query, split, thread, k).
template <int MAXK>
__device__ __forceinline__ void emit_candidates(
    const float (&lv)[MAXK], const int (&li)[MAXK], int row, int split,
    int sl, int k, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  const long long o = (((long long)row * gridDim.y + split) * SCAN + sl) * k;
#pragma unroll
  for (int p = 0; p < MAXK; ++p) {
    if (p < k) {
      cand_v[o + p] = lv[p];
      cand_i[o + p] = li[p];
    }
  }
}

// An fp32 value rounded to bf16 and back (round to nearest even), or as it
// is.
template <bool ROUND_BF16>
__device__ __forceinline__ float4 round_f4(float4 x) {
  if (ROUND_BF16) {
    x.x = __bfloat162float(__float2bfloat16_rn(x.x));
    x.y = __bfloat162float(__float2bfloat16_rn(x.y));
    x.z = __bfloat162float(__float2bfloat16_rn(x.z));
    x.w = __bfloat162float(__float2bfloat16_rn(x.w));
  }
  return x;
}

// One thread's 8 x 4 share of the (QT x KT) fp32 score tile of queries q0..
// and keys key0..: acc[i][j] = q[q0 + trow * 8 + i] . keys[key0 + tcol +
// 32 j] (rows past bq or n are zero), summed in order over 32-deep
// shared-memory chunks. ROUND_BF16 rounds each operand to bf16 as it is
// staged (K6's "default" precision). Starts and ends with the block in step.
template <bool ROUND_BF16>
__device__ __forceinline__ void f32_tile(const float* __restrict__ q,
                                         const float* __restrict__ keys,
                                         int bq, int n, int d, int q0,
                                         int key0, float* qs, float* kss,
                                         float (&acc)[8][4]) {
  const int tid = threadIdx.x;
  const int trow = tid >> 5;     // queries trow*8 .. trow*8+7
  const int tcol = tid & 31;     // keys tcol + 32*j
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
        x = round_f4<ROUND_BF16>(*reinterpret_cast<const float4*>(
            q + (long long)(q0 + r) * d + d0 + c4 * 4));
      qs[(c4 * 4 + 0) * QS + r] = x.x;
      qs[(c4 * 4 + 1) * QS + r] = x.y;
      qs[(c4 * 4 + 2) * QS + r] = x.z;
      qs[(c4 * 4 + 3) * QS + r] = x.w;
    }
    for (int f = tid; f < KT * DK / 4; f += TPB) {
      const int r = f >> 3, c4 = f & 7;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key0 + r < n)
        x = round_f4<ROUND_BF16>(*reinterpret_cast<const float4*>(
            keys + (long long)(key0 + r) * d + d0 + c4 * 4));
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
}

// K6's int8 tile: acc[i][j] = the exact int32 dot of query code row q0 +
// trow * 8 + i and key code row key0 + tcol + 32 j, by `__dp4a` over
// 64-byte chunks held in shared memory as words of 4 codes.
__device__ __forceinline__ void i8_tile(const signed char* __restrict__ q,
                                        const signed char* __restrict__ keys,
                                        int bq, int n, int d, int q0,
                                        int key0, int* qs, int* kss,
                                        int (&acc)[8][4]) {
  const int tid = threadIdx.x;
  const int trow = tid >> 5;
  const int tcol = tid & 31;
  constexpr int V = DKB / 16;    // 16-byte vectors per chunk row
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int d0 = 0; d0 < d; d0 += DKB) {
    __syncthreads();  // previous chunk (and previous tile's scan) done
    for (int f = tid; f < QT * V; f += TPB) {
      const int r = f / V, c4 = f % V;
      int4 x = make_int4(0, 0, 0, 0);
      if (q0 + r < bq)
        x = *reinterpret_cast<const int4*>(q + (long long)(q0 + r) * d +
                                           d0 + c4 * 16);
      qs[(c4 * 4 + 0) * QSW + r] = x.x;
      qs[(c4 * 4 + 1) * QSW + r] = x.y;
      qs[(c4 * 4 + 2) * QSW + r] = x.z;
      qs[(c4 * 4 + 3) * QSW + r] = x.w;
    }
    for (int f = tid; f < KT * V; f += TPB) {
      const int r = f / V, c4 = f % V;
      int4 x = make_int4(0, 0, 0, 0);
      if (key0 + r < n)
        x = *reinterpret_cast<const int4*>(
            keys + (long long)(key0 + r) * d + d0 + c4 * 16);
      kss[(c4 * 4 + 0) * KSS + r] = x.x;
      kss[(c4 * 4 + 1) * KSS + r] = x.y;
      kss[(c4 * 4 + 2) * KSS + r] = x.z;
      kss[(c4 * 4 + 3) * KSS + r] = x.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < DKW; ++dd) {
      const int4 a0 =
          *reinterpret_cast<const int4*>(qs + dd * QSW + trow * 8);
      const int4 a1 =
          *reinterpret_cast<const int4*>(qs + dd * QSW + trow * 8 + 4);
      const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      int bk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kss[dd * KSS + tcol + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bk[j], acc[i][j]);
    }
  }
}

// ROUND_BF16: "default" precision, each operand rounded to bf16 as staged.
template <int MAXK, bool ROUND_BF16>
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
  init_list<MAXK>(lv, li);

  for (int t = tile0; t < tile1; ++t) {
    const int key0 = t * KT;
    float acc[8][4];
    f32_tile<ROUND_BF16>(q, keys, bq, n, d, q0, key0, qs, kss, acc);

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ss[(trow * 8 + i) * SS + tcol + 32 * j] = acc[i][j];
    __syncthreads();
    if (q0 + sq < bq) scan_tile<MAXK>(ss, sq, sl, key0, n_valid, lv, li);
  }

  if (q0 + sq < bq)
    emit_candidates<MAXK>(lv, li, q0 + sq, split, sl, k, cand_v, cand_i);
}

// ---- K5: int8 tensor-core tiles ----------------------------------------
//
// The product unit is `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`.
// Taken as 32-bit words of 4 codes, its fragments are those of the bf16
// m16n8k16 (attention_common.cuh): A (16 queries x 32 bytes) a[0] = (row g,
// word t), a[1] = (g + 8, t), a[2] = (g, 4 + t), a[3] = (g + 8, 4 + t); B
// (32 bytes x 8 keys) b[0] = (key g, word t), b[1] = (key g, word 4 + t);
// C (16 x 8 int32) c[0], c[1] = (row g, keys 2t, 2t + 1), c[2], c[3] = (row
// g + 8, the same keys); g = lane / 4, t = lane % 4. So `ldmatrix` (b16)
// loads both from row-major code tiles in shared memory as it loads bf16.
// A block holds QB query rows (16, 32 or 64, the plan's choice from Bq) of
// codes staged once, and walks its key range in 128-key tiles whose codes
// stream through a ring of depth chunks by `cp.async` (16 bytes a thread).
// Staged rows are padded by 16 bytes: the 8 rows of an `ldmatrix` then
// start 16 bytes apart modulo 128, free of bank conflicts (d % 64 == 0, so
// a row is 16 or 80 bytes modulo 128). Each of the 8 warps takes 16 keys of
// a tile (two n-blocks) against all QB rows.

constexpr int I8_KT = 128;            // keys per tile
constexpr int I8_TPB = 256;           // 8 warps, 16 keys of a tile each
constexpr int I8_BUF = 32;            // screened scores per query per merge
constexpr int I8_CLUSTER = 2;         // key splits merged before pass 2

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper

// Depth bytes per ring chunk and ring stages. Below 64 query rows a chunk
// is 128 bytes deep, whole 128-byte lines of each key row, which stream
// faster than half lines, in four stages; at 64 rows, 64 bytes in three,
// so that two blocks share an SM. A staged chunk row is padded by 16 bytes.
__host__ __device__ constexpr int i8_dc(int qb) { return qb == 64 ? 64 : 128; }
__host__ __device__ constexpr int i8_stages(int qb) { return qb == 64 ? 3 : 4; }

__host__ __device__ constexpr int i8_maxk(int k) {
  return k <= 8 ? 8 : (k <= 16 ? 16 : (k <= 32 ? 32 : 64));
}

// the staged queries, the ring, and per query its list (MAXK), its
// screened-score buffer (I8_BUF), threshold (value, index) and buffer count
__host__ __device__ constexpr size_t i8_smem(int qb, int d, int maxk) {
  return (size_t)qb * (d + 16) +
         (size_t)i8_stages(qb) * I8_KT * (i8_dc(qb) + 16) +
         sizeof(float) * qb * (2 * maxk + 2 * I8_BUF + 3);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Chunk c of the block's key range into ring slot c % STAGES: key rows of
// tile tile0 + c / cpt, depth bytes (c % cpt) * DC ..; keys >= n and depth
// >= d are zero.
template <int STAGES, int DC>
__device__ __forceinline__ void i8_load_chunk(unsigned char* ring,
                                              const signed char* keys, int n,
                                              int d, int tile0, int cpt,
                                              int c) {
  constexpr int V = DC / 16;  // 16-byte pieces per chunk row
  unsigned char* dst = ring + (c % STAGES) * (I8_KT * (DC + 16));
  const int key0 = (tile0 + c / cpt) * I8_KT;
  const int off = (c % cpt) * DC;
  for (int f = threadIdx.x; f < I8_KT * V; f += I8_TPB) {
    const int r = f / V, p = f % V;
    const bool ok = key0 + r < n && off + p * 16 < d;
    bscan::cp_async16(dst + r * (DC + 16) + p * 16,
                      keys + (ok ? (long long)(key0 + r) * d + off + p * 16
                                 : 0),
                      ok);
  }
}

// acc += the int32 dots of the block's QB query rows (A, row stride d + 16)
// and this warp's 16 keys of one staged chunk (DC / 32 k-steps of 32
// bytes). Past depth d the key chunk is zero, so whatever A holds there
// adds nothing.
template <int QB, int DC>
__device__ __forceinline__ void i8_mma_chunk(const signed char* as, int arow,
                                             int off, const unsigned char* kc,
                                             int warp, int lane,
                                             int (&acc)[QB / 16][2][4]) {
#pragma unroll
  for (int ks = 0; ks < DC / 32; ++ks) {
    unsigned b[4];
    bscan::ldsm_x4(b, kc + (warp * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                               (DC + 16) +
                           ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
    for (int mt = 0; mt < QB / 16; ++mt) {
      unsigned a[4];
      bscan::ldsm_x4(a, as + (mt * 16 + (lane & 15)) * arow + off + ks * 32 +
                            (lane >> 4) * 16);
      mma_s8(acc[mt][0], a, b[0], b[1]);
      mma_s8(acc[mt][1], a, b[2], b[3]);
    }
  }
}

// Merge one query's screened scores (its buffer, n_buf entries) into its
// sorted list of k entries, by one warp: each entry's rank in the union is
// the count of entries better than it (the list's own order, plus a binary
// search of the list for a buffered entry, plus a count over the buffer);
// key indices are unique, so the ranks are distinct, and the entries ranked
// below k are the new list. Then the threshold is its k-th entry.
template <int MAXK>
__device__ __forceinline__ void i8_merge_row(float* lv, int* li,
                                             const float* bv, const int* bi,
                                             int n_buf, int k, float* thv,
                                             int* thi, int* cnt, int lane) {
  constexpr int PER = (MAXK + I8_BUF + 31) / 32;
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

// K5's pass 1, grid (query blocks of QB, key splits). Each block walks its
// key range in 128-key tiles: the (QB x 128) int32 dots on the int8 tensor
// cores, then, in registers, each score formed in the fixed order
// (int -> fp32, times the query scale, times the key scale) and screened
// against its query's threshold theta, the k-th entry of the query's
// block-wide sorted list in shared memory. Scores that beat theta (by
// `better`: a score equal to theta passes when its key index is smaller)
// are appended to the query's buffer; at the end of each tile every query
// with buffered scores merges them into its list (one warp a query) and
// theta is refreshed. A buffer that fills mid-tile leaves the rest of the
// tile's passing scores pending in their threads: after the merge they are
// screened again, against the raised theta, until none is left.
// Exactness: until k scores of a query have entered its list, theta is
// (-inf, INT_MAX), which every score beats; after, theta is an entry that k
// entries of the same query's keys (itself included) beat or equal, so a
// score that does not beat it cannot be among the query's top k. Theta
// only rises, and it changes only between two barriers, so every thread of
// a screen reads the same value (a thread reading an older, lower theta
// would only admit more). The first block of each cluster writes the
// merged lists' first k entries as candidates (query, cluster, k) for K4's
// pass 2.
template <int MAXK, int QB>
__global__ void __cluster_dims__(1, I8_CLUSTER, 1) __launch_bounds__(I8_TPB, 2)
    topk_i8_pass1(const signed char* __restrict__ q,
                  const float* __restrict__ q_scale,
                  const signed char* __restrict__ keys,
                  const float* __restrict__ k_scale, int bq, int n, int d,
                  int n_valid, int k, int tiles_per_split,
                  float* __restrict__ cand_v, int* __restrict__ cand_i) {
  constexpr int STAGES = i8_stages(QB), DC = i8_dc(QB);
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int arow = d + 16;
  signed char* as = reinterpret_cast<signed char*>(smem_b);
  unsigned char* ring = smem_b + (size_t)QB * arow;
  float* lv = reinterpret_cast<float*>(ring + STAGES * I8_KT * (DC + 16));
  int* li = reinterpret_cast<int*>(lv + QB * MAXK);
  float* bv = reinterpret_cast<float*>(li + QB * MAXK);
  int* bi = reinterpret_cast<int*>(bv + QB * I8_BUF);
  float* thv = reinterpret_cast<float*>(bi + QB * I8_BUF);
  int* thi = reinterpret_cast<int*>(thv + QB);
  int* cnt = thi + QB;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min((n_valid + I8_KT - 1) / I8_KT,
                        tile0 + tiles_per_split);
  const int cpt = (d + DC - 1) / DC;
  const int n_chunks = max(0, tile1 - tile0) * cpt;

  // the query block's codes, staged once (rows >= bq zero)
  for (int f = tid; f < QB * (d / 16); f += I8_TPB) {
    const int r = f / (d / 16), p = f % (d / 16);
    const bool ok = q0 + r < bq;
    bscan::cp_async16(as + r * arow + p * 16,
                      q + (ok ? (long long)(q0 + r) * d + p * 16 : 0), ok);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks)
      i8_load_chunk<STAGES, DC>(ring, keys, n, d, tile0, cpt, s);
    bscan::cp_async_commit();
  }
  for (int i = tid; i < QB * MAXK; i += I8_TPB) {
    lv[i] = -INFINITY;
    li[i] = INT_MAX;
  }
  for (int i = tid; i < QB; i += I8_TPB) {
    thv[i] = -INFINITY;
    thi[i] = INT_MAX;
    cnt[i] = 0;
  }
  float qsc[QB / 16][2];
#pragma unroll
  for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + mt * 16 + g + 8 * h;
      qsc[mt][h] = r < bq ? q_scale[r] : 0.f;
    }
  int acc[QB / 16][2][4];
#pragma unroll
  for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0;
  float ksc[2][2];

  for (int c = 0; c < n_chunks; ++c) {
    const int key0 = (tile0 + c / cpt) * I8_KT;
    if (c % cpt == 0) {  // this thread's 4 key scales of the tile, early
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + warp * 16 + nb * 8 + 2 * t4 + e;
          ksc[nb][e] = key < n_valid ? __ldg(k_scale + key) : 0.f;
        }
    }
    bscan::cp_async_wait<STAGES - 2>();  // chunk c (and the queries) landed
    __syncthreads();  // ... for every thread; slot (c - 1) % STAGES is free
    if (c + STAGES - 1 < n_chunks)
      i8_load_chunk<STAGES, DC>(ring, keys, n, d, tile0, cpt,
                                c + STAGES - 1);
    bscan::cp_async_commit();
    i8_mma_chunk<QB, DC>(as, arow, (c % cpt) * DC,
                         ring + (c % STAGES) * (I8_KT * (DC + 16)), warp,
                         lane, acc);
    if (c % cpt != cpt - 1) continue;

    // the tile's scores: bit (mt * 2 + h) * 4 + nb * 2 + e of `pend` is
    // acc[mt][nb][2 h + e] (query mt * 16 + g + 8 h, key warp * 16 + nb * 8
    // + 2 t4 + e of the tile), set while it is still to be screened
    unsigned pend = 0;
#pragma unroll
    for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (q0 + mt * 16 + g + 8 * h < bq &&
                key0 + warp * 16 + nb * 8 + 2 * t4 + e < n_valid)
              pend |= 1u << ((mt * 2 + h) * 4 + nb * 2 + e);
    while (true) {
#pragma unroll
      for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const unsigned bit = 1u << ((mt * 2 + h) * 4 + nb * 2 + e);
              if (!(pend & bit)) continue;
              const int r = mt * 16 + g + 8 * h;
              const int key = key0 + warp * 16 + nb * 8 + 2 * t4 + e;
              const float s = __fmul_rn(
                  __fmul_rn(__int2float_rn(acc[mt][nb][2 * h + e]),
                            qsc[mt][h]),
                  ksc[nb][e]);
              if (!better(s, key, thv[r], thi[r])) {
                pend &= ~bit;
              } else {
                const int p = atomicAdd(cnt + r, 1);
                if (p < I8_BUF) {
                  bv[r * I8_BUF + p] = s;
                  bi[r * I8_BUF + p] = key;
                  pend &= ~bit;
                }
              }
            }
      __syncthreads();  // the buffers are full or the tile screened
      for (int r = warp; r < QB; r += I8_TPB / 32) {
        const int nbuf = min(cnt[r], I8_BUF);
        if (nbuf > 0)
          i8_merge_row<MAXK>(lv + r * MAXK, li + r * MAXK, bv + r * I8_BUF,
                             bi + r * I8_BUF, nbuf, k, thv + r, thi + r,
                             cnt + r, lane);
      }
      if (!__syncthreads_or(pend != 0)) break;  // lists and thetas updated
    }
#pragma unroll
    for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0;
  }
  bscan::cp_async_wait<0>();

  // The I8_CLUSTER key splits of a cluster merge their lists into its first
  // block's: I8_BUF entries at a time are copied from another block's shared
  // memory into the query's buffer and merged as screened scores are. Pass
  // 2 then reads a cluster's k candidates per query, not each split's.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every list of the cluster is final
  if (cluster.block_rank() == 0) {
    for (int src = 1; src < I8_CLUSTER; ++src) {
      const float* rv = cluster.map_shared_rank(lv, src);
      const int* ri = cluster.map_shared_rank(li, src);
      for (int r = warp; r < QB && q0 + r < bq; r += I8_TPB / 32)
        for (int b = 0; b < k; b += I8_BUF) {
          const int nbuf = min(I8_BUF, k - b);
          if (lane < nbuf) {
            bv[r * I8_BUF + lane] = rv[r * MAXK + b + lane];
            bi[r * I8_BUF + lane] = ri[r * MAXK + b + lane];
          }
          __syncwarp();
          i8_merge_row<MAXK>(lv + r * MAXK, li + r * MAXK, bv + r * I8_BUF,
                             bi + r * I8_BUF, nbuf, k, thv + r, thi + r,
                             cnt + r, lane);
        }
    }
    __syncthreads();
    const int group = split / I8_CLUSTER, groups = gridDim.y / I8_CLUSTER;
    for (int i = tid; i < QB * k; i += I8_TPB) {
      const int r = i / k, p = i - r * k;
      if (q0 + r < bq) {
        const long long o = ((long long)(q0 + r) * groups + group) * k + p;
        cand_v[o] = lv[r * MAXK + p];
        cand_i[o] = li[r * MAXK + p];
      }
    }
  }
  cluster.sync();  // the other blocks' lists stay until they are read
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

template <int MAXK, bool ROUND_BF16>
cudaError_t launch(const float* q, const float* keys, int bq, int n, int d,
                   int n_valid, int k, int splits, int tiles_per_split,
                   float* cand_v, int* cand_i, float* out_v, int* out_i,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1<MAXK, ROUND_BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPass1Smem);
  if (err != cudaSuccess) return err;
  const dim3 grid1((bq + QT - 1) / QT, splits);
  topk_pass1<MAXK, ROUND_BF16><<<grid1, TPB, kPass1Smem, stream>>>(
      q, keys, bq, n, d, n_valid, k, tiles_per_split, cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pass2<MAXK>(bq, splits * SCAN * k, k, cand_v, cand_i, out_v,
                            out_i, stream);
}

template <bool ROUND_BF16>
cudaError_t launch_f32(const float* q, const float* keys, int bq, int n,
                       int d, int n_valid, int k, int splits,
                       int tiles_per_split, float* cand_v, int* cand_i,
                       float* out_v, int* out_i, cudaStream_t stream) {
  if (k <= 8)
    return launch<8, ROUND_BF16>(q, keys, bq, n, d, n_valid, k, splits,
                                 tiles_per_split, cand_v, cand_i, out_v,
                                 out_i, stream);
  if (k <= 16)
    return launch<16, ROUND_BF16>(q, keys, bq, n, d, n_valid, k, splits,
                                  tiles_per_split, cand_v, cand_i, out_v,
                                  out_i, stream);
  return launch<32, ROUND_BF16>(q, keys, bq, n, d, n_valid, k, splits,
                                tiles_per_split, cand_v, cand_i, out_v, out_i,
                                stream);
}

template <int MAXK, int QB>
cudaError_t launch_i8(const signed char* q, const float* q_scale,
                      const signed char* keys, const float* k_scale, int bq,
                      int n, int d, int n_valid, int k, int splits,
                      int tiles_per_split, float* cand_v, int* cand_i,
                      float* out_v, int* out_i, cudaStream_t stream) {
  const int smem = (int)i8_smem(QB, d, MAXK);
  cudaError_t err = cudaFuncSetAttribute(
      topk_i8_pass1<MAXK, QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid1((bq + QB - 1) / QB, splits);
  topk_i8_pass1<MAXK, QB><<<grid1, I8_TPB, smem, stream>>>(
      q, q_scale, keys, k_scale, bq, n, d, n_valid, k, tiles_per_split,
      cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pass2<MAXK>(bq, splits / I8_CLUSTER * k, k, cand_v, cand_i,
                            out_v, out_i, stream);
}

template <int MAXK>
cudaError_t launch_i8_qb(const signed char* q, const float* q_scale,
                         const signed char* keys, const float* k_scale,
                         int bq, int n, int d, int n_valid, int k, int qb,
                         int splits, int tiles_per_split, float* cand_v,
                         int* cand_i, float* out_v, int* out_i,
                         cudaStream_t stream) {
  if (qb == 16)
    return launch_i8<MAXK, 16>(q, q_scale, keys, k_scale, bq, n, d, n_valid,
                               k, splits, tiles_per_split, cand_v, cand_i,
                               out_v, out_i, stream);
  if (qb == 32)
    return launch_i8<MAXK, 32>(q, q_scale, keys, k_scale, bq, n, d, n_valid,
                               k, splits, tiles_per_split, cand_v, cand_i,
                               out_v, out_i, stream);
  return launch_i8<MAXK, 64>(q, q_scale, keys, k_scale, bq, n, d, n_valid, k,
                             splits, tiles_per_split, cand_v, cand_i, out_v,
                             out_i, stream);
}

// K6's pass 1, grid (query blocks of 64, key splits) as K4's: each thread
// keeps the running max of its 8 query rows over its columns of every tile
// (keys >= n_valid never enter), then the warp (one group of 8 rows, 32
// column lanes) reduces it, and lane 0 writes part[row * splits + split].
// MODE 0: fp32 FFMA; 1: fp32 operands rounded to bf16; 2: int8 codes.
template <int MODE>
__global__ void __launch_bounds__(TPB)
    mm_only_pass1(const void* __restrict__ q, const void* __restrict__ keys,
                  int bq, int n, int d, int n_valid, int tiles_per_split,
                  float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int n_tiles = (n + KT - 1) / KT;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);
  const int trow = tid >> 5;
  const int tcol = tid & 31;

  float rm[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rm[i] = -INFINITY;
  for (int t = tile0; t < tile1; ++t) {
    const int key0 = t * KT;
    float sc[8][4];
    if (MODE == 2) {
      int* qs = reinterpret_cast<int*>(smem);
      int acc[8][4];
      i8_tile(static_cast<const signed char*>(q),
              static_cast<const signed char*>(keys), bq, n, d, q0, key0, qs,
              qs + DKW * QSW, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = __int2float_rn(acc[i][j]);
    } else {
      f32_tile<MODE == 1>(static_cast<const float*>(q),
                          static_cast<const float*>(keys), bq, n, d, q0, key0,
                          smem, smem + DK * QS, sc);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (key0 + tcol + 32 * j < n_valid) {
#pragma unroll
        for (int i = 0; i < 8; ++i) rm[i] = fmaxf(rm[i], sc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float m = rm[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const int row = q0 + trow * 8 + i;
    if (tcol == 0 && row < bq) part[(long long)row * gridDim.y + split] = m;
  }
}

// K6's pass 2: one block of 128 threads per query row takes the max over
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

template <int MODE>
cudaError_t launch_mm_only(const void* q, const void* keys, int bq, int n,
                           int d, int n_valid, int splits,
                           int tiles_per_split, float* part, float* out,
                           cudaStream_t stream) {
  // the staging buffers of K4's pass 1 or of the int8 tile, without a score
  // tile
  const size_t smem = MODE == 2 ? sizeof(int) * (DKW * QSW + DKW * KSS)
                                : sizeof(float) * (DK * QS + DK * KSS);
  const dim3 grid1((bq + QT - 1) / QT, splits);
  mm_only_pass1<MODE><<<grid1, TPB, smem, stream>>>(
      q, keys, bq, n, d, n_valid, tiles_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mm_only_pass2<<<bq, 128, 0, stream>>>(part, splits, out);
  return cudaGetLastError();
}

// K7: o = x + 1 over n fp32 elements.
__global__ void tiny_kernel(const float* __restrict__ x, float* __restrict__ o,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.f;
}

}  // namespace

extern "C" {

// Shapes the wrapper must respect: q (bq, d) and keys (n, d) contiguous fp32,
// 16-byte aligned, d % 32 == 0, 1 <= k <= 32, k <= n_valid <= n.
// precision: 0 "high" (fp32 FFMA), 1 "default" (operands rounded to bf16,
// fp32 sums). cand_v / cand_i hold bq * splits * 4 * k entries. Returns
// cudaError_t.
int bscan_topk_f32(const float* q, const float* keys, int bq, int n, int d,
                   int n_valid, int k, int precision, int splits,
                   int tiles_per_split, float* cand_v, int* cand_i,
                   float* out_v, int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % DK != 0 || k < 1 || k > 32 || n_valid > n || precision < 0 ||
      precision > 1)
    return (int)cudaErrorInvalidValue;
  if (precision == 1)
    return (int)launch_f32<true>(q, keys, bq, n, d, n_valid, k, splits,
                                 tiles_per_split, cand_v, cand_i, out_v,
                                 out_i, s);
  return (int)launch_f32<false>(q, keys, bq, n, d, n_valid, k, splits,
                                tiles_per_split, cand_v, cand_i, out_v, out_i,
                                s);
}

// K5. Shapes the wrapper must respect: q (bq, d) and keys (n, d) contiguous
// int8 codes, 16-byte aligned, d % 64 == 0; q_scale (bq,) and k_scale (n,)
// fp32; 1 <= k <= 64, k <= n_valid <= n; qb, splits, tiles_per_split and
// the candidate buffers' size from bscan_topk_i8_plan. Returns cudaError_t.
int bscan_topk_i8(const signed char* q, const float* q_scale,
                  const signed char* keys, const float* k_scale, int bq,
                  int n, int d, int n_valid, int k, int qb, int splits,
                  int tiles_per_split, float* cand_v, int* cand_i,
                  float* out_v, int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 64 != 0 || k < 1 || k > 64 || n_valid > n ||
      (qb != 16 && qb != 32 && qb != 64) ||
      i8_smem(qb, d, i8_maxk(k)) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (k <= 8)
    return (int)launch_i8_qb<8>(q, q_scale, keys, k_scale, bq, n, d, n_valid,
                                k, qb, splits, tiles_per_split, cand_v,
                                cand_i, out_v, out_i, s);
  if (k <= 16)
    return (int)launch_i8_qb<16>(q, q_scale, keys, k_scale, bq, n, d,
                                 n_valid, k, qb, splits, tiles_per_split,
                                 cand_v, cand_i, out_v, out_i, s);
  if (k <= 32)
    return (int)launch_i8_qb<32>(q, q_scale, keys, k_scale, bq, n, d,
                                 n_valid, k, qb, splits, tiles_per_split,
                                 cand_v, cand_i, out_v, out_i, s);
  return (int)launch_i8_qb<64>(q, q_scale, keys, k_scale, bq, n, d, n_valid,
                               k, qb, splits, tiles_per_split, cand_v, cand_i,
                               out_v, out_i, s);
}

// K5's launch plan for (bq, n, d, k) on a card with `sm_count` SMs: the
// query block (16 rows for bq <= 16, 32 for bq <= 32, else 64; smaller
// where the staged block would not fit in shared memory), key splits (a
// multiple of I8_CLUSTER) so that about two pass-1 blocks per SM are in
// flight, key tiles per split, and the candidate entries (per buffer) the
// wrapper allocates: k per query and cluster.
void bscan_topk_i8_plan(int bq, int n, int d, int k, int sm_count, int* qb,
                        int* splits, int* tiles_per_split,
                        long long* n_cand) {
  int b = bq <= 16 ? 16 : (bq <= 32 ? 32 : 64);
  while (b > 16 && i8_smem(b, d, i8_maxk(k)) > kMaxSmem) b /= 2;
  *qb = b;
  const int n_tiles = (n + I8_KT - 1) / I8_KT;
  const int q_blocks = (bq + b - 1) / b;
  int want = (2 * sm_count + q_blocks - 1) / q_blocks;
  want = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  *tiles_per_split = (n_tiles + want - 1) / want;
  const int clusters =
      (n_tiles + *tiles_per_split * I8_CLUSTER - 1) /
      (*tiles_per_split * I8_CLUSTER);
  *splits = clusters * I8_CLUSTER;
  *n_cand = (long long)bq * clusters * k;
}

// The launch plan for (bq, n, k) on a card with `sm_count` SMs: key splits
// so that about two pass-1 blocks per SM are in flight whatever the number
// of queries, key tiles per split, and the candidate entries (per buffer)
// the wrapper allocates for bscan_topk_f32 and bscan_topk_i8.
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

// K6. mode 0: q (bq, d) and keys (n, d) fp32, products in fp32 FFMA; mode 1:
// the same with each operand rounded to bf16; mode 2: int8 codes. d % 32 ==
// 0 (fp32) or d % 64 == 0 (int8), 16-byte aligned rows, 0 <= n_valid <= n,
// the plan of bscan_topk_plan; part holds bq * splits floats, out (bq, 128).
// A row with no valid key comes out -inf. Returns cudaError_t.
int bscan_mm_only(const void* q, const void* keys, int bq, int n, int d,
                  int n_valid, int mode, int splits, int tiles_per_split,
                  float* part, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_valid < 0 || n_valid > n || bq < 1) return (int)cudaErrorInvalidValue;
  if (mode == 0 && d % DK == 0)
    return (int)launch_mm_only<0>(q, keys, bq, n, d, n_valid, splits,
                                  tiles_per_split, part, out, s);
  if (mode == 1 && d % DK == 0)
    return (int)launch_mm_only<1>(q, keys, bq, n, d, n_valid, splits,
                                  tiles_per_split, part, out, s);
  if (mode == 2 && d % DKB == 0)
    return (int)launch_mm_only<2>(q, keys, bq, n, d, n_valid, splits,
                                  tiles_per_split, part, out, s);
  return (int)cudaErrorInvalidValue;
}

// K7: o = x + 1 over n contiguous fp32 elements. Returns cudaError_t.
int bscan_tiny(const float* x, float* o, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  tiny_kernel<<<(n + 1023) / 1024, 1024, 0,
                static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return (int)cudaGetLastError();
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
