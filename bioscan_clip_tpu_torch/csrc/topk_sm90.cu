// K4, the exact fp32-key top-k, for Hopper: one walk of the keys serves a
// block of up to 256 queries. The keys are wgmma's M side, split into bf16
// pieces in registers; the queries are its N side, split once a call and
// loaded as TMA tiles.
//
// Replaces (TPU Pallas kernel in bioscan_clip_tpu/ops/topk_pallas.py):
//   `pallas_topk` (:185; kernel `_topk_kernel` :133, running top-k
//   `_merge_tile` :59) in "high" (`Precision.HIGHEST`) and "default"
//   precision, for query counts at or above the plan's crossing and widths
//   that are a multiple of 64 (`ops/topk.plan_f32`); below the crossing
//   the mma.sync body of csrc/topk.cu runs.
//   With ROWMAX, K6's fp32 modes: `mm_only` (tools/bench_topk_variants.py
//   :78, `_mm_only_kernel` :47), from `ops/topk.plan_mm_only`'s crossing.
//
// Contract: csrc/topk.cu's header. Top-k of Q . K^T over keys[:n_valid],
// each row sorted descending, the smaller key index first among equal
// values. "high" sums the six products of the operands' three bf16 pieces
// whose indices add up to 2 or less, in fp32, within fp32 rounding of the
// full fp32 product; "default" the products of the operands rounded to bf16,
// summed in fp32. The keys stay resident in fp32.
//
// What bounds it on an H100: a call reads the keys once for every query
// block (1,048,576 x 768 fp32 = 3.22 GB, 0.962 ms at 3.35 TB/s); "default"
// does 2 Bq N D bf16 operations (Bq * 1.6 us at 989 TFLOP/s), "high" six
// times as many (Bq * 9.8 us). So up to a query block of 256 ("default") or
// 128 ("high") the keys leave device memory once a call, and "high" is bound
// by its products above Bq ~ 100.
//
// Design.
// - Grid (query blocks of NQ rows, key splits): about one CTA per SM (a CTA
//   takes most of an SM's shared memory), the query blocks of one key range
//   adjacent in launch order, so that they read it from L2 together. A CTA
//   walks its split's 128-key tiles in 64-deep chunks through a ring of
//   `stages` slots: a slot holds the chunk's fp32 keys (two TMA boxes of 128
//   rows x 32 floats, 128-byte swizzle) and the query block's TERMS bf16
//   piece tiles (NQ rows x 64, 128-byte swizzle). Thread 0 issues the loads
//   of chunk c + stages - 1 before its own products of chunk c; each warp
//   releases a slot once its products have read it (8 arrivals).
// - Products: consumer warpgroup w (two, 256 threads) takes keys 64 w .. 64 w
//   + 63 of the tile as wgmma's A (M = 64) from registers. Lane (g, t4) of
//   warp v reads key rows 16 v + g and 16 v + g + 8 at 16-byte unit 2 t4 + s
//   of a box for k-step s (a float4: depth 8 t4 + 4 s .. + 3) into k-slots
//   2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9, and splits them into TERMS bf16
//   pieces; the prologue kernel stores the query pieces in the same k-slot
//   order (`slot_depth`): a dot product does not depend on which k-slot
//   holds which depth. Units 2 t4 + s of rows g and g + 1 land, after the
//   swizzle (unit u of row r at u ^ (r % 8)), on 8 distinct 16-byte
//   positions: no bank conflict. B is a query piece tile, K-major, N = NQ.
//   "default": one wgmma a k-step, summed over the tile's whole depth on the
//   tensor cores, as the mma.sync body does. "high": each k-step's six
//   products, smallest first (lo.hi, mid.mid, hi.lo, hi.mid, mid.hi, hi.hi);
//   the products of kFaddSteps k-steps are summed from zero on the tensor
//   cores, then added to the running score by FADD: the tensor core's own
//   fp32 additions need not round to nearest, so they see only a 64-deep
//   partial sum, not the running score.
// - Screen: after a tile's last chunk a thread holds the scores of keys
//   16 v + g and 16 v + g + 8 of its warpgroup's 64 against queries 8 i +
//   2 t4 + e; they are screened against each query's running k-th best and
//   merged into the lists of topk_common.cuh, as csrc/topk.cu's screen_tile
//   does for its fragments (pending bits, NQ / 2 a thread), but in two
//   steps (loads and compares, then the appends of the few that pass) and
//   with a query's merge deferred until its buffer is half full. A tile
//   that floods (more than a quarter of some thread's scores reach their
//   thresholds, as when scores rise with the key index: a vote, one
//   barrier a tile, kFloodVote) first raises each query's threshold to the
//   k-th largest of its 32 strided group maxima (topk_sm90_common.cuh
//   `raise_flooded`), so it appends about k scores a query and merges
//   once, not 128 and eight times.
// - ROWMAX (K6): the same walk and products; after each tile a thread folds
//   its scores into running row maxima (keys at n_valid and above masked to
//   -inf) over its two key rows and, by shuffles, its warp's 8 row groups,
//   so that it keeps NQ / 32 registers, not NQ / 2; at the end the 8 warps'
//   maxima meet in the ring's first slot and each (query, split) writes one
//   partial maximum, which mm_only_pass2 reduces over the splits. No lists,
//   so the ring takes the shared memory: "default" three stages at 256
//   queries, four at 128; "high" two at 128, four at 64.
// - Each CTA writes its lists' first k entries as candidates (query, split,
//   k), and pass 2 (topk_common.cuh) takes the top k of each query's.
// No atomics in any sum and no order that depends on scheduling: two
// launches give the same bits.
//
// Budget (`plan_f32` in ops/topk.py gives the same numbers; the launch checks
// them): shared memory 1 KB of alignment + stages x (32 KB of keys + TERMS x
// NQ x 128 B of query pieces) + the lists, 4 NQ (2 MAXK + 2 BUF + 3) bytes,
// + 64 B of barriers: "default" NQ = 256 (k <= 8) 2 stages, NQ = 128 3,
// NQ = 64 4; "high" NQ = 128 2, NQ = 64 3. ROWMAX: 1 KB + stages x the
// stage + 64 B (`rowmax_smem_bytes`, `plan_mm_only`). Registers: NQ / 2 fp32 scores a
// thread ("high" also a chunk's partial sums) and 4 k-steps of A fragments
// (4 TERMS registers each); chip_smoke.py's build phase prints ptxas' count
// and spills for every instantiation.

#include <cuda.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "sm90_common.cuh"
#include "topk_common.cuh"
#include "topk_sm90_common.cuh"

namespace {

using bscan::smem_addr;
using namespace bscan::sm90;

constexpr int kTileKeys = 128;  // keys per tile: 64 per consumer warpgroup
constexpr int kChunk = 64;      // depth values per ring chunk: 4 k-steps
constexpr int kBoxFloats = 32;  // fp32 per key box row: one 128-byte row
constexpr int kKeyBoxBytes = kTileKeys * kBoxFloats * 4;  // 16 KB
constexpr int kKeyBytes = 2 * kKeyBoxBytes;               // a chunk's keys
constexpr int kPieceRowBytes = kChunk * 2;  // a query piece row of a chunk
constexpr int kMinStages = 2;
constexpr int kMaxStages = 4;
constexpr int kAlign = 1024;       // the 128-byte swizzle's atom: 8 rows
constexpr int kBarrierBytes = 64;  // full[4], empty[4]
constexpr int kFaddSteps = 4;      // "high": k-steps summed before one FADD
constexpr int kMergeAt = BUF / 2;  // a query's buffered scores that merge

__host__ __device__ constexpr int stage_bytes(int nq, int terms) {
  return kKeyBytes + terms * nq * kPieceRowBytes;
}

__host__ __device__ constexpr long long smem_bytes(int nq, int maxk,
                                                   int terms, int stages) {
  return kAlign + (long long)stages * stage_bytes(nq, terms) +
         (long long)lists_bytes(nq, maxk) + kBarrierBytes;
}

// K6's pass 1 (ROWMAX): the ring and the barriers, no lists
__host__ __device__ constexpr long long rowmax_smem_bytes(int nq, int terms,
                                                          int stages) {
  return kAlign + (long long)stages * stage_bytes(nq, terms) + kBarrierBytes;
}
static_assert(8 * 64 * 4 <= stage_bytes(64, 1) &&
                  8 * 256 * 4 <= stage_bytes(256, 1),
              "the warps' row maxima fit in the ring's first slot");

// The depth (within a 64-deep chunk) that k-slot j of the chunk holds:
// k-step j / 16, slot s = j % 16, lane t4 = (s % 8) / 2 of the key fragments.
__host__ __device__ constexpr int slot_depth(int j) {
  return 32 * ((j >> 4) >> 1) + 8 * ((j & 7) >> 1) + 4 * ((j >> 4) & 1) +
         2 * ((j & 15) >> 3) + (j & 1);
}

struct Args {
  int bq, d, n_valid, k, tiles_per_split, stages;
  float* cand_v;
  int* cand_i;
  float* part;  // ROWMAX: the (bq, splits) partial row maxima
};

// The query pieces, once a call: pieces[t][r][j] = piece t of q[r][depth],
// depth = 64 (j / 64) + slot_depth(j % 64); TERMS = 1: q rounded to bf16;
// TERMS = 3: hi, mid, lo (split_bf16).
template <int TERMS>
__global__ void __launch_bounds__(256)
    split_queries(const float* __restrict__ q,
                  unsigned short* __restrict__ pieces, int bq, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)bq * d) return;
  const int r = (int)(i / d), j = (int)(i % d);
  const float x = q[(long long)r * d + (j & ~(kChunk - 1)) +
                    slot_depth(j & (kChunk - 1))];
  const Pieces<TERMS> p = split_bf16<TERMS>(x, 0.f);
#pragma unroll
  for (int t = 0; t < TERMS; ++t)
    pieces[((long long)t * bq + r) * d + j] =
        (unsigned short)(p.p[t] & 0xFFFFu);
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// acc += the products of this thread's warpgroup's 64 keys and the NQ
// queries over the chunk in slot `st`; r0 is the thread's first key row
// of the tile (64 w + 16 v + g), the other r0 + 8.
template <int NQ, int TERMS>
__device__ __forceinline__ void chunk_products(float (&acc)[NQ / 2],
                                               uint32_t st, int r0, int g,
                                               int t4) {
  static_assert(TERMS == 1 || TERMS == 3, "one product or the six");
  // A: the key pieces of the chunk's 4 k-steps, piece t of k-step kk at
  // a[kk * TERMS + t]
  uint32_t a[4 * TERMS][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t box = st + (kk >> 1) * kKeyBoxBytes;
    const uint32_t unit = (uint32_t)((2 * t4 + (kk & 1)) ^ g) << 4;
    const float4 x0 = lds128(box + r0 * 128 + unit);
    const float4 x1 = lds128(box + (r0 + 8) * 128 + unit);
    const Pieces<TERMS> p0 = split_bf16<TERMS>(x0.x, x0.y);
    const Pieces<TERMS> p1 = split_bf16<TERMS>(x1.x, x1.y);
    const Pieces<TERMS> p2 = split_bf16<TERMS>(x0.z, x0.w);
    const Pieces<TERMS> p3 = split_bf16<TERMS>(x1.z, x1.w);
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
      a[kk * TERMS + t][0] = p0.p[t];
      a[kk * TERMS + t][1] = p1.p[t];
      a[kk * TERMS + t][2] = p2.p[t];
      a[kk * TERMS + t][3] = p3.p[t];
    }
  }
  // B: query piece t's tile at st + kKeyBytes + t * NQ * 128, k-step kk 32
  // bytes along its rows
  const uint64_t db = sw128_desc(st + kKeyBytes, 16);
  auto desc = [&](int t, int kk) {
    return db + (uint64_t)((t * NQ * kPieceRowBytes) >> 4) + 2 * kk;
  };
  if constexpr (TERMS == 1) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<NQ>::run(acc, a[kk], desc(0, kk), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
  } else {
    float part[NQ / 2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int first = kk % kFaddSteps == 0;
      if (first) wgmma_fence();
      const uint32_t(&hi)[4] = a[kk * 3];
      const uint32_t(&mid)[4] = a[kk * 3 + 1];
      const uint32_t(&lo)[4] = a[kk * 3 + 2];
      WgmmaRS<NQ>::run(part, lo, desc(0, kk), !first);  // lo.hi
      WgmmaRS<NQ>::run(part, mid, desc(1, kk), 1);      // mid.mid
      WgmmaRS<NQ>::run(part, hi, desc(2, kk), 1);       // hi.lo
      WgmmaRS<NQ>::run(part, hi, desc(1, kk), 1);       // hi.mid
      WgmmaRS<NQ>::run(part, mid, desc(0, kk), 1);      // mid.hi
      WgmmaRS<NQ>::run(part, hi, desc(0, kk), 1);       // hi.hi
      if (kk % kFaddSteps == kFaddSteps - 1) {
        wgmma_commit();
        wgmma_wait();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      }
    }
  }
  fence_regs(a);
}

// Screen a finished tile's scores against each query's threshold theta and
// merge those that beat it into the query's list (topk_sm90_common.cuh's
// screen_scores): acc[j] is the score of query 8 (j / 4) + 2 t4 + (j % 2)
// of the block against key `key` + 8 ((j / 2) % 2), `key` the thread's
// first key row of the tile (global). A query merges its buffer once it
// holds kMergeAt scores; each tile votes whether it floods (kFloodVote).
template <int NQ, int MAXK>
__device__ __forceinline__ void screen(const float (&acc)[NQ / 2],
                                       const Lists<NQ, MAXK>& L, int q0,
                                       int bq, int key, int n_valid, int k,
                                       int warp, int lane) {
  bool flood;  // kFloodCarry's state, which a vote does not read
  screen_scores<NQ, MAXK, kMergeAt, kFloodVote>(
      [&](int j) { return acc[j]; }, L, q0, bq, key, n_valid, k, warp, lane,
      flood);
}

// Pass 1 (ROWMAX: K6's pass 1, the same walk and products with a running
// row max in place of the screen and lists). Shared memory from the
// 1024-aligned base: the ring (slot s at s * stage_bytes: key box 0, key
// box 1, query piece tiles 0 .. TERMS - 1), the lists (none in ROWMAX,
// whose warps' row maxima take the ring's first slot once the walk is
// done), then the barriers full[s] at 8 s and empty[s] at 32 + 8 s.
template <int MAXK, int NQ, int TERMS, bool ROWMAX = false>
__global__ void __launch_bounds__(TPB, 1)
    topk_f32_sm90(const __grid_constant__ CUtensorMap tm_keys,
                  const __grid_constant__ CUtensorMap tm_q, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  constexpr int kStage = stage_bytes(NQ, TERMS);
  const int stages = a.stages;
  const uint32_t lists = base + stages * kStage;
  const uint32_t bars =
      lists + (ROWMAX ? 0u : (uint32_t)lists_bytes(NQ, MAXK));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * NQ;
  const int tile0 = blockIdx.y * a.tiles_per_split;
  const int tile1 = min((a.n_valid + kTileKeys - 1) / kTileKeys,
                        tile0 + a.tiles_per_split);
  const int cpt = a.d / kChunk;
  const int n_chunks = max(0, tile1 - tile0) * cpt;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);             // full[s]: the loader
      mbar_init(bars + 32 + 8 * s, TPB / 32);  // empty[s]: every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  Lists<NQ, MAXK> L{smem_raw + (lists - raw)};
  if constexpr (!ROWMAX) L = init_lists<NQ, MAXK>(smem_raw + (lists - raw));
  __syncthreads();

  // thread 0: chunk c's keys and query pieces into slot c % stages, once
  // every warp has released the slot's previous chunk
  auto load = [&](int c) {
    const int s = c % stages, use = c / stages;
    if (use > 0) mbar_wait(bars + 32 + 8 * s, (use - 1) & 1);
    const uint32_t st = base + s * kStage, full = bars + 8 * s;
    mbar_expect_tx(full, kStage);
    const int col = (c % cpt) * kChunk;
    const int key0 = (tile0 + c / cpt) * kTileKeys;
    tma_load(st, &tm_keys, full, col, key0, 0);
    tma_load(st + kKeyBoxBytes, &tm_keys, full, col + kBoxFloats, key0, 0);
#pragma unroll
    for (int t = 0; t < TERMS; ++t)
      tma_load(st + kKeyBytes + t * NQ * kPieceRowBytes, &tm_q, full, col, q0,
               t);
  };
  if (tid == 0) {
    for (int c = 0; c < stages - 1 && c < n_chunks; ++c) load(c);
  }

  const int r0 = 64 * (warp >> 2) + 16 * (warp & 3) + g;  // and r0 + 8
  float acc[NQ / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
  float rm[kRowMaxRegs<NQ>];  // ROWMAX: the running row maxima
#pragma unroll
  for (int u = 0; u < kRowMaxRegs<NQ>; ++u) rm[u] = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) {
    if (tid == 0 && c + stages - 1 < n_chunks) load(c + stages - 1);
    const int s = c % stages;
    mbar_wait(bars + 8 * s, (c / stages) & 1);
    __syncwarp();
    chunk_products<NQ, TERMS>(acc, base + s * kStage, r0, g, t4);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 32 + 8 * s);
    if (c % cpt == cpt - 1) {
      const int key = (tile0 + c / cpt) * kTileKeys + r0;
      if constexpr (ROWMAX)
        fold_rowmax<NQ>(rm, [&](int j) { return acc[j]; }, key < a.n_valid,
                        key + 8 < a.n_valid, -INFINITY, lane);
      else
        screen<NQ, MAXK>(acc, L, q0, a.bq, key, a.n_valid, a.k, warp, lane);
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
    }
  }
  if constexpr (ROWMAX) {
    __syncthreads();  // every warp is done with the ring
    rowmax_write<NQ, CtaBarrier>(
        rm, reinterpret_cast<float*>(smem_raw + (base - raw)), -INFINITY,
        q0, a.bq, a.part, tid);
    return;
  }
  __syncthreads();  // every screen is done: merge what is buffered
  merge_buffers<NQ, MAXK>(L, 1, a.k, warp, lane);
  __syncthreads();  // every list is final
  for (int i = tid; i < NQ * a.k; i += TPB) {
    const int r = i / a.k, p = i - r * a.k;
    if (q0 + r < a.bq) {
      const long long o =
          ((long long)(q0 + r) * gridDim.y + blockIdx.y) * a.k + p;
      a.cand_v[o] = L.lv()[r * MAXK + p];
      a.cand_i[o] = L.li()[r * MAXK + p];
    }
  }
}

// ---- host: tensor maps and the launches ----------------------------------

// A map over the (n, d) fp32 keys, boxes of 128 rows x 32 floats in the
// 128-byte swizzle; rows past n load as zeros.
bool encode_keys(CUtensorMap* map, const float* keys, int n, int d) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                 (cuuint64_t)n * (cuuint64_t)d * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxFloats, (cuuint32_t)kTileKeys,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(keys), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MAXK, int NQ, int TERMS, bool ROWMAX = false>
cudaError_t launch(const CUtensorMap& mk, const CUtensorMap& mq,
                   const Args& a, int splits, long long smem,
                   cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  const auto kernel = topk_f32_sm90<MAXK, NQ, TERMS, ROWMAX>;
  cudaError_t err = allow_smem(ready, (const void*)kernel, kMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.bq + NQ - 1) / NQ, splits);
  kernel<<<grid, TPB, smem, stream>>>(mk, mq, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory of topk_f32_sm90<maxk, nq, terms> at `stages`
// ring slots, in bytes.
long long bscan_topk_f32_sm90_smem(int nq, int maxk, int terms, int stages) {
  return smem_bytes(nq, maxk, terms, stages);
}

// The depth (0 .. 63) that k-slot j of a 64-deep chunk holds.
int bscan_topk_f32_sm90_slot_depth(int j) { return slot_depth(j); }

// K4 on the Hopper body. q (bq, d) and keys (n, d) contiguous fp32,
// 16-byte aligned, d % 64 == 0, 1 <= k <= 32, k <= n_valid <= n; pieces:
// (terms, bq, d) bf16 scratch (terms = 3 for precision 0 "high", 1 for 1
// "default"). The plan (`plan_f32` in ops/topk.py): the query block nq (64,
// 128 or 256; at most 128 in "high"), splits x tiles_per_split covering the
// n / 128 key tiles with no empty split, 2-4 ring stages, smem the bytes
// this library computes for them (at most 232,448), n_cand = bq * splits *
// k entries per candidate buffer. Otherwise it returns
// cudaErrorInvalidValue and launches nothing. Returns the cudaError_t of the
// launches (0 on success).
int bscan_topk_f32_sm90(const float* q, const float* keys, void* pieces,
                        int bq, int n, int d, int n_valid, int k,
                        int precision, int nq, int splits,
                        int tiles_per_split, int stages, long long smem,
                        long long n_cand, float* cand_v, int* cand_i,
                        float* out_v, int* out_i, void* stream) {
  const int terms = precision == 1 ? 1 : 3;
  const int maxk = k <= 8 ? 8 : (k <= 16 ? 16 : 32);
  const int n_tiles = (n + kTileKeys - 1) / kTileKeys;
  if (bq < 1 || d < kChunk || d % kChunk != 0 || k < 1 || k > 32 ||
      n_valid < k || n_valid > n || precision < 0 || precision > 1 ||
      (nq != 64 && nq != 128 && nq != 256) || (terms == 3 && nq > 128) ||
      stages < kMinStages || stages > kMaxStages || splits < 1 ||
      tiles_per_split < 1 || (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles ||
      smem != smem_bytes(nq, maxk, terms, stages) || smem > (long long)kMaxSmem ||
      n_cand != (long long)bq * splits * k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned short* pc = static_cast<unsigned short*>(pieces);
  const int blocks = (int)(((long long)bq * d + 255) / 256);
  if (terms == 1)
    split_queries<1><<<blocks, 256, 0, s>>>(q, pc, bq, d);
  else
    split_queries<3><<<blocks, 256, 0, s>>>(q, pc, bq, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mk, mq;
  if (!encode_keys(&mk, keys, n, d) ||
      !encode(&mq, pieces, terms, bq, d, nq))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.bq = bq;
  a.d = d;
  a.n_valid = n_valid;
  a.k = k;
  a.tiles_per_split = tiles_per_split;
  a.stages = stages;
  a.cand_v = cand_v;
  a.cand_i = cand_i;
  a.part = nullptr;
  err = by_nq(nq, [&](auto nqc) {
    return by_maxk<32>(k, [&](auto mkc) -> cudaError_t {
      constexpr int NQ = decltype(nqc)::value, MAXK = decltype(mkc)::value;
      if constexpr (NQ == 256 && MAXK > 8) {
        return cudaErrorInvalidValue;  // the lists would not fit
      } else if (terms == 1) {
        return launch<MAXK, NQ, 1>(mk, mq, a, splits, smem, s);
      } else if constexpr (NQ <= 128) {
        return launch<MAXK, NQ, 3>(mk, mq, a, splits, smem, s);
      } else {
        return cudaErrorInvalidValue;
      }
    });
  });
  if (err != cudaSuccess) return (int)err;
  return (int)by_maxk<32>(k, [&](auto mkc) {
    return launch_pass2<decltype(mkc)::value>(bq, splits * k, k, cand_v,
                                              cand_i, out_v, out_i, s);
  });
}

// The dynamic shared memory of K6's pass 1 on this walk
// (topk_f32_sm90<8, nq, terms, true>) at `stages` ring slots, in bytes.
long long bscan_mm_only_f32_sm90_smem(int nq, int terms, int stages) {
  return rowmax_smem_bytes(nq, terms, stages);
}

// K6 on K4's Hopper walk: out (bq, 128) fp32, each row the maximum over
// keys[:n_valid] of Q . K^T in K4's products (precision 0 "high": the six
// bf16 products; 1 "default": one), -inf where n_valid is 0. q (bq, d) and
// keys (n, d) contiguous fp32, 16-byte aligned, d % 64 == 0, 0 <= n_valid
// <= n; pieces: (terms, bq, d) bf16 scratch; part: bq * splits floats. The
// plan (`plan_mm_only` in ops/topk.py): the query block nq (64, 128 or
// 256; at most 128 in "high"), splits x tiles_per_split covering the n /
// 128 key tiles with no empty split, 2-4 ring stages, smem the bytes this
// library computes for them (at most 232,448). Otherwise it returns
// cudaErrorInvalidValue and launches nothing. Pass 1 writes each (query,
// split)'s maximum; pass 2 (mm_only_pass2) takes each query's over the
// splits. Returns the cudaError_t of the launches.
int bscan_mm_only_f32_sm90(const float* q, const float* keys, void* pieces,
                           int bq, int n, int d, int n_valid, int precision,
                           int nq, int splits, int tiles_per_split,
                           int stages, long long smem, float* part,
                           float* out, void* stream) {
  const int terms = precision == 1 ? 1 : 3;
  const int n_tiles = (n + kTileKeys - 1) / kTileKeys;
  if (bq < 1 || n < 1 || d < kChunk || d % kChunk != 0 || n_valid < 0 ||
      n_valid > n || precision < 0 || precision > 1 ||
      (nq != 64 && nq != 128 && nq != 256) || (terms == 3 && nq > 128) ||
      stages < kMinStages || stages > kMaxStages || splits < 1 ||
      tiles_per_split < 1 || (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles ||
      smem != rowmax_smem_bytes(nq, terms, stages) ||
      smem > (long long)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned short* pc = static_cast<unsigned short*>(pieces);
  const int blocks = (int)(((long long)bq * d + 255) / 256);
  if (terms == 1)
    split_queries<1><<<blocks, 256, 0, s>>>(q, pc, bq, d);
  else
    split_queries<3><<<blocks, 256, 0, s>>>(q, pc, bq, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mk, mq;
  if (!encode_keys(&mk, keys, n, d) ||
      !encode(&mq, pieces, terms, bq, d, nq))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.bq = bq;
  a.d = d;
  a.n_valid = n_valid;
  a.k = 1;
  a.tiles_per_split = tiles_per_split;
  a.stages = stages;
  a.cand_v = nullptr;
  a.cand_i = nullptr;
  a.part = part;
  err = by_nq(nq, [&](auto nqc) -> cudaError_t {
    constexpr int NQ = decltype(nqc)::value;
    if (terms == 1) return launch<8, NQ, 1, true>(mk, mq, a, splits, smem, s);
    if constexpr (NQ <= 128)
      return launch<8, NQ, 3, true>(mk, mq, a, splits, smem, s);
    return cudaErrorInvalidValue;
  });
  if (err != cudaSuccess) return (int)err;
  mm_only_pass2<<<bq, 128, 0, s>>>(part, splits, out);
  return (int)cudaGetLastError();
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
