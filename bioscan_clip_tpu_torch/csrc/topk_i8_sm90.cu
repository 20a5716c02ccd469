// K5, the exact int8-key top-k, for Hopper: one walk of the keys serves a
// block of up to 128 queries. Both operands of int8 wgmma come straight from
// TMA tiles in shared memory: the keys as its M side, the queries as its N
// side, both K-major as 8-bit wgmma needs them and as the codes lie.
//
// Replaces (TPU Pallas kernel in bioscan_clip_tpu/ops/topk_pallas.py):
//   `pallas_topk_i8` (:253; kernel `_topk_i8_kernel` :154, with
//   `_merge_tile`'s running threshold), for query counts at or above the
//   plan's crossing and widths that are a multiple of 128
//   (`ops/topk.plan_i8`); elsewhere the mma.sync body of csrc/topk.cu runs.
//   With ROWMAX, K6's int8 mode: `mm_only` (tools/bench_topk_variants.py
//   :78, `_mm_only_kernel` :47), from `ops/topk.plan_mm_only`'s crossing.
//
// Contract: csrc/topk.cu's header (the K5 paragraph). Top-k over
// keys[:n_valid] of the scores __fmul_rn(__fmul_rn(float(dot), q_scale),
// k_scale), `dot` the exact int32 dot product of the codes (wgmma sums it
// in int32 on the tensor cores, exact in any order), the multiplies in the
// TPU kernel's order; each row sorted descending, the smaller key index
// first among equal values. So it equals its plain version bit for bit.
//
// What bounds it on an H100: a call reads the key codes and scales once for
// every query block (1,048,576 x 768 int8 + 4 MB of scales = 0.81 GB,
// 0.2417 ms at 3.35 TB/s; 5,000,000 keys 1.1523 ms); its 2 Bq N D integer
// operations take Bq * 0.81 us at the 1,979 TOP/s int8 peak (0.208 ms at
// Bq = 256, N = 1,048,576). Up to Bq = 256 the bytes bound it. What no bound
// counts is the screen: at k = 21 each key split appends ~150 scores a
// query to its lists (and its first tile all 128 of them), and every
// append and merge is latency-bound work on 8 warps an SM.
//
// Design (K4's Hopper body, csrc/topk_sm90.cu, with int8 operands, a
// producer warpgroup and a seeded threshold).
// - Grid (query blocks of NQ = 16, 32, 64 or 128 rows, the smallest that
//   holds Bq, key splits): about one CTA
//   per SM, the query blocks of one key range adjacent in launch order, so
//   that they read it from L2 together. A CTA is three warpgroups.
//   Warpgroup 0, the producer: one thread
//   walks the split's 128-key tiles in 128-byte depth chunks (four k-steps)
//   through a ring of `stages` slots, each slot the chunk's key codes (one
//   TMA box of 128 rows x 128 bytes) and the query block's (NQ rows x 128
//   bytes), both in the 128-byte swizzle, waiting on a slot's `empty`
//   barrier before it reuses it. So loads stay in flight while the
//   consumers screen. Warpgroups 1 and 2, the consumers: warpgroup w takes
//   keys 64 w .. 64 w + 63 of each tile as wgmma's A (M = 64) and the NQ
//   queries as B, both by shared-memory descriptors, one wgmma m64nNQk32 a
//   32-byte k-step (a k-step's descriptors are the chunk's advanced by 32
//   bytes: the swizzle applies to the computed address); no code passes
//   through registers. The s32 accumulators sum the tile's whole depth. A
//   chunk's products are issued as one wgmma group, and a warp frees the
//   previous chunk's slot once that group has completed (wait_group 1), so
//   the tensor cores run under the wait for the next chunk.
// - Screen (topk_sm90_common.cuh, K4's, between the consumers alone: named
//   barrier 1): after a tile's last chunk a thread holds the dots of keys
//   16 v + g and 16 v + g + 8 of its warpgroup's 64 against queries 8 i +
//   2 t4 + e, and forms each score in place from the dot, the query's scale
//   (the block's NQ scales staged in shared memory once a CTA: a thread
//   touches NQ / 4 queries) and the key's (two a tile a thread, plain loads
//   issued as the tile starts: the engine's scales start at any row of a
//   slab, not always 16-byte aligned). A query's buffer merges into its
//   list by warp shuffles over registers (merge_row_shfl). At a block of
//   128 queries a flooded tile (scores rising with the key index pass whole
//   tiles) first raises each query's threshold to the k-th largest of its
//   32 strided group maxima (`raise_flooded`): about k appends a query and
//   one merge, where 128 appends merged eight times. The walk carries its
//   flood state from tile to tile and screens a flooded tile out of line
//   (kFloodCarry): K4's vote, a barrier a tile, with the raise inline made
//   random keys 3-18% slower here; smaller blocks keep the plain screen.
// - ROWMAX (K6): the same walk and products with no scales, screen, lists
//   or seed; a thread folds each tile's int32 dots into NQ / 32 running
//   maxima (keys at n_valid and above masked), the warps' meet in the
//   ring's first slot after the walk, and each (query, split) writes one
//   maximum, converted to fp32 once; mm_only_pass2 reduces the splits.
//   The ring takes the shared memory: seven stages at 128 queries.
// - Seed: a first launch of this kernel (SEED) walks k disjoint groups of
//   up to kSeedTiles whole tiles spread over keys[:n_valid] (grid: query
//   blocks x k) and writes each query's best score in each group. The
//   least of a query's k group bests is a score that k distinct keys
//   reach or beat, so no key scoring below it is in the query's top k: the
//   main launch starts each query's threshold there, with its list's empty
//   entries (seed, INT_MAX), which every key that reaches the seed beats,
//   in place of (-inf, INT_MAX). A split then appends the few keys above
//   the seed, not its first tile whole. Empty entries that survive as
//   candidates lose in pass 2 to the k real ones, which all reach the seed.
// - Each CTA writes its lists' first k entries as candidates (query, split,
//   k), and pass 2 (topk_common.cuh) takes the top k of each query's.
// No atomics in any sum and no order that depends on scheduling: two
// launches give the same bits.
//
// Budget (`plan_i8` in ops/topk.py gives the same numbers; the launch checks
// them): shared memory 1 KB of alignment + stages x (128 + NQ) x 128 bytes
// of codes + the lists, 4 NQ (2 MAXK + 2 BUF + 3) bytes, + 4 NQ bytes of
// query scales + 128 B of barriers: at MAXK = 32 (k = 21) NQ = 128 four
// stages, NQ = 64 eight. Registers: at most 168 a thread (384 threads, one
// CTA an SM); a consumer holds NQ / 2 int32 accumulators and no operand
// fragments. No `setmaxnreg`: ptxas keeps its allocation within the launch
// bound's 168 whatever the consumers are given later, and an increase
// beyond what the producer releases would wait forever; so 256 queries a
// block (128 accumulators and the screen's state) would spill.
// chip_smoke.py's build phase prints ptxas' count and spills for every
// instantiation.

#include <cuda.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "sm90_common.cuh"
#include "topk_common.cuh"
#include "topk_sm90_common.cuh"

namespace {

using bscan::smem_addr;
using namespace bscan::sm90;

constexpr int kThreads = 384;   // the producer and two consumer warpgroups
constexpr int kTileKeys = 128;  // keys per tile: 64 per consumer warpgroup
constexpr int kChunk = 128;     // depth bytes a ring chunk: four k-steps
constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
constexpr int kAlign = 1024;        // the 128-byte swizzle's atom: 8 rows
constexpr int kBarrierBytes = 128;  // full[8], empty[8]
constexpr int kMergeAt = BUF / 2;   // a query's buffered scores that merge
constexpr int kSeedTiles = 8;       // whole tiles in a seed group, at most
static_assert(TPB == kThreads - 128, "the screen's threads: the consumers");

__host__ __device__ constexpr int stage_bytes(int nq) {
  return (kTileKeys + nq) * kChunk;
}

__host__ __device__ constexpr long long smem_bytes(int nq, int maxk,
                                                   int stages) {
  return kAlign + (long long)stages * stage_bytes(nq) +
         (long long)lists_bytes(nq, maxk) + 4 * nq + kBarrierBytes;
}

// K6's pass 1 (ROWMAX): the ring and the barriers, no lists or scales
__host__ __device__ constexpr long long rowmax_smem_bytes(int nq,
                                                          int stages) {
  return kAlign + (long long)stages * stage_bytes(nq) + kBarrierBytes;
}
static_assert(8 * 16 * 4 <= stage_bytes(16) && 8 * 128 * 4 <= stage_bytes(128),
              "the warps' row maxima fit in the ring's first slot");

// The seed's groups over keys[:n_valid]: group g walks `tiles` whole tiles
// from tile g * stride; none when there are fewer than `groups` whole
// tiles.
struct SeedGroups {
  int tiles, stride;
  __host__ __device__ SeedGroups(int n_valid, int groups) {
    const int whole = n_valid / kTileKeys;
    stride = groups > 0 ? whole / groups : 0;
    tiles = stride < kSeedTiles ? stride : kSeedTiles;
  }
};

struct Args {
  int bq, d, n_valid, k, tiles_per_split, tile_stride, stages, groups;
  const float* q_scale;
  const float* k_scale;
  const float* seed;  // (bq, groups) group bests, or null: no seed
  float* part;        // SEED: the (bq, groups) group bests it writes;
                      // ROWMAX: the (bq, splits) partial row maxima
  float* cand_v;
  int* cand_i;
};

// wgmma descriptor of a K-major tile of int8 rows in the CB-byte swizzle:
// start address, leading offset 1 (unused by a swizzled K-major operand),
// stride 8 rows x CB bytes, layout 1 (128-byte swizzle) or 2 (64-byte).
template <int CB>
__device__ __forceinline__ uint64_t desc_i8(uint32_t addr) {
  static_assert(CB == 64 || CB == 128, "a 64- or 128-byte swizzle");
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((8 * CB) >> 4) << 32) |
         ((uint64_t)(CB == 128 ? 1 : 2) << 62);
}

// d (64 x N int32, d[N / 2] a thread: the f32 accumulators' layout) += A .
// B (acc = 0 overwrites d): A (64 x 32) and B (N x 32) int8 codes in shared
// memory, both K-major.
template <int N>
struct WgmmaI8;

template <>
struct WgmmaI8<16> {
  static __device__ __forceinline__ void run(uint32_t (&d)[8], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaI8<32> {
  static __device__ __forceinline__ void run(uint32_t (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaI8<64> {
  static __device__ __forceinline__ void run(uint32_t (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaI8<128> {
  static __device__ __forceinline__ void run(uint32_t (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <int R>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Issue acc (+)= the dots of warpgroup wg's 64 keys and the NQ queries
// over one chunk as one wgmma group (not waited for): the keys' tile at
// `keys`, the queries' at `queries`; `more`: add to the tile's earlier
// chunks, else overwrite.
template <int NQ>
__device__ __forceinline__ void chunk_products(uint32_t (&acc)[NQ / 2],
                                               uint32_t keys,
                                               uint32_t queries, int wg,
                                               bool more) {
  const uint64_t da = desc_i8<kChunk>(keys + wg * 64 * kChunk);
  const uint64_t db = desc_i8<kChunk>(queries);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kChunk / 32; ++kk)
    WgmmaI8<NQ>::run(acc, da + 2 * kk, db + 2 * kk, more || kk > 0);
  wgmma_commit();
}

// Every wgmma group of this warp but the last issued has completed.
__device__ __forceinline__ void wgmma_wait_all_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pass 1 (and, SEED, the seed's launch, at MAXK = 8 whatever k is, in the
// shared memory of pass 1's plan; ROWMAX, K6's pass 1: the same walk and
// products with a running row max of the int32 dots in place of the
// scales, the screen and the lists, at MAXK = 8). Shared memory from the
// 1024-aligned base: the ring (slot s at s * stage_bytes: the key box, the
// query box), the lists (SEED: the warps' group bests, 8 NQ floats; none
// in ROWMAX, whose warps' row maxima take the ring's first slot once the
// walk is done), the query block's scales (none in ROWMAX), then the
// barriers full[s] at 8 s and empty[s] at 64 + 8 s.
template <int MAXK, int NQ, bool SEED, bool ROWMAX = false>
__global__ void __launch_bounds__(kThreads, 1)
    topk_i8_sm90(const __grid_constant__ CUtensorMap tm_keys,
                 const __grid_constant__ CUtensorMap tm_q, const Args a) {
  static_assert(!(SEED && ROWMAX), "one launch or the other");
  constexpr int kStage = stage_bytes(NQ);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const int stages = a.stages;
  const uint32_t lists = base + stages * kStage;
  const uint32_t scales =
      lists + (ROWMAX ? 0u : (uint32_t)lists_bytes(NQ, MAXK));
  const uint32_t bars = scales + (ROWMAX ? 0u : 4u * NQ);
  const int q0 = blockIdx.x * NQ;
  const int tile0 = blockIdx.y * a.tile_stride;
  const int tile1 = min((a.n_valid + kTileKeys - 1) / kTileKeys,
                        tile0 + a.tiles_per_split);
  const int cpt = a.d / kChunk;
  const int n_chunks = max(0, tile1 - tile0) * cpt;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);                           // full[s]
      mbar_init(bars + 8 * kMaxStages + 8 * s, TPB / 32);  // empty[s]
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: chunk c's key and query codes into slot c % stages,
    // once every consumer warp has released the slot's previous chunk ----
    if (threadIdx.x == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % stages, use = c / stages;
        if (use > 0) mbar_wait(bars + 8 * kMaxStages + 8 * s, (use - 1) & 1);
        const uint32_t st = base + s * kStage, full = bars + 8 * s;
        mbar_expect_tx(full, kStage);
        const int col = (c % cpt) * kChunk;
        tma_load(st, &tm_keys, full, col, (tile0 + c / cpt) * kTileKeys, 0);
        tma_load(st + kTileKeys * kChunk, &tm_q, full, col, q0, 0);
      }
    }
    return;
  }

  // ---- consumers ----
  using Sync = ConsumerBarrier;
  const int tid = threadIdx.x - 128, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Lists<NQ, MAXK> L{smem_raw + (lists - raw)};
  float* qs = reinterpret_cast<float*>(smem_raw + (scales - raw));
  if constexpr (!ROWMAX) {
    for (int i = tid; i < NQ; i += TPB)
      qs[i] = q0 + i < a.bq ? a.q_scale[q0 + i] : 0.f;
  }
  if constexpr (!SEED && !ROWMAX) {
    // each query's list empty: entries (seed, INT_MAX), the seed the least
    // of its group bests (-inf without one), and its threshold there
    for (int i = tid; i < NQ; i += TPB) {
      float v = -INFINITY;
      if (a.seed != nullptr && q0 + i < a.bq) {
        v = INFINITY;
        for (int gr = 0; gr < a.groups; ++gr)
          v = fminf(v, a.seed[(long long)(q0 + i) * a.groups + gr]);
      }
      L.thv()[i] = v;
      L.thi()[i] = INT_MAX;
      L.cnt()[i] = 0;
    }
    Sync::sync();
    for (int i = tid; i < NQ * MAXK; i += TPB) {
      L.lv()[i] = L.thv()[i / MAXK];
      L.li()[i] = INT_MAX;
    }
  }
  Sync::sync();

  const int wg = warp >> 2;
  const int r0 = 64 * wg + 16 * (warp & 3) + g;  // and r0 + 8
  uint32_t acc[NQ / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) acc[i] = 0u;
  float best[SEED ? NQ / 2 : 1];  // SEED: the best score of each j
#pragma unroll
  for (int i = 0; i < (SEED ? NQ / 2 : 1); ++i) best[i] = -INFINITY;
  int rm[kRowMaxRegs<NQ>];  // ROWMAX: the running row maxima of the dots
#pragma unroll
  for (int u = 0; u < kRowMaxRegs<NQ>; ++u) rm[u] = INT_MIN;
  unsigned qvalid[(NQ / 2 + 31) / 32];  // the scores of queries below bq
  query_bits<NQ>(qvalid, q0, a.bq, t4);
  bool flood = true;  // the screen's flooded-tile state
  const int n_tiles = n_chunks / cpt;
  for (int t = 0, c = 0; t < n_tiles; ++t) {
    // the scales of keys `key` and `key` + 8, loaded before the tile's
    // chunks are waited for
    const int key = (tile0 + t) * kTileKeys + r0;
    const float ks0 =
        !ROWMAX && key < a.n_valid ? __ldg(a.k_scale + key) : 0.f;
    const float ks1 =
        !ROWMAX && key + 8 < a.n_valid ? __ldg(a.k_scale + key + 8) : 0.f;
    // the tile's chunks: each one's products issued once it has landed,
    // the previous one's slot freed once its products have completed (the
    // waits unconditional: a wgmma wait under a branch serializes them)
    for (int kc = 0; kc < cpt; ++kc, ++c) {
      const int s = c % stages;
      mbar_wait(bars + 8 * s, (c / stages) & 1);
      __syncwarp();
      chunk_products<NQ>(acc, base + s * kStage,
                         base + s * kStage + kTileKeys * kChunk, wg, kc != 0);
      wgmma_wait_all_but_one();
      __syncwarp();
      if (lane == 0 && kc > 0)
        mbar_arrive(bars + 8 * kMaxStages + 8 * ((c - 1) % stages));
    }
    wgmma_wait();  // the tile's dots are complete
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * kMaxStages + 8 * ((c - 1) % stages));
    if constexpr (ROWMAX)
      fold_rowmax<NQ>(rm, [&](int j) { return (int)acc[j]; },
                      key < a.n_valid, key + 8 < a.n_valid, INT_MIN, lane);
    // each dot becomes its score in place: times its query's scale, then
    // its key's (the tile's next product overwrites the accumulators)
    if constexpr (!ROWMAX) {
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j)
        acc[j] = __float_as_uint(__fmul_rn(
            __fmul_rn(__int2float_rn((int)acc[j]),
                      qs[8 * (j >> 2) + 2 * t4 + (j & 1)]),
            (j & 2) ? ks1 : ks0));
    }
    if constexpr (SEED) {
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j)
        if (key + 8 * ((j >> 1) & 1) < a.n_valid)
          best[j] = fmaxf(best[j], __uint_as_float(acc[j]));
    } else if constexpr (!ROWMAX) {
      screen_scores<NQ, MAXK, kMergeAt, NQ == 128 ? kFloodCarry : kFloodNone,
                    true, Sync>(
          [&](int j) { return __uint_as_float(acc[j]); }, L, q0, a.bq, key,
          a.n_valid, a.k, warp, lane, flood, qvalid);
    }
  }
  if constexpr (ROWMAX) {
    Sync::sync();  // every consumer is done with the ring
    rowmax_write<NQ, Sync>(rm, reinterpret_cast<int*>(smem_raw + (base - raw)),
                           INT_MIN, q0, a.bq, a.part, tid);
    return;
  }
  if constexpr (SEED) {
    // the group's best of each query: over the thread's two keys, the
    // warp's 8 row groups (lanes g), then the 8 warps
    float* red = reinterpret_cast<float*>(smem_raw + (lists - raw));
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) {
      if (j & 2) continue;
      float m = fmaxf(best[j], best[j + 2]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (g == 0) red[warp * NQ + 8 * (j >> 2) + 2 * t4 + (j & 1)] = m;
    }
    Sync::sync();
    for (int i = tid; i < NQ; i += TPB) {
      float m = -INFINITY;
      for (int w = 0; w < TPB / 32; ++w) m = fmaxf(m, red[w * NQ + i]);
      if (q0 + i < a.bq)
        a.part[(long long)(q0 + i) * a.groups + blockIdx.y] = m;
    }
    return;
  }
  Sync::sync();  // every screen is done: merge what is buffered
  merge_buffers_shfl<NQ, MAXK>(L, 1, a.k, warp, lane);
  Sync::sync();  // every list is final
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

// A map over (rows, d) int8 codes, boxes of box_rows x kChunk bytes in the
// swizzle of that width; rows past `rows` load as zeros.
bool encode_i8(CUtensorMap* map, const void* codes, int rows, int d,
               int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)d,
                                 (cuuint64_t)rows * (cuuint64_t)d};
  const cuuint32_t box[3] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(codes),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            kChunk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MAXK, int NQ, bool SEED, bool ROWMAX = false>
cudaError_t launch(const CUtensorMap& mk, const CUtensorMap& mq,
                   const Args& a, int splits, long long smem,
                   cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  const auto kernel = topk_i8_sm90<MAXK, NQ, SEED, ROWMAX>;
  cudaError_t err = allow_smem(ready, (const void*)kernel, kMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.bq + NQ - 1) / NQ, splits);
  kernel<<<grid, kThreads, smem, stream>>>(mk, mq, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory of topk_i8_sm90<maxk, nq> at `stages` ring
// slots, in bytes.
long long bscan_topk_i8_sm90_smem(int nq, int maxk, int stages) {
  return smem_bytes(nq, maxk, stages);
}

// The seed's groups over keys[:n_valid] for `groups` of them: whole tiles a
// group (0: no seed) and the tiles between two groups' first.
void bscan_topk_i8_sm90_seed(int n_valid, int groups, int* tiles,
                             int* stride) {
  const SeedGroups sg(n_valid, groups);
  *tiles = sg.tiles;
  *stride = sg.stride;
}

// K5 on the Hopper body. q (bq, d) and keys (n, d) contiguous int8 codes,
// 16-byte aligned, d % 128 == 0; q_scale (bq,) and k_scale (n,) fp32; 1 <=
// k <= 64, k <= n_valid <= n. The plan (`plan_i8` in ops/topk.py): the
// query block nq (16, 32, 64 or 128), splits x tiles_per_split covering the
// n / 128 key tiles with no empty split, 2-8 ring stages, smem the bytes
// this library computes for them (at most 232,448), n_cand = bq * splits *
// k entries per candidate buffer, seed_groups 0 (no seed) or k, with
// `part` room for bq * k floats. Otherwise it returns cudaErrorInvalidValue
// and launches nothing. With a seed and at least k whole tiles of valid
// keys it launches the seed, then pass 1 and pass 2. Returns the
// cudaError_t of the launches (0 on success).
int bscan_topk_i8_sm90(const void* q, const float* q_scale, const void* keys,
                       const float* k_scale, int bq, int n, int d,
                       int n_valid, int k, int nq, int splits,
                       int tiles_per_split, int stages, long long smem,
                       long long n_cand, int seed_groups, float* part,
                       float* cand_v, int* cand_i, float* out_v, int* out_i,
                       void* stream) {
  const int maxk = k <= 8 ? 8 : (k <= 16 ? 16 : (k <= 32 ? 32 : 64));
  const int n_tiles = (n + kTileKeys - 1) / kTileKeys;
  if (bq < 1 || d < kChunk || d % kChunk != 0 || k < 1 || k > 64 ||
      n_valid < k || n_valid > n ||
      (nq != 16 && nq != 32 && nq != 64 && nq != 128) ||
      stages < kMinStages || stages > kMaxStages || splits < 1 ||
      tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles ||
      smem != smem_bytes(nq, maxk, stages) || smem > (long long)kMaxSmem ||
      n_cand != (long long)bq * splits * k ||
      (seed_groups != 0 && seed_groups != k) ||
      (seed_groups != 0 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mk, mq;
  if (!encode_i8(&mk, keys, n, d, kTileKeys) ||
      !encode_i8(&mq, q, bq, d, nq))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.bq = bq;
  a.d = d;
  a.n_valid = n_valid;
  a.k = k;
  a.stages = stages;
  a.q_scale = q_scale;
  a.k_scale = k_scale;
  a.cand_v = cand_v;
  a.cand_i = cand_i;
  a.groups = seed_groups;
  a.seed = nullptr;
  a.part = part;
  const SeedGroups sg(n_valid, seed_groups);
  cudaError_t err = by_maxk<64>(k, [&](auto mkc) -> cudaError_t {
    constexpr int MAXK = decltype(mkc)::value;
    auto run = [&](auto nqc) -> cudaError_t {
      constexpr int NQ = decltype(nqc)::value;
      if (sg.tiles > 0) {  // the seed: k groups of sg.tiles tiles
        a.tiles_per_split = sg.tiles;
        a.tile_stride = sg.stride;
        // (the seed keeps no lists: one instantiation serves every k)
        const cudaError_t e =
            launch<8, NQ, true>(mk, mq, a, seed_groups, smem, s);
        if (e != cudaSuccess) return e;
        a.seed = part;
      }
      a.tiles_per_split = tiles_per_split;
      a.tile_stride = tiles_per_split;
      return launch<MAXK, NQ, false>(mk, mq, a, splits, smem, s);
    };
    return nq == 16   ? run(Int<16>{})
           : nq == 32 ? run(Int<32>{})
           : nq == 64 ? run(Int<64>{})
                      : run(Int<128>{});
  });
  if (err != cudaSuccess) return (int)err;
  return (int)by_maxk<64>(k, [&](auto mkc) {
    return launch_pass2<decltype(mkc)::value>(bq, splits * k, k, cand_v,
                                              cand_i, out_v, out_i, s);
  });
}

// The dynamic shared memory of K6's pass 1 on this walk
// (topk_i8_sm90<8, nq, false, true>) at `stages` ring slots, in bytes.
long long bscan_mm_only_i8_sm90_smem(int nq, int stages) {
  return rowmax_smem_bytes(nq, stages);
}

// K6 on K5's Hopper walk: out (bq, 128) fp32, each row the maximum over
// keys[:n_valid] of the exact int32 dots of the codes, converted to fp32
// once (exact: 768 * 127^2 < 2^24), -inf where n_valid is 0. q (bq, d) and
// keys (n, d) contiguous int8 codes, 16-byte aligned, d % 128 == 0, 0 <=
// n_valid <= n; part: bq * splits floats. The plan (`plan_mm_only` in
// ops/topk.py): the query block nq (16, 32, 64 or 128), splits x
// tiles_per_split covering the n / 128 key tiles with no empty split, 2-8
// ring stages, smem the bytes this library computes for them (at most
// 232,448). Otherwise it returns cudaErrorInvalidValue and launches
// nothing. No seed: pass 1 writes each (query, split)'s maximum, pass 2
// (mm_only_pass2) each query's over the splits. Returns the cudaError_t of
// the launches.
int bscan_mm_only_i8_sm90(const void* q, const void* keys, int bq, int n,
                          int d, int n_valid, int nq, int splits,
                          int tiles_per_split, int stages, long long smem,
                          float* part, float* out, void* stream) {
  const int n_tiles = (n + kTileKeys - 1) / kTileKeys;
  if (bq < 1 || n < 1 || d < kChunk || d % kChunk != 0 || n_valid < 0 ||
      n_valid > n || (nq != 16 && nq != 32 && nq != 64 && nq != 128) ||
      stages < kMinStages || stages > kMaxStages || splits < 1 ||
      tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles ||
      smem != rowmax_smem_bytes(nq, stages) || smem > (long long)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mk, mq;
  if (!encode_i8(&mk, keys, n, d, kTileKeys) ||
      !encode_i8(&mq, q, bq, d, nq))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.bq = bq;
  a.d = d;
  a.n_valid = n_valid;
  a.k = 1;
  a.tiles_per_split = tiles_per_split;
  a.tile_stride = tiles_per_split;
  a.stages = stages;
  a.groups = 0;
  a.q_scale = nullptr;
  a.k_scale = nullptr;
  a.seed = nullptr;
  a.part = part;
  a.cand_v = nullptr;
  a.cand_i = nullptr;
  auto run = [&](auto nqc) -> cudaError_t {
    return launch<8, decltype(nqc)::value, false, true>(mk, mq, a, splits,
                                                        smem, s);
  };
  const cudaError_t err = nq == 16   ? run(Int<16>{})
                          : nq == 32 ? run(Int<32>{})
                          : nq == 64 ? run(Int<64>{})
                                     : run(Int<128>{});
  if (err != cudaSuccess) return (int)err;
  mm_only_pass2<<<bq, 128, 0, s>>>(part, splits, out);
  return (int)cudaGetLastError();
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
