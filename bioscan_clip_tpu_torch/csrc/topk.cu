// Exact inner-product top-k over a resident key matrix.
//
// Replaces `pallas_topk` (bioscan_clip_tpu/ops/topk_pallas.py, kernel
// `_topk_kernel` with the running-top-k merge `_merge_tile`): top-k of
// Q . K^T, keys with index >= n_valid never enter, output sorted descending,
// and among equal values the smaller global key index comes first. The keys
// stay resident in fp32. "high" (and "highest"; `Precision.HIGHEST` on the
// TPU, what `pallas_topk` runs for both) is the six-product bf16 split with
// fp32 sums: each fp32 operand x is split into hi = bf16(x), mid = bf16(x -
// hi), lo = bf16(x - hi - mid) (round to nearest even; each difference is
// exact in fp32), and a score sums the six products whose piece indices add
// up to 2 or less (lo.hi, mid.mid, hi.lo, hi.mid, mid.hi, hi.hi). Each
// product of two bf16 values is exact in fp32 and the three dropped terms are
// below 2^-24 |x||y|, so a score is within fp32 rounding of the full fp32
// product: the FAISS IndexFlatIP contract the retrieval engine keeps. It is
// never TF32. "default" (`Precision.DEFAULT`, the TPU's single bf16 pass) is
// one product of the operands rounded to bf16, summed in fp32.
//
// What bounds it on an H100: one call reads the whole key matrix (1,048,576 x
// 768 fp32 = 3.22 GB, 0.962 ms at 3.35 TB/s); "default" does 2 * Bq * N *
// 768 bf16 operations (Bq * 1.6 us at 989 TFLOP/s) and "high" six times as
// many (Bq * 9.8 us): bound by bytes at every Bq of a request in "default",
// and by the six products above Bq ~ 100 in "high" (FFMA would take Bq * 24
// us at 67 TFLOP/s). From the plan's crossing up (`ops/topk.plan_f32`: 17
// queries in "high", every Bq in "default", at widths that are a multiple
// of 64) K4 runs the Hopper body of topk_sm90.cu instead, one walk of the
// keys for up to 256 queries. Design of this body (the K4 section below),
// which serves the rest: pass 1 computes each
// tile's products with bf16 `mma.sync` (m16n8k16) over a query block of 16,
// 32 or 64 rows chosen from Bq, with the key axis split across about two
// blocks per SM; keys and the block's queries stream through one `cp.async`
// ring of 32-deep fp32 chunks (three bf16 pieces of 64 whole query rows would
// not fit in shared memory), each chunk's queries split into bf16 pieces once
// for the block and each key split as its fragment is built; each score is
// screened in registers against its query's running k-th best, and only the
// scores that beat it are merged into a sorted list per query in shared
// memory (the exactness argument is at topk_i8_pass1); the two blocks of a
// cluster merge their lists through
// distributed shared memory, and pass 2 (one warp per query, k rounds of a
// warp arg-best over the (splits / 2 * k) candidates) writes the result. The
// comparison is (value desc, index asc) everywhere, which gives the tie rule
// whatever order candidates arrive in.
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
// a request. From the plan's crossing up (`ops/topk.plan_i8`, at widths
// that are a multiple of 128) K5 runs the Hopper body of topk_i8_sm90.cu
// instead, one walk of the keys for up to 128 queries. Design of this body
// (the K5 section below), which serves the rest: K4's, with int8 `mma.sync`
// (m16n8k32) products, the query block's codes staged once, and the key
// codes streaming through the ring.
//
// K6 replaces `mm_only` (tools/bench_topk_variants.py, `_mm_only_kernel`),
// the top-k benchmark's matmul-only control: per query, the maximum over
// valid keys (index < n_valid) of Q . K^T, broadcast over 128 output
// columns. Its pass 1 walks the key range as K4's ("high" and "default") or
// K5's (int8) pass 1 does, with the same products, and keeps a running row
// max in registers in place of the screen and lists; pass 2
// (topk_common.cuh `mm_only_pass2`) takes the max over the key splits. So
// K4's time minus K6's fp32 time, and K5's minus K6's int8 time, at the
// same walk and query block, is what the screen and lists cost. int8 is
// the exact int32 dot converted to fp32, which equals the TPU's bf16
// products of the codes summed in fp32 (768 * 127^2 < 2^24). Bound: as K4
// or K5. From the plan's crossing up (`ops/topk.plan_mm_only`: 17 queries
// in "high", every Bq in "default" and int8, at widths the Hopper bodies
// take) K6 is the row-max launch (`ROWMAX`) of K4's and K5's Hopper bodies
// (topk_sm90.cu, topk_i8_sm90.cu); the mma.sync walks below serve the
// rest.
//
// K7 replaces `tiny` (same file, `_tiny_kernel`): x + 1 on (8, 128) fp32,
// the launch-plus-sync floor of a call through this library. Its 8 KB take
// the card a few nanoseconds at the bytes rate, so what bounds a call is the
// host's launch path (`ops/_launch.py`) and the card's per-launch cost; the
// body is one small grid of 16-byte loads and stores where both pointers
// allow them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "topk_common.cuh"

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KT = 128;           // keys per tile
constexpr int CLUSTER = 2;        // key splits merged before pass 2

// ---- pass 1's screen and cluster merge (K4's mma.sync body and K5); the
// lists are in topk_common.cuh --------------------------------------------
//
// Screen one finished tile's scores against each query's threshold theta
// and merge those that beat it (by `better`: a score equal to theta passes
// when its key index is smaller) into the query's list. Thread (warp, lane)
// holds score(mt, h, nb, e), of query mt * 16 + g + 8 h of the block and key
// key0 + warp * 16 + nb * 8 + 2 t4 + e, g = lane / 4, t4 = lane % 4 (the
// C fragments of the tile's products). Passing scores are appended to the
// query's buffer; then every query with buffered scores merges them (one
// warp a query) and theta is refreshed. A buffer that fills leaves the rest
// of the tile's passing scores pending in their threads (bit (mt * 2 + h) *
// 4 + nb * 2 + e of `pend`): after the merge they are screened again,
// against the raised theta, until none is left.
template <int QB, int MAXK, class Score>
__device__ __forceinline__ void screen_tile(const Score& score,
                                            const Lists<QB, MAXK>& L, int q0,
                                            int bq, int key0, int n_valid,
                                            int k, int warp, int lane) {
  static_assert(QB / 16 * 8 <= 32, "one pending bit per score");
  const int g = lane >> 2, t4 = lane & 3;
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
            const float s = score(mt, h, nb, e);
            if (!better(s, key, L.thv()[r], L.thi()[r])) {
              pend &= ~bit;
            } else {
              const int p = atomicAdd(L.cnt() + r, 1);
              if (p < BUF) {
                L.bv()[r * BUF + p] = s;
                L.bi()[r * BUF + p] = key;
                pend &= ~bit;
              }
            }
          }
    __syncthreads();  // the buffers are full or the tile screened
    for (int r = warp; r < QB; r += TPB / 32) {
      const int nbuf = min(L.cnt()[r], BUF);
      if (nbuf > 0)
        merge_row<MAXK>(L.lv() + r * MAXK, L.li() + r * MAXK,
                        L.bv() + r * BUF, L.bi() + r * BUF, nbuf, k,
                        L.thv() + r, L.thi() + r, L.cnt() + r, lane);
    }
    if (!__syncthreads_or(pend != 0)) break;  // lists and thetas updated
  }
}

// The CLUSTER key splits of a cluster merge their lists into its first
// block's: BUF entries at a time are copied from another block's shared
// memory into the query's buffer and merged as screened scores are. The
// first block then writes its lists' first k entries as candidates (query,
// cluster, k) for pass 2, which reads a cluster's k candidates per query,
// not each split's.
template <int QB, int MAXK>
__device__ __forceinline__ void cluster_emit(const Lists<QB, MAXK>& L, int q0,
                                             int bq, int k,
                                             float* __restrict__ cand_v,
                                             int* __restrict__ cand_i) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.y;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every list of the cluster is final
  if (cluster.block_rank() == 0) {
    for (int src = 1; src < CLUSTER; ++src) {
      const float* rv = cluster.map_shared_rank(L.lv(), src);
      const int* ri = cluster.map_shared_rank(L.li(), src);
      for (int r = warp; r < QB && q0 + r < bq; r += TPB / 32)
        for (int b = 0; b < k; b += BUF) {
          const int nbuf = min(BUF, k - b);
          if (lane < nbuf) {
            L.bv()[r * BUF + lane] = rv[r * MAXK + b + lane];
            L.bi()[r * BUF + lane] = ri[r * MAXK + b + lane];
          }
          __syncwarp();
          merge_row<MAXK>(L.lv() + r * MAXK, L.li() + r * MAXK,
                          L.bv() + r * BUF, L.bi() + r * BUF, nbuf, k,
                          L.thv() + r, L.thi() + r, L.cnt() + r, lane);
        }
    }
    __syncthreads();
    const int group = split / CLUSTER, groups = gridDim.y / CLUSTER;
    for (int i = tid; i < QB * k; i += TPB) {
      const int r = i / k, p = i - r * k;
      if (q0 + r < bq) {
        const long long o = ((long long)(q0 + r) * groups + group) * k + p;
        cand_v[o] = L.lv()[r * MAXK + p];
        cand_i[o] = L.li()[r * MAXK + p];
      }
    }
  }
  cluster.sync();  // the other blocks' lists stay until they are read
}

// K6's running row max over one finished tile, in place of the screen:
// rm[mt][h] is the maximum of this thread's valid scores of query mt * 16 +
// g + 8 h (score and key as in screen_tile).
template <int QB, class Score>
__device__ __forceinline__ void rowmax_tile(float (&rm)[QB / 16][2],
                                            const Score& score, int key0,
                                            int n_valid, int warp, int lane) {
#pragma unroll
  for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (key0 + warp * 16 + nb * 8 + 2 * (lane & 3) + e < n_valid)
            rm[mt][h] = fmaxf(rm[mt][h], score(mt, h, nb, e));
}

// The block's row maxima, over the four lanes of a row, then over the 8
// warps through `red` (8 x QB floats of shared memory): part[row * splits +
// split], -inf for a query whose split has no valid key.
template <int QB>
__device__ __forceinline__ void rowmax_write(const float (&rm)[QB / 16][2],
                                             float* red, int q0, int bq,
                                             float* __restrict__ part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = rm[mt][h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if ((lane & 3) == 0) red[warp * QB + mt * 16 + (lane >> 2) + 8 * h] = m;
    }
  __syncthreads();
  for (int r = threadIdx.x; r < QB; r += TPB) {
    if (q0 + r >= bq) continue;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < TPB / 32; ++w) m = fmaxf(m, red[w * QB + r]);
    part[(long long)(q0 + r) * gridDim.y + blockIdx.y] = m;
  }
}

// ---- K4: fp32 keys on bf16 tensor cores ---------------------------------
//
// The product unit is `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
// (fragments in attention_common.cuh). A block walks its key range in
// 128-key tiles; each ring chunk holds 32 fp32 depth values (one 128-byte
// line) of the tile's 128 key rows and of the block's QB query rows, landed
// by `cp.async`. Once a chunk has landed, the block splits its query rows
// into bf16 pieces in shared memory (each value once, not once per warp),
// and each of the 8 warps takes 16 keys of the tile (two n-blocks) against
// all QB rows: A fragments by `ldmatrix` from the pieces, B fragments split
// from the fp32 keys in registers. Lane (g, t4) reads depth 4 t4 .. 4 t4 +
// 3 of a k-step as one float4 of its key row and puts it in k-slots 2 t4,
// 2 t4 + 1, 2 t4 + 8, 2 t4 + 9; the query pieces are stored in the same
// k-slot order: a dot product does not depend on which k-slot holds which
// depth, as long as A and B agree. The 16-byte unit u of staged fp32 row r
// lives at unit u ^ 4 (r % 2), so the float4 reads of a quarter warp (rows
// g, g + 1, four units each) cover all 32 banks; a row of pieces is padded
// to 40 bf16 (80 bytes), so the 8 rows of an `ldmatrix` start 16 bytes
// apart modulo 128.

constexpr int F32_DC = 32;            // fp32 depth values per ring chunk
constexpr int F32_AROW = F32_DC + 8;  // bf16 per row of query pieces

__host__ __device__ constexpr int f32_stages(int qb) {
  return qb == 64 ? 3 : 4;  // at 64 query rows, two blocks still share an SM
}

// the ring, then the query pieces of one chunk
__host__ __device__ constexpr size_t f32_work_bytes(int qb, int terms) {
  return sizeof(float) * f32_stages(qb) * (KT + qb) * F32_DC +
         sizeof(bf16_t) * terms * qb * F32_AROW;
}

__host__ __device__ constexpr size_t f32_smem(int qb, int maxk, int terms) {
  return f32_work_bytes(qb, terms) + lists_bytes(qb, maxk);
}

__device__ __forceinline__ int f32_at(int r, int u) {
  return r * F32_DC + ((u ^ ((r & 1) << 2)) << 2);
}

// c[nb] += a . (piece J of B fragment nb), on the tensor cores.
template <int J, int TERMS>
__device__ __forceinline__ void mma_b(float (&c)[2][4], const unsigned (&a)[4],
                                      const Pieces<TERMS> (&b)[2][2]) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
    bscan::mma_bf16(c[nb], a, b[nb][0].p[J], b[nb][1].p[J]);
}

// Chunk c of the block's key range into ring slot c % STAGES: depth
// (c % cpt) * 32 .. of the key rows of tile tile0 + c / cpt (rows 0..127 of
// the slot) and of query rows q0 .. q0 + QB - 1 (rows 128..); keys >= n and
// queries >= bq are zero.
template <int QB, int STAGES>
__device__ __forceinline__ void f32_load_chunk(float* ring, const float* q,
                                               const float* keys, int bq,
                                               int n, int d, int q0,
                                               int tile0, int cpt, int c) {
  float* dst = ring + (c % STAGES) * ((KT + QB) * F32_DC);
  const int key0 = (tile0 + c / cpt) * KT;
  const int off = (c % cpt) * F32_DC;
  for (int f = threadIdx.x; f < (KT + QB) * (F32_DC / 4); f += TPB) {
    const int r = f / (F32_DC / 4), u = f % (F32_DC / 4);
    const bool is_key = r < KT;
    const int row = is_key ? key0 + r : q0 + r - KT;
    const bool ok = row < (is_key ? n : bq);
    const float* src = is_key ? keys : q;
    bscan::cp_async16(dst + f32_at(r, u),
                      src + (ok ? (long long)row * d + off + u * 4 : 0), ok);
  }
}

// The staged chunk's QB query rows as TERMS bf16 pieces: piece p of row r at
// ap[(p * QB + r) * F32_AROW ..], depth 4 t .. 4 t + 3 of k-step ks in
// k-slots 2 t, 2 t + 1 (32-bit word ks * 8 + t of the row) and 2 t + 8,
// 2 t + 9 (word ks * 8 + 4 + t), the order the key fragments use.
template <int QB, int TERMS>
__device__ __forceinline__ void f32_split_queries(const float* slot,
                                                  bf16_t* ap) {
  unsigned* w = reinterpret_cast<unsigned*>(ap);
  for (int f = threadIdx.x; f < QB * (F32_DC / 4); f += TPB) {
    const int r = f / (F32_DC / 4), u = f % (F32_DC / 4);
    const float4 x =
        *reinterpret_cast<const float4*>(slot + f32_at(KT + r, u));
    const Pieces<TERMS> lo = split_bf16<TERMS>(x.x, x.y);
    const Pieces<TERMS> hi = split_bf16<TERMS>(x.z, x.w);
    const int o = r * (F32_AROW / 2) + (u >> 2) * 8 + (u & 3);
#pragma unroll
    for (int p = 0; p < TERMS; ++p) {
      w[p * QB * (F32_AROW / 2) + o] = lo.p[p];
      w[p * QB * (F32_AROW / 2) + o + 4] = hi.p[p];
    }
  }
}

// acc += the products of the block's QB query rows (their pieces, ap) and
// this warp's 16 keys over k-step ks of the staged chunk. TERMS = 3: the six
// products, smallest first (lo.hi, mid.mid, hi.lo, hi.mid, mid.hi, hi.hi),
// each query piece loaded as it is first needed, summed from zero on the
// tensor cores, then added to acc by FADD: the tensor core's own fp32
// additions need not round to nearest, so they see only the k-step's
// partial sum, not the running score.
template <int QB, int TERMS>
__device__ __forceinline__ void f32_mma_kstep(const float* slot,
                                              const bf16_t* ap, int warp,
                                              int lane, int ks,
                                              float (&acc)[QB / 16][2][4]) {
  static_assert(TERMS == 1 || TERMS == 3, "one product or the six");
  const int g = lane >> 2, t4 = lane & 3;
  Pieces<TERMS> b[2][2];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    const float4 x = *reinterpret_cast<const float4*>(
        slot + f32_at(warp * 16 + nb * 8 + g, ks * 4 + t4));
    b[nb][0] = split_bf16<TERMS>(x.x, x.y);
    b[nb][1] = split_bf16<TERMS>(x.z, x.w);
  }
#pragma unroll
  for (int mt = 0; mt < QB / 16; ++mt) {
    auto piece = [&](unsigned (&a)[4], int p) {
      bscan::ldsm_x4(a, bscan::rows16<F32_AROW>(ap + p * QB * F32_AROW,
                                                mt * 16, ks * 16, lane));
    };
    if constexpr (TERMS == 1) {
      unsigned a[4];
      piece(a, 0);
      mma_b<0>(acc[mt], a, b);
    } else {
      float c[2][4] = {};
      unsigned lo[4], mid[4], hi[4];
      piece(lo, 2);
      mma_b<0>(c, lo, b);  // lo.hi
      piece(mid, 1);
      mma_b<1>(c, mid, b);  // mid.mid
      piece(hi, 0);
      mma_b<2>(c, hi, b);  // hi.lo
      mma_b<1>(c, hi, b);  // hi.mid
      mma_b<0>(c, mid, b);  // mid.hi
      mma_b<0>(c, hi, b);  // hi.hi
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nb][e] = __fadd_rn(acc[mt][nb][e], c[nb][e]);
    }
  }
}

// The staged chunk's two k-steps. At 64 rows of six products the loop stays
// rolled, one k-step's pieces live at a time: unrolled, it spills at the 128
// registers that two blocks per SM allow.
template <int QB, int TERMS>
__device__ __forceinline__ void f32_mma_chunk(const float* slot,
                                              const bf16_t* ap, int warp,
                                              int lane,
                                              float (&acc)[QB / 16][2][4]) {
  if constexpr (QB == 64 && TERMS == 3) {
#pragma unroll 1
    for (int ks = 0; ks < F32_DC / 16; ++ks)
      f32_mma_kstep<QB, TERMS>(slot, ap, warp, lane, ks, acc);
  } else {
#pragma unroll
    for (int ks = 0; ks < F32_DC / 16; ++ks)
      f32_mma_kstep<QB, TERMS>(slot, ap, warp, lane, ks, acc);
  }
}

// K4's and K6 fp32's pass-1 walk, grid (query blocks of QB, key splits):
// the block's key range chunk by chunk through the ring (at `work`, then
// the query pieces); after a tile's last chunk, tile_end(key0, acc) takes
// its (QB x 128) scores.
template <int QB, int TERMS, class End>
__device__ __forceinline__ void f32_walk(const float* q, const float* keys,
                                         int bq, int n, int d, int n_valid,
                                         int tiles_per_split,
                                         unsigned char* work,
                                         const End& tile_end) {
  constexpr int STAGES = f32_stages(QB);
  float* ring = reinterpret_cast<float*>(work);
  bf16_t* ap = reinterpret_cast<bf16_t*>(ring + STAGES * (KT + QB) * F32_DC);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QB;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min((n_valid + KT - 1) / KT, tile0 + tiles_per_split);
  const int cpt = d / F32_DC;
  const int n_chunks = max(0, tile1 - tile0) * cpt;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks)
      f32_load_chunk<QB, STAGES>(ring, q, keys, bq, n, d, q0, tile0, cpt, s);
    bscan::cp_async_commit();
  }
  float acc[QB / 16][2][4] = {};
  for (int c = 0; c < n_chunks; ++c) {
    const float* slot = ring + (c % STAGES) * ((KT + QB) * F32_DC);
    bscan::cp_async_wait<STAGES - 2>();  // chunk c landed
    __syncthreads();  // ... for every thread; slot (c - 1) % STAGES and the
                      // pieces of chunk c - 1 are free
    if (c + STAGES - 1 < n_chunks)
      f32_load_chunk<QB, STAGES>(ring, q, keys, bq, n, d, q0, tile0, cpt,
                                 c + STAGES - 1);
    bscan::cp_async_commit();
    f32_split_queries<QB, TERMS>(slot, ap);
    __syncthreads();  // the pieces of chunk c are in place
    f32_mma_chunk<QB, TERMS>(slot, ap, warp, lane, acc);
    if (c % cpt != cpt - 1) continue;
    tile_end((tile0 + c / cpt) * KT, acc);
#pragma unroll
    for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;
  }
  bscan::cp_async_wait<0>();
}

// K4's pass 1: each tile's scores screened and merged into the block's
// lists, then the cluster merge. TERMS = 3 is "high", 1 "default".
template <int MAXK, int QB, int TERMS>
__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(TPB, 2)
    topk_f32_pass1(const float* __restrict__ q,
                   const float* __restrict__ keys, int bq, int n, int d,
                   int n_valid, int k, int tiles_per_split,
                   float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QB;
  const auto L = init_lists<QB, MAXK>(smem_b + f32_work_bytes(QB, TERMS));
  f32_walk<QB, TERMS>(
      q, keys, bq, n, d, n_valid, tiles_per_split, smem_b,
      [&](int key0, const auto& acc) {
        screen_tile<QB, MAXK>(
            [&](int mt, int h, int nb, int e) {
              return acc[mt][nb][2 * h + e];
            },
            L, q0, bq, key0, n_valid, k, warp, lane);
      });
  cluster_emit<QB, MAXK>(L, q0, bq, k, cand_v, cand_i);
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

// Depth bytes per ring chunk and ring stages. Below 64 query rows a chunk
// is 128 bytes deep, whole 128-byte lines of each key row, which stream
// faster than half lines, in four stages; at 64 rows, 64 bytes in three,
// so that two blocks share an SM. A staged chunk row is padded by 16 bytes.
__host__ __device__ constexpr int i8_dc(int qb) { return qb == 64 ? 64 : 128; }
__host__ __device__ constexpr int i8_stages(int qb) { return qb == 64 ? 3 : 4; }

__host__ __device__ constexpr int i8_maxk(int k) {
  return k <= 8 ? 8 : (k <= 16 ? 16 : (k <= 32 ? 32 : 64));
}

// the staged queries and the ring
__host__ __device__ constexpr size_t i8_ring_bytes(int qb, int d) {
  return (size_t)qb * (d + 16) +
         (size_t)i8_stages(qb) * KT * (i8_dc(qb) + 16);
}

__host__ __device__ constexpr size_t i8_smem(int qb, int d, int maxk) {
  return i8_ring_bytes(qb, d) + lists_bytes(qb, maxk);
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
  unsigned char* dst = ring + (c % STAGES) * (KT * (DC + 16));
  const int key0 = (tile0 + c / cpt) * KT;
  const int off = (c % cpt) * DC;
  for (int f = threadIdx.x; f < KT * V; f += TPB) {
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

// K5's and K6 int8's pass-1 walk, grid (query blocks of QB, key splits):
// the block's query codes staged once, its key range chunk by chunk through
// the ring; tile_start(key0) runs as a tile's first chunk is waited for,
// and after its last chunk tile_end(key0, acc) takes the (QB x 128) int32
// dots.
template <int QB, class Start, class End>
__device__ __forceinline__ void i8_walk(const signed char* q,
                                        const signed char* keys, int bq,
                                        int n, int d, int n_valid,
                                        int tiles_per_split,
                                        unsigned char* smem_b,
                                        const Start& tile_start,
                                        const End& tile_end) {
  constexpr int STAGES = i8_stages(QB), DC = i8_dc(QB);
  const int arow = d + 16;
  signed char* as = reinterpret_cast<signed char*>(smem_b);
  unsigned char* ring = smem_b + (size_t)QB * arow;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QB;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min((n_valid + KT - 1) / KT, tile0 + tiles_per_split);
  const int cpt = (d + DC - 1) / DC;
  const int n_chunks = max(0, tile1 - tile0) * cpt;

  // the query block's codes, staged once (rows >= bq zero)
  for (int f = tid; f < QB * (d / 16); f += TPB) {
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
  int acc[QB / 16][2][4] = {};
  for (int c = 0; c < n_chunks; ++c) {
    const int key0 = (tile0 + c / cpt) * KT;
    if (c % cpt == 0) tile_start(key0);
    bscan::cp_async_wait<STAGES - 2>();  // chunk c (and the queries) landed
    __syncthreads();  // ... for every thread; slot (c - 1) % STAGES is free
    if (c + STAGES - 1 < n_chunks)
      i8_load_chunk<STAGES, DC>(ring, keys, n, d, tile0, cpt,
                                c + STAGES - 1);
    bscan::cp_async_commit();
    i8_mma_chunk<QB, DC>(as, arow, (c % cpt) * DC,
                         ring + (c % STAGES) * (KT * (DC + 16)), warp, lane,
                         acc);
    if (c % cpt != cpt - 1) continue;
    tile_end(key0, acc);
#pragma unroll
    for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0;
  }
  bscan::cp_async_wait<0>();
}

// K5's pass 1: each tile's int32 dots, formed in registers into scores in
// the fixed order (int -> fp32, times the query scale, times the key scale),
// screened against each query's threshold theta (screen_tile), the k-th
// entry of the query's block-wide sorted list in shared memory, and merged.
// Exactness (K4's too): until k scores of a query have entered its list,
// theta is (-inf, INT_MAX), which every score beats; after, theta is an
// entry that k entries of the same query's keys (itself included) beat or
// equal, so a score that does not beat it cannot be among the query's top
// k. Theta only rises, and it changes only between two barriers, so every
// thread of a screen reads the same value (a thread reading an older, lower
// theta would only admit more). Then the cluster merge writes the
// candidates (query, cluster, k) for pass 2.
template <int MAXK, int QB>
__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(TPB, 2)
    topk_i8_pass1(const signed char* __restrict__ q,
                  const float* __restrict__ q_scale,
                  const signed char* __restrict__ keys,
                  const float* __restrict__ k_scale, int bq, int n, int d,
                  int n_valid, int k, int tiles_per_split,
                  float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * QB;
  const auto L = init_lists<QB, MAXK>(smem_b + i8_ring_bytes(QB, d));
  float qsc[QB / 16][2];
#pragma unroll
  for (int mt = 0; mt < QB / 16; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + mt * 16 + g + 8 * h;
      qsc[mt][h] = r < bq ? q_scale[r] : 0.f;
    }
  float ksc[2][2];
  i8_walk<QB>(
      q, keys, bq, n, d, n_valid, tiles_per_split, smem_b,
      [&](int key0) {  // this thread's 4 key scales of the tile, early
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + warp * 16 + nb * 8 + 2 * t4 + e;
            ksc[nb][e] = key < n_valid ? __ldg(k_scale + key) : 0.f;
          }
      },
      [&](int key0, const auto& acc) {
        screen_tile<QB, MAXK>(
            [&](int mt, int h, int nb, int e) {
              return __fmul_rn(
                  __fmul_rn(__int2float_rn(acc[mt][nb][2 * h + e]),
                            qsc[mt][h]),
                  ksc[nb][e]);
            },
            L, q0, bq, key0, n_valid, k, warp, lane);
      });
  cluster_emit<QB, MAXK>(L, q0, bq, k, cand_v, cand_i);
}

// ---- K6 on the mma.sync walks: the products with a row max ---------------

// fp32: K4's walk and products (TERMS = 3 "high", 1 "default").
template <int QB, int TERMS>
__global__ void __launch_bounds__(TPB, 2)
    mm_only_f32_pass1(const float* __restrict__ q,
                      const float* __restrict__ keys, int bq, int n, int d,
                      int n_valid, int tiles_per_split,
                      float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float rm[QB / 16][2];
#pragma unroll
  for (int mt = 0; mt < QB / 16; ++mt) rm[mt][0] = rm[mt][1] = -INFINITY;
  f32_walk<QB, TERMS>(
      q, keys, bq, n, d, n_valid, tiles_per_split, smem_b,
      [&](int key0, const auto& acc) {
        rowmax_tile<QB>(
            rm,
            [&](int mt, int h, int nb, int e) {
              return acc[mt][nb][2 * h + e];
            },
            key0, n_valid, warp, lane);
      });
  rowmax_write<QB>(
      rm, reinterpret_cast<float*>(smem_b + f32_work_bytes(QB, TERMS)),
      blockIdx.x * QB, bq, part);
}

// int8: K5's walk and products; the int32 dots converted to fp32 (exact).
template <int QB>
__global__ void __launch_bounds__(TPB, 2)
    mm_only_i8_pass1(const signed char* __restrict__ q,
                     const signed char* __restrict__ keys, int bq, int n,
                     int d, int n_valid, int tiles_per_split,
                     float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float rm[QB / 16][2];
#pragma unroll
  for (int mt = 0; mt < QB / 16; ++mt) rm[mt][0] = rm[mt][1] = -INFINITY;
  i8_walk<QB>(
      q, keys, bq, n, d, n_valid, tiles_per_split, smem_b, [](int) {},
      [&](int key0, const auto& acc) {
        rowmax_tile<QB>(
            rm,
            [&](int mt, int h, int nb, int e) {
              return __int2float_rn(acc[mt][nb][2 * h + e]);
            },
            key0, n_valid, warp, lane);
      });
  rowmax_write<QB>(rm,
                   reinterpret_cast<float*>(smem_b + i8_ring_bytes(QB, d)),
                   blockIdx.x * QB, bq, part);
}

// ---- the launches ---------------------------------------------------------

// f(Int<qb>{}) for the plan's query block (16, 32 or 64).
template <class F>
cudaError_t by_qb(int qb, const F& f) {
  if (qb == 16) return f(Int<16>{});
  if (qb == 32) return f(Int<32>{});
  return f(Int<64>{});
}

template <int MAXK, int QB, int TERMS>
cudaError_t launch_f32(const float* q, const float* keys, int bq, int n,
                       int d, int n_valid, int k, int splits,
                       int tiles_per_split, float* cand_v, int* cand_i,
                       float* out_v, int* out_i, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  const int smem = (int)f32_smem(QB, MAXK, TERMS);
  cudaError_t err = allow_smem(
      ready, (const void*)topk_f32_pass1<MAXK, QB, TERMS>, kMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid1((bq + QB - 1) / QB, splits);
  topk_f32_pass1<MAXK, QB, TERMS><<<grid1, TPB, smem, stream>>>(
      q, keys, bq, n, d, n_valid, k, tiles_per_split, cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pass2<MAXK>(bq, splits / CLUSTER * k, k, cand_v, cand_i,
                            out_v, out_i, stream);
}

template <int MAXK, int QB>
cudaError_t launch_i8(const signed char* q, const float* q_scale,
                      const signed char* keys, const float* k_scale, int bq,
                      int n, int d, int n_valid, int k, int splits,
                      int tiles_per_split, float* cand_v, int* cand_i,
                      float* out_v, int* out_i, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  const int smem = (int)i8_smem(QB, d, MAXK);
  cudaError_t err =
      allow_smem(ready, (const void*)topk_i8_pass1<MAXK, QB>, kMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid1((bq + QB - 1) / QB, splits);
  topk_i8_pass1<MAXK, QB><<<grid1, TPB, smem, stream>>>(
      q, q_scale, keys, k_scale, bq, n, d, n_valid, k, tiles_per_split,
      cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pass2<MAXK>(bq, splits / CLUSTER * k, k, cand_v, cand_i,
                            out_v, out_i, stream);
}

// K7: o = x + 1 over n fp32 elements. VEC (x and o 16-byte aligned): a
// thread takes four by one 16-byte load and store, the threads past n / 4 one
// of the n % 4 left; else one each.
constexpr int kTinyThreads = 256;

template <bool VEC>
__global__ void __launch_bounds__(kTinyThreads)
    tiny_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    const int n4 = n >> 2;
    if (i < n4) {
      float4 v = reinterpret_cast<const float4*>(x)[i];
      v.x += 1.f;
      v.y += 1.f;
      v.z += 1.f;
      v.w += 1.f;
      reinterpret_cast<float4*>(o)[i] = v;
      return;
    }
    const int j = 4 * n4 + (i - n4);
    if (j < n) o[j] = x[j] + 1.f;
  } else if (i < n) {
    o[i] = x[i] + 1.f;
  }
}

}  // namespace

extern "C" {

// K4's mma.sync body. Shapes the wrapper must respect: q (bq, d) and keys
// (n, d) contiguous fp32, 16-byte aligned, d % 32 == 0, 1 <= k <= 32, k <=
// n_valid <= n. precision: 0 "high" (the six-product bf16 split, fp32
// sums), 1 "default" (operands rounded to bf16, fp32 sums). The plan
// (`plan_f32` in ops/topk.py): the query block qb (16, 32 or 64), splits (a
// multiple of CLUSTER) x tiles_per_split covering the n / KT key tiles with
// no empty cluster, n_cand = bq * (splits / CLUSTER) * k entries per
// candidate buffer. Otherwise it returns cudaErrorInvalidValue and
// launches nothing. Returns the cudaError_t of the launches.
int bscan_topk_f32(const float* q, const float* keys, int bq, int n, int d,
                   int n_valid, int k, int precision, int qb, int splits,
                   int tiles_per_split, long long n_cand, float* cand_v,
                   int* cand_i, float* out_v, int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + KT - 1) / KT;
  if (bq < 1 || d < F32_DC || d % F32_DC != 0 || k < 1 || k > 32 ||
      n_valid < k || n_valid > n || precision < 0 || precision > 1 ||
      (qb != 16 && qb != 32 && qb != 64) || splits < CLUSTER ||
      splits % CLUSTER != 0 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - CLUSTER) * tiles_per_split >= n_tiles ||
      n_cand != (long long)bq * (splits / CLUSTER) * k)
    return (int)cudaErrorInvalidValue;
  return (int)by_qb(qb, [&](auto qbc) {
    return by_maxk<32>(k, [&](auto mk) {
      constexpr int QB = decltype(qbc)::value, MAXK = decltype(mk)::value;
      if (precision == 1)
        return launch_f32<MAXK, QB, 1>(q, keys, bq, n, d, n_valid, k, splits,
                                       tiles_per_split, cand_v, cand_i,
                                       out_v, out_i, s);
      return launch_f32<MAXK, QB, 3>(q, keys, bq, n, d, n_valid, k, splits,
                                     tiles_per_split, cand_v, cand_i, out_v,
                                     out_i, s);
    });
  });
}

// The dynamic shared memory of topk_f32_pass1<maxk, qb, terms>, in bytes.
int bscan_topk_f32_smem(int qb, int maxk, int terms) {
  return (int)f32_smem(qb, maxk, terms);
}

// K5's mma.sync body. Shapes the wrapper must respect: q (bq, d) and keys
// (n, d) contiguous int8 codes, 16-byte aligned, d % 64 == 0; q_scale (bq,)
// and k_scale (n,) fp32; 1 <= k <= 64, k <= n_valid <= n. The plan
// (`plan_i8` in ops/topk.py): the query block qb (16, 32 or 64) whose
// staged codes, ring and lists fit in shared memory, splits (a multiple of
// CLUSTER) x tiles_per_split covering the n / KT key tiles with no empty
// cluster, n_cand = bq * (splits / CLUSTER) * k entries per candidate
// buffer. Otherwise it returns cudaErrorInvalidValue and launches nothing.
// Returns the cudaError_t of the launches.
int bscan_topk_i8(const signed char* q, const float* q_scale,
                  const signed char* keys, const float* k_scale, int bq,
                  int n, int d, int n_valid, int k, int qb, int splits,
                  int tiles_per_split, long long n_cand, float* cand_v,
                  int* cand_i, float* out_v, int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + KT - 1) / KT;
  if (bq < 1 || d < 64 || d % 64 != 0 || k < 1 || k > 64 || n_valid < k ||
      n_valid > n || (qb != 16 && qb != 32 && qb != 64) ||
      i8_smem(qb, d, i8_maxk(k)) > kMaxSmem || splits < CLUSTER ||
      splits % CLUSTER != 0 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - CLUSTER) * tiles_per_split >= n_tiles ||
      n_cand != (long long)bq * (splits / CLUSTER) * k)
    return (int)cudaErrorInvalidValue;
  return (int)by_qb(qb, [&](auto qbc) {
    return by_maxk<64>(k, [&](auto mk) {
      constexpr int QB = decltype(qbc)::value, MAXK = decltype(mk)::value;
      return launch_i8<MAXK, QB>(q, q_scale, keys, k_scale, bq, n, d, n_valid,
                                 k, splits, tiles_per_split, cand_v, cand_i,
                                 out_v, out_i, s);
    });
  });
}

// The dynamic shared memory of topk_i8_pass1<maxk, qb> at width d, in
// bytes.
long long bscan_topk_i8_smem(int qb, int d, int maxk) {
  return (long long)i8_smem(qb, d, maxk);
}

// The dynamic shared memory of K6's pass 1 on the mma.sync walks (mode 2:
// int8 at width d; else fp32 in `terms` products), in bytes.
long long bscan_mm_only_smem(int qb, int d, int mode) {
  return (long long)((mode == 2 ? i8_ring_bytes(qb, d)
                                : f32_work_bytes(qb, mode == 0 ? 3 : 1)) +
                     sizeof(float) * 8 * qb);
}

// K6 on the mma.sync walks. mode 0: q (bq, d) and keys (n, d) fp32, "high"
// (K4's six products); mode 1: "default" (K4's one bf16 product); mode 2:
// int8 codes (K5's products). d % 32 == 0 (fp32) or d % 64 == 0 (int8),
// 16-byte aligned rows, 0 <= n_valid <= n; the plan (`plan_mm_only` in
// ops/topk.py, its mma body): the query block qb (16, 32 or 64), splits (a
// multiple of CLUSTER, from the mma plans of K4 and K5) x tiles_per_split
// covering the n / KT key tiles with no empty cluster, smem the bytes
// `bscan_mm_only_smem` gives (at most 232,448); part holds bq * splits
// floats, out (bq, 128). Otherwise it returns cudaErrorInvalidValue and
// launches nothing. A row with no valid key comes out -inf. Returns
// cudaError_t.
int bscan_mm_only(const void* q, const void* keys, int bq, int n, int d,
                  int n_valid, int mode, int qb, int splits,
                  int tiles_per_split, long long smem, float* part,
                  float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + KT - 1) / KT;
  if (n_valid < 0 || n_valid > n || bq < 1 || mode < 0 || mode > 2 ||
      (qb != 16 && qb != 32 && qb != 64) ||
      d % (mode == 2 ? 64 : F32_DC) != 0 || splits < CLUSTER ||
      splits % CLUSTER != 0 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - CLUSTER) * tiles_per_split >= n_tiles ||
      smem != bscan_mm_only_smem(qb, d, mode) || smem > (long long)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid1((bq + qb - 1) / qb, splits);
  cudaError_t err;
  if (mode == 2) {
    err = by_qb(qb, [&](auto qbc) {
      constexpr int QB = decltype(qbc)::value;
      static bool ready[kMaxDevices] = {};
      cudaError_t e =
          allow_smem(ready, (const void*)mm_only_i8_pass1<QB>, kMaxSmem);
      if (e != cudaSuccess) return e;
      mm_only_i8_pass1<QB><<<grid1, TPB, smem, s>>>(
          static_cast<const signed char*>(q),
          static_cast<const signed char*>(keys), bq, n, d, n_valid,
          tiles_per_split, part);
      return cudaGetLastError();
    });
  } else {
    err = by_qb(qb, [&](auto qbc) {
      constexpr int QB = decltype(qbc)::value;
      static bool ready[2][kMaxDevices] = {};  // mode 0, mode 1
      auto kernel = mode == 0 ? mm_only_f32_pass1<QB, 3>
                              : mm_only_f32_pass1<QB, 1>;
      cudaError_t e =
          allow_smem(ready[mode], (const void*)kernel, kMaxSmem);
      if (e != cudaSuccess) return e;
      kernel<<<grid1, TPB, smem, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(keys), bq,
          n, d, n_valid, tiles_per_split, part);
      return cudaGetLastError();
    });
  }
  if (err != cudaSuccess) return (int)err;
  mm_only_pass2<<<bq, 128, 0, s>>>(part, splits, out);
  return (int)cudaGetLastError();
}

// K7: o = x + 1 over n contiguous fp32 elements. Returns cudaError_t.
int bscan_tiny(const float* x, float* o, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((((uintptr_t)x | (uintptr_t)o) & 15) == 0) {
    const int threads = n / 4 + n % 4;
    tiny_kernel<true><<<(threads + kTinyThreads - 1) / kTinyThreads,
                        kTinyThreads, 0, s>>>(x, o, n);
  } else {
    tiny_kernel<false><<<(n + kTinyThreads - 1) / kTinyThreads,
                         kTinyThreads, 0, s>>>(x, o, n);
  }
  return (int)cudaGetLastError();
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
