// K3, the attention backward, for Hopper: TMA loads behind mbarriers, wgmma
// products, each query row's scores held in registers, two passes without
// atomics. The same body, with an (N, N) score mask, is K3m.
//
// Replaces (TPU Pallas kernels in bioscan_clip_tpu/ops/attention.py), on
// bf16 input at head dim 64 without a key bias:
//   K3  `_pallas_mha_bwd` without a mask (:321; body `_attend_bwd_one_row`
//       :212-271), 33 <= N <= 272: ViT-B/16's packed qkv at N = 197,
//       BarcodeBERT's split q/k/v at N = 133 with row-keyed dropout,
//       ViT-L/14's packed qkv at N = 257;
//   K3m the same with the (N, N) fp32 score mask (`has_mask` :363-367, the
//       add at :237), without dropout, 1 <= N <= 144 (the plan, `plan_bwd`
//       in ops/attention.py, keeps mha_bwd.cu's body at small N and large
//       B, where it measured faster): the backward of K1m, OpenCLIP's
//       causal text tower at N = 77 and the WordPiece N = 20 of its
//       training.
// Every other case of `mha_bwd` (fp32, a key bias or its gradient, another
// head dim, N outside these ranges) stays on the bodies of mha_bwd.cu.
//
// Contract (`_attend_bwd_one_row`, the plain `mha_bwd_reference`): per
// (batch row, head), s = (q . k) * scale in fp32, then + mask[i, j] in fp32
// (K3m); p = exp(s - m) * (1 / l) in fp32 (`bscan::prob`); y = p * keep,
// rounded to bf16 for dv = y^T g;
// dp = (g . v^T) * keep in fp32; D = rowsum(dp * p); ds = p (dp - D), with
// ds * scale rounded to bf16 for dq = ds . k and dk = ds^T q. keep is the
// counter hash of `bscan::Dropout`, bit-equal to K2d's mask. D sums dp * p,
// as JAX does (not FlashAttention's rowsum(dO * O): O is rounded).
//
// What bounds it on an H100: at ViT-B B = 400, N = 197, D = 768, h = 12 the
// bytes are q, k, v, g read once and dq, dk, dv written once, 7 * 400 *
// 197 * 768 * 2 = 0.85 GB: 0.25 ms at 3.35 TB/s; the five products, 5 * 2
// * B * h * N^2 * 64 = 0.19 ms at 989 TFLOP/s. So the bytes bound it, with
// the products close behind; this body forms 8 N^2 hd products (the scores
// once in each pass, dp twice in pass A) and reads ~11 units of B N D bf16.
// K3m at OpenCLIP's B = 64, N = 77 moves 53.0 MB (0.0158 ms), at its
// training's B = 10, N = 20 2.15 MB (0.0006 ms): there two launches' fixed
// cost, not bytes, bound the time.
//
// Two passes, each one launch of a persistent grid (one CTA per SM) over
// work items (batch row, head, pair of 64-row tiles), pair fastest, so the
// items that share a head's full tensors run side by side and the second
// reads them from L2. Every output element has one writer, and every sum a
// fixed order: two launches give the same bits.
// A CTA is two warpgroups of 128 threads, each computing one 64-row tile of
// an item. Thread 0 also issues the TMA loads of item i + 1 into one of two
// stages while both work on item i; a warpgroup releases a stage after its
// output tile, written into the stage's own tile slot, has been read by its
// TMA store. No warp is set aside for the loads: ptxas sizes registers as
// if a CTA's threads came in warpgroups, so a separate producer warp (288
// threads) capped every thread at 168 registers, as K1's 384 threads do,
// and pass A spilled up to 980 bytes of its score row; at 256 threads
// `__launch_bounds__(256, 1)` allows 255. The two warpgroups issue their
// products as they come: taking turns on the tensor cores, as K1's
// consumers do, ran 5-6% slower here (tools/sweep_k3_sm90.py).
//
// Pass A, per query tile; writes dq and the statistics (B, h, 3, rows) fp32:
// m, 1 / l and D of every query row (rows past N: m = +inf, so pass B's p is
// 0 there).
// - Loads: the two Q tiles, the two G tiles, all of K_h and V_h (pad16(N)
//   rows in one TMA box up to 256 rows, two boxes above; rows past N arrive
//   as zeros).
// - S = Q . K_h^T once (wgmma, both operands in shared memory), the whole
//   score row in registers (pad16(N) / 2 fp32 a thread: 104 at N = 197);
//   keys past N score -inf; m, l, and p = e * (1 / l) in place. With
//   dropout the keep bits are hashed once, into a register bitmask.
// - Sweep 1 over 64-key chunks: dP = G . V_c^T (wgmma), times keep, and
//   D += dp * p. Sweep 2: the same dP chunk again, ds = p (dp - D), ds *
//   scale rounded to bf16 straight into the register A fragments of dq +=
//   ds . K_c (wgmma, B = K_c transposed from shared memory, the form of K1's
//   P . V). Four N^2 hd products, one exp and one hash per score.
// Pass B, per key tile; writes dk and dv.
// - Loads: the two K tiles, the two V tiles, all of Q_h and G_h (as pass A's
//   K_h) and the head's statistics (one bulk copy).
// - For each 64-row query chunk (the last one 16, 32 or 48 rows at a ragged
//   N): S^T = K_t . Q_c^T and dP^T = V_t . G_c^T (wgmma), p^T from m and
//   1 / l, y^T and ds^T * scale rounded to bf16 into A fragments for dV +=
//   y^T . G_c and dK += ds^T . Q_c (B transposed from shared memory). The
//   registers do not grow with N.
// Pass B rebuilds p from pass A's m and 1 / l, so it must form the same
// score: s of pass A (Q in wgmma's A role) and of pass B (K in the A role)
// are equal bit for bit, as the `gpu` tests check through this library's
// score read-out (`bscan_mha_bwd_sm90` with score pointers), with and
// without the mask.
// The score mask (K3m). Its rows are N fp32 apart (308 B at N = 77), not
// 16-byte aligned, so no TMA map takes them; each consumer stages the part
// it needs into its own shared memory by 4-byte `cp.async`, issued before
// it waits for the stage (the copy runs under the TMA loads), 64 rows of
// pad16(N) + 8 fp32 (the 8 floats put rows g and g + 2 of a quad's float2
// reads in other banks), entries past N 0:
// - pass A, its query tile's 64 mask rows, read as the forward (K1m) reads
//   them: thread (g, t) of warp w takes rows 16 w + g and + 8, columns 2 t;
// - pass B, its key tile's 64 mask columns, key-major: row j of the buffer
//   holds mask[i, 64 tile + j] at column i. A thread's S^T accumulator holds
//   (key 16 w + g [+ 8], query q0 + 8 nb + 2 t [+ 1]), so it reads the
//   buffer in pass A's pattern, float2 for two queries. The copy reads a
//   query row's 64 keys in order (coalesced); its shared-memory writes are
//   pad16(N) + 8 floats apart (8-way bank conflicts), once per CTA at most
//   sizes.
// Both add the mask to the scaled score with one `__fadd_rn`, the order of
// `mha_bwd_reference` and of mha_bwd.cu's `masked`. A consumer restages only
// when its tile changes: items walk the pair fastest and the grid is even,
// so at N <= 128 (one pair: consumer c always has tile c), and whenever the
// grid is a multiple of the pairs, a CTA stages once. The mask is general
// (no causal tile skip). `MASK` is a template flag, so K3's instantiations
// compile as before (their SASS is unchanged, `tools/bench_k3.py --sass`);
// it is instantiated without dropout only (OpenCLIP's text tower has none),
// for 1-9 16-row key units. At N <= 64 a head is one tile, so the second
// consumer of an item idles: from B = 12-56 at N <= 30 (the larger the N,
// the larger the B) the mma.sync passes, many small CTAs to an SM, beat
// this body's walk of several items a CTA, and keep those shapes
// (`BWD_MASK_MMA_FROM`, tools/sweep_k3_sm90.py --mask).
//
// Budget. Shared memory (`plan_bwd` in ops/attention.py gives the same
// numbers; the launch checks them): pass A two stages of (4 tiles + K_h +
// V_h) = 2 * (32 KB + 2 * pad16(N) * 128 B) and 1 KB of alignment slack:
// 173,120 B at N = 197, 205,888 B at N = 272; pass B two stages of (4 tiles
// + Q_h + G_h + the statistics, rounded up to 1 KB): 179,264 B at N = 197,
// 214,080 B at N = 272. Registers (the build phase of chip_smoke.py prints
// ptxas' lines for every instantiation): pass B 182 without dropout, 211
// with; pass A without dropout 93-242 and no spill up to 256 key rows but
// at 240 (44 bytes) and 272 (72 bytes); with dropout the hash's temporaries
// raise it to 255 from 128 key rows on, with 8 bytes of spill at 128-144
// rows (BarcodeBERT), 12-80 at 160-192 and 248-1048 above. Every N up to
// 272 keeps the sm90 body all the same: each spilling instantiation timed
// 1.07-2.5x faster than the mma.sync body of mha_bwd.cu at its shape
// (tools/sweep_k3_sm90.py). 64-key dP chunks: 32-key chunks above 208 key
// rows spilled more (160 bytes at 272) and ran slower.
// With the mask each pass adds its two consumers' staged mask, 2 * 64 *
// (pad16(N) + 8) * 4 B: pass A 103,488 B at N = 20, 152,640 B at N = 77 and
// 218,176 B at N = 144; pass B 105,536 B at N = 20, 156,736 B at N = 77 and
// 224,320 B at N = 144, the largest N whose mask fits the 232,448 B a block
// may have (`kMaxMaskN`; pass A at N = 160 would need 234,560 B).

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace {

using bscan::Dropout;
using bscan::smem_addr;
using namespace bscan::sm90;

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 2;            // one 128-byte swizzle row
constexpr int kTileRows = 64;                      // wgmma M: one warpgroup
constexpr int kTileBytes = kTileRows * kRowBytes;  // 8 KB
constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * kConsumers;         // thread 0 also loads
constexpr int kStages = 2;
constexpr int kChunk = 4;  // 16-row units of a dP chunk (64 keys / queries)
constexpr int kMinN = 33;
constexpr int kMaxN = 272;
constexpr int kMinMaskN = 1;     // K3m's least N: 16 key rows
constexpr int kMaxMaskN = 144;  // K3m's largest N: its mask fits
constexpr int kMaxBox = 256;  // TMA's largest box dimension
constexpr int kAlign = 1024;  // the 128-byte swizzle's atom: 8 rows
constexpr int kBarrierBytes = 64;
constexpr int kStats = 3;  // m, 1 / l, D

// ---- the plan (`plan_bwd` in ops/attention.py is its twin) --------------

struct Plan {
  int key_rows;  // N padded to 16: K_h, V_h (pass A), Q_h, G_h (pass B)
  int box;       // rows of one TMA box of those
  int loads;     // boxes per tensor
  int tiles;     // 64-row tiles (query tiles in A, key tiles in B)
  int rows;      // tiles * 64: the rows of one statistics plane
  int items;     // (batch row, head, pair of tiles), in either pass
  long long smem_a, smem_b;  // dynamic shared memory of a CTA
};

// a consumer's staged mask (K3m): 64 rows of pad16(N) + 8 fp32, pass A's
// query rows or pass B's key columns
__host__ __device__ constexpr int mask_stride(int key_rows) {
  return key_rows + 8;
}

__host__ __device__ constexpr int mask_bytes(int key_rows) {
  return kTileRows * mask_stride(key_rows) * 4;
}

__host__ __device__ constexpr int stage_a(int key_rows) {
  return 2 * kConsumers * kTileBytes + 2 * key_rows * kRowBytes;
}

__host__ __device__ constexpr int stage_b(int key_rows, int rows) {
  return (2 * kConsumers * kTileBytes + 2 * key_rows * kRowBytes +
          kStats * rows * 4 + kAlign - 1) /
         kAlign * kAlign;
}

constexpr long long smem_a(int key_rows, bool masked) {
  return kAlign + (long long)kStages * stage_a(key_rows) + kBarrierBytes +
         (masked ? kConsumers * mask_bytes(key_rows) : 0);
}

constexpr long long smem_b(int key_rows, int rows, bool masked) {
  return kAlign + (long long)kStages * stage_b(key_rows, rows) +
         kBarrierBytes + (masked ? kConsumers * mask_bytes(key_rows) : 0);
}

Plan make_plan(int b, int n, int heads, bool masked) {
  Plan p;
  p.key_rows = bscan::pad16(n);
  p.loads = p.key_rows > kMaxBox ? 2 : 1;
  p.box = p.key_rows / p.loads;
  p.tiles = (n + kTileRows - 1) / kTileRows;
  p.rows = p.tiles * kTileRows;
  p.items = b * heads * ((p.tiles + kConsumers - 1) / kConsumers);
  p.smem_a = smem_a(p.key_rows, masked);
  p.smem_b = smem_b(p.key_rows, p.rows, masked);
  return p;
}

// ---- kernel arguments ----------------------------------------------------

struct Args {
  int n, heads;
  int key_rows, box, loads, tiles, rows, items;
  // column of head 0 in each tensor map: 0, D, 2 D in the packed layout
  int q_col, k_col, v_col, dq_col, dk_col, dv_col;
  float scale;
  float* stats;    // (B, heads, 3, rows): m, 1 / l, D
  Dropout drop;
  float* score_a;  // (B, heads, N, N) or nullptr: the read-out of s
  float* score_b;
  const float* mask;  // (N, N) fp32 (K3m) or nullptr; last, so that K3's
                      // fields keep their offsets
};

// The largest piece (in 16-row units) of `rest` units that one wgmma takes:
// 16 (256 keys), 8, 4, 2 or 1.
__host__ __device__ constexpr int piece(int rest) {
  return rest >= 16 ? 16 : rest >= 8 ? 8 : rest >= 4 ? 4 : rest >= 2 ? 2 : 1;
}

// Call f(J0, C) for the pieces [J0, J0 + C) that cover units [J, KT).
template <int KT, int J, typename F>
__device__ __forceinline__ void for_pieces(F&& f) {
  if constexpr (J < KT) {
    constexpr int C = piece(KT - J);
    f(std::integral_constant<int, J>{}, std::integral_constant<int, C>{});
    for_pieces<KT, J + C>(f);
  }
}

// Call f(J0, W) for the dP chunks [J0, J0 + W) of kChunk units that cover
// units [J, KT).
template <int KT, int J, typename F>
__device__ __forceinline__ void for_chunks(F&& f) {
  if constexpr (J < KT) {
    constexpr int W = KT - J < kChunk ? KT - J : kChunk;
    f(std::integral_constant<int, J>{}, std::integral_constant<int, W>{});
    for_chunks<KT, J + kChunk>(f);
  }
}

// d[0, 8 W) = A . B^T over the head dim: A a 64-row tile, B the 16 W rows
// from `b_rows`, both K-major in shared memory (the 128-byte swizzle).
template <int W>
__device__ __forceinline__ void product_nt(float (&d)[8 * W], uint32_t a_tile,
                                           uint32_t b_rows) {
  const uint64_t da = sw128_desc(a_tile, 16), db = sw128_desc(b_rows, 16);
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    for_pieces<W, 0>([&](auto j0, auto cn) {
      constexpr int J0 = decltype(j0)::value, C = decltype(cn)::value;
      WgmmaSS<16 * C>::template run<8 * J0>(
          d, da + 2 * kk, db + ((J0 * 16 * kRowBytes) >> 4) + 2 * kk, kk > 0);
    });
}

// Accumulator element x (of 8) of a 16-column unit: row g + 8 ((x >> 1) & 1)
// of the warp's 16, column 8 (x >> 2) + 2 t + (x & 1) of the unit.
__device__ __forceinline__ int row_of(int x) { return 8 * ((x >> 1) & 1); }
__device__ __forceinline__ int col_of(int x, int t) {
  return 8 * (x >> 2) + 2 * t + (x & 1);
}

// Eight values of a unit in accumulator order, rounded to bf16, as the A
// fragment of a 64 x 16 slice (the layout of mma.sync's A, a warp a slice).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&v)[8]) {
  a[0] = bscan::pack_bf16(v[0], v[1]);
  a[1] = bscan::pack_bf16(v[2], v[3]);
  a[2] = bscan::pack_bf16(v[4], v[5]);
  a[3] = bscan::pack_bf16(v[6], v[7]);
}

__device__ __forceinline__ void init_barriers(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);               // full[s]: the loader
      mbar_init(bars + 16 + 8 * s, kConsumers);  // empty[s]: one a consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The loader's wait for stage it % 2 to be free before its use `it`.
__device__ __forceinline__ void loader_wait(uint32_t bars, int it) {
  if (it >= kStages)
    mbar_wait(bars + 16 + 8 * (it & 1), ((it >> 1) + 1) & 1);
}

// Release stage s once this thread's TMA stores have read their slots (the
// consumers' output tiles are written into the stage's own tile slots).
__device__ __forceinline__ void release_after_stores(uint32_t empty) {
  tma_store_read_wait();
  mbar_arrive(empty);
}

// 4 bytes from global to shared memory, asynchronously (as in
// mha_fwd_sm90.cu); `valid` false writes 4 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The mask rows of query tile `tile` into a consumer's shared memory (`dst`:
// 64 rows of mask_stride(16 KT) fp32), the warpgroup's 128 threads in order
// (coalesced reads), one committed group; entries past N stage 0. The
// caller waits for the group and syncs the warpgroup before reading.
template <int KT>
__device__ __forceinline__ void stage_rows(float* dst, const float* mask,
                                           int n, int tile, int tid) {
  constexpr int kCols = 16 * KT;
#pragma unroll 8
  for (int i = 0; i < 8 * KT; ++i) {  // 64 * kCols / 128 elements a thread
    const int e = tid + 128 * i;
    const int r = e / kCols, col = e - r * kCols;
    const int row = tile * kTileRows + r;
    const bool in = row < n && col < n;
    cp_async4(dst + r * mask_stride(kCols) + col,
              in ? mask + (long long)row * n + col : mask, in);
  }
  bscan::cp_async_commit();
}

// The mask columns of key tile `tile`, key-major, into a consumer's shared
// memory (`dst`: row j of mask_stride(key_rows) fp32 holds mask[i, 64 tile +
// j] at column i < key_rows): threads 64 apart take the 64 keys of query
// rows i and i + 1 (coalesced reads); one committed group, entries past N
// 0. The caller waits and syncs as for `stage_rows`.
__device__ __forceinline__ void stage_cols(float* dst, const float* mask,
                                           int n, int key_rows, int tile,
                                           int tid) {
  const int j = tid & (kTileRows - 1);
  const int key = tile * kTileRows + j;
  for (int i = tid / kTileRows; i < key_rows; i += 128 / kTileRows) {
    const bool in = i < n && key < n;
    cp_async4(dst + j * mask_stride(key_rows) + i,
              in ? mask + (long long)i * n + key : mask, in);
  }
  bscan::cp_async_commit();
}

// ---- pass A: per query tile, dq and the statistics ----------------------
//
// Shared memory from the 1024-aligned base: stage s at s * stage_a (Q tile
// 0, Q tile 1, G tile 0, G tile 1, K_h, V_h), then the barriers full[2] and
// empty[2], then (MASK) the consumers' mask rows. A consumer's dq goes out
// through its Q tile's slot.
template <int KT, bool DROP, bool MASK, bool READOUT>
__global__ void __launch_bounds__(kThreads, 1)
    mha_bwd_sm90_pass_a(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_g,
                        const __grid_constant__ CUtensorMap tm_dq,
                        const Args a) {
  static_assert(!(MASK && DROP), "K3m has no dropout");
  constexpr int kKeyRows = 16 * KT;
  constexpr int kStage = stage_a(kKeyRows);
  constexpr int kKeepWords = (8 * KT + 31) / 32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t bars = base + kStages * kStage;
  const int pairs = (a.tiles + kConsumers - 1) / kConsumers;
  const int n = a.n;
  init_barriers(bars);

  // thread 0 issues the TMA loads of item `item` (its use `it` of the
  // stages) into stage it % 2, once both consumers have released it
  auto load = [&](int item, int it) {
    loader_wait(bars, it);
    const Item w(item, a.heads, pairs);
    const int t0 = kConsumers * w.pair;
    const int tiles = min(kConsumers, a.tiles - t0);
    const uint32_t full = bars + 8 * (it & 1);
    const uint32_t st = base + (it & 1) * kStage;
    mbar_expect_tx(full, 2 * tiles * kTileBytes +
                             2u * a.loads * a.box * kRowBytes);
    for (int q = 0; q < tiles; ++q) {
      const int row = (t0 + q) * kTileRows;
      tma_load(st + q * kTileBytes, &tm_q, full, a.q_col + w.h * kHeadDim,
               row, w.b);
      tma_load(st + (kConsumers + q) * kTileBytes, &tm_g, full,
               w.h * kHeadDim, row, w.b);
    }
    const uint32_t ks = st + 2 * kConsumers * kTileBytes;
    const uint32_t vs = ks + kKeyRows * kRowBytes;
    for (int l = 0; l < a.loads; ++l) {
      tma_load(ks + l * a.box * kRowBytes, &tm_k, full,
               a.k_col + w.h * kHeadDim, l * a.box, w.b);
      tma_load(vs + l * a.box * kRowBytes, &tm_v, full,
               a.v_col + w.h * kHeadDim, l * a.box, w.b);
    }
  };

  // ---- warpgroup c takes query tile 2 * pair + c ----
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int wq = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warpgroup's mask rows (MASK), and this thread's: rows g and g + 8
  // of its warp's 16, from column 2 t
  constexpr int kMaskStride = mask_stride(kKeyRows);
  float* const mask_s = reinterpret_cast<float*>(
      smem_raw + (bars + kBarrierBytes - raw) + c * mask_bytes(kKeyRows));
  [[maybe_unused]] const float* const mask_g =
      mask_s + (16 * wq + g) * kMaskStride + 2 * t;
  [[maybe_unused]] int staged = -1;  // the tile whose mask rows are staged
  if (threadIdx.x == 0 && (int)blockIdx.x < a.items) load(blockIdx.x, 0);
  int it = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x, ++it) {
    // the next item's loads run under this item's products
    if (threadIdx.x == 0 && item + (int)gridDim.x < a.items)
      load(item + gridDim.x, it + 1);
    const int s = it & 1;
    const Item w(item, a.heads, pairs);
    const int tile = kConsumers * w.pair + c;
    const uint32_t st = base + s * kStage;
    const uint32_t qs = st + c * kTileBytes;
    const uint32_t gs = st + (kConsumers + c) * kTileBytes;
    const uint32_t ks = st + 2 * kConsumers * kTileBytes;
    const uint32_t vs = ks + kKeyRows * kRowBytes;
    const uint32_t empty = bars + 16 + 8 * s;
    // the mask rows of this tile when it changed, copied under the stage's
    // loads (the last item's reads ended at its dq store's warpgroup sync)
    [[maybe_unused]] bool restaged = false;
    if constexpr (MASK) {
      if (tile < a.tiles && tile != staged) {
        stage_rows<KT>(mask_s, a.mask, n, tile, tid);
        staged = tile;
        restaged = true;
      }
    }
    mbar_wait(bars + 8 * s, (it >> 1) & 1);
    if (tile >= a.tiles) {  // an odd tile count: nothing for this one
      if (tid == 0) mbar_arrive(empty);
      continue;
    }
    const int row0 = tile * kTileRows + 16 * wq + g;  // and row0 + 8
    const long long bh = (long long)w.b * a.heads + w.h;

    // S = Q . K_h^T: 64 x kKeyRows fp32, unit j in sc[8 j .. 8 j + 7]
    float sc[8 * KT];
    wgmma_fence();
    product_nt<KT>(sc, qs, ks);
    wgmma_commit();
    if constexpr (MASK) {
      if (restaged) {  // the mask rows copied (all the warpgroup's)
        bscan::cp_async_wait_all();
        warpgroup_sync(1 + c);
      }
    }
    wgmma_wait();
    fence_regs(sc);

    // scale, + the mask, keys past N at -inf, the row max over the quad
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int key = 16 * j + col_of(x, t);
        float v = __fmul_rn(sc[8 * j + x], a.scale);
        if constexpr (MASK) {
          const float2 mm = *reinterpret_cast<const float2*>(
              mask_g + row_of(x) * kMaskStride + 16 * j + 8 * (x >> 2));
          v = __fadd_rn(v, (x & 1) ? mm.y : mm.x);
        }
        if constexpr (READOUT) {
          const int i = row0 + row_of(x);
          if (i < n && key < n) a.score_a[(bh * n + i) * n + key] = v;
        }
        if (j == KT - 1 && key >= n) v = -INFINITY;
        sc[8 * j + x] = v;
        m[(x >> 1) & 1] = fmaxf(m[(x >> 1) & 1], v);
      }
    m[0] = bscan::quad_max(m[0]);
    m[1] = bscan::quad_max(m[1]);
    // e = exp(s - m), l = sum e, then p = e * (1 / l) in place: the
    // arithmetic of `bscan::prob`, which pass B repeats from m and 1 / l
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 8 * KT; ++e) {
      const float x = __expf(sc[e] - m[(e >> 1) & 1]);
      sc[e] = x;
      l[(e >> 1) & 1] += x;
    }
    const float inv[2] = {1.f / bscan::quad_sum(l[0]),
                          1.f / bscan::quad_sum(l[1])};
#pragma unroll
    for (int e = 0; e < 8 * KT; ++e) sc[e] *= inv[(e >> 1) & 1];

    // the keep bits, hashed once: element e of sc is bit e % 32 of word
    // e / 32
    uint32_t keep[kKeepWords];
    if constexpr (DROP) {
      unsigned dbase, dseed;
      a.drop.row(w.b, w.h, a.heads, n, &dbase, &dseed);
#pragma unroll
      for (int wd = 0; wd < kKeepWords; ++wd) keep[wd] = 0u;
#pragma unroll
      for (int e = 0; e < 8 * KT; ++e) {
        const int i = row0 + row_of(e & 7);
        const int key = 16 * (e >> 3) + col_of(e & 7, t);
        const unsigned ctr = (dbase + (unsigned)i) * (unsigned)n + key;
        if (bscan::mix32(dseed ^ bscan::mix32(ctr)) >= a.drop.threshold)
          keep[e >> 5] |= 1u << (e & 31);
      }
    }
    // dp times keep: the factor of `Dropout::factor`, keep_scale or 0
    auto dropped = [&](float dp, int e) {
      if constexpr (DROP)
        return dp * ((keep[e >> 5] >> (e & 31)) & 1u ? a.drop.keep_scale
                                                      : 0.f);
      return dp;
    };

    // sweep 1: D = rowsum(dp * p) over 64-key chunks of dP = G . V_c^T
    float dsum[2] = {0.f, 0.f};
    for_chunks<KT, 0>([&](auto j0, auto wn) {
      constexpr int J0 = decltype(j0)::value, W = decltype(wn)::value;
      float dp[8 * W];
      wgmma_fence();
      product_nt<W>(dp, gs, vs + J0 * 16 * kRowBytes);
      wgmma_commit();
      wgmma_wait();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < 8 * W; ++e) {
        const int se = 8 * J0 + e;
        dsum[(e >> 1) & 1] += dropped(dp[e], se) * sc[se];
      }
    });
    const float dvec[2] = {bscan::quad_sum(dsum[0]),
                           bscan::quad_sum(dsum[1])};

    // sweep 2: the same dP chunks, ds = p (dp - D), dq += (ds * scale ->
    // bf16) . K_c
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    for_chunks<KT, 0>([&](auto j0, auto wn) {
      constexpr int J0 = decltype(j0)::value, W = decltype(wn)::value;
      float dp[8 * W];
      wgmma_fence();
      product_nt<W>(dp, gs, vs + J0 * 16 * kRowBytes);
      wgmma_commit();
      wgmma_wait();
      fence_regs(dp);
      uint32_t da[W][4];
#pragma unroll
      for (int u = 0; u < W; ++u) {
        float v[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int se = 8 * (J0 + u) + x;
          const float ds =
              sc[se] * (dropped(dp[8 * u + x], se) - dvec[(x >> 1) & 1]);
          v[x] = ds * a.scale;
        }
        pack_a(da[u], v);
      }
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < W; ++u)
        wgmma_rs64(dq, da[u],
                   sw128_desc(ks + (J0 + u) * 16 * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dq);
      fence_regs(da);
    });

    // the statistics of rows row0, row0 + 8 (rows past N: m = +inf)
    if (t == 0) {
      float* sp = a.stats + bh * kStats * a.rows;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 8 * r;
        const bool ok = i < n;
        sp[i] = ok ? m[r] : INFINITY;
        sp[a.rows + i] = ok ? inv[r] : 0.f;
        sp[2 * a.rows + i] = ok ? dvec[r] : 0.f;
      }
    }
    // dq through the Q tile's slot (read by S long ago) and one TMA store
    // (rows past N are not written)
    warpgroup_sync(1 + c);
    store_tile(qs, dq, wq, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(1 + c);
    if (tid == 0) {
      tma_store(&tm_dq, qs, a.dq_col + w.h * kHeadDim, tile * kTileRows,
                w.b);
      release_after_stores(empty);
    }
  }
  if (tid == 0) tma_store_wait();
}

// ---- pass B: per key tile, dk and dv --------------------------------------

// One query chunk of W 16-row units at query row q0: S^T and dP^T (+ the
// mask from `mask_j`, this thread's first key row of the staged columns,
// MASK), p^T from the statistics, dV += y^T . G_c and dK += ds^T . Q_c.
template <int W, bool DROP, bool MASK, bool READOUT>
__device__ __forceinline__ void key_chunk(float (&dk)[32], float (&dv)[32],
                                          const Args& a, uint32_t kt,
                                          uint32_t vt, uint32_t qs,
                                          uint32_t gs, const float* stats,
                                          int q0, int j0, int t,
                                          long long bh, unsigned dbase,
                                          unsigned dseed,
                                          const float* mask_j) {
  const int n = a.n;
  float sT[8 * W], dpT[8 * W];
  wgmma_fence();
  product_nt<W>(sT, kt, qs + q0 * kRowBytes);
  product_nt<W>(dpT, vt, gs + q0 * kRowBytes);
  wgmma_commit();
  wgmma_wait();
  fence_regs(sT);
  fence_regs(dpT);
  uint32_t ya[W][4], sa[W][4];
#pragma unroll
  for (int u = 0; u < W; ++u) {
    float y[8], ds[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int i = q0 + 16 * u + col_of(x, t);  // query
      const int j = j0 + row_of(x);              // key
      float s = __fmul_rn(sT[8 * u + x], a.scale);
      if constexpr (MASK) {
        const float2 mm = *reinterpret_cast<const float2*>(
            mask_j + row_of(x) * mask_stride(a.key_rows) + q0 + 16 * u +
            8 * (x >> 2));
        s = __fadd_rn(s, (x & 1) ? mm.y : mm.x);
      }
      if constexpr (READOUT) {
        if (i < n && j < n) a.score_b[(bh * n + i) * n + j] = s;
      }
      const float p = bscan::prob(s, stats[i], stats[a.rows + i]);
      float yv = p, d = dpT[8 * u + x];
      if constexpr (DROP) {
        const float f = a.drop.factor(dbase, dseed, i, j, n);
        yv = p * f;
        d = d * f;
      }
      y[x] = yv;
      ds[x] = p * (d - stats[2 * a.rows + i]) * a.scale;
    }
    pack_a(ya[u], y);
    pack_a(sa[u], ds);
  }
  fence_regs(ya);
  fence_regs(sa);
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const int r = q0 + 16 * u;
    wgmma_rs64(dv, ya[u], sw128_desc(gs + r * kRowBytes, 1024));
    wgmma_rs64(dk, sa[u], sw128_desc(qs + r * kRowBytes, 1024));
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(ya);
  fence_regs(sa);
}

// Shared memory from the 1024-aligned base: stage s at s * stage_b (K tile
// 0, K tile 1, V tile 0, V tile 1, Q_h, G_h, the statistics), then the
// barriers, then (MASK) the consumers' mask columns. A consumer's dk and dv
// go out through its K and V tiles' slots.
template <bool DROP, bool MASK, bool READOUT>
__global__ void __launch_bounds__(kThreads, 1)
    mha_bwd_sm90_pass_b(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_g,
                        const __grid_constant__ CUtensorMap tm_dk,
                        const __grid_constant__ CUtensorMap tm_dv,
                        const Args a) {
  static_assert(!(MASK && DROP), "K3m has no dropout");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const int stage = stage_b(a.key_rows, a.rows);
  const uint32_t bars = base + kStages * stage;
  const int pairs = (a.tiles + kConsumers - 1) / kConsumers;
  const int stats_bytes = kStats * a.rows * 4;
  init_barriers(bars);

  // thread 0 issues the TMA loads of item `item` (its use `it` of the
  // stages) into stage it % 2, once both consumers have released it
  auto load = [&](int item, int it) {
    loader_wait(bars, it);
    const Item w(item, a.heads, pairs);
    const int t0 = kConsumers * w.pair;
    const int tiles = min(kConsumers, a.tiles - t0);
    const uint32_t full = bars + 8 * (it & 1);
    const uint32_t st = base + (it & 1) * stage;
    mbar_expect_tx(full, 2 * tiles * kTileBytes +
                             2u * a.loads * a.box * kRowBytes + stats_bytes);
    for (int q = 0; q < tiles; ++q) {
      const int row = (t0 + q) * kTileRows;
      tma_load(st + q * kTileBytes, &tm_k, full, a.k_col + w.h * kHeadDim,
               row, w.b);
      tma_load(st + (kConsumers + q) * kTileBytes, &tm_v, full,
               a.v_col + w.h * kHeadDim, row, w.b);
    }
    const uint32_t qs = st + 2 * kConsumers * kTileBytes;
    const uint32_t gs = qs + a.key_rows * kRowBytes;
    for (int l = 0; l < a.loads; ++l) {
      tma_load(qs + l * a.box * kRowBytes, &tm_q, full,
               a.q_col + w.h * kHeadDim, l * a.box, w.b);
      tma_load(gs + l * a.box * kRowBytes, &tm_g, full, w.h * kHeadDim,
               l * a.box, w.b);
    }
    const long long bh = (long long)w.b * a.heads + w.h;
    bulk_load(gs + a.key_rows * kRowBytes, a.stats + bh * kStats * a.rows,
              stats_bytes, full);
  };

  // ---- warpgroup c takes key tile 2 * pair + c ----
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int wq = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int full_chunks = a.key_rows / (16 * kChunk);
  const int tail = (a.key_rows / 16) % kChunk;
  // this warpgroup's mask columns (MASK), from this thread's key row 16 wq
  // + g and column 2 t
  float* const mask_s = reinterpret_cast<float*>(
      smem_raw + (bars + kBarrierBytes - raw) + c * mask_bytes(a.key_rows));
  const float* const mask_j =
      mask_s + (16 * wq + g) * mask_stride(a.key_rows) + 2 * t;
  [[maybe_unused]] int staged = -1;  // the tile whose columns are staged
  if (threadIdx.x == 0 && (int)blockIdx.x < a.items) load(blockIdx.x, 0);
  int it = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x, ++it) {
    // the next item's loads run under this item's products
    if (threadIdx.x == 0 && item + (int)gridDim.x < a.items)
      load(item + gridDim.x, it + 1);
    const int s = it & 1;
    const Item w(item, a.heads, pairs);
    const int tile = kConsumers * w.pair + c;
    const uint32_t st = base + s * stage;
    const uint32_t kt = st + c * kTileBytes;
    const uint32_t vt = st + (kConsumers + c) * kTileBytes;
    const uint32_t qs = st + 2 * kConsumers * kTileBytes;
    const uint32_t gs = qs + a.key_rows * kRowBytes;
    const float* stats = reinterpret_cast<const float*>(
        smem_raw + (gs + a.key_rows * kRowBytes - raw));
    const uint32_t empty = bars + 16 + 8 * s;
    // the mask columns of this tile when it changed, copied under the
    // stage's loads (the last item's reads ended at its stores' warpgroup
    // sync)
    [[maybe_unused]] bool restaged = false;
    if constexpr (MASK) {
      if (tile < a.tiles && tile != staged) {
        stage_cols(mask_s, a.mask, a.n, a.key_rows, tile, tid);
        staged = tile;
        restaged = true;
      }
    }
    mbar_wait(bars + 8 * s, (it >> 1) & 1);
    if (tile >= a.tiles) {  // an odd tile count: nothing for this one
      if (tid == 0) mbar_arrive(empty);
      continue;
    }
    const int j0 = tile * kTileRows + 16 * wq + g;  // and j0 + 8
    const long long bh = (long long)w.b * a.heads + w.h;
    unsigned dbase = 0, dseed = 0;
    if constexpr (DROP) a.drop.row(w.b, w.h, a.heads, a.n, &dbase, &dseed);
    if constexpr (MASK) {
      if (restaged) {  // the mask columns copied (all the warpgroup's)
        bscan::cp_async_wait_all();
        warpgroup_sync(1 + c);
      }
    }

    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    for (int q = 0; q < full_chunks; ++q)
      key_chunk<kChunk, DROP, MASK, READOUT>(dk, dv, a, kt, vt, qs, gs,
                                             stats, 16 * kChunk * q, j0, t,
                                             bh, dbase, dseed, mask_j);
    const int q0 = 16 * kChunk * full_chunks;
    if (tail == 1)
      key_chunk<1, DROP, MASK, READOUT>(dk, dv, a, kt, vt, qs, gs, stats,
                                        q0, j0, t, bh, dbase, dseed, mask_j);
    else if (tail == 2)
      key_chunk<2, DROP, MASK, READOUT>(dk, dv, a, kt, vt, qs, gs, stats,
                                        q0, j0, t, bh, dbase, dseed, mask_j);
    else if (tail == 3)
      key_chunk<3, DROP, MASK, READOUT>(dk, dv, a, kt, vt, qs, gs, stats,
                                        q0, j0, t, bh, dbase, dseed, mask_j);

    // dk and dv through the K and V tiles' slots and two TMA stores
    warpgroup_sync(1 + c);
    store_tile(kt, dk, wq, g, t);
    store_tile(vt, dv, wq, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(1 + c);
    if (tid == 0) {
      tma_store(&tm_dk, kt, a.dk_col + w.h * kHeadDim, tile * kTileRows,
                w.b);
      tma_store(&tm_dv, vt, a.dv_col + w.h * kHeadDim, tile * kTileRows,
                w.b);
      release_after_stores(empty);
    }
  }
  if (tid == 0) tma_store_wait();
}

// ---- host: tensor maps and the launches ----------------------------------

using bscan::allow_smem;
using bscan::kMaxDevices;

struct Maps {
  // pass A: Q, G, dq in 64-row boxes, K_h, V_h in `box` rows;
  // pass B: K, V, dk, dv in 64-row boxes, Q_h, G_h in `box` rows
  CUtensorMap q64, g64, dq64, kbox, vbox;
  CUtensorMap k64, v64, dk64, dv64, qbox, gbox;
};

template <int KT, bool DROP, bool MASK, bool READOUT>
cudaError_t launch_a(const Maps& m, const Args& a, int grid,
                     cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  const auto kernel = mha_bwd_sm90_pass_a<KT, DROP, MASK, READOUT>;
  const long long smem = smem_a(16 * KT, MASK);
  cudaError_t err = allow_smem(ready, (const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(m.q64, m.kbox, m.vbox, m.g64,
                                           m.dq64, a);
  return cudaGetLastError();
}

template <bool DROP, bool MASK, bool READOUT>
cudaError_t launch_b(const Maps& m, const Args& a, long long smem, int grid,
                     cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  const auto kernel = mha_bwd_sm90_pass_b<DROP, MASK, READOUT>;
  // the most any N takes
  const Plan most = make_plan(1, MASK ? kMaxMaskN : kMaxN, 1, MASK);
  cudaError_t err = allow_smem(ready, (const void*)kernel, most.smem_b);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(m.k64, m.v64, m.qbox, m.gbox,
                                           m.dk64, m.dv64, a);
  return cudaGetLastError();
}

// Pass A by its 16-row key units: K3 (without a mask) at 3-17, K3m (with
// it, without dropout) at 1-9.
template <bool DROP, bool MASK>
cudaError_t dispatch_a(int kt, const Maps& m, const Args& a, int grid,
                       cudaStream_t stream) {
  if constexpr (MASK) {
    switch (kt) {
#define BSCAN_MASK_KT(KT) \
  case KT:                \
    return launch_a<KT, false, true, false>(m, a, grid, stream);
      BSCAN_MASK_KT(1) BSCAN_MASK_KT(2) BSCAN_MASK_KT(3) BSCAN_MASK_KT(4)
      BSCAN_MASK_KT(5) BSCAN_MASK_KT(6) BSCAN_MASK_KT(7) BSCAN_MASK_KT(8)
      BSCAN_MASK_KT(9)
#undef BSCAN_MASK_KT
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    switch (kt) {
#define BSCAN_KT(KT) \
  case KT:           \
    return launch_a<KT, DROP, false, false>(m, a, grid, stream);
      BSCAN_KT(3) BSCAN_KT(4) BSCAN_KT(5) BSCAN_KT(6) BSCAN_KT(7) BSCAN_KT(8)
      BSCAN_KT(9) BSCAN_KT(10) BSCAN_KT(11) BSCAN_KT(12) BSCAN_KT(13)
      BSCAN_KT(14) BSCAN_KT(15) BSCAN_KT(16) BSCAN_KT(17)
#undef BSCAN_KT
      default:
        return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

extern "C" {

// K3 (K3m with `mask`) on the Hopper body. packed = 1: q = k = v point at
// qkv (B, N, 3 D) and dq = dk = dv at dqkv (B, N, 3 D); packed = 0: each
// (B, N, D). g is (B, N, D); every tensor bf16, contiguous and 16-byte
// aligned. mask: nullptr or the (N, N) fp32 score mask (K3m: 1 <= N <= 144,
// no dropout). stats: (B, heads, 3, rows) fp32 scratch. Dropout as
// bscan_mha_bwd (row_seeds a (B,) device pointer or nullptr for the scalar
// seed). score_a, score_b: both nullptr, or (B, heads, N, N) fp32 that
// receive pass A's and pass B's scaled (and masked) scores (without
// dropout; 208 key rows without a mask, 80 or 32 with one). The plan's
// fields (`plan_bwd`) must equal what this library computes for (b, n,
// heads, a mask or not), and grid_a, grid_b lie in [1, items]; otherwise,
// and outside head dim 64 and 33 <= N <= 272 (1 <= N <= 144 with a mask),
// it returns cudaErrorInvalidValue and launches nothing. Returns the
// cudaError_t of the launches (0 on success).
int bscan_mha_bwd_sm90(const void* q, const void* k, const void* v,
                       const void* g, const void* mask, void* dq, void* dk,
                       void* dv, void* stats, int b, int n, int heads,
                       int head_dim, int packed, float scale, int key_rows,
                       int box, int loads, int tiles, int rows, int items,
                       int grid_a, int grid_b, long long smem_a_bytes,
                       long long smem_b_bytes, const void* row_seeds,
                       unsigned seed, unsigned threshold, float keep_scale,
                       int drop, void* score_a, void* score_b, void* stream) {
  const bool masked = mask != nullptr;
  if (head_dim != kHeadDim || n < (masked ? kMinMaskN : kMinN) ||
      n > (masked ? kMaxMaskN : kMaxN) || b < 1 || heads < 1 ||
      (masked && drop))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(b, n, heads, masked);
  if (key_rows != p.key_rows || box != p.box || loads != p.loads ||
      tiles != p.tiles || rows != p.rows || items != p.items ||
      smem_a_bytes != p.smem_a || smem_b_bytes != p.smem_b || grid_a < 1 ||
      grid_a > p.items || grid_b < 1 || grid_b > p.items)
    return (int)cudaErrorInvalidValue;
  const bool readout = score_a != nullptr || score_b != nullptr;
  if (readout &&
      (!score_a || !score_b || drop ||
       (masked ? p.key_rows != 80 && p.key_rows != 32 : p.key_rows != 208)))
    return (int)cudaErrorInvalidValue;
  const int d = heads * kHeadDim;
  const int cols = packed ? 3 * d : d;
  Maps m;
  if (!encode(&m.q64, q, b, n, cols, kTileRows) ||
      !encode(&m.g64, g, b, n, d, kTileRows) ||
      !encode(&m.dq64, dq, b, n, cols, kTileRows) ||
      !encode(&m.kbox, k, b, n, cols, p.box) ||
      !encode(&m.vbox, v, b, n, cols, p.box) ||
      !encode(&m.k64, k, b, n, cols, kTileRows) ||
      !encode(&m.v64, v, b, n, cols, kTileRows) ||
      !encode(&m.dk64, dk, b, n, cols, kTileRows) ||
      !encode(&m.dv64, dv, b, n, cols, kTileRows) ||
      !encode(&m.qbox, q, b, n, cols, p.box) ||
      !encode(&m.gbox, g, b, n, d, p.box))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.n = n;
  a.heads = heads;
  a.key_rows = p.key_rows;
  a.box = p.box;
  a.loads = p.loads;
  a.tiles = p.tiles;
  a.rows = p.rows;
  a.items = p.items;
  a.q_col = a.dq_col = 0;
  a.k_col = a.dk_col = packed ? d : 0;
  a.v_col = a.dv_col = packed ? 2 * d : 0;
  a.scale = scale;
  a.stats = static_cast<float*>(stats);
  a.drop = Dropout{static_cast<const unsigned*>(row_seeds), seed, threshold,
                   keep_scale, drop};
  a.score_a = static_cast<float*>(score_a);
  a.score_b = static_cast<float*>(score_b);
  a.mask = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (readout) {
    if (!masked)
      err = launch_a<13, false, false, true>(m, a, grid_a, s);
    else if (p.key_rows == 80)
      err = launch_a<5, false, true, true>(m, a, grid_a, s);
    else
      err = launch_a<2, false, true, true>(m, a, grid_a, s);
    if (err != cudaSuccess) return (int)err;
    if (masked) return (int)launch_b<false, true, true>(m, a, p.smem_b,
                                                        grid_b, s);
    return (int)launch_b<false, false, true>(m, a, p.smem_b, grid_b, s);
  }
  const int kt = p.key_rows / 16;
  if (masked) {
    err = dispatch_a<false, true>(kt, m, a, grid_a, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_b<false, true, false>(m, a, p.smem_b, grid_b, s);
  }
  err = drop ? dispatch_a<true, false>(kt, m, a, grid_a, s)
             : dispatch_a<false, false>(kt, m, a, grid_a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)(drop ? launch_b<true, false, false>(m, a, p.smem_b, grid_b, s)
                    : launch_b<false, false, false>(m, a, p.smem_b, grid_b,
                                                    s));
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
