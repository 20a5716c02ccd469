// The attention forward for Hopper: TMA loads behind mbarriers, wgmma
// products, the exact softmax held in registers. One body serves K1 (ViT's
// packed qkv), K1m (the same with an (N, N) score mask: OpenCLIP's causal
// text tower), K2 and K2d (the BERT towers' split q, k, v, with a key bias
// and in-kernel dropout).
//
// Replaces (TPU Pallas kernels in bioscan_clip_tpu/ops/attention.py), on
// bf16 input at head dim 64:
//   K1  `_pallas_mha_packed` without a mask (:425; `_packed_kernel` :153),
//       33 <= N <= 272: ViT-B/16's N = 197 and ViT-L/14's N = 257;
//   K1m `_pallas_mha_packed` with an (N, N) mask (`_packed_mask_kernel`
//       :162), 1 <= N <= 160 (the plan from N = 8: below, the FFMA body of
//       mha_fwd.cu measured faster): OpenCLIP's text at N = 77 and the
//       WordPiece N = 20 of its service and training;
//   K2  `_pallas_mha_split` (:449; `_split_kernel`, `_split_bias_kernel`),
//       1 <= N <= 272: BarcodeBERT's N = 133, BERT-small's N = 20;
//   K2d the same with counter-hash dropout (`_split_drop_kernel` :195,
//       `_split_bias_drop_kernel` :203, `_row_drop` :184).
// All share the body `_attend_one_row` (:116-150). Every other case
// (another head dim, N outside these ranges, fp32) stays on the bodies of
// mha_fwd.cu. The body takes base pointers and a row stride: packed is (p,
// p + D, p + 2 D; stride 3 D), split (q, k, v; stride D).
//
// Contract (`_attend_one_row` with `bias_row` (the key bias or `m_ref`,
// the mask) and `drop`): per head, s = (q . k) * scale in fp32, then +
// bias[b, j] (the (B, N) key bias: 0 / -1e9 padding) or + mask[i, j] (the
// (N, N) score mask, shared across the batch) in fp32; keys past N score
// -inf; p = exp(s - max) / sum in fp32 (the SFU's exp times 1 / l, as
// `bscan::prob`); with dropout p times keep_scale or 0 in fp32
// (`bscan::Dropout::factor`: the counter over the real N, row-keyed seeds
// with b = 0 or one scalar seed with the batch index); p rounded to bf16;
// o = p . v summed in fp32 and written in bf16.
//
// What bounds it on an H100: at ViT-B B=256 N=197 D=768 h=12 the bytes are
// q, k, v read once and o written once, 4 * 256 * 197 * 768 * 2 = 310 MB:
// 0.0925 ms at 3.35 TB/s; the products, 4 * B * h * N^2 * 64 = 30.5 GFLOP,
// take 0.031 ms at 989 TFLOP/s. BarcodeBERT at B=400 N=133 moves 327 MB
// (0.0976 ms) for 21.7 GFLOP; K1m at B=64 N=77 30.3 MB (0.0090 ms) for 1.2
// GFLOP. So the bound is bytes, and the kernel's job is to keep the loads
// streaming while the products, the softmax and the dropout hash run.
//
// Why the scores stay in registers. JAX rounds the normalised fp32 p (times
// the keep factor) to bf16 before P . V. An online softmax rescales
// unnormalised exp(s), so it rounds other values; the `mma.sync` body of
// mha_fwd.cu keeps JAX's rounding by forming every score twice (one sweep
// for max and sum, one for p). Here one consumer warpgroup owns 64 query
// rows and holds their whole score rows in its accumulators (pad16(N) / 2
// fp32 a thread: 72 at N = 133, 104 at N = 197, 136 at N = 257), so each
// score is one product: max and sum over the quad, p = e * (1 / l) (times
// the keep factor, hashed there) rounded to bf16 and packed straight into
// the register A fragments of O += P . V (wgmma m64n64k16, A from
// registers, B = V_h transposed from shared memory).
//
// Design. A persistent grid (one CTA per SM, the plan's grid) walks work
// items (batch row, head, pair of 64-row query tiles), pair fastest, so the
// items that share K_h and V_h run side by side and the second reads them
// from L2. A CTA is three warpgroups:
// - warpgroup 0, the producer (40 registers after `setmaxnreg`): one
//   thread issues the TMA loads of an item into one of two stages: the
//   two Q tiles, K_h and V_h (pad16(N) rows, one box up to 256 rows, two
//   boxes of pad16(N) / 2 above; rows past N arrive as zeros), all on the
//   stage's `full` barrier. It loads item i + 1 while the consumers work
//   on item i and waits on the stage's `empty` barrier before reusing it;
// - warpgroups 1 and 2, the consumers (232 registers): each takes one Q
//   tile of the item. S = Q . K_h^T is wgmma m64nNk16 with both operands
//   in shared memory (N the padded key count, cut into instructions of
//   256, 128, 64, 32 and 16 keys), keys past N score -inf, and after P . V
//   the warpgroup releases the stage and writes O through its own 8 KB of
//   shared memory with one TMA store (rows past N are not written). The
//   two consumers take turns to issue their products (named barriers 3
//   and 4: S of 0, S of 1, P . V of 0, P . V of 1, ...), so one's softmax
//   and hash run on the ALUs and SFUs while the other's products run on the
//   tensor cores; issued together, both would wait on the tensor cores,
//   then both on the SFUs (0.168 ms against 0.150 at ViT-B B=256 on an
//   H100 at 700 W, tools/sweep_k1_sm90.py).
// - The key bias (K2, K2d): the bias row's N fp32 are not 16-byte aligned
//   rows (N = 133), so no TMA map takes them. Each consumer thread reads
//   its few columns of the row with `__ldg` (from L2: the (B, N) bias is
//   213 KB at B=400) before it waits for the stage, writes them to the
//   warpgroup's own pad16(N) floats of shared memory while its S product
//   runs, and the softmax adds them from there, two columns a load.
// - The score mask (K1m): its rows are N fp32 apart (308 B at N = 77), not
//   16-byte aligned either. A consumer's query tile owns 64 of them, and
//   the warpgroup stages them into its own shared memory, 64 rows of
//   pad16(N) + 8 fp32 (the 8 floats put rows g and g + 2 of a quad's
//   float2 reads in other banks: no conflict), by 4-byte `cp.async` in
//   order (coalesced reads) issued before it waits for the stage, so the
//   copy runs under the TMA loads and its S product; rows and columns past
//   N stage 0. It stages only when its query tile changes: items walk the
//   pair fastest and the grid is even, so at N <= 128 (one pair: consumer
//   c always has tile c) and whenever the grid is a multiple of the pairs,
//   a CTA stages once. The softmax adds the mask where it adds the bias.
//   The mask is general (no causal tile skip).
// - The dropout hash (K2d): the keep bits hang on the indices alone, so
//   each thread hashes its scores' bits (two `mix32` a score, into 32-bit
//   words) while its S product runs, skipping a warp's 16 rows that all
//   lie past N; the softmax then takes p * keep_scale or 0 by the bit. The
//   hash is integer work, ~99.5 M hashes at BarcodeBERT B=400 (two full
//   query tiles and a warp of the third a head), and it bounds K2d there:
//   0.41 ms against 0.18 with every bit set, on an H100 at 700 W
//   (tools/sweep_k2_sm90.py, variant no_hash). Hashing after the softmax,
//   on one consumer while the other does its softmax, in the producer
//   warpgroup, with right shifts as `__umulhi`, or skipping 8-row and
//   8-key halves past N all ran slower.
// `BIAS`, `DROP` and `MASK` are template flags: as uniform runtime
// branches, one for each score, they cut the straight-line code into a
// block per score (K2d at BarcodeBERT B=400 0.51 ms, against 0.41 as
// flags), and K1's instantiations compile without any. The bias and the
// mask share one pointer argument (no launch has both), so K1's kernel
// takes the same arguments as before the mask. The mask is instantiated
// only without a bias or dropout (K1m has neither) and only up to 160
// key rows.
// Why persistent and not several co-resident CTAs: a consumer needs up to
// ~170 registers for its scores and O, so an SM holds two consumer
// warpgroups; two CTAs of one consumer each would load K_h and V_h for
// every 64 query rows, and a CTA that only starts its loads when the
// previous one exits leaves the tensor cores idle during them. One CTA
// with two stages keeps the next item's loads in flight under the current
// item's products.
// Every tile is 64 rows of 128 bytes (head dim 64 in bf16), the width of
// the TMA maps' 128-byte swizzle and of wgmma's shared-memory descriptors.
//
// Budget. Registers: 168 at entry (384 threads, one CTA per SM), 40 for the
// producer and 232 for each consumer after `setmaxnreg` (128 * 40 + 256 *
// 232 = 64,512 of 65,536); the build prints ptxas' count and spills. At
// 256 and 272 key rows (136 score registers a thread) ptxas spills 4
// bytes and serializes the wgmmas, with or without `setmaxnreg`: its
// allocation stays within the 168 of the launch bound. Up to 240 key rows
// nothing spills.
// Shared memory: two stages of (2 Q tiles + K_h + V_h) = 2 * (16 KB + 2 *
// pad16(N) * 128 B), two 8 KB O tiles and the barriers, with 1 KB of slack
// for the 1024-byte alignment of the swizzled tiles: 156,736 B at N = 197,
// 189,504 B at N = 272; with a key bias 2 * pad16(N) * 4 B more:
// 125,120 B at N = 133, 191,680 B at N = 272; with a mask 2 * 64 *
// (pad16(N) + 8) * 4 B more: 136,256 B at N = 77, 87,104 B at N = 20,
// 218,176 B at N = 160, the largest N whose mask tiles fit the 232,448 B
// a block may have (N = 176 would need 234,560 B). (`sm90_fwd_plan` in
// ops/attention.py gives the same numbers; the launch checks them.)

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 2;           // one 128-byte swizzle row
constexpr int kTileRows = 64;                     // wgmma M: one warpgroup
constexpr int kTileBytes = kTileRows * kRowBytes;  // 8 KB
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 2;
constexpr int kMinN = 1;  // the least instantiation: 16 key rows
constexpr int kMaxN = 272;
constexpr int kMaxMaskN = 160;  // K1m's largest N: its mask tiles fit
constexpr int kMaxBox = 256;  // TMA's largest box dimension
constexpr int kAlign = 1024;  // the 128-byte swizzle's atom: 8 rows
constexpr int kBarrierBytes = 64;

// ---- the plan (`sm90_fwd_plan` in ops/attention.py is its twin) -------

struct Plan {
  int key_rows;   // keys padded to 16
  int kv_box;     // rows of one TMA box of K_h / V_h
  int kv_loads;   // boxes per tensor
  int q_tiles;    // 64-row query tiles
  int items;      // (batch row, head, pair of query tiles)
  long long smem;  // dynamic shared memory of a CTA
};

__host__ __device__ constexpr int stage_bytes(int key_rows) {
  return kConsumers * kTileBytes + 2 * key_rows * kRowBytes;
}

// a consumer's staged bias row: pad16(N) fp32
__host__ __device__ constexpr int bias_bytes(int key_rows) {
  return key_rows * 4;
}

// a consumer's staged mask rows: 64 rows of pad16(N) + 8 fp32 (the 8
// floats of padding: rows g and g + 2 of a quad's float2 reads fall in other
// banks)
__host__ __device__ constexpr int mask_stride(int key_rows) {
  return key_rows + 8;
}

__host__ __device__ constexpr int mask_bytes(int key_rows) {
  return kTileRows * mask_stride(key_rows) * 4;
}

constexpr long long smem_bytes(int key_rows, bool biased, bool masked) {
  return kAlign + (long long)kStages * stage_bytes(key_rows) +
         kConsumers * kTileBytes + kBarrierBytes +
         (biased   ? kConsumers * bias_bytes(key_rows)
          : masked ? kConsumers * mask_bytes(key_rows)
                   : 0);
}

Plan make_plan(int b, int n, int heads, bool biased, bool masked) {
  Plan p;
  p.key_rows = bscan::pad16(n);
  p.kv_loads = p.key_rows > kMaxBox ? 2 : 1;
  p.kv_box = p.key_rows / p.kv_loads;
  p.q_tiles = (n + kTileRows - 1) / kTileRows;
  p.items = b * heads * ((p.q_tiles + kConsumers - 1) / kConsumers);
  p.smem = smem_bytes(p.key_rows, biased, masked);
  return p;
}

// ---- turns and pieces (the PTX wrappers are sm90_common.cuh's) --------

using bscan::Dropout;
using bscan::smem_addr;
using namespace bscan::sm90;

// The consumers take turns on the tensor cores: named barrier 3 + c is
// consumer c's turn. It completes when c's 128 threads wait on it and the
// other consumer's 128 have passed the turn to c.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
}

__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
}

// The largest piece (in 16-key chunks) of a score row of `rest` chunks that
// one wgmma takes: 16 (256 keys), 8, 4, 2 or 1.
__host__ __device__ constexpr int piece(int rest) {
  return rest >= 16 ? 16 : rest >= 8 ? 8 : rest >= 4 ? 4 : rest >= 2 ? 2 : 1;
}

// Call f(J0, C) for the pieces [J0, J0 + C) that cover chunks [J, KT).
template <int KT, int J, typename F>
__device__ __forceinline__ void for_pieces(F&& f) {
  if constexpr (J < KT) {
    constexpr int C = piece(KT - J);
    f(std::integral_constant<int, J>{}, std::integral_constant<int, C>{});
    for_pieces<KT, J + C>(f);
  }
}

// The keep bits of a consumer thread's 8 * KT scores (query rows `row` and
// row + 8 of the tile, keys of its quad column t): score x of chunk j (key
// 16 j + 8 (x / 4) + 2 t + x % 2, row + 8 when x / 2 is odd) is bit
// (8 j + x) % 32 of word (8 j + x) / 32, set (in `keep`, zero on entry)
// when mix32(seed ^ mix32((base + i) * n + k)) >= threshold
// (`Dropout::factor`).
template <int KT>
__device__ __forceinline__ void keep_bits(uint32_t (&keep)[(KT + 3) / 4],
                                          int row, int t, int n,
                                          unsigned base, unsigned seed,
                                          unsigned threshold) {
  const unsigned ctr0 = (base + (unsigned)row) * (unsigned)n + 2u * t;
  const unsigned ctr1 = ctr0 + 8u * (unsigned)n;
#pragma unroll
  for (int e = 0; e < 8 * KT; ++e) {
    const int x = e & 7;
    const unsigned ctr = ((x & 2) ? ctr1 : ctr0) +
                         (unsigned)(16 * (e >> 3) + 8 * (x >> 2) + (x & 1));
    if (bscan::mix32(seed ^ bscan::mix32(ctr)) >= threshold)
      keep[e >> 5] |= 1u << (e & 31);
  }
}

// 4 bytes from global to shared memory, asynchronously; `valid` false
// writes 4 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The (N, N) score mask's rows of query tile `tile` into a consumer's
// shared memory (`dst`: 64 rows of mask_stride(16 KT) fp32) by 4-byte
// cp.async, the warpgroup's 128 threads in order (coalesced reads), one
// committed group; rows and columns past N stage 0 (their scores are -inf
// or not stored). The caller waits for the group (`cp_async_wait_all`)
// and syncs the warpgroup before the rows are read.
template <int KT>
__device__ __forceinline__ void stage_mask(float* dst,
                                           const float* __restrict__ mask,
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

// Shared memory, from the 1024-aligned base: stage s at s * stage_bytes
// (Q tile 0, Q tile 1, K_h, V_h), then the consumers' O tiles, then the
// barriers full[2] and empty[2], then (with a bias) the consumers' bias
// rows or (with a mask) their mask rows. `add` is the (B, N) key bias
// (BIAS) or the (N, N) score mask (MASK).
template <int KT, bool BIAS, bool DROP, bool MASK>
__global__ void __launch_bounds__(kThreads, 1)
    mha_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, int n, int heads,
                 int q_tiles, int items, int kv_box, int kv_loads,
                 float scale, const float* __restrict__ add, Dropout drop) {
  static_assert(!(MASK && (BIAS || DROP)), "K1m has no bias or dropout");
  constexpr int kKeyRows = 16 * KT;
  constexpr int kStage = stage_bytes(kKeyRows);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t o_tiles = base + kStages * kStage;
  const uint32_t bars = o_tiles + kConsumers * kTileBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 16 + 8 s
  const int pairs = (q_tiles + kConsumers - 1) / kConsumers;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 16 + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const uint32_t kv_bytes = 2u * kv_loads * kv_box * kRowBytes;
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int s = it & 1;
        if (it >= kStages) mbar_wait(bars + 16 + 8 * s, ((it >> 1) + 1) & 1);
        const Item w(item, heads, pairs);
        const int t0 = kConsumers * w.pair;
        const int tiles = min(kConsumers, q_tiles - t0);
        const uint32_t full = bars + 8 * s;
        const uint32_t st = base + s * kStage;
        mbar_expect_tx(full, tiles * kTileBytes + kv_bytes);
        for (int q = 0; q < tiles; ++q)
          tma_load(st + q * kTileBytes, &tm_q, full, w.h * kHeadDim,
                   (t0 + q) * kTileRows, w.b);
        const uint32_t ks = st + kConsumers * kTileBytes;
        const uint32_t vs = ks + kKeyRows * kRowBytes;
        for (int l = 0; l < kv_loads; ++l) {
          tma_load(ks + l * kv_box * kRowBytes, &tm_k, full, w.h * kHeadDim,
                   l * kv_box, w.b);
          tma_load(vs + l * kv_box * kRowBytes, &tm_v, full, w.h * kHeadDim,
                   l * kv_box, w.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c = wg - 1 takes Q tile 2 * pair + c ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t o_tile = o_tiles + c * kTileBytes;
    // this warpgroup's bias row (pad16(N) fp32) or mask rows, when there is
    // one
    float* const bias_s = reinterpret_cast<float*>(
        smem_raw + (bars + kBarrierBytes - raw) + c * bias_bytes(kKeyRows));
    float* const mask_s = reinterpret_cast<float*>(
        smem_raw + (bars + kBarrierBytes - raw) + c * mask_bytes(kKeyRows));
    constexpr int kBiasCols = (kKeyRows + 127) / 128;  // staged a thread
    constexpr int kMaskStride = mask_stride(kKeyRows);
    // this thread's mask rows: g and g + 8 of its warp's 16, from column 2 t
    [[maybe_unused]] const float* const mask_g =
        mask_s + (16 * warp + g) * kMaskStride + 2 * t;
    [[maybe_unused]] int staged = -1;  // the tile whose mask rows are staged
    bool stored = false;  // this warpgroup has a TMA store in flight
    // Turns, in order: S of consumer 0, S of 1, P . V of 0, P . V of 1, the
    // next item's S of 0, ...: while one consumer's products run, the other
    // runs its softmax. Consumer 1 passes the first turn to 0, and does not
    // pass its last one (no arrival is left on a barrier at exit).
    if (c == 1) turn_pass(c);
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int s = it & 1;
      const Item w(item, heads, pairs);
      const int tile = kConsumers * w.pair + c;
      const bool last = item + (int)gridDim.x >= items;
      const uint32_t st = base + s * kStage;
      const uint32_t qs = st + c * kTileBytes;
      const uint32_t ks = st + kConsumers * kTileBytes;
      const uint32_t vs = ks + kKeyRows * kRowBytes;
      // the bias columns and the dropout seed, read before the wait
      float bv[kBiasCols];
      unsigned dbase = 0, dseed = 0;
      if constexpr (DROP) drop.row(w.b, w.h, heads, n, &dbase, &dseed);
      // the mask rows of this tile, when the tile changed, copied while the
      // stage's loads and the S product run (the last item's reads ended
      // at its O store's warpgroup barriers)
      [[maybe_unused]] bool restaged = false;
      if constexpr (MASK) {
        if (tile < q_tiles && tile != staged) {
          stage_mask<KT>(mask_s, add, n, tile, tid);
          staged = tile;
          restaged = true;
        }
      }
      if constexpr (BIAS) {
        if (tile < q_tiles) {
          const float* row = add + (long long)w.b * n;
#pragma unroll
          for (int r = 0; r < kBiasCols; ++r) {
            const int col = tid + 128 * r;
            bv[r] = col < n ? __ldg(row + col) : 0.f;
          }
        }
      }
      mbar_wait(bars + 8 * s, (it >> 1) & 1);
      if (tile >= q_tiles) {  // an odd tile count: nothing for this one
        turn_wait(c);
        turn_pass(c);
        turn_wait(c);
        if (!(c == 1 && last)) turn_pass(c);
        mbar_arrive(bars + 16 + 8 * s);
        continue;
      }

      // S = Q . K_h^T: 64 x kKeyRows fp32, 16-key chunk j in s[8j..8j+7]
      float sc[KT * 8];
      const uint64_t dq = sw128_desc(qs, 16);
      const uint64_t dk = sw128_desc(ks, 16);
      turn_wait(c);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk)
        for_pieces<KT, 0>([&](auto j0, auto cn) {
          constexpr int J0 = decltype(j0)::value, C = decltype(cn)::value;
          WgmmaSS<16 * C>::template run<8 * J0>(
              sc, dq + 2 * kk, dk + ((J0 * 16 * kRowBytes) >> 4) + 2 * kk,
              kk > 0);
        });
      wgmma_commit();
      turn_pass(c);
      if constexpr (BIAS) {
        // the bias row into shared memory while S runs (the last item's
        // reads ended at its O store's warpgroup barriers)
#pragma unroll
        for (int r = 0; r < kBiasCols; ++r) {
          const int col = tid + 128 * r;
          if (col < kKeyRows) bias_s[col] = bv[r];
        }
        warpgroup_sync(1 + c);
      }
      if constexpr (MASK) {
        if (restaged) {  // the mask rows copied (all the warpgroup's)
          bscan::cp_async_wait_all();
          warpgroup_sync(1 + c);
        }
      }
      // The keep bits hang on the indices alone: hashed while S runs. A
      // warp whose 16 rows all lie past N hashes nothing (its rows are not
      // stored).
      uint32_t keep[(KT + 3) / 4] = {};
      const int row0 = tile * kTileRows + 16 * warp;
      if constexpr (DROP) {
        if (row0 < n)
          keep_bits<KT>(keep, row0 + g, t, n, dbase, dseed, drop.threshold);
      }
      wgmma_wait();
      fence_regs(sc);

      // the softmax of rows g (e < 2) and g + 8 (e >= 2) of warp's 16:
      // element x = 4 nb + e of chunk j is key 16 j + 8 nb + 2 t + (e & 1)
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          float v = __fmul_rn(sc[8 * j + x], scale);
          if constexpr (BIAS) {
            const float2 bb = *reinterpret_cast<const float2*>(
                bias_s + 16 * j + 8 * (x >> 2) + 2 * t);
            v = __fadd_rn(v, (x & 1) ? bb.y : bb.x);
          }
          if constexpr (MASK) {
            const float2 mm = *reinterpret_cast<const float2*>(
                mask_g + ((x & 2) ? 8 * kMaskStride : 0) + 16 * j +
                8 * (x >> 2));
            v = __fadd_rn(v, (x & 1) ? mm.y : mm.x);
          }
          if (j == KT - 1 && 16 * j + 8 * (x >> 2) + 2 * t + (x & 1) >= n)
            v = -INFINITY;
          sc[8 * j + x] = v;
          if (x & 2)
            m1 = fmaxf(m1, v);
          else
            m0 = fmaxf(m0, v);
        }
      m0 = bscan::quad_max(m0);
      m1 = bscan::quad_max(m1);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float e = __expf(sc[8 * j + x] - ((x & 2) ? m1 : m0));
          sc[8 * j + x] = e;
          if (x & 2)
            l1 += e;
          else
            l0 += e;
        }
      const float inv0 = 1.f / bscan::quad_sum(l0);
      const float inv1 = 1.f / bscan::quad_sum(l1);
      // p = e * (1 / l), with dropout times keep_scale or 0 (its keep bit)
      auto prob = [&](int j, int x) {
        const float p = sc[8 * j + x] * ((x & 2) ? inv1 : inv0);
        if constexpr (DROP) {
          const int e = 8 * j + x;
          return (keep[e >> 5] >> (e & 31)) & 1u ? p * drop.keep_scale : 0.f;
        }
        return p;
      };
      // p rounded to bf16, packed as the A fragments of P . V, all of them
      // before the products (the scores' registers are free by then)
      uint32_t pa[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        pa[j][0] = bscan::pack_bf16(prob(j, 0), prob(j, 1));
        pa[j][1] = bscan::pack_bf16(prob(j, 2), prob(j, 3));
        pa[j][2] = bscan::pack_bf16(prob(j, 4), prob(j, 5));
        pa[j][3] = bscan::pack_bf16(prob(j, 6), prob(j, 7));
      }
      fence_regs(pa);

      // O = P . V_h: 64 x 64 fp32, V_h (keys x 64) transposed from shared
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      turn_wait(c);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KT; ++j)
        wgmma_rs64(o, pa[j], sw128_desc(vs + j * 16 * kRowBytes, 1024));
      wgmma_commit();
      if (!(c == 1 && last)) turn_pass(c);
      wgmma_wait();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(bars + 16 + 8 * s);  // Q, K_h, V_h of this stage read

      // O through shared memory (the 128-byte swizzle of the output map)
      // and one TMA store
      if (tid == 0 && stored) tma_store_read_wait();
      warpgroup_sync(1 + c);
      store_tile(o_tile, o, warp, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(1 + c);
      if (tid == 0) {
        tma_store(&tm_o, o_tile, w.h * kHeadDim, tile * kTileRows, w.b);
        stored = true;
      }
    }
    if (tid == 0 && stored) tma_store_wait();
  }
}

// ---- host: tensor maps and the launch ----------------------------------

struct Maps {
  CUtensorMap q, k, v, o;
};

template <int KT, bool BIAS, bool DROP, bool MASK>
cudaError_t launch(const Maps& m, const Plan& p, int n, int heads, int grid,
                   float scale, const float* add, const Dropout& drop,
                   cudaStream_t stream) {
  if constexpr (MASK && 16 * KT > bscan::pad16(kMaxMaskN)) {
    return cudaErrorInvalidValue;  // no mask instantiation past kMaxMaskN
  } else {
    static bool ready[bscan::kMaxDevices] = {};
    const auto kernel = mha_fwd_sm90<KT, BIAS, DROP, MASK>;
    cudaError_t err = bscan::allow_smem(ready, (const void*)kernel,
                                        smem_bytes(16 * KT, BIAS, MASK));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, p.smem, stream>>>(
        m.q, m.k, m.v, m.o, n, heads, p.q_tiles, p.items, p.kv_box,
        p.kv_loads, scale, add, drop);
    return cudaGetLastError();
  }
}

template <bool BIAS, bool DROP, bool MASK>
cudaError_t dispatch(const Maps& m, const Plan& p, int n, int heads,
                     int grid, float scale, const float* add,
                     const Dropout& drop, cudaStream_t s) {
  switch (p.key_rows / 16) {
#define BSCAN_KT(KT)                                                    \
  case KT:                                                              \
    return launch<KT, BIAS, DROP, MASK>(m, p, n, heads, grid, scale, add, \
                                        drop, s);
    BSCAN_KT(1) BSCAN_KT(2) BSCAN_KT(3) BSCAN_KT(4) BSCAN_KT(5) BSCAN_KT(6)
    BSCAN_KT(7) BSCAN_KT(8) BSCAN_KT(9) BSCAN_KT(10) BSCAN_KT(11)
    BSCAN_KT(12) BSCAN_KT(13) BSCAN_KT(14) BSCAN_KT(15) BSCAN_KT(16)
    BSCAN_KT(17)
#undef BSCAN_KT
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The attention forward on the Hopper body: q, k, v bf16 (B, N, heads * 64)
// views with row stride `row_stride` elements (3 D for a packed qkv: k = q
// + D, v = q + 2 D; D for split tensors), each 16-byte aligned -> out (B,
// N, heads * 64) bf16. bias: nullptr or (B, N) fp32. mask: nullptr or the
// (N, N) fp32 score mask (K1m: N <= 160, no bias, no dropout). Dropout
// (drop != 0): row_seeds (B,) uint32 on the card or nullptr for the scalar
// `seed`, keep when the hash >= threshold, kept p times keep_scale. The
// plan's fields (`sm90_fwd_plan`) must equal what this library computes
// for (b, n, heads, a bias or not, a mask or not), and grid lie in [1,
// items]; otherwise, and outside head dim 64 and 1 <= N <= 272, it returns
// cudaErrorInvalidValue and launches nothing. Returns the cudaError_t of
// the launch (0 on success).
int bscan_mha_fwd_sm90(const void* q, const void* k, const void* v,
                       void* out, long long row_stride, const void* bias,
                       const void* mask, const void* row_seeds,
                       unsigned seed, unsigned threshold, float keep_scale,
                       int drop, int b, int n, int heads, int head_dim,
                       float scale, int key_rows, int kv_box, int kv_loads,
                       int q_tiles, int items, int grid, long long smem,
                       void* stream) {
  if (head_dim != kHeadDim || n < kMinN || n > kMaxN ||
      b < 1 || heads < 1 || row_stride < (long long)heads * kHeadDim ||
      row_stride > (1LL << 30) ||
      (mask && (bias || drop || n > kMaxMaskN)))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(b, n, heads, bias != nullptr, mask != nullptr);
  if (key_rows != p.key_rows || kv_box != p.kv_box ||
      kv_loads != p.kv_loads || q_tiles != p.q_tiles || items != p.items ||
      smem != p.smem || grid < 1 || grid > p.items)
    return (int)cudaErrorInvalidValue;
  const int d = heads * kHeadDim;
  const int stride = (int)row_stride;
  Maps m;
  if (!encode(&m.q, q, b, n, d, kTileRows, stride) ||
      !encode(&m.k, k, b, n, d, p.kv_box, stride) ||
      !encode(&m.v, v, b, n, d, p.kv_box, stride) ||
      !encode(&m.o, out, b, n, d, kTileRows))
    return (int)cudaErrorInvalidValue;
  Dropout dr{static_cast<const unsigned*>(row_seeds), seed, threshold,
             keep_scale, drop};
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_f)
    return (int)dispatch<false, false, true>(m, p, n, heads, grid, scale,
                                             mask_f, dr, s);
  if (bias_f && drop)
    return (int)dispatch<true, true, false>(m, p, n, heads, grid, scale,
                                            bias_f, dr, s);
  if (bias_f)
    return (int)dispatch<true, false, false>(m, p, n, heads, grid, scale,
                                             bias_f, dr, s);
  if (drop)
    return (int)dispatch<false, true, false>(m, p, n, heads, grid, scale,
                                             nullptr, dr, s);
  return (int)dispatch<false, false, false>(m, p, n, heads, grid, scale,
                                            nullptr, dr, s);
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
