// K1, ViT's packed attention forward, for Hopper: TMA loads behind
// mbarriers, wgmma products, the exact softmax held in registers.
//
// Replaces (TPU Pallas kernel in bioscan_clip_tpu/ops/attention.py):
//   K1 `_pallas_mha_packed` without a mask (:425; `_packed_kernel` :153,
//   body `_attend_one_row` :116-150), on bf16 input at head dim 64 and
//   33 <= N <= 272: ViT-B/16's N = 197 and ViT-L/14's N = 257. Every other
//   case of `mha_packed` (another head dim, N <= 32 or N > 272, fp32, the
//   (N, N) mask of K1m) stays on the bodies of mha_fwd.cu.
//
// Contract (`_attend_one_row`): per head, s = (q . k) * scale in fp32,
// p = exp(s - max) / sum in fp32 (the SFU's exp times 1 / l, as
// `bscan::prob`), p rounded to bf16, o = p . v summed in fp32 and written
// in bf16.
//
// What bounds it on an H100: at ViT-B B=256 N=197 D=768 h=12 the bytes are
// q, k, v read once and o written once, 4 * 256 * 197 * 768 * 2 = 310 MB:
// 0.0925 ms at 3.35 TB/s; the products, 4 * B * h * N^2 * 64 = 30.5 GFLOP,
// take 0.031 ms at 989 TFLOP/s. So the bound is bytes, and the kernel's job
// is to keep the loads streaming while the products and the softmax run.
//
// Why the scores stay in registers. JAX rounds the normalised fp32 p to
// bf16 before P . V. An online softmax rescales unnormalised exp(s), so it
// rounds other values; the `mma.sync` body of mha_fwd.cu keeps JAX's
// rounding by forming every score twice (one sweep for max and sum, one
// for p). Here one consumer warpgroup owns 64 query rows and holds their
// whole score rows in its accumulators (pad16(N) / 2 fp32 a thread: 104 at
// N = 197, 136 at N = 257), so each score is one product: max and sum over
// the quad, p = e * (1 / l) rounded to bf16 and packed straight into the
// register A fragments of O += P . V (wgmma m64n64k16, A from registers,
// B = V_h transposed from shared memory).
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
//   runs on the ALUs and SFUs while the other's products run on the
//   tensor cores; issued together, both would wait on the tensor cores,
//   then both on the SFUs (0.168 ms against 0.150 at ViT-B B=256 on an
//   H100 at 700 W, tools/sweep_k1_sm90.py).
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
// 189,504 B at N = 272 (`plan_packed_fwd` in ops/attention.py gives the
// same number; the launch checks it).

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
constexpr int kMinN = 33;
constexpr int kMaxN = 272;
constexpr int kMaxBox = 256;  // TMA's largest box dimension
constexpr int kAlign = 1024;  // the 128-byte swizzle's atom: 8 rows
constexpr int kBarrierBytes = 64;

// ---- the plan (`plan_packed_fwd` in ops/attention.py is its twin) ------

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

constexpr long long smem_bytes(int key_rows) {
  return kAlign + (long long)kStages * stage_bytes(key_rows) +
         kConsumers * kTileBytes + kBarrierBytes;
}

Plan make_plan(int b, int n, int heads) {
  Plan p;
  p.key_rows = bscan::pad16(n);
  p.kv_loads = p.key_rows > kMaxBox ? 2 : 1;
  p.kv_box = p.key_rows / p.kv_loads;
  p.q_tiles = (n + kTileRows - 1) / kTileRows;
  p.items = b * heads * ((p.q_tiles + kConsumers - 1) / kConsumers);
  p.smem = smem_bytes(p.key_rows);
  return p;
}

// ---- turns and pieces (the PTX wrappers are sm90_common.cuh's) --------

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

// Shared memory, from the 1024-aligned base: stage s at s * stage_bytes
// (Q tile 0, Q tile 1, K_h, V_h), then the consumers' O tiles, then the
// barriers full[2] and empty[2].
template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    mha_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_kv,
                 const __grid_constant__ CUtensorMap tm_o, int n, int heads,
                 int q_tiles, int items, int kv_box, int kv_loads,
                 float scale) {
  constexpr int kKeyRows = 16 * KT;
  constexpr int kStage = stage_bytes(kKeyRows);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t o_tiles = base + kStages * kStage;
  const uint32_t bars = o_tiles + kConsumers * kTileBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 16 + 8 s
  const int pairs = (q_tiles + kConsumers - 1) / kConsumers;
  const int d_model = heads * kHeadDim;

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
          tma_load(ks + l * kv_box * kRowBytes, &tm_kv, full,
                   d_model + w.h * kHeadDim, l * kv_box, w.b);
          tma_load(vs + l * kv_box * kRowBytes, &tm_kv, full,
                   2 * d_model + w.h * kHeadDim, l * kv_box, w.b);
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
      // p rounded to bf16, packed as the A fragments of P . V, all of them
      // before the products (the scores' registers are free by then)
      uint32_t pa[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float* e = sc + 8 * j;
        pa[j][0] = bscan::pack_bf16(e[0] * inv0, e[1] * inv0);
        pa[j][1] = bscan::pack_bf16(e[2] * inv1, e[3] * inv1);
        pa[j][2] = bscan::pack_bf16(e[4] * inv0, e[5] * inv0);
        pa[j][3] = bscan::pack_bf16(e[6] * inv1, e[7] * inv1);
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


template <int KT>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& kv,
                   const CUtensorMap& o, const Plan& p, int n, int heads,
                   int grid, float scale, cudaStream_t stream) {
  // the shared-memory attribute is set once per card for each instantiation
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(mha_fwd_sm90<KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(16 * KT));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  mha_fwd_sm90<KT><<<grid, kThreads, p.smem, stream>>>(
      q, kv, o, n, heads, p.q_tiles, p.items, p.kv_box, p.kv_loads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 on the Hopper body: qkv (B, N, 3 * heads * 64) bf16, 16-byte aligned,
// -> out (B, N, heads * 64) bf16. The plan's fields (`plan_packed_fwd`)
// must equal what this library computes for (b, n, heads), and grid lie in
// [1, items]; otherwise, and outside head dim 64 and 33 <= N <= 272, it
// returns cudaErrorInvalidValue and launches nothing. Returns the
// cudaError_t of the launch (0 on success).
int bscan_mha_fwd_sm90(const void* qkv, void* out, int b, int n, int heads,
                       int head_dim, float scale, int key_rows, int kv_box,
                       int kv_loads, int q_tiles, int items, int grid,
                       long long smem, void* stream) {
  if (head_dim != kHeadDim || n < kMinN || n > kMaxN || b < 1 || heads < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(b, n, heads);
  if (key_rows != p.key_rows || kv_box != p.kv_box ||
      kv_loads != p.kv_loads || q_tiles != p.q_tiles || items != p.items ||
      smem != p.smem || grid < 1 || grid > p.items)
    return (int)cudaErrorInvalidValue;
  const int d = heads * kHeadDim;
  CUtensorMap tq, tkv, to;
  if (!encode(&tq, qkv, b, n, 3 * d, kTileRows) ||
      !encode(&tkv, qkv, b, n, 3 * d, p.kv_box) ||
      !encode(&to, out, b, n, d, kTileRows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.key_rows / 16) {
#define BSCAN_KT(KT) \
  case KT:           \
    return (int)launch<KT>(tq, tkv, to, p, n, heads, grid, scale, s);
    BSCAN_KT(3) BSCAN_KT(4) BSCAN_KT(5) BSCAN_KT(6) BSCAN_KT(7) BSCAN_KT(8)
    BSCAN_KT(9) BSCAN_KT(10) BSCAN_KT(11) BSCAN_KT(12) BSCAN_KT(13)
    BSCAN_KT(14) BSCAN_KT(15) BSCAN_KT(16) BSCAN_KT(17)
#undef BSCAN_KT
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
