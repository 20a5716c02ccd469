// Pieces shared by the attention forward (mha_fwd.cu) and backward
// (mha_bwd.cu): dtype conversions, warp reductions, the dropout counter hash,
// and the bf16 tensor-core pieces of the bf16 bodies (mma.sync, ldmatrix,
// cp.async, the score epilogue); and, for every csrc/*.cu (each includes
// this file), `allow_smem`, which sets a kernel's shared-memory attributes
// once per card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace bscan {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// uint32 avalanche mix (murmur3 finalizer): `_mix32` of the JAX package
// (ops/attention.py:60-67), wrapping mod 2**32 as uint32 does there.
__device__ __forceinline__ unsigned mix32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Attention-probability dropout of one (batch row, head): element (i, j)
// keeps when mix32(seed ^ mix32(((b * heads + h) * n + i) * n + j)) >=
// threshold (`dropout_keep_2d`, attention.py:75-89). Row-keyed seeds use
// their own row's seed and b = 0 (`_row_drop` :184-192).
struct Dropout {
  const unsigned* row_seeds;  // (B,) or nullptr: one scalar seed
  unsigned seed;
  unsigned threshold;
  float keep_scale;  // float32(1) / float32(1 - rate), from the wrapper
  int on;

  // The hash base of (batch row b, head h): counter offset and seed.
  __device__ __forceinline__ void row(int b, int h, int heads, int n,
                                      unsigned* base, unsigned* s) const {
    const unsigned bc = row_seeds ? 0u : (unsigned)b;
    *base = (bc * (unsigned)heads + (unsigned)h) * (unsigned)n;
    *s = row_seeds ? row_seeds[b] : seed;
  }

  // The keep/scale factor of element (i, j) under that base.
  __device__ __forceinline__ float factor(unsigned base, unsigned s, int i,
                                          int j, int n) const {
    const unsigned ctr = (base + (unsigned)i) * (unsigned)n + (unsigned)j;
    return mix32(s ^ mix32(ctr)) >= threshold ? keep_scale : 0.f;
  }
};

// ---- bf16 tensor cores -------------------------------------------------
//
// The product unit is `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`:
// bf16 operands, exact products, fp32 sums. Its fragments (PTX ISA), with
// g = lane / 4 and t = lane % 4, each register two bf16 of adjacent columns,
// the lower column in the low half:
//   A (16 x 16): a[0] = (row g, cols 2t, 2t+1), a[1] = (g + 8, 2t..),
//                a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..);
//   B (16 x 8):  b[0] = (k 2t, 2t+1; n g), b[1] = (k 2t + 8.., n g);
//   C (16 x 8 fp32): c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] =
//                (row g + 8, cols 2t, 2t+1).
// So a C tile of 16 x 16 (two n-blocks) is, rounded to bf16, the A fragment
// of the next product (P into P.V, dS into dS.K) without leaving registers.
// Staged (rows, HD) bf16 tiles are padded to HD + 8 elements a row: 8 rows
// of an ldmatrix then start 16 bytes apart modulo 128, free of bank
// conflicts.

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; `valid` false
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b on the tensor cores (one m16n8k16 product).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ldmatrix row addresses (one per lane) into a tile of row stride S:
// rows16: matrix q = lane / 8 holds rows r + 8 (q % 2), cols c + 8 (q / 2).
//   Plain: the A fragment of rows r..r+15, cols c..c+15. Transposed: the B
//   fragments with k = rows r..r+15 and n = cols c..c+7 (r[0], r[1]) and
//   c+8..c+15 (r[2], r[3]).
// cols16: matrix q holds rows r + 8 (q / 2), cols c + 8 (q % 2).
//   Plain: the B fragments with n = rows r..r+7 (r[0], r[1]) and r+8..r+15
//   (r[2], r[3]), k = cols c..c+15. Transposed: the A fragment of the
//   transpose (m = cols c..c+15, k = rows r..r+15).
template <int S>
__device__ __forceinline__ const bf16* rows16(const bf16* base, int r, int c,
                                              int lane) {
  return base + (r + (lane & 15)) * S + c + ((lane >> 4) << 3);
}

template <int S>
__device__ __forceinline__ const bf16* cols16(const bf16* base, int r, int c,
                                              int lane) {
  return base + (r + ((lane >> 4) << 3) + (lane & 7)) * S + c +
         (((lane >> 3) & 1) << 3);
}

// Warps per CTA of a tensor-core body whose warps take the pad16(n) / 16
// row tiles in turn, at most `max_warps`: the fewest rounds, then the fewest
// warps that finish in them (N = 20: 2 warps, 77: 5, 133: 5, 197: 7, 257:
// 6 of 8), so only the last round can leave a warp idle and small N leaves
// room for more CTAs per SM. Every warp has a first tile.
inline int mma_warps(int n, int max_warps) {
  const int tiles = pad16(n) / 16;
  const int rounds = (tiles + max_warps - 1) / max_warps;
  return (tiles + rounds - 1) / rounds;
}

// Stage rows [0, np) of one head (HD bf16 columns) of a strided tensor into
// shared memory, row stride HD + 8; rows >= n are zero (p = 0 must never
// meet a NaN there). 16-byte pieces: the rows must be 16-byte aligned.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long row, int n, int np) {
  constexpr int V = HD / 8;
  for (int idx = threadIdx.x; idx < np * V; idx += blockDim.x) {
    const int j = idx / V, c = idx - j * V;
    const bool ok = j < n;
    cp_async16(dst + j * (HD + 8) + c * 8,
               src + (ok ? (long long)j * row + c * 8 : 0), ok);
  }
}

// The A fragments (k over the whole head dim, HD / 16 steps) of rows
// r0..r0+15 of one head of a strided bf16 tensor, read straight from global
// memory; rows >= n are zero. The same registers are the B fragments of
// those 16 rows taken as n: (a[c][0], a[c][2]) rows r0..r0+7, (a[c][1],
// a[c][3]) rows r0+8..r0+15.
template <int HD>
__device__ __forceinline__ void load_frags(unsigned (&a)[HD / 16][4],
                                           const bf16* base, long long row,
                                           int r0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const unsigned* p0 =
      r0 + g < n
          ? reinterpret_cast<const unsigned*>(base + (long long)(r0 + g) * row)
          : nullptr;
  const unsigned* p1 = r0 + g + 8 < n
                           ? reinterpret_cast<const unsigned*>(
                                 base + (long long)(r0 + g + 8) * row)
                           : nullptr;
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    a[c][0] = p0 ? __ldg(p0 + 8 * c + t) : 0u;
    a[c][1] = p1 ? __ldg(p1 + 8 * c + t) : 0u;
    a[c][2] = p0 ? __ldg(p0 + 8 * c + 4 + t) : 0u;
    a[c][3] = p1 ? __ldg(p1 + 8 * c + 4 + t) : 0u;
  }
}

// s[nb][.] = A (16 rows, fragments a) times the transpose of rows
// r..r+15 of a staged tile (n-block nb: rows r + 8 nb..): one 16 x 16 tile of
// q . k (or g . v), k over the head dim in increasing order from zero.
template <int HD>
__device__ __forceinline__ void mm_nt(float (&s)[2][4],
                                      const unsigned (&a)[HD / 16][4],
                                      const bf16* tile, int r, int lane) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
  const bf16* p = cols16<HD + 8>(tile, r, 0, lane);
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    unsigned b[4];
    ldsm_x4(b, p + 16 * c);
    mma_bf16(s[0], a[c], b[0], b[1]);
    mma_bf16(s[1], a[c], b[2], b[3]);
  }
}

// acc[dn][.] += A (16 x 16, fragment a) times rows r..r+15 of a staged
// (rows, HD) tile: output columns 8 dn..8 dn+7.
template <int HD>
__device__ __forceinline__ void mm_nn(float (&acc)[HD / 8][4],
                                      const unsigned (&a)[4],
                                      const bf16* tile, int r, int lane) {
  const bf16* p = rows16<HD + 8>(tile, r, 0, lane);
#pragma unroll
  for (int dn = 0; dn < HD / 8; dn += 2) {
    unsigned b[4];
    ldsm_x4_t(b, p + 8 * dn);
    mma_bf16(acc[dn], a, b[0], b[1]);
    mma_bf16(acc[dn + 1], a, b[2], b[3]);
  }
}

// A 16 x 16 C tile (two n-blocks), rounded to bf16, as an A fragment.
__device__ __forceinline__ void to_a_frag(unsigned (&a)[4],
                                          const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// The score epilogue of a 16 x 16 tile in C layout: element (nb, e) is row
// i0 + 8 (e / 2), key j0 + 8 nb + (e % 2), where i0 = tile row + g and j0 =
// tile key + 2t. s = dot * scale [+ bias[j]] [+ mask[i, j]], each step
// rounded on its own (never contracted into an FMA), so every pass that
// forms a score gets the same bits; keys >= n get -inf (p = 0 exactly). The
// mask row of a padding query row (i >= n) is not read.
template <bool HAS_MASK>
__device__ __forceinline__ void score_tile(float (&s)[2][4], float scale,
                                           const float* bias_row,
                                           const float* mask, int i0, int j0,
                                           int n) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 8 * (e >> 1), j = j0 + 8 * nb + (e & 1);
      float x = __fmul_rn(s[nb][e], scale);
      if (j < n) {
        if (bias_row) x = __fadd_rn(x, __ldg(bias_row + j));
        if (HAS_MASK && i < n)
          x = __fadd_rn(x, __ldg(mask + (long long)i * n + j));
      } else {
        x = -INFINITY;
      }
      s[nb][e] = x;
    }
}

// Max / sum over the four lanes of a quad (one C-fragment row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// p = exp(s - m) / l as the tensor-core bodies form it: exp on the SFU
// (`__expf`, ex2.approx of (s - m) log2(e), a few fp32 ulp) times the row's
// reciprocal 1 / l (one rounding more than a division). Both stay far below
// the bf16 rounding of p that follows (2^-9 relative); every pass that forms
// p calls this with the same m and 1 / l, so the passes agree bit for bit.
__device__ __forceinline__ float prob(float s, float m, float inv_l) {
  return __expf(s - m) * inv_l;
}

// Row max m and row sum l of exp(s - m) of the warp's 16 query rows (fragment
// rows g and g + 8) over keys [0, np): one sweep of q . k tiles, the running
// sum rescaled when the running max grows. The max is taken over the quad
// after every tile, so all four lanes keep the same m, which is finite from
// the first tile on (key 0 is always valid).
template <int HD, bool HAS_MASK>
__device__ __forceinline__ void row_stats(float (&m)[2], float (&l)[2],
                                          const unsigned (&qa)[HD / 16][4],
                                          const bf16* ks, int np, float scale,
                                          const float* bias_row,
                                          const float* mask, int i0, int j0,
                                          int n, int lane) {
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int kt = 0; kt < np; kt += 16) {
    float s[2][4];
    mm_nt<HD>(s, qa, ks, kt, lane);
    score_tile<HAS_MASK>(s, scale, bias_row, mask, i0, kt + j0, n);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mt = quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                      fmaxf(s[1][2 * r], s[1][2 * r + 1])));
      const float mn = fmaxf(m[r], mt);
      l[r] = l[r] * __expf(m[r] - mn) + __expf(s[0][2 * r] - mn) +
             __expf(s[0][2 * r + 1] - mn) + __expf(s[1][2 * r] - mn) +
             __expf(s[1][2 * r + 1] - mn);
      m[r] = mn;
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// ---- host: a kernel's shared-memory attributes, once per card ----------

constexpr int kMaxDevices = 64;
constexpr long long kCardSmem = -1;  // `allow_smem`: all a block may have

// Let `kernel` take up to `bytes` of dynamic shared memory and, with
// `max_carveout`, ask for the largest shared-memory carveout, once per card.
// `ready` is that kernel's own flags (a static beside its launch, one set per
// instantiation), so every later launch on the card costs one cudaGetDevice
// and no cudaFuncSetAttribute. `bytes` is the most the instantiation can ask
// for at any shape it takes, so no later launch needs it raised; kCardSmem:
// all that a block may have on this card (227 KB on Hopper; the kernels have
// no static shared memory), for a kernel whose need grows with N up to what
// its wrapper checks against that limit.
inline cudaError_t allow_smem(bool (&ready)[kMaxDevices], const void* kernel,
                              long long bytes, bool max_carveout = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  if (bytes == kCardSmem) {
    int most = 0;
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    bytes = most;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && max_carveout)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  ready[dev] = true;
  return cudaSuccess;
}

}  // namespace bscan
