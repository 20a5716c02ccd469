// Fused multi-head attention forward for the short-sequence towers.
//
// Replaces (TPU Pallas kernels in bioscan_clip_tpu/ops/attention.py):
//   K1 `_pallas_mha_packed` without a mask (`_packed_kernel`, body
//      `_attend_one_row`): ViT's packed (B, N, 3D) qkv.
//   K1m `_pallas_mha_packed` with an (N, N) mask (`_packed_mask_kernel`):
//      K1 plus an fp32 additive score mask shared across the batch
//      (OpenCLIP's causal text mask).
//   K2 `_pallas_mha_split` without dropout (`_split_kernel`,
//      `_split_bias_kernel`): BERT's separate (B, N, D) q/k/v with an
//      optional (B, N) fp32 additive key-padding bias.
//   K2d `_pallas_mha_split` with dropout (`_split_drop_kernel`,
//      `_split_bias_drop_kernel`, `_row_drop`): K2 with counter-hash
//      attention-probability dropout, keyed by one scalar seed (batch index
//      in the counter) or by a (B,) vector of per-row seeds (b = 0).
// One kernel body serves all four: q/k/v are three base pointers that
// share a row stride (3D packed, D split) and a batch stride; the mask is one
// more term of the score; dropout is one step between the softmax and the
// rounding of p.
//
// Contract (`_attend_one_row`, attention.py:116-150): per head,
// s = (q . k) * scale [+ bias[b, j]] [+ mask[i, j]] in fp32, p = exp(s -
// max) / sum in fp32, [p *= keep(i, j) ? keep_scale : 0], p rounded to the
// input dtype, then o = p . v accumulated in fp32 and written in the input
// dtype. A -1e9 mask entry gives exp(-1e9 - max) = 0 exactly. fp32
// inputs use FFMA (never TF32). The dropout threshold and keep_scale come
// from the wrapper, rounded as the JAX package rounds them.
//
// What bounds it on an H100: at the flagship shapes (ViT B=256, N=197,
// D=768, h=12) the bytes are ~0.31 GB (92 us at 3.35 TB/s) and the
// arithmetic 30.5 GFLOP, so with tensor cores the kernel would be
// memory-bound. This first version does the arithmetic in FFMA out of shared
// memory, which makes it bound by FFMA issue and shared-memory loads; the
// dropout hash adds ~10 integer operations per probability.
// Design: one CTA per (64-query-row block, head, batch row). K_h and V_h of
// that (batch row, head) are staged once into shared memory as fp32 (K rows
// padded to HD+4 floats: 16-byte aligned float4 reads without bank
// conflicts), so the (N, N) scores never leave the SM. Each warp owns query
// rows; a lane holds the query row in registers, scores keys j = lane + 32c,
// the warp reduces max and sum, and the rounded probabilities go through a
// per-warp shared row into P.V, where lane owns output dims lane + 32t.
// N that is not a power of two (197, 133, 20) needs no padding: the key loop
// is bounded by N and rows past N are not computed.
// The mask is read from device memory where the score is formed, row i's
// lanes on neighbouring addresses (one 77 x 77 fp32 mask is 23.7 KB and
// stays in L1/L2 for the whole grid); it takes no shared memory, so K1m's
// footprint is K1's and ViT-L/14's N = 257 (144,016 B) still fits. Whether
// there is a mask is a template parameter: K1, K2 and K2d compile without
// the mask read.

#include "attention_common.cuh"

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;

using bscan::Dropout;
using bscan::from_f32;
using bscan::to_f32;
using bscan::warp_max;
using bscan::warp_sum;

template <int HD>
__host__ __device__ constexpr int k_stride() {
  return HD + 4;
}

template <typename T, int HD, bool HAS_MASK>
__global__ void __launch_bounds__(kThreads)
    mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ mask, T* __restrict__ o, int n,
                   int heads, long long row_stride, long long batch_stride,
                   float scale, Dropout drop) {
  static_assert(HD % 32 == 0, "head dim must be a multiple of 32");
  constexpr int KS = k_stride<HD>();
  extern __shared__ __align__(16) float smem[];
  const int n4 = (n + 3) & ~3;
  float* ks = smem;                    // n x KS
  float* vs = ks + (size_t)n * KS;     // n x HD
  float* ps = vs + (size_t)n * HD;     // kWarps x n4

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long base = (long long)b * batch_stride + (long long)h * HD;

  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int j = idx / HD;
    const int d = idx - j * HD;
    const long long g = base + (long long)j * row_stride + d;
    ks[j * KS + d] = to_f32(k[g]);
    vs[j * HD + d] = to_f32(v[g]);
  }
  __syncthreads();

  float* pw = ps + warp * n4;
  const float* bias_row = bias ? bias + (long long)b * n : nullptr;
  unsigned drop_base = 0, drop_seed = 0;
  if (drop.on) drop.row(b, h, heads, n, &drop_base, &drop_seed);
  const int d_model = heads * HD;
  const int row_end = min(n, (int)(blockIdx.x + 1) * kRowsPerBlock);
  for (int i = blockIdx.x * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    float qr[HD];
    const T* qg = q + base + (long long)i * row_stride;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_f32(qg[d]);

    const float* mask_row = HAS_MASK ? mask + (long long)i * n : nullptr;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * KS);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 kk = kr[d4];
        s0 = fmaf(qr[4 * d4 + 0], kk.x, s0);
        s1 = fmaf(qr[4 * d4 + 1], kk.y, s1);
        s2 = fmaf(qr[4 * d4 + 2], kk.z, s2);
        s3 = fmaf(qr[4 * d4 + 3], kk.w, s3);
      }
      float s = ((s0 + s1) + (s2 + s3)) * scale;
      if (bias_row) s += bias_row[j];
      if constexpr (HAS_MASK) s += mask_row[j];
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);

    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) {
      float p = pw[j] / sum;
      if (drop.on) p *= drop.factor(drop_base, drop_seed, i, j, n);
      pw[j] = to_f32(from_f32<T>(p));
    }
    __syncwarp();

    float acc[HD / 32];
#pragma unroll
    for (int t = 0; t < HD / 32; ++t) acc[t] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float p = pw[j];
      const float* vr = vs + j * HD + lane;
#pragma unroll
      for (int t = 0; t < HD / 32; ++t) acc[t] = fmaf(p, vr[32 * t], acc[t]);
    }
    T* og = o + ((long long)b * n + i) * d_model + h * HD + lane;
#pragma unroll
    for (int t = 0; t < HD / 32; ++t) og[32 * t] = from_f32<T>(acc[t]);
    __syncwarp();  // pw is rewritten by this warp's next row
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const float* mask, void* o, int b,
                   int n, int heads, long long row_stride,
                   long long batch_stride, float scale, const Dropout& drop,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)n * (k_stride<HD>() + HD) +
                       (size_t)kWarps * ((n + 3) & ~3));
  // K1m is its own instantiation, so K1, K2 and K2d carry no mask branch
  const auto kernel = mask ? mha_fwd_kernel<T, HD, true>
                           : mha_fwd_kernel<T, HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, mask, static_cast<T*>(o), n, heads,
      row_stride, batch_stride, scale, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int head_dim, const void* q, const void* k,
                        const void* v, const float* bias, const float* mask,
                        void* o, int b, int n, int heads, long long row_stride,
                        long long batch_stride, float scale,
                        const Dropout& drop, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, bias, mask, o, b, n, heads, row_stride,
                           batch_stride, scale, drop, stream);
    case 64:
      return launch<T, 64>(q, k, v, bias, mask, o, b, n, heads, row_stride,
                           batch_stride, scale, drop, stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, mask, o, b, n, heads, row_stride,
                            batch_stride, scale, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bias: nullptr or (B, N) float32.
// mask: nullptr or (N, N) float32, shared across the batch (K1m).
// drop = 0: no dropout (K1/K2). drop = 1 (K2d): row_seeds is nullptr (one
// scalar `seed`, batch index in the counter) or (B,) uint32 per-row seeds.
// Returns the cudaError_t of the launch (0 on success).
int bscan_mha_fwd(const void* q, const void* k, const void* v,
                  const void* bias, const void* mask, void* o, int b, int n,
                  int heads, int head_dim, long long row_stride,
                  long long batch_stride, float scale, int dtype,
                  const void* row_seeds, unsigned seed, unsigned threshold,
                  float keep_scale, int drop, void* stream) {
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{static_cast<const unsigned*>(row_seeds), seed, threshold,
                   keep_scale, drop};
  if (dtype == 0)
    return (int)dispatch_hd<float>(head_dim, q, k, v, bias_f, mask_f, o, b, n,
                                   heads, row_stride, batch_stride, scale, dr,
                                   s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(head_dim, q, k, v, bias_f, mask_f,
                                           o, b, n, heads, row_stride,
                                           batch_stride, scale, dr, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one CTA needs at (n, head_dim): the
// wrapper checks this against the card's per-block limit before launching.
long long bscan_mha_fwd_smem_bytes(int n, int head_dim) {
  return (long long)sizeof(float) *
         ((long long)n * (head_dim + 4 + head_dim) +
          (long long)kWarps * ((n + 3) & ~3));
}

// The card's opt-in per-block shared memory limit (227 KB on Hopper).
long long bscan_max_smem_per_block(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
