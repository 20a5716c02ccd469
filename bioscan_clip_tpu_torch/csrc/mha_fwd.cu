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
// arithmetic 30.5 GFLOP (31 us on bf16 tensor cores), so a tensor-core
// kernel is memory-bound; the dropout hash adds ~10 integer operations per
// probability.
//
// Two bodies, one contract:
//
// bf16 inputs above N = 32: `mha_fwd_mma`, on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 sums; attention_common.cuh). One CTA of up
// to eight warps per (head, batch row): K_h and V_h are staged once into
// shared memory as bf16 by cp.async (rows padded to 16, HD + 8 elements a
// row for conflict-free ldmatrix; rows >= N zero), 2 * pad16(N) * (HD + 8)
// * 2 bytes: 59.9 KB at N = 197, 78.3 KB at ViT-L/14's N = 257, so two or
// three CTAs share an SM. Each warp takes 16-row query tiles (warp, warp +
// W, ...; W = `mma_warps`, at most 8, so only the last round can leave a
// warp idle), holds the tile's q as A fragments in registers and runs two
// sweeps over 16-key tiles:
//   1. s = q . k (mma) and the score epilogue, the row max m and the row sum
//      l of exp(s - m), the sum rescaled when the max grows (`row_stats`);
//      V lands in shared memory behind this sweep;
//   2. the same s again (the same mma on the same operands in the same
//      order: the same bits), p = exp(s - m) / l in fp32 (`prob`: the SFU's
//      exp times 1 / l, a few ulp), [p *= keep(i, j)], p rounded to bf16
//      straight into the A fragment of P . V, and o += P . V (mma, V read
//      by ldmatrix.trans).
// So p is JAX's normalized probability, rounded where JAX rounds it; an
// online softmax that rescales unnormalized exp(s) would round other values.
// The second q . k costs a third of the arithmetic, which the bytes cover.
// The split is one CTA per (head, batch row) rather than per 64-row block:
// K_h and V_h are staged once instead of ceil(N / 64) times, and no CTA is a
// lone 5-row block (197 = 3 * 64 + 5). Keys past N in the last tile score
// -inf (p = 0); query rows past N are computed on zero q and not stored. The
// (i, j) of every accumulator element follows from the fragment layout, so
// the dropout keep mask is the plain version's bit for bit.
//
// fp32 inputs (and bf16 at N <= 32, where the scores are a 20 x 20 tile and
// the tensor-core body's 16-row padding and two-warp CTAs lose):
// `mha_fwd_kernel`, FFMA (never TF32), one CTA per (64-query-row
// block, head, batch row). K_h and V_h of that (batch row, head) are staged
// into shared memory as fp32 (K rows padded to HD+4 floats: 16-byte aligned
// float4 reads without bank conflicts), so the (N, N) scores never leave the
// SM. Each warp owns query rows; a lane holds the query row in registers,
// scores keys j = lane + 32c, the warp reduces max and sum, and the
// probabilities go through a per-warp shared row into P.V, where lane owns
// output dims lane + 32t. ViT-L/14's N = 257 takes 144,016 B: one CTA per
// SM.
//
// In both, the mask is read from device memory where the score is formed
// (one 77 x 77 fp32 mask is 23.7 KB and stays in L1/L2 for the whole grid);
// it takes no shared memory. Whether there is a mask is a template
// parameter: K1, K2 and K2d compile without the mask read.
//
// What still runs here: bf16 at head dim 64 goes to the Hopper body of
// mha_fwd_sm90.cu (TMA and wgmma) by the plans of ops/attention.py: K1 at
// 33 <= N <= 272, K1m at 8 <= N <= 160, K2 and K2d at 1 <= N <= 272. These
// bodies keep fp32, head dims 32 and 128, K1 at N <= 32 or above 272, K1m
// above N = 160 (its mask rows no longer fit beside the Hopper body's
// stages), K2 and K2d above 272, and the shapes where the plans measured
// this file's bodies faster (`attention.SPLIT_MMA_FROM`: K2d at
// BarcodeBERT's N = 133 from B = 256 on mma.sync;
// `attention.SM90_MASK_MIN_N`: K1m below N = 8 on FFMA).

#include "attention_common.cuh"

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;

using bscan::bf16;
using bscan::Dropout;
using bscan::from_f32;
using bscan::pad16;
using bscan::to_f32;
using bscan::warp_max;
using bscan::warp_sum;

constexpr int kMmaMaxWarps = 8;

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

template <int HD, bool HAS_MASK>
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
    mha_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ mask, bf16* __restrict__ o, int n,
                int heads, long long row_stride, long long batch_stride,
                float scale, Dropout drop) {
  constexpr int KC = HD / 16;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int np = pad16(n);
  bf16* ks = reinterpret_cast<bf16*>(fwd_smem);  // np x (HD + 8)
  bf16* vs = ks + np * (HD + 8);                  // np x (HD + 8)
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = (long long)b * batch_stride + (long long)h * HD;
  // K and V in two groups: sweep 1 reads only K, so V lands behind it
  bscan::stage_rows<HD>(ks, k + base, row_stride, n, np);
  bscan::cp_async_commit();
  bscan::stage_rows<HD>(vs, v + base, row_stride, n, np);
  bscan::cp_async_commit();
  bscan::cp_async_wait<1>();
  __syncthreads();

  const float* bias_row = bias ? bias + (long long)b * n : nullptr;
  unsigned drop_base = 0, drop_seed = 0;
  if (drop.on) drop.row(b, h, heads, n, &drop_base, &drop_seed);
  const int d_model = heads * HD;
  for (int r0 = warp * 16; r0 < n; r0 += (blockDim.x >> 5) * 16) {
    unsigned qa[KC][4];
    bscan::load_frags<HD>(qa, q + base, row_stride, r0, n, lane);
    const int i0 = r0 + g;
    float m[2], l[2];
    bscan::row_stats<HD, HAS_MASK>(m, l, qa, ks, np, scale, bias_row, mask,
                                   i0, 2 * t, n, lane);
    if (r0 == warp * 16) {  // every warp has a first tile: V has landed
      bscan::cp_async_wait<0>();
      __syncthreads();
    }
    const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
    float acc[HD / 8][4];
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
    for (int kt = 0; kt < np; kt += 16) {
      float s[2][4];
      bscan::mm_nt<HD>(s, qa, ks, kt, lane);
      bscan::score_tile<HAS_MASK>(s, scale, bias_row, mask, i0, kt + 2 * t,
                                  n);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kt + 2 * t + 8 * nb + (e & 1);
          float p = bscan::prob(s[nb][e], m[e >> 1], inv_l[e >> 1]);
          if (drop.on && j < n)  // p = 0 past N: no hash there
            p *= drop.factor(drop_base, drop_seed, i0 + 8 * (e >> 1), j, n);
          s[nb][e] = p;
        }
      unsigned pa[4];
      bscan::to_a_frag(pa, s);
      bscan::mm_nn<HD>(acc, pa, vs, kt, lane);
    }
    bf16* orow = o + ((long long)b * n + i0) * d_model + h * HD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      if (i0 < n)
        *reinterpret_cast<unsigned*>(orow + 8 * dn) =
            bscan::pack_bf16(acc[dn][0], acc[dn][1]);
      if (i0 + 8 < n)
        *reinterpret_cast<unsigned*>(orow + 8LL * d_model + 8 * dn) =
            bscan::pack_bf16(acc[dn][2], acc[dn][3]);
    }
  }
}

// bf16 at N <= kFfmaMaxN runs the FFMA body: at N = 20 the tensor-core
// body pads the 20 x 20 scores to 32 x 32 on two warps a CTA and was no
// faster (K1m at (64, 20): 0.058-0.064 ms against 0.036-0.041; both bodies'
// times are in PERF.md).
constexpr int kFfmaMaxN = 32;

__host__ __device__ constexpr long long smem_ffma(int n, int hd) {
  return (long long)sizeof(float) *
         ((long long)n * (hd + 4 + hd) + (long long)kWarps * ((n + 3) & ~3));
}

__host__ __device__ constexpr long long smem_mma(int n, int hd) {
  return 2LL * pad16(n) * (hd + 8) * (long long)sizeof(bf16);
}

bool use_mma(int dtype, int n) { return dtype == 1 && n > kFfmaMaxN; }

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* bias, const float* mask, void* o, int b,
                       int n, int heads, long long row_stride,
                       long long batch_stride, float scale,
                       const Dropout& drop, cudaStream_t stream) {
  static bool ready[2][bscan::kMaxDevices] = {};  // without, with a mask
  const long long smem = smem_mma(n, HD);
  const auto kernel =
      mask ? mha_fwd_mma<HD, true> : mha_fwd_mma<HD, false>;
  // the most any N asks for, and the largest carveout, so that several
  // CTAs fit an SM
  cudaError_t err = bscan::allow_smem(
      ready[mask != nullptr], (const void*)kernel, bscan::kCardSmem, true);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, b), 32 * bscan::mma_warps(n, kMmaMaxWarps), smem,
           stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, mask, static_cast<bf16*>(o), n,
      heads, row_stride, batch_stride, scale, drop);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const float* mask, void* o, int b,
                   int n, int heads, long long row_stride,
                   long long batch_stride, float scale, const Dropout& drop,
                   cudaStream_t stream) {
  static bool ready[2][bscan::kMaxDevices] = {};  // without, with a mask
  const size_t smem = (size_t)smem_ffma(n, HD);
  // K1m is its own instantiation, so K1, K2 and K2d carry no mask branch
  const auto kernel = mask ? mha_fwd_kernel<T, HD, true>
                           : mha_fwd_kernel<T, HD, false>;
  cudaError_t err = bscan::allow_smem(
      ready[mask != nullptr], (const void*)kernel, bscan::kCardSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, mask, static_cast<T*>(o), n, heads,
      row_stride, batch_stride, scale, drop);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(int head_dim, const void* q, const void* k,
                         const void* v, const float* bias, const float* mask,
                         void* o, int b, int n, int heads,
                         long long row_stride, long long batch_stride,
                         float scale, const Dropout& drop,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_mma<32>(q, k, v, bias, mask, o, b, n, heads, row_stride,
                            batch_stride, scale, drop, stream);
    case 64:
      return launch_mma<64>(q, k, v, bias, mask, o, b, n, heads, row_stride,
                            batch_stride, scale, drop, stream);
    case 128:
      return launch_mma<128>(q, k, v, bias, mask, o, b, n, heads, row_stride,
                             batch_stride, scale, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
// bf16 runs the tensor-core body (`mha_fwd_mma`) above N = kFfmaMaxN, whose
// q, k, v rows must be 16-byte aligned (the wrapper checks); fp32, and bf16
// at small N, the FFMA body. Returns the
// cudaError_t of the launch (0 on success).
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
  if (use_mma(dtype, n))
    return (int)dispatch_mma(head_dim, q, k, v, bias_f, mask_f, o, b, n,
                             heads, row_stride, batch_stride, scale, dr, s);
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

// Bytes of dynamic shared memory one CTA needs at (n, head_dim, dtype): the
// wrapper checks this against the card's per-block limit before launching.
long long bscan_mha_fwd_smem_bytes(int n, int head_dim, int dtype) {
  return use_mma(dtype, n) ? smem_mma(n, head_dim) : smem_ffma(n, head_dim);
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
