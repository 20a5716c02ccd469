// Fused multi-head attention backward for the short-sequence towers.
//
// Replaces (TPU Pallas kernel in bioscan_clip_tpu/ops/attention.py):
//   K3 `_pallas_mha_bwd` (`_bwd_kernel`, body `_attend_bwd_one_row`
//      :212-271): dq/dk/dv (+ dbias) of the K1/K2/K2d forward, for ViT's
//      packed (B, N, 3D) qkv and BERT's split q/k/v with an optional (B, N)
//      fp32 key bias, with and without counter-hash probability dropout.
//   K3m the same with an (N, N) fp32 additive score mask shared across the
//      batch (`has_mask`, :363-367, `mask2d` :237, :295): the backward of
//      K1m, OpenCLIP's causal text attention.
//
// Contract, per (batch row, head): recompute s = q.k * scale [+ bias[b, j]]
// [+ mask[i, j]] and the fp32 softmax p;
// y = p * keep; dv = y^T g with y rounded to the input dtype;
// dp = (g v^T) * keep in fp32; ds = p * (dp - rowsum(dp * p));
// dq = (ds * scale -> input dtype) k; dk = (ds * scale -> input dtype)^T q;
// dbias[b, j] = sum over heads and query rows of ds (fp32). Outputs are in
// the input dtype; in the packed layout dq|dk|dv go straight into the
// (B, N, 3D) dqkv through the same strides K1 reads with.
//
// What bounds it on an H100: at the flagship shapes (ViT B=400, N=197,
// D=768, h=12, bf16) the bytes are ~0.85 GB (0.25 ms at 3.35 TB/s) and the
// five products 119 GFLOP (0.12 ms on bf16 tensor cores), so a tensor-core
// kernel would be memory-bound. This first version does the arithmetic in
// FFMA out of shared memory (7 N^2 hd FMAs per (row, head): it recomputes s
// and g.v^T in both passes), which makes it bound by FFMA issue and
// shared-memory loads.
//
// Design (FlashAttention-2 style; blocks run in no order, so every output
// element has exactly one writer and every sum a fixed order, no atomics):
//   pass A, one CTA per (64-query block, head, batch row): K_h and V_h are
//     staged in shared memory as fp32; each warp takes query rows, computes
//     s, the row max m and sum l, p, dp and D = rowsum(dp * p), writes
//     (m, l, D) to a (B, h, N, 3) fp32 scratch, then ds and dq (lane owns
//     output dims lane + 32t).
//   pass B, one CTA per (64-key block, head, batch row): Q_h, G_h and the
//     row statistics are staged in shared memory; each warp takes key rows
//     j, recomputes p(i, j) = exp(s - m_i) / l_i, dp and ds for all query
//     rows i (lane-strided), then dv_j and dk_j, and the head's partial
//     dbias[b, h, j].
//   pass C (only when dbias is asked for) sums the partials over heads in
//     order.
// Both passes compute s and dp with the same `dot` over the same operand
// pairs in the same order, and add the scale, bias and mask with the same
// explicit roundings, so p and ds are bit-identical between them. A -1e9
// mask entry gives p = exp(-1e9 - m) = 0 exactly, so ds = 0 there.
// The mask is read from device memory where the score is formed: pass A's
// lanes read row i on neighbouring addresses, pass B's lanes column j with a
// stride of N floats (one 77 x 77 mask is 23.7 KB and stays in L1/L2).
// Whether there is a mask is a template parameter, so K3 compiles without
// the mask read.
// The staged rows keep the input dtype (bf16 rows are exact in bf16): at
// N=197, hd=64 a bf16 CTA needs ~72 KB of shared memory, so three share an
// SM (fp32 rows: ~124 KB, one CTA). Rows are padded by 16 bytes: 16-byte
// reads of different rows by different lanes hit distinct banks. N that is
// not a power of two (197, 133, 20) is handled by bounding the loops;
// nothing is padded.

#include "attention_common.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;

using bscan::Dropout;
using bscan::from_f32;
using bscan::to_f32;
using bscan::warp_max;
using bscan::warp_sum;

struct BwdArgs {
  const void* q;  // q, k, v: base pointers sharing in_row / in_batch strides
  const void* k;
  const void* v;
  const void* g;        // (B, N, heads * HD) contiguous
  const float* bias;    // (B, N) or nullptr
  const float* mask;    // (N, N) or nullptr: only read when HAS_MASK
  void* dq;             // dq, dk, dv: out_row / out_batch strides
  void* dk;
  void* dv;
  float* stats;         // (B, heads, N, 3): m, l, D
  float* dbias_part;    // (B, heads, N) or nullptr
  float* dbias;         // (B, N) or nullptr
  int n;
  int heads;
  long long in_row;
  long long in_batch;
  long long out_row;
  long long out_batch;
  float scale;
  Dropout drop;
};

// Elements per staged row of type T: HD plus 16 bytes of padding.
template <typename T, int HD>
__host__ __device__ constexpr int row_pad() {
  return HD + 16 / (int)sizeof(T);
}

// fp32 dot of an fp32 row `a` (padded to HD+4 floats) and a staged row `b`
// of type T, both in shared memory. Element d goes to partial sum d % 4 in
// increasing d, whatever T is: one fixed order.
template <typename T, int HD>
__device__ __forceinline__ float dot(const float* a, const T* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if constexpr (std::is_same<T, float>::value) {
    const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 x = a4[d4];
      const float4 y = b4[d4];
      s0 = fmaf(x.x, y.x, s0);
      s1 = fmaf(x.y, y.y, s1);
      s2 = fmaf(x.z, y.z, s2);
      s3 = fmaf(x.w, y.w, s3);
    }
  } else {
    const uint4* b8 = reinterpret_cast<const uint4*>(b);
#pragma unroll
    for (int d8 = 0; d8 < HD / 8; ++d8) {
      const uint4 raw = b8[d8];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 y0 = __bfloat1622float2(h2[0]);
      const float2 y1 = __bfloat1622float2(h2[1]);
      const float2 y2 = __bfloat1622float2(h2[2]);
      const float2 y3 = __bfloat1622float2(h2[3]);
      const float4 x0 = a4[2 * d8];
      const float4 x1 = a4[2 * d8 + 1];
      s0 = fmaf(x0.x, y0.x, s0);
      s1 = fmaf(x0.y, y0.y, s1);
      s2 = fmaf(x0.z, y1.x, s2);
      s3 = fmaf(x0.w, y1.y, s3);
      s0 = fmaf(x1.x, y2.x, s0);
      s1 = fmaf(x1.y, y2.y, s1);
      s2 = fmaf(x1.z, y3.x, s2);
      s3 = fmaf(x1.w, y3.y, s3);
    }
  }
  return (s0 + s1) + (s2 + s3);
}

// s = dot * scale + bias with explicit roundings: never contracted into an
// FMA, so both passes get the same bits whatever the compiler decides.
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// The score plus the (N, N) mask entry (i, j), rounded the same way in both
// passes (JAX adds the mask after the bias, `_attend_bwd_one_row` :235-238).
template <bool HAS_MASK>
__device__ __forceinline__ float masked(float s, const float* mask, int i,
                                        int j, int n) {
  if constexpr (HAS_MASK)
    return __fadd_rn(s, __ldg(mask + (long long)i * n + j));
  return s;
}

// Stage rows [0, n) of one head of a strided (B, N, *) tensor into shared
// memory in its own dtype, rows padded to row_pad<T, HD>() elements.
template <typename T, int HD>
__device__ __forceinline__ void stage(T* dst, const T* src, long long base,
                                      long long row, int n) {
  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int j = idx / HD;
    const int d = idx - j * HD;
    dst[j * row_pad<T, HD>() + d] = src[base + (long long)j * row + d];
  }
}

template <typename T, int HD>
__device__ __forceinline__ void stage_row(float* dst, const T* src,
                                          int lane) {
  for (int d = lane; d < HD; d += 32) dst[d] = to_f32(src[d]);
}

// Shared-memory layouts, in bytes (every piece a multiple of 16):
// pass A: K, V staged; per warp two fp32 rows (q_i, g_i) and two fp32
//   columns (p, dp / ds);
// pass B: Q, G staged; the row statistics (3 fp32 columns); per warp two
//   fp32 rows (k_j, v_j) and two T columns (y, ds, both rounded to T).
template <typename T>
__host__ __device__ constexpr long long staged_bytes(int n, int hd) {
  return 2LL * n * (hd + 16 / (long long)sizeof(T)) * (long long)sizeof(T);
}

__host__ __device__ constexpr long long warp_bytes_query(int hd, int n4) {
  return (2LL * (hd + 4) + 2LL * n4) * 4;
}

template <typename T>
__host__ __device__ constexpr long long warp_bytes_key(int hd, int n4) {
  return 2LL * (hd + 4) * 4 + 2LL * n4 * (long long)sizeof(T);
}

template <typename T, int HD, bool HAS_MASK>
__global__ void __launch_bounds__(kThreads) bwd_query_rows(BwdArgs a) {
  constexpr int S = row_pad<T, HD>();
  constexpr int SF = HD + 4;  // fp32 row
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, n4 = (n + 3) & ~3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* ks = reinterpret_cast<T*>(smem);    // n x S
  T* vs = ks + (size_t)n * S;            // n x S
  float* qrow = reinterpret_cast<float*>(
      smem + staged_bytes<T>(n, HD) + warp * warp_bytes_query(HD, n4));
  float* grow = qrow + SF;
  float* pw = grow + SF;                 // p(i, .)
  float* dpw = pw + n4;                  // dp(i, .), then ds * scale rounded

  const T* q = static_cast<const T*>(a.q);
  const T* g = static_cast<const T*>(a.g);
  const long long in_base = (long long)b * a.in_batch + (long long)h * HD;
  stage<T, HD>(ks, static_cast<const T*>(a.k), in_base, a.in_row, n);
  stage<T, HD>(vs, static_cast<const T*>(a.v), in_base, a.in_row, n);
  __syncthreads();

  const float* bias_row = a.bias ? a.bias + (long long)b * n : nullptr;
  unsigned drop_base = 0, drop_seed = 0;
  if (a.drop.on) a.drop.row(b, h, a.heads, n, &drop_base, &drop_seed);
  const int d_model = a.heads * HD;
  T* dq = static_cast<T*>(a.dq);
  const int row_end = min(n, (int)(blockIdx.x + 1) * kRowsPerBlock);
  for (int i = blockIdx.x * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    stage_row<T, HD>(qrow, q + in_base + (long long)i * a.in_row, lane);
    stage_row<T, HD>(grow, g + ((long long)b * n + i) * d_model + h * HD,
                     lane);
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float s = masked<HAS_MASK>(
          score(dot<T, HD>(qrow, ks + j * S), a.scale,
                bias_row ? bias_row[j] : 0.f),
          a.mask, i, j, n);
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      l += e;
    }
    l = warp_sum(l);
    float dsum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = pw[j] / l;
      float dp = dot<T, HD>(grow, vs + j * S);
      if (a.drop.on) dp *= a.drop.factor(drop_base, drop_seed, i, j, n);
      pw[j] = p;
      dpw[j] = dp;
      dsum += dp * p;
    }
    const float dvec = warp_sum(dsum);
    for (int j = lane; j < n; j += 32)
      dpw[j] = to_f32(from_f32<T>(pw[j] * (dpw[j] - dvec) * a.scale));
    __syncwarp();

    float acc[HD / 32];
#pragma unroll
    for (int t = 0; t < HD / 32; ++t) acc[t] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float c = dpw[j];
      const T* kr = ks + j * S + lane;
#pragma unroll
      for (int t = 0; t < HD / 32; ++t)
        acc[t] = fmaf(c, to_f32(kr[32 * t]), acc[t]);
    }
    T* out = dq + (long long)b * a.out_batch + (long long)i * a.out_row +
             h * HD + lane;
#pragma unroll
    for (int t = 0; t < HD / 32; ++t) out[32 * t] = from_f32<T>(acc[t]);
    if (lane == 0) {
      float* st = a.stats + (((long long)b * a.heads + h) * n + i) * 3;
      st[0] = mx;
      st[1] = l;
      st[2] = dvec;
    }
    __syncwarp();  // this warp's rows are rewritten for its next row
  }
}

template <typename T, int HD, bool HAS_MASK>
__global__ void __launch_bounds__(kThreads) bwd_key_rows(BwdArgs a) {
  constexpr int S = row_pad<T, HD>();
  constexpr int SF = HD + 4;  // fp32 row
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, n4 = (n + 3) & ~3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* qs = reinterpret_cast<T*>(smem);    // n x S
  T* gs = qs + (size_t)n * S;            // n x S
  float* ms = reinterpret_cast<float*>(smem + staged_bytes<T>(n, HD));
  float* ls = ms + n4;                   // row sum, n4
  float* dsv = ls + n4;                  // rowsum(dp * p), n4
  float* krow = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(dsv + n4) +
      warp * warp_bytes_key<T>(HD, n4));
  float* vrow = krow + SF;
  T* ys = reinterpret_cast<T*>(vrow + SF);  // y(., j) rounded
  T* dss = ys + n4;                          // ds(., j) * scale rounded

  const int d_model = a.heads * HD;
  const long long in_base = (long long)b * a.in_batch + (long long)h * HD;
  stage<T, HD>(qs, static_cast<const T*>(a.q), in_base, a.in_row, n);
  stage<T, HD>(gs, static_cast<const T*>(a.g),
               (long long)b * n * d_model + (long long)h * HD, d_model, n);
  const float* st = a.stats + ((long long)b * a.heads + h) * n * 3;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    ms[i] = st[3 * i];
    ls[i] = st[3 * i + 1];
    dsv[i] = st[3 * i + 2];
  }
  __syncthreads();

  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  unsigned drop_base = 0, drop_seed = 0;
  if (a.drop.on) a.drop.row(b, h, a.heads, n, &drop_base, &drop_seed);
  const int row_end = min(n, (int)(blockIdx.x + 1) * kRowsPerBlock);
  for (int j = blockIdx.x * kRowsPerBlock + warp; j < row_end; j += kWarps) {
    stage_row<T, HD>(krow, k + in_base + (long long)j * a.in_row, lane);
    stage_row<T, HD>(vrow, v + in_base + (long long)j * a.in_row, lane);
    __syncwarp();
    const float bj = a.bias ? a.bias[(long long)b * n + j] : 0.f;

    float db = 0.f;
    for (int i = lane; i < n; i += 32) {
      // dot(k_j, q_i) and dot(v_j, g_i): fmaf is exact in the product, so
      // these equal pass A's dot(q_i, k_j) and dot(g_i, v_j) bit for bit
      const float s = masked<HAS_MASK>(
          score(dot<T, HD>(krow, qs + i * S), a.scale, bj), a.mask, i, j, n);
      const float p = expf(s - ms[i]) / ls[i];
      float dp = dot<T, HD>(vrow, gs + i * S);
      float y = p;
      if (a.drop.on) {
        const float f = a.drop.factor(drop_base, drop_seed, i, j, n);
        y *= f;
        dp *= f;
      }
      const float ds = p * (dp - dsv[i]);
      ys[i] = from_f32<T>(y);
      dss[i] = from_f32<T>(ds * a.scale);
      db += ds;
    }
    __syncwarp();

    float ak[HD / 32], av[HD / 32];
#pragma unroll
    for (int t = 0; t < HD / 32; ++t) ak[t] = av[t] = 0.f;
    for (int i = 0; i < n; ++i) {
      const float cy = to_f32(ys[i]), cs = to_f32(dss[i]);
      const T* qr = qs + i * S + lane;
      const T* gr = gs + i * S + lane;
#pragma unroll
      for (int t = 0; t < HD / 32; ++t) {
        av[t] = fmaf(cy, to_f32(gr[32 * t]), av[t]);
        ak[t] = fmaf(cs, to_f32(qr[32 * t]), ak[t]);
      }
    }
    const long long o = (long long)b * a.out_batch +
                        (long long)j * a.out_row + h * HD + lane;
#pragma unroll
    for (int t = 0; t < HD / 32; ++t) {
      dk[o + 32 * t] = from_f32<T>(ak[t]);
      dv[o + 32 * t] = from_f32<T>(av[t]);
    }
    if (a.dbias_part) {
      db = warp_sum(db);
      if (lane == 0)
        a.dbias_part[((long long)b * a.heads + h) * n + j] = db;
    }
    __syncwarp();  // krow / vrow / ys / dss are rewritten for the next j
  }
}

__global__ void dbias_sum_heads(const float* __restrict__ part,
                                float* __restrict__ dbias, int b, int heads,
                                int n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)b * n) return;
  const long long r = idx / n, j = idx - r * n;
  float s = 0.f;
  for (int h = 0; h < heads; ++h) s += part[(r * heads + h) * n + j];
  dbias[idx] = s;
}

template <typename T>
long long smem_query_rows(int n, int hd) {
  const int n4 = (n + 3) & ~3;
  return staged_bytes<T>(n, hd) + kWarps * warp_bytes_query(hd, n4);
}

template <typename T>
long long smem_key_rows(int n, int hd) {
  const int n4 = (n + 3) & ~3;
  return staged_bytes<T>(n, hd) + 3LL * n4 * 4 +
         kWarps * warp_bytes_key<T>(hd, n4);
}

template <typename T, int HD, bool HAS_MASK>
cudaError_t launch(const BwdArgs& a, int b, cudaStream_t stream) {
  const auto pass_a = bwd_query_rows<T, HD, HAS_MASK>;
  const auto pass_b = bwd_key_rows<T, HD, HAS_MASK>;
  const long long sa = smem_query_rows<T>(a.n, HD);
  const long long sb = smem_key_rows<T>(a.n, HD);
  cudaError_t err = cudaFuncSetAttribute(
      pass_a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      pass_b, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb);
  if (err != cudaSuccess) return err;
  // ask for the largest shared-memory carveout, so several CTAs fit an SM
  err = cudaFuncSetAttribute(pass_a,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(pass_b,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kRowsPerBlock - 1) / kRowsPerBlock, a.heads, b);
  pass_a<<<grid, kThreads, sa, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pass_b<<<grid, kThreads, sb, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.dbias_part) {
    const long long total = (long long)b * a.n;
    dbias_sum_heads<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        a.dbias_part, a.dbias, b, a.heads, a.n);
    err = cudaGetLastError();
  }
  return err;
}

// K3m is its own instantiation, so K3 carries no mask read
template <typename T, bool HAS_MASK>
cudaError_t dispatch_hd(int head_dim, const BwdArgs& a, int b,
                        cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32, HAS_MASK>(a, b, stream);
    case 64:
      return launch<T, 64, HAS_MASK>(a, b, stream);
    case 128:
      return launch<T, 128, HAS_MASK>(a, b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_mask(int head_dim, const BwdArgs& a, int b,
                          cudaStream_t stream) {
  return a.mask ? dispatch_hd<T, true>(head_dim, a, b, stream)
                : dispatch_hd<T, false>(head_dim, a, b, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/k/v share (in_row, in_batch) element
// strides, dq/dk/dv share (out_row, out_batch); g is contiguous (B, N, D).
// bias: nullptr or (B, N) float32. mask: nullptr or (N, N) float32, shared
// across the batch (K3m). dbias and dbias_part: both nullptr, or
// (B, N) and (B, heads, N) float32. stats: (B, heads, N, 3) float32
// scratch. drop/row_seeds/seed/threshold/keep_scale as bscan_mha_fwd.
// Returns the cudaError_t of the launches (0 on success).
int bscan_mha_bwd(const void* q, const void* k, const void* v, const void* g,
                  const void* bias, const void* mask, void* dq, void* dk,
                  void* dv, void* dbias,
                  void* stats, void* dbias_part, int b, int n, int heads,
                  int head_dim, long long in_row, long long in_batch,
                  long long out_row, long long out_batch, float scale,
                  int dtype, const void* row_seeds, unsigned seed,
                  unsigned threshold, float keep_scale, int drop,
                  void* stream) {
  if ((dbias == nullptr) != (dbias_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, g, static_cast<const float*>(bias),
                  static_cast<const float*>(mask), dq, dk, dv,
                  static_cast<float*>(stats),
                  static_cast<float*>(dbias_part),
                  static_cast<float*>(dbias), n, heads, in_row, in_batch,
                  out_row, out_batch, scale,
                  Dropout{static_cast<const unsigned*>(row_seeds), seed,
                          threshold, keep_scale, drop}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_mask<float>(head_dim, a, b, s);
  if (dtype == 1) return (int)dispatch_mask<__nv_bfloat16>(head_dim, a, b, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory the larger of the two passes needs at
// (n, head_dim, dtype): the wrapper checks this against the card's limit.
long long bscan_mha_bwd_smem_bytes(int n, int head_dim, int dtype) {
  const bool bf16 = dtype == 1;
  const long long a = bf16 ? smem_query_rows<__nv_bfloat16>(n, head_dim)
                           : smem_query_rows<float>(n, head_dim);
  const long long b = bf16 ? smem_key_rows<__nv_bfloat16>(n, head_dim)
                           : smem_key_rows<float>(n, head_dim);
  return a > b ? a : b;
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
