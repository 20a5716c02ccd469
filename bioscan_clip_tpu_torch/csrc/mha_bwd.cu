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
// kernel is memory-bound.
//
// Two bodies, one contract and one structure (FlashAttention-2 style;
// blocks run in no order, so every output element has exactly one writer
// and every sum a fixed order, no atomics):
//   pass A, per query rows: s, the row max m and sum l, p, dp and D =
//     rowsum(dp * p); (m, l, D) go to a (B, h, N, 3) fp32 scratch; then ds
//     and dq;
//   pass B, per key rows: p(i, j) = exp(s - m_i) / l_i rebuilt from pass A's
//     statistics, dp and ds for every query row i, then dv_j, dk_j and the
//     head's partial dbias[b, h, j];
//   pass C (only when dbias is asked for) sums the partials over heads in
//     order.
// Pass B rebuilds p from pass A's m and l, so both passes must form the same
// score bit for bit: both run the same product over the same operands in the
// same order and add the scale, bias and mask with the same explicit
// roundings. A -1e9 mask entry gives p = exp(-1e9 - m) = 0 exactly, so
// ds = 0 there. The mask is read from device memory where the score is
// formed (one 77 x 77 mask is 23.7 KB and stays in L1/L2); whether there is
// one is a template parameter, so K3 compiles without the mask read.
//
// bf16 inputs: `bwd_query_rows_mma` and `bwd_key_rows_mma`, on the tensor
// cores (mma.sync m16n8k16; attention_common.cuh), one CTA per (head,
// batch row), each warp taking 16-row tiles (warp, warp + W, ...; W =
// `mma_warps`, at most 8 in pass A and 4 in pass B):
//   pass A stages K_h and V_h (bf16, rows padded to 16, HD + 8 a row; 59.9 KB
//     at N = 197, 78.3 KB at N = 257) and holds the tile's q and g as A
//     fragments in registers. Three sweeps over 16-key tiles, each forming
//     s = q . k^T with the same mma: (1) m and l (`row_stats`); (2) p, dp =
//     g . v^T (mma) times keep, D; (3) p and dp again, ds = p (dp - D), ds *
//     scale rounded to bf16 straight from the accumulators into the A
//     fragment of dq += ds . k (k read by ldmatrix.trans). This keeps JAX's
//     normalized p (no online rescaling of p or D); both passes form p with
//     one device function (`prob`) from the same m and 1 / l.
//   pass B stages Q_h and G_h and the statistics (m, 1 / l and D; rows past
//     N: m = +inf, so p = 0) and holds the tile's k and v as B fragments in
//     registers. For each 16-row query tile: s = q . k^T as the SAME mma as
//     pass A (q in the
//     A role from ldmatrix, k in the B role, the same k order, the same
//     `score_tile` epilogue), dp = g . v^T likewise, then p, y = p * keep
//     and ds. y and ds * scale, rounded to bf16, go through a per-warp
//     16 x 16 shared tile and come back by ldmatrix.trans as the A fragments
//     of dv += y^T g and dk += ds^T q. The partial dbias is the fp32 ds
//     summed over query rows in tile order, then over the lanes in a fixed
//     butterfly.
//   About 10 N^2 hd multiply-adds per (row, head) against the minimum 5:
//   the scores three times in pass A and once in pass B, dp twice and once;
//   the arithmetic is cheap on the tensor cores next to the bytes.
//   (One CTA per (row, head) forming each score once would need Q, K, V and
//   G staged together: 120 KB at N = 197, one CTA per SM.)
//
// fp32 inputs: `bwd_query_rows` and `bwd_key_rows`, FFMA out of shared
// memory (7 N^2 hd FMAs per (row, head)), one CTA of eight warps per
// (64-row block, head, batch row). Pass A stages K_h and V_h as fp32 and
// each warp takes query rows (lane owns output dims lane + 32t); pass B
// stages Q_h, G_h and the statistics and each warp takes key rows j,
// recomputing p(i, j), dp and ds for all query rows i (lane-strided). Both
// compute s and dp with the same `dot` over the same operand pairs in the
// same order. Rows are padded by 16 bytes: 16-byte reads of different rows by
// different lanes hit distinct banks. fp32 at N = 197, hd 64: ~124 KB, one
// CTA per SM.

#include "attention_common.cuh"

#include <math.h>

#include <type_traits>

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

// pass A up to 8 warps a CTA; pass B (~165 registers a thread at hd 64) up
// to 4, so three CTAs still fit an SM's registers
constexpr int kMaxWarpsA = 8;
constexpr int kMaxWarpsB = 4;
constexpr int kTileStride = 16 + 8;  // per-warp 16 x 16 bf16 tile, padded

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

// fp32 dot of two fp32 rows in shared memory (padded to HD+4 floats).
// Element d goes to partial sum d % 4 in increasing d: one fixed order.
template <typename T, int HD>
__device__ __forceinline__ float dot(const float* a, const T* b) {
  static_assert(std::is_same<T, float>::value, "the FFMA passes are fp32");
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 x = a4[d4];
    const float4 y = b4[d4];
    s0 = fmaf(x.x, y.x, s0);
    s1 = fmaf(x.y, y.y, s1);
    s2 = fmaf(x.z, y.z, s2);
    s3 = fmaf(x.w, y.w, s3);
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

template <int HD, bool HAS_MASK>
__global__ void __launch_bounds__(kMaxWarpsA * 32)
    bwd_query_rows_mma(BwdArgs a) {
  constexpr int KC = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, np = pad16(n);
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* ks = reinterpret_cast<bf16*>(smem);  // np x (HD + 8)
  bf16* vs = ks + np * (HD + 8);              // np x (HD + 8)
  const long long in_base = (long long)b * a.in_batch + (long long)h * HD;
  bscan::stage_rows<HD>(ks, static_cast<const bf16*>(a.k) + in_base,
                        a.in_row, n, np);
  bscan::cp_async_commit();  // sweep 1 reads only K: V lands behind it
  bscan::stage_rows<HD>(vs, static_cast<const bf16*>(a.v) + in_base,
                        a.in_row, n, np);
  bscan::cp_async_commit();
  bscan::cp_async_wait<1>();
  __syncthreads();

  const float* bias_row = a.bias ? a.bias + (long long)b * n : nullptr;
  unsigned drop_base = 0, drop_seed = 0;
  if (a.drop.on) a.drop.row(b, h, a.heads, n, &drop_base, &drop_seed);
  const int d_model = a.heads * HD;
  const bf16* q = static_cast<const bf16*>(a.q) + in_base;
  const bf16* gq = static_cast<const bf16*>(a.g) + (long long)b * n * d_model +
                   (long long)h * HD;
  for (int r0 = warp * 16; r0 < n; r0 += (blockDim.x >> 5) * 16) {
    unsigned qa[KC][4], ga[KC][4];
    bscan::load_frags<HD>(qa, q, a.in_row, r0, n, lane);
    bscan::load_frags<HD>(ga, gq, d_model, r0, n, lane);
    const int i0 = r0 + g;
    float m[2], l[2];
    bscan::row_stats<HD, HAS_MASK>(m, l, qa, ks, np, a.scale, bias_row,
                                   a.mask, i0, 2 * t, n, lane);
    if (r0 == warp * 16) {  // every warp has a first tile: V has landed
      bscan::cp_async_wait<0>();
      __syncthreads();
    }
    const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
    // sweep 2: D = rowsum(dp * p)
    float dsum[2] = {0.f, 0.f};
    for (int kt = 0; kt < np; kt += 16) {
      float s[2][4], dp[2][4];
      bscan::mm_nt<HD>(s, qa, ks, kt, lane);
      bscan::score_tile<HAS_MASK>(s, a.scale, bias_row, a.mask, i0,
                                  kt + 2 * t, n);
      bscan::mm_nt<HD>(dp, ga, vs, kt, lane);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = bscan::prob(s[nb][e], m[e >> 1], inv_l[e >> 1]);
          float d = dp[nb][e];
          if (a.drop.on)
            d *= a.drop.factor(drop_base, drop_seed, i0 + 8 * (e >> 1),
                               kt + 2 * t + 8 * nb + (e & 1), n);
          dsum[e >> 1] += d * p;
        }
    }
    const float dvec[2] = {bscan::quad_sum(dsum[0]),
                           bscan::quad_sum(dsum[1])};
    // sweep 3: ds, and dq = (ds * scale -> bf16) . k
    float acc[HD / 8][4];
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
    for (int kt = 0; kt < np; kt += 16) {
      float s[2][4], dp[2][4];
      bscan::mm_nt<HD>(s, qa, ks, kt, lane);
      bscan::score_tile<HAS_MASK>(s, a.scale, bias_row, a.mask, i0,
                                  kt + 2 * t, n);
      bscan::mm_nt<HD>(dp, ga, vs, kt, lane);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = bscan::prob(s[nb][e], m[e >> 1], inv_l[e >> 1]);
          float d = dp[nb][e];
          if (a.drop.on)
            d *= a.drop.factor(drop_base, drop_seed, i0 + 8 * (e >> 1),
                               kt + 2 * t + 8 * nb + (e & 1), n);
          const float ds = p * (d - dvec[e >> 1]);
          s[nb][e] = ds * a.scale;
        }
      unsigned dsa[4];
      bscan::to_a_frag(dsa, s);
      bscan::mm_nn<HD>(acc, dsa, ks, kt, lane);
    }
    bf16* out = static_cast<bf16*>(a.dq) + (long long)b * a.out_batch +
                (long long)i0 * a.out_row + h * HD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      if (i0 < n)
        *reinterpret_cast<unsigned*>(out + 8 * dn) =
            bscan::pack_bf16(acc[dn][0], acc[dn][1]);
      if (i0 + 8 < n)
        *reinterpret_cast<unsigned*>(out + 8 * a.out_row + 8 * dn) =
            bscan::pack_bf16(acc[dn][2], acc[dn][3]);
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 8 * r;
        if (i < n) {
          float* st = a.stats + (((long long)b * a.heads + h) * n + i) * 3;
          st[0] = m[r];
          st[1] = l[r];
          st[2] = dvec[r];
        }
      }
    }
  }
}

template <int HD, bool HAS_MASK>
__global__ void __launch_bounds__(kMaxWarpsB * 32)
    bwd_key_rows_mma(BwdArgs a) {
  constexpr int KC = HD / 16;
  constexpr int TS = kTileStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, np = pad16(n);
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // np x (HD + 8)
  bf16* gs = qs + np * (HD + 8);              // np x (HD + 8)
  float* ms = reinterpret_cast<float*>(gs + np * (HD + 8));
  float* ils = ms + np;  // 1 / l, as pass A multiplies by it
  float* dsv = ils + np;
  bf16* ys = reinterpret_cast<bf16*>(dsv + np) + warp * 2 * 16 * TS;
  bf16* dss = ys + 16 * TS;

  const int d_model = a.heads * HD;
  const long long in_base = (long long)b * a.in_batch + (long long)h * HD;
  bscan::stage_rows<HD>(qs, static_cast<const bf16*>(a.q) + in_base,
                        a.in_row, n, np);
  bscan::stage_rows<HD>(
      gs, static_cast<const bf16*>(a.g) + (long long)b * n * d_model +
              (long long)h * HD,
      d_model, n, np);
  const float* st = a.stats + ((long long)b * a.heads + h) * n * 3;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const bool ok = i < n;
    ms[i] = ok ? st[3 * i] : INFINITY;  // padding rows: p = exp(-inf) = 0
    ils[i] = ok ? 1.f / st[3 * i + 1] : 1.f;
    dsv[i] = ok ? st[3 * i + 2] : 0.f;
  }
  bscan::cp_async_wait_all();
  __syncthreads();

  const float* bias_row = a.bias ? a.bias + (long long)b * n : nullptr;
  unsigned drop_base = 0, drop_seed = 0;
  if (a.drop.on) a.drop.row(b, h, a.heads, n, &drop_base, &drop_seed);
  for (int j0 = warp * 16; j0 < n; j0 += (blockDim.x >> 5) * 16) {
    // B fragments of keys j0..j0+15: (x[c][0], x[c][2]) rows j0 + g,
    // (x[c][1], x[c][3]) rows j0 + 8 + g
    unsigned kb[KC][4], vb[KC][4];
    bscan::load_frags<HD>(kb, static_cast<const bf16*>(a.k) + in_base,
                          a.in_row, j0, n, lane);
    bscan::load_frags<HD>(vb, static_cast<const bf16*>(a.v) + in_base,
                          a.in_row, j0, n, lane);
    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
    float db[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // keys j0 + 8 nb + 2t + c
    for (int it = 0; it < np; it += 16) {
      // the score tile as pass A forms it: q in the A role, k in the B role
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        unsigned x[4];
        bscan::ldsm_x4(x, bscan::rows16<HD + 8>(qs, it, 16 * c, lane));
        bscan::mma_bf16(s[0], x, kb[c][0], kb[c][2]);
        bscan::mma_bf16(s[1], x, kb[c][1], kb[c][3]);
        bscan::ldsm_x4(x, bscan::rows16<HD + 8>(gs, it, 16 * c, lane));
        bscan::mma_bf16(dp[0], x, vb[c][0], vb[c][2]);
        bscan::mma_bf16(dp[1], x, vb[c][1], vb[c][3]);
      }
      const int i0 = it + g;
      bscan::score_tile<HAS_MASK>(s, a.scale, bias_row, a.mask, i0,
                                  j0 + 2 * t, n);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * (e >> 1);
          const float p = bscan::prob(s[nb][e], ms[i], ils[i]);
          float y = p, d = dp[nb][e];
          if (a.drop.on) {
            const float f = a.drop.factor(drop_base, drop_seed, i,
                                          j0 + 2 * t + 8 * nb + (e & 1), n);
            y *= f;
            d *= f;
          }
          const float ds = p * (d - dsv[i]);
          db[nb][e & 1] += ds;
          s[nb][e] = y;
          dp[nb][e] = ds * a.scale;
        }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = (g + 8 * r) * TS + 8 * nb + 2 * t;
          *reinterpret_cast<unsigned*>(ys + o) =
              bscan::pack_bf16(s[nb][2 * r], s[nb][2 * r + 1]);
          *reinterpret_cast<unsigned*>(dss + o) =
              bscan::pack_bf16(dp[nb][2 * r], dp[nb][2 * r + 1]);
        }
      __syncwarp();
      unsigned ya[4], sa[4];
      bscan::ldsm_x4_t(ya, bscan::cols16<TS>(ys, 0, 0, lane));
      bscan::ldsm_x4_t(sa, bscan::cols16<TS>(dss, 0, 0, lane));
      bscan::mm_nn<HD>(dv, ya, gs, it, lane);
      bscan::mm_nn<HD>(dk, sa, qs, it, lane);
      __syncwarp();  // ys / dss are rewritten by the next query tile
    }
    const int j = j0 + g;
    const long long o = (long long)b * a.out_batch + (long long)j * a.out_row +
                        h * HD + 2 * t;
    bf16* dkp = static_cast<bf16*>(a.dk) + o;
    bf16* dvp = static_cast<bf16*>(a.dv) + o;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      if (j < n) {
        *reinterpret_cast<unsigned*>(dkp + 8 * dn) =
            bscan::pack_bf16(dk[dn][0], dk[dn][1]);
        *reinterpret_cast<unsigned*>(dvp + 8 * dn) =
            bscan::pack_bf16(dv[dn][0], dv[dn][1]);
      }
      if (j + 8 < n) {
        *reinterpret_cast<unsigned*>(dkp + 8 * a.out_row + 8 * dn) =
            bscan::pack_bf16(dk[dn][2], dk[dn][3]);
        *reinterpret_cast<unsigned*>(dvp + 8 * a.out_row + 8 * dn) =
            bscan::pack_bf16(dv[dn][2], dv[dn][3]);
      }
    }
    if (a.dbias_part) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = db[nb][c];  // this lane's rows; sum over the 8 g lanes
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          const int jj = j0 + 8 * nb + 2 * t + c;
          if (g == 0 && jj < n)
            a.dbias_part[((long long)b * a.heads + h) * n + jj] = x;
        }
    }
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

long long smem_query_rows_mma(int n, int hd) {
  return 2LL * pad16(n) * (hd + 8) * (long long)sizeof(bf16);
}

long long smem_key_rows_mma(int n, int hd) {
  return 2LL * pad16(n) * (hd + 8) * (long long)sizeof(bf16) +
         3LL * pad16(n) * 4 +
         (long long)kMaxWarpsB * 2 * 16 * kTileStride * sizeof(bf16);
}

// Both passes' shared-memory attributes, once per card (`ready`: the
// calling instantiation's flags, pass A's then pass B's): the most any N asks
// for, and the largest carveout, so that several CTAs fit an SM.
cudaError_t set_smem(bool (&ready)[2][bscan::kMaxDevices], const void* pass_a,
                     const void* pass_b) {
  cudaError_t err =
      bscan::allow_smem(ready[0], pass_a, bscan::kCardSmem, true);
  if (err != cudaSuccess) return err;
  return bscan::allow_smem(ready[1], pass_b, bscan::kCardSmem, true);
}

cudaError_t launch_dbias(const BwdArgs& a, int b, cudaStream_t stream) {
  const long long total = (long long)b * a.n;
  dbias_sum_heads<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      a.dbias_part, a.dbias, b, a.heads, a.n);
  return cudaGetLastError();
}

template <int HD, bool HAS_MASK>
cudaError_t launch_mma(const BwdArgs& a, int b, cudaStream_t stream) {
  const auto pass_a = bwd_query_rows_mma<HD, HAS_MASK>;
  const auto pass_b = bwd_key_rows_mma<HD, HAS_MASK>;
  static bool ready[2][bscan::kMaxDevices] = {};
  const long long sa = smem_query_rows_mma(a.n, HD);
  const long long sb = smem_key_rows_mma(a.n, HD);
  cudaError_t err = set_smem(ready, (const void*)pass_a, (const void*)pass_b);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.heads, b);
  pass_a<<<grid, 32 * bscan::mma_warps(a.n, kMaxWarpsA), sa, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pass_b<<<grid, 32 * bscan::mma_warps(a.n, kMaxWarpsB), sb, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.dbias_part) return err;
  return launch_dbias(a, b, stream);
}

template <typename T, int HD, bool HAS_MASK>
cudaError_t launch(const BwdArgs& a, int b, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_mma<HD, HAS_MASK>(a, b, stream);
  } else {
    const auto pass_a = bwd_query_rows<T, HD, HAS_MASK>;
    const auto pass_b = bwd_key_rows<T, HD, HAS_MASK>;
    static bool ready[2][bscan::kMaxDevices] = {};
    const long long sa = smem_query_rows<T>(a.n, HD);
    const long long sb = smem_key_rows<T>(a.n, HD);
    cudaError_t err =
        set_smem(ready, (const void*)pass_a, (const void*)pass_b);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n + kRowsPerBlock - 1) / kRowsPerBlock, a.heads, b);
    pass_a<<<grid, kThreads, sa, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    pass_b<<<grid, kThreads, sb, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess || !a.dbias_part) return err;
    return launch_dbias(a, b, stream);
  }
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
// bf16 runs the tensor-core passes (at every N: they beat the FFMA passes
// down to BERT-small's N = 20), whose q/k/v/g rows must be 16-byte aligned
// (the wrapper checks); fp32 the FFMA passes. Returns the cudaError_t of the
// launches (0 on success).
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
  if (dtype == 1) return (int)dispatch_mask<bf16>(head_dim, a, b, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory the larger of the two passes needs at
// (n, head_dim, dtype): the wrapper checks this against the card's limit.
long long bscan_mha_bwd_smem_bytes(int n, int head_dim, int dtype) {
  long long a, b;
  if (dtype == 1) {
    a = smem_query_rows_mma(n, head_dim);
    b = smem_key_rows_mma(n, head_dim);
  } else {
    a = smem_query_rows<float>(n, head_dim);
    b = smem_key_rows<float>(n, head_dim);
  }
  return a > b ? a : b;
}

const char* bscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
