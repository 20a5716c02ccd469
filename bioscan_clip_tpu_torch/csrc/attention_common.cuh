// Pieces shared by the attention forward (mha_fwd.cu) and backward
// (mha_bwd.cu): dtype conversions, warp reductions, the dropout counter hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace bscan
