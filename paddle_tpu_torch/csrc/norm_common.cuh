// Row-normalisation helpers shared by layer_norm.cu and rms_norm.cu: one
// warp owns one row of H elements (8 rows per 256-thread block), reads it in
// 16-byte words when H and the bases allow it and one element a lane
// otherwise, and reduces its fp32 sums with warp shuffles (no shared memory,
// no block barrier).

#pragma once

#include <stdint.h>

#include "dtypes.cuh"

namespace ptt_norm {

using ptt::by_dtype;
using ptt::from_f32;
using ptt::to_f32;

constexpr int kWarps = 8;  // rows per block, one warp each
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f(i, a[i], b[i]) for every element i of a row of H held by this lane: in
// 16-byte words (N elements each) when vec, else one element per lane. b may
// be the same row as a (one-array passes).
template <typename T, typename F>
__device__ __forceinline__ void walk(const T* __restrict__ a, const T* __restrict__ b, int H,
                                     bool vec, F&& f) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  if (vec) {
    for (int w = lane; w < H / N; w += 32) {
      const uint4 ra = __ldg(reinterpret_cast<const uint4*>(a) + w);
      const uint4 rb = __ldg(reinterpret_cast<const uint4*>(b) + w);
      const T* va = reinterpret_cast<const T*>(&ra);
      const T* vb = reinterpret_cast<const T*>(&rb);
#pragma unroll
      for (int k = 0; k < N; ++k) f(w * N + k, to_f32(va[k]), to_f32(vb[k]));
    }
  } else {
    for (int i = lane; i < H; i += 32) f(i, to_f32(a[i]), to_f32(b[i]));
  }
}

// out[i] = g(i, a[i], b[i]) over the row, written in 16-byte words when vec.
template <typename T, typename G>
__device__ __forceinline__ void write_row(const T* __restrict__ a, const T* __restrict__ b,
                                          T* __restrict__ out, int H, bool vec, G&& g) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  if (vec) {
    for (int w = lane; w < H / N; w += 32) {
      const uint4 ra = __ldg(reinterpret_cast<const uint4*>(a) + w);
      const uint4 rb = __ldg(reinterpret_cast<const uint4*>(b) + w);
      const T* va = reinterpret_cast<const T*>(&ra);
      const T* vb = reinterpret_cast<const T*>(&rb);
      uint4 ro;
      T* vo = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int k = 0; k < N; ++k) vo[k] = from_f32<T>(g(w * N + k, to_f32(va[k]), to_f32(vb[k])));
      reinterpret_cast<uint4*>(out)[w] = ro;
    }
  } else {
    for (int i = lane; i < H; i += 32) out[i] = from_f32<T>(g(i, to_f32(a[i]), to_f32(b[i])));
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline dim3 grid_for(long long rows) {
  return dim3(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
}

}  // namespace ptt_norm
