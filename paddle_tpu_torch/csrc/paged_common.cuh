// Shared device helpers of the paged-attention kernels
// (ragged_paged_attention.cu, paged_decode_attention.cu): element conversion
// to fp32, the page load into shared memory, and warp reductions.
//
// Pools are head-major [H_kv, num_blocks, bs, D]; one (head, page) tile is a
// contiguous [bs, D] slab. Float pools (fp32, bf16, fp16) are read as they are;
// quantized pools (int8, fp8 e4m3) are dequantized in the load, each element
// times the page's factor scale[h, page] / qmax, so no float copy of a page
// ever reaches device memory.
#pragma once

#include <cuda_fp8.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace ptt_paged {

using ptt::by_dtype;
using ptt::from_f32;
using ptt::to_f32;

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// One contiguous [bs, D] page -> shared fp32 with row stride `ld`, each
// element times `mul` (1 for float pools). `vec`: 16 bytes per thread per
// load (D a multiple of the vector width and the pool 16-byte aligned, so a
// vector never straddles two rows); else one element a thread (any D, any
// alignment). `threads` is the block size.
template <typename P>
__device__ __forceinline__ void load_page(const P* __restrict__ src, float* dst, int bs, int D,
                                          int ld, float mul, int threads, bool vec) {
  constexpr int kVec = 16 / sizeof(P);
  if (!vec) {
    for (int e = threadIdx.x; e < bs * D; e += threads)
      dst[(e / D) * ld + (e % D)] = to_f32(src[e]) * mul;
    return;
  }
  const int n_vec = bs * D / kVec;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int v = threadIdx.x; v < n_vec; v += threads) {
    const uint4 raw = __ldg(src4 + v);
    const P* e = reinterpret_cast<const P*>(&raw);
    const int idx = v * kVec;
    float* d = dst + (idx / D) * ld + (idx % D);
#pragma unroll
    for (int i = 0; i < kVec; ++i) d[i] = to_f32(e[i]) * mul;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pool element codes of the C entries: 0 = the query's float type,
// 1 = int8, 2 = fp8 e4m3. The quantized grids top out at 127 and 448.
inline int pool_itemsize(int pool_dtype, int float_itemsize) {
  return pool_dtype == 0 ? float_itemsize : 1;
}
__host__ __device__ constexpr float qmax_of(int pool_dtype) {
  return pool_dtype == 2 ? 448.f : 127.f;
}

}  // namespace ptt_paged
