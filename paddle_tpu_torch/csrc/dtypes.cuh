// The float element types the port's row and elementwise kernels take, and
// the C entries' dtype codes for them: 0 = float32, 1 = bfloat16, 2 = float16
// (kernels/_build.py `dtype_code`). Every kernel that includes this reads its
// elements into fp32, computes in fp32 and rounds once on store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ptt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the element type of a dtype code; cudaErrorInvalidValue for
// a code the kernels do not take
template <typename F>
int by_dtype(int code, F&& f) {
  switch (code) {
    case 0: return f(Tag<float>{});
    case 1: return f(Tag<__nv_bfloat16>{});
    case 2: return f(Tag<__half>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ptt
