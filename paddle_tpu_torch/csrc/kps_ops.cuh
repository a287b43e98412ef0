// The fp32 ops of the tile primitives' generated code
// (paddle_tpu_torch/kernels/_codegen.py `emit_fn`) that are more than one
// intrinsic. Each follows PyTorch's own CUDA kernel for the op, with the
// round-to-nearest intrinsics, so a generated kernel and the plain version
// (the same fn on fp32 tensors) agree op by op.
#pragma once

#include <stdint.h>

#include "dtypes.cuh"

namespace ptt_kps {

// torch.maximum / torch.minimum: a NaN operand wins
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// gelu, approximate "none": x * 0.5 * (1 + erf(x / sqrt(2)))
__device__ __forceinline__ float gelu_none(float x) {
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(x, 0.70710678118654752f))));
}

// gelu, approximate "tanh": 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner =
      __fmul_rn(0.79788456080286536f, __fadd_rn(x, __fmul_rn(0.044715f, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
}

// a cast to a 16-bit float inside fn: round to it and back
__device__ __forceinline__ float round_bfloat16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_float16(float x) {
  return __half2float(__float2half_rn(x));
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace ptt_kps
