// The tile primitives' `elementwise` for Hopper (sm_90a): the template that
// every generated source (paddle_tpu_torch/kernels/_codegen.py
// `elementwise_source`) includes.
//
// Replaces paddle_tpu/kernels/pallas/primitives.py `elementwise` (its
// pallas_call runs the caller's fn on [block_rows, C] tiles of 1+ arrays of
// one shape). Here the caller's fn is traced to a small IR and emitted as an
// inline fp32 __device__ function `ptt_fn`; the generated `Gen` struct loads
// its operands (each in its own dtype) into fp32, calls ptt_fn and rounds
// once to the output dtype on store.
//
// TPU -> Hopper. The Pallas grid walks row tiles of the [R, C] view in VMEM;
// an elementwise map has no row structure, so here the arrays are one flat
// run of n elements and a grid-stride loop hands each thread groups of
// Gen::kVec contiguous elements: 16 bytes of the narrowest operand (8
// elements when any operand or the output is 16-bit, else 4), each operand
// read in one or two 16-byte words and the output written the same way, when
// every base is 16-byte aligned; the tail past the last whole group, and an
// unaligned call, go one element a thread.
//
// Bound on an H100 SXM (3.35 TB/s): fn is a few to a few tens of fp32 ops
// an element against 2-4 bytes an operand, so bytes bound it unless fn is
// long (a tanh GELU is ~10 ops and a tanhf against 4 bytes in bf16: still
// bytes at 67 TFLOP/s).
#pragma once

#include "kps_ops.cuh"

namespace ptt_kps {

constexpr int kMaxIn = 16;  // operands a call (kernels/_codegen.py MAX_INPUTS)
constexpr int kThreads = 256;

struct Ptrs {
  const void* p[kMaxIn];
};

// elements [i * V, i * V + V) of base in fp32 (V * sizeof(T) is 16 or 32)
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ base, long long i, float (&f)[V]) {
  constexpr int kWords = V * sizeof(T) / 16;
  uint4 r[kWords];
  const uint4* src = reinterpret_cast<const uint4*>(base + i * V);
#pragma unroll
  for (int w = 0; w < kWords; ++w) r[w] = __ldg(src + w);
  const T* e = reinterpret_cast<const T*>(r);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = ptt::to_f32(e[k]);
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ base, long long i, const float (&f)[V]) {
  constexpr int kWords = V * sizeof(T) / 16;
  uint4 r[kWords];
  T* e = reinterpret_cast<T*>(r);
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = ptt::from_f32<T>(f[k]);
  uint4* dst = reinterpret_cast<uint4*>(base + i * V);
#pragma unroll
  for (int w = 0; w < kWords; ++w) dst[w] = r[w];
}

template <typename Gen>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(Ptrs in, void* out, long long n, int vec) {
  const long long first = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long groups = vec ? n / Gen::kVec : 0;
  for (long long t = first; t < groups; t += stride) Gen::vec(in, out, t);
  for (long long e = groups * Gen::kVec + first; e < n; e += stride) Gen::one(in, out, e);
}

// ins: n_in device pointers (a host array), out: n elements. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for an operand
// count that is not the generated fn's.
template <typename Gen>
int launch_elementwise(const void* const* ins, int n_in, void* out, long long n, void* stream) {
  if (n_in != Gen::kIn) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  Ptrs p{};
  int vec = aligned16(out);
  for (int k = 0; k < n_in; ++k) {
    p.p[k] = ins[k];
    vec = vec && aligned16(ins[k]);
  }
  const long long items = vec ? n / Gen::kVec + n % Gen::kVec : n;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
  elementwise_kernel<Gen><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, out, n,
                                                                                     vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ptt_kps
