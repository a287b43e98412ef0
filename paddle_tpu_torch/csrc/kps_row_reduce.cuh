// The tile primitives' `row_reduce` for Hopper (sm_90a): the template that
// every generated source (paddle_tpu_torch/kernels/_codegen.py
// `row_reduce_source`) includes.
//
// Replaces paddle_tpu/kernels/pallas/primitives.py `row_reduce` (its
// pallas_call folds [block_rows, block_cols] tiles of x into a [rows, 128]
// fp32 VMEM carry with the caller's fn, and the last 128 lanes are folded
// outside the kernel). Here out[r] = fn(identity, x[r, 0], ..., x[r, C-1])
// in fp32 in one kernel, for an associative and commutative fn (the Pallas
// kernel's lane folds reorder the columns too): the generated `Gen` struct
// gives fn as an inline fp32 function and the identity.
//
// TPU -> Hopper. The C % 128 rule of the Pallas kernel is lane tiling; any C
// works here. A row of C <= kWarpMaxC is one warp's (8 rows a 256-thread
// block); a wider row is one block's. Each thread folds its share of the row
// in 16-byte words (8 elements for bf16 / fp16, 4 for fp32) when C is a whole
// number of words and x is 16-byte aligned, into one fp32 accumulator per
// element of the word (independent chains), then folds those; the warp folds
// its lanes with a shuffle tree of fn, and a block folds its 8 warps through
// shared memory. Lanes that hold no element hold the identity.
//
// Bound on an H100 SXM (3.35 TB/s): one fn per element against 2-4 bytes
// read, so bytes bound it (the Llama logits [8192, 32000] bf16 read 524 MB:
// ~0.157 ms).
#pragma once

#include "kps_ops.cuh"

namespace ptt_kps {

constexpr int kReduceThreads = 256;
constexpr int kReduceWarps = kReduceThreads / 32;
constexpr int kWarpMaxC = 1024;  // widest row one warp takes

// thread `tid` of `nthreads` folds its share of one row
template <typename Gen>
__device__ __forceinline__ float fold_share(const typename Gen::In* __restrict__ row, int C,
                                            bool vec, int tid, int nthreads) {
  using T = typename Gen::In;
  constexpr int V = 16 / sizeof(T);
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = Gen::identity();
  if (vec) {
    const uint4* w = reinterpret_cast<const uint4*>(row);
    for (int j = tid; j < C / V; j += nthreads) {
      const uint4 r = __ldg(w + j);
      const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = Gen::fn(acc[k], ptt::to_f32(e[k]));
    }
  } else {
    for (int i = tid; i < C; i += nthreads) acc[0] = Gen::fn(acc[0], ptt::to_f32(row[i]));
  }
  float a = acc[0];
#pragma unroll
  for (int k = 1; k < V; ++k) a = Gen::fn(a, acc[k]);
  return a;
}

template <typename Gen>
__device__ __forceinline__ float warp_fold(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = Gen::fn(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

// one warp a row
template <typename Gen>
__global__ void __launch_bounds__(kReduceThreads)
row_reduce_warp(const typename Gen::In* __restrict__ x, float* __restrict__ out, long long rows,
                int C, bool vec) {
  const long long r = blockIdx.x * static_cast<long long>(kReduceWarps) + threadIdx.x / 32;
  if (r >= rows) return;  // the whole warp: no barrier follows
  const float a = warp_fold<Gen>(fold_share<Gen>(x + r * C, C, vec, threadIdx.x % 32, 32));
  if (threadIdx.x % 32 == 0) out[r] = a;
}

// one block a row
template <typename Gen>
__global__ void __launch_bounds__(kReduceThreads)
row_reduce_block(const typename Gen::In* __restrict__ x, float* __restrict__ out, int C,
                 bool vec) {
  __shared__ float part[kReduceWarps];
  const long long r = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float a =
      warp_fold<Gen>(fold_share<Gen>(x + r * C, C, vec, threadIdx.x, kReduceThreads));
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    const float b = warp_fold<Gen>(lane < kReduceWarps ? part[lane] : Gen::identity());
    if (lane == 0) out[r] = b;
  }
}

// x: contiguous [rows, C] of Gen::In; out: fp32 [rows]. Returns
// cudaGetLastError() after the launch.
template <typename Gen>
int launch_row_reduce(const void* x, void* out, long long rows, int C, void* stream) {
  if (rows <= 0) return 0;
  if (C < 0 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  using T = typename Gen::In;
  const bool vec = C % (16 / sizeof(T)) == 0 && aligned16(x);
  const T* xt = static_cast<const T*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= kWarpMaxC)
    row_reduce_warp<Gen><<<static_cast<unsigned>((rows + kReduceWarps - 1) / kReduceWarps),
                           kReduceThreads, 0, st>>>(xt, o, rows, C, vec);
  else
    row_reduce_block<Gen><<<static_cast<unsigned>(rows), kReduceThreads, 0, st>>>(xt, o, C, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ptt_kps
