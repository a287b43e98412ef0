// Row-normalisation helpers shared by layer_norm.cu and rms_norm.cu: one
// warp owns one row of H elements (8 rows per 256-thread block, or 4 in the
// forwards' persistent grids), reads it in 16-byte words when H and the
// bases allow it and one element a lane otherwise, and reduces its fp32 sums
// with warp shuffles (no shared memory, no block barrier). A 16-bit word is rounded
// two elements at a time (cvt.rn.bf16x2.f32 / cvt.rn.f16x2.f32), the same
// bits as one rounding each.
//
// And the backwards that sum a weight's gradient inside their one launch
// (rms_norm.cu dw; layer_norm.cu dw and db): a cooperative grid of G blocks
// (coop_grid), each writing its fp32 partial of W columns to a [G, W]
// workspace, then one grid-wide barrier and a fold of the G partials spread
// over the grid in a fixed order (fold_partials).

#pragma once

#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

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

// 16 bytes of T from N = 16 / sizeof(T) floats, each rounded once to T
template <typename T>
__device__ __forceinline__ uint4 pack_word(const float* f) {
  uint4 r;
  uint32_t* u = reinterpret_cast<uint32_t*>(&r);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) u[k] = __float_as_uint(f[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
        u[k] = *reinterpret_cast<const uint32_t*>(&p);
      } else {
        const __half2 p = __floats2half2_rn(f[2 * k], f[2 * k + 1]);
        u[k] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
  }
  return r;
}

// the N = 16 / sizeof(T) elements of a 16-byte word in fp32. A bf16 pair
// is one 32-bit word: the low element shifted up, the high one masked (one
// integer op each, where the element-wise conversion takes one and a half)
template <typename T>
__device__ __forceinline__ void unpack_word(const uint4& r, float* f) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  } else {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < static_cast<int>(16 / sizeof(T)); ++k) f[k] = to_f32(e[k]);
  }
}

// N consecutive fp32 weights from a 16-byte aligned address
template <int N>
__device__ __forceinline__ void load_w(const float* __restrict__ w, float* out) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(w + k));
    out[k] = f.x;
    out[k + 1] = f.y;
    out[k + 2] = f.z;
    out[k + 3] = f.w;
  }
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
      float va[N], vb[N];
      unpack_word<T>(__ldg(reinterpret_cast<const uint4*>(a) + w), va);
      unpack_word<T>(__ldg(reinterpret_cast<const uint4*>(b) + w), vb);
#pragma unroll
      for (int k = 0; k < N; ++k) f(w * N + k, va[k], vb[k]);
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
      float va[N], vb[N], o[N];
      unpack_word<T>(__ldg(reinterpret_cast<const uint4*>(a) + w), va);
      unpack_word<T>(__ldg(reinterpret_cast<const uint4*>(b) + w), vb);
#pragma unroll
      for (int k = 0; k < N; ++k) o[k] = g(w * N + k, va[k], vb[k]);
      reinterpret_cast<uint4*>(out)[w] = pack_word<T>(o);
    }
  } else {
    for (int i = lane; i < H; i += 32) out[i] = from_f32<T>(g(i, to_f32(a[i]), to_f32(b[i])));
  }
}

// V consecutive elements of p in fp32: one 16-byte word, or one element
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f32(*p);
  } else {
    unpack_word<T>(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_v(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = from_f32<T>(f[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = pack_word<T>(f);
  }
}

// ---------------------------------------------------------------------------
// the forwards' held row (rms_norm.cu rms_fwd_held, layer_norm.cu
// ln_fwd_held): a persistent grid of kFwdWarps-warp blocks; warp gw walks
// rows gw, gw + TW, ... (TW the grid's warps), NW 16-byte words a lane (word
// j * 32 + lane in buf[j]), with two row buffers: the next row's load is in
// flight while work(buf, row) normalises and stores this one
constexpr int kFwdWarps = 4;

template <typename T, int NW, typename Work>
__device__ __forceinline__ void held_rows(const T* __restrict__ x, long long rows, int H,
                                          Work&& work) {
  const int lane = threadIdx.x % 32;
  const int nw = H / static_cast<int>(16 / sizeof(T));
  const long long tw = static_cast<long long>(gridDim.x) * kFwdWarps;
  auto load = [&](uint4 (&buf)[NW], long long row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j * 32 + lane < nw) buf[j] = __ldg(xr + j * 32 + lane);
  };
  uint4 a[NW], b[NW];
  long long row = blockIdx.x * static_cast<long long>(kFwdWarps) + threadIdx.x / 32;
  if (row < rows) load(a, row);
  for (; row < rows; row += 2 * tw) {
    const long long next = row + tw;
    if (next < rows) load(b, next);
    work(a, row);
    if (next >= rows) break;
    if (next + tw < rows) load(a, next + tw);
    work(b, next);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline dim3 grid_for(long long rows) {
  return dim3(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
}

// ---------------------------------------------------------------------------
// the backwards with a weight's gradient summed in the kernel

// Every block has written its W-column fp32 partial to part[blockIdx.x]. A
// grid-wide barrier (sync[0] counts arrivals; the cooperative launch
// guarantees every block is resident), then block j folds columns [j cpb,
// (j + 1) cpb) into out: 8 columns at a time, thread t summing partials
// t / 8, t / 8 + kBlock / 8, ... of column t % 8 in order, then the lanes by
// shuffles and the warps in order, so the order is fixed and two calls give
// the same bits (no float atomics). sync[1] counts departures: the last block
// out sets both counters back to 0 for the next call on the stream.
template <int kBlock>
__device__ __forceinline__ void fold_partials(const float* part, float* __restrict__ out,
                                              unsigned* sync, int W) {
  __shared__ float red[kBlock / 32][8];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&sync[0], 1u);
    while (atomicAdd(&sync[0], 0u) < gridDim.x) __nanosleep(100);
  }
  __syncthreads();
  __threadfence();
  constexpr int kQ = kBlock / 8;
  const int G = gridDim.x;
  const int cpb = ((W + 7) / 8 + G - 1) / G * 8;
  const int c_begin = blockIdx.x * cpb, c_end = min(W, c_begin + cpb);
  const int cl = threadIdx.x % 8, kq = threadIdx.x / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c8 = c_begin; c8 < c_end; c8 += 8) {
    const int col = c8 + cl;
    float s = 0.f;
    if (col < c_end)
      for (int k = kq; k < G; k += kQ) s += __ldcg(part + static_cast<size_t>(k) * W + col);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 8) red[warp][lane] = s;
    __syncthreads();
    if (threadIdx.x < 8 && c8 + threadIdx.x < c_end) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) t += red[w][threadIdx.x];
      out[c8 + threadIdx.x] = t;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && atomicAdd(&sync[1], 1u) == gridDim.x - 1) {
    atomicExch(&sync[0], 0u);
    atomicExch(&sync[1], 0u);
  }
}

// The SMs and the blocks an SM holds of `kernel` at (threads, smem) on the
// current device (and the shared-memory opt-in past 48 KB), asked of the
// runtime once per (kernel, threads, smem, device) and kept: every launch
// needs them, and the occupancy query costs microseconds of host time.
inline int occupancy(const void* kernel, int threads, size_t smem, int& sms, int& occ) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  using Key = std::tuple<const void*, int, size_t, int>;
  static std::mutex mu;
  static std::map<Key, std::pair<int, int>> known;
  const Key key{kernel, threads, smem, dev};
  std::lock_guard<std::mutex> hold(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    sms = it->second.first;
    occ = it->second.second;
    return 0;
  }
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  known.emplace(key, std::make_pair(sms, occ));
  return 0;
}

// The cooperative grid of `kernel` at (threads, smem): G blocks, every one
// resident at once (the fold waits for all), and at most one per min_rows
// rows; each block owns a contiguous run of rows_per_block rows.
inline int coop_grid(const void* kernel, int threads, size_t smem, long long rows,
                     long long min_rows, int& blocks, long long& rows_per_block) {
  int sms = 0, occ = 0;
  const int err = occupancy(kernel, threads, smem, sms, occ);
  if (err != 0) return err;
  const long long want = std::max(1LL, (rows + min_rows - 1) / min_rows);
  const long long g = std::min<long long>(static_cast<long long>(occ) * sms, want);
  rows_per_block = std::max(1LL, (rows + g - 1) / g);
  blocks = static_cast<int>(std::max(1LL, (rows + rows_per_block - 1) / rows_per_block));
  return 0;
}

}  // namespace ptt_norm
