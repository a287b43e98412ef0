// RMSNorm forward and dx backward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/pallas/rms_norm.py `_rms_fwd` (kernel body
// `_fwd_kernel`) and `_rms_bwd` (kernel body `_bwd_kernel`):
//
//   forward   y = x * rstd * w, rstd = rsqrt(mean(x^2) + eps); every step
//             in fp32, one rounding to x's dtype; rstd saved fp32 [rows];
//   backward  dx = rstd * dy * w - rstd^3 * x * sum(dy * w * x) / H.
//
// The weight is fp32 [H] (the wrapper casts other dtypes), so an fp32 weight
// beside bf16 rows never promotes the output. dw is a cross-row reduction
// left outside the kernel, as the JAX backward leaves it to one XLA reduce.
// The Pallas kernel's [rows, 128] lane-replicated rstd is TPU tiling; here
// it is [rows].
//
// TPU -> Hopper. The Pallas grid walks blocks of ~2 MB of rows in VMEM. Here
// one warp owns one row, as in layer_norm.cu (helpers in norm_common.cuh):
// 8 rows per 256-thread block, any row count, fp32 sums by warp shuffles.
// Where the row is read in 16-byte words (H a multiple of 8 for bf16 and
// fp16, of 4 for fp32, 16-byte aligned bases) and fits kCacheWords words a
// lane (bf16 and fp16 H <= 2048, fp32 H <= 1024), the warp keeps it in
// registers: the forward reads x once and writes y once, the backward reads x and dy once and
// writes dx once (x and dy together are 16 words, 64 registers, a lane at
// bf16 H 2048). Other widths (odd, small, wide, unaligned) read the row
// again for the second pass, one element a lane where needed; those
// re-reads come from L1. The held row is worth its second pair of kernels:
// at x [8192, 2048] bf16 it runs the forward in 0.034 ms and dx in 0.064 ms,
// where the re-reading pair takes 0.042 and 0.073 ms (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).
//
// Bound on an H100 SXM (3.35 TB/s): ~4 FLOPs an element forward and ~7
// backward against 4 bytes (bf16 x in, y out) or 6 (x, dy in, dx out), so
// bytes bound both. At the Llama-1.4B step's rows (x [8192, 2048] bf16) the
// forward must move 67.1 MB, ~0.020 ms, and the backward 100.7 MB,
// ~0.030 ms.

#include "norm_common.cuh"

using namespace ptt_norm;

namespace {

constexpr int kCacheWords = 8;  // 16-byte words of a row a lane holds

// N consecutive fp32 weights from a 16-byte aligned address
template <int N>
__device__ __forceinline__ void load_w(const float* __restrict__ w, float (&out)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(w + k));
    out[k] = f.x;
    out[k + 1] = f.y;
    out[k + 2] = f.z;
    out[k + 3] = f.w;
  }
}

// the row held in registers: H / N words, word j * 32 + lane in buf[j]
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_fwd_cached(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
               float* __restrict__ rstd_out, long long rows, int H, float eps) {
  constexpr int N = 16 / sizeof(T);
  const long long row = blockIdx.x * static_cast<long long>(kWarps) + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: no barrier follows
  const int lane = threadIdx.x % 32;
  const int nw = H / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
  uint4 buf[kCacheWords];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kCacheWords; ++j) {
    const int wi = j * 32 + lane;
    if (wi < nw) {
      buf[j] = __ldg(xr + wi);
      const T* v = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float f = to_f32(v[k]);
        ss += f * f;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / H + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * H);
#pragma unroll
  for (int j = 0; j < kCacheWords; ++j) {
    const int wi = j * 32 + lane;
    if (wi < nw) {
      const T* v = reinterpret_cast<const T*>(&buf[j]);
      float wv[N];
      load_w<N>(w + wi * N, wv);
      uint4 ro;
      T* vo = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int k = 0; k < N; ++k) vo[k] = from_f32<T>(to_f32(v[k]) * rstd * wv[k]);
      yr[wi] = ro;
    }
  }
  if (lane == 0) rstd_out[row] = rstd;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
               float* __restrict__ rstd_out, long long rows, int H, float eps, bool vec) {
  const long long row = blockIdx.x * static_cast<long long>(kWarps) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * H;
  float ss = 0.f;
  walk(xr, xr, H, vec, [&](int, float v, float) { ss += v * v; });
  const float rstd = rsqrtf(warp_sum(ss) / H + eps);
  write_row(xr, xr, y + row * H, H, vec,
            [&](int i, float v, float) { return v * rstd * __ldg(w + i); });
  if (threadIdx.x % 32 == 0) rstd_out[row] = rstd;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_bwd_cached(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ rstd, const T* __restrict__ dy, T* __restrict__ dx,
               long long rows, int H) {
  constexpr int N = 16 / sizeof(T);
  const long long row = blockIdx.x * static_cast<long long>(kWarps) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int nw = H / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
  const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * H);
  uint4 bx[kCacheWords], bd[kCacheWords];
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < kCacheWords; ++j) {
    const int wi = j * 32 + lane;
    if (wi < nw) {
      bx[j] = __ldg(xr + wi);
      bd[j] = __ldg(dyr + wi);
      const T* vx = reinterpret_cast<const T*>(&bx[j]);
      const T* vd = reinterpret_cast<const T*>(&bd[j]);
      float wv[N];
      load_w<N>(w + wi * N, wv);
#pragma unroll
      for (int k = 0; k < N; ++k) dot += to_f32(vd[k]) * wv[k] * to_f32(vx[k]);
    }
  }
  const float rs = rstd[row];
  const float c = rs * rs * rs * warp_sum(dot) / H;
  uint4* dxr = reinterpret_cast<uint4*>(dx + row * H);
#pragma unroll
  for (int j = 0; j < kCacheWords; ++j) {
    const int wi = j * 32 + lane;
    if (wi < nw) {
      const T* vx = reinterpret_cast<const T*>(&bx[j]);
      const T* vd = reinterpret_cast<const T*>(&bd[j]);
      float wv[N];
      load_w<N>(w + wi * N, wv);
      uint4 ro;
      T* vo = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int k = 0; k < N; ++k)
        vo[k] = from_f32<T>(rs * (to_f32(vd[k]) * wv[k]) - c * to_f32(vx[k]));
      dxr[wi] = ro;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ rstd, const T* __restrict__ dy, T* __restrict__ dx,
               long long rows, int H, bool vec) {
  const long long row = blockIdx.x * static_cast<long long>(kWarps) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * H;
  const T* dyr = dy + row * H;
  float dot = 0.f;
  walk(xr, dyr, H, vec, [&](int i, float xv, float dyv) { dot += dyv * __ldg(w + i) * xv; });
  const float rs = rstd[row];
  const float c = rs * rs * rs * warp_sum(dot) / H;
  write_row(xr, dyr, dx + row * H, H, vec, [&](int i, float xv, float dyv) {
    return rs * (dyv * __ldg(w + i)) - c * xv;
  });
}

// the register-resident path: whole 16-byte words, an aligned weight, and a
// row of at most kCacheWords words a lane
bool fits_cache(int H, int n, bool vec, const void* w) {
  return vec && aligned16(w) && H / n <= 32 * kCacheWords;
}

template <typename T>
int fwd(const void* x, const void* w, void* y, void* rstd, long long rows, int H, float eps,
        cudaStream_t st) {
  constexpr int n = 16 / sizeof(T);  // elements per 16-byte word
  const bool vec = H % n == 0 && aligned16(x) && aligned16(y);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* yt = static_cast<T*>(y);
  float* rt = static_cast<float*>(rstd);
  if (fits_cache(H, n, vec, w))
    rms_fwd_cached<T><<<grid_for(rows), kThreads, 0, st>>>(xt, wt, yt, rt, rows, H, eps);
  else
    rms_fwd_kernel<T><<<grid_for(rows), kThreads, 0, st>>>(xt, wt, yt, rt, rows, H, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const void* w, const void* rstd, const void* dy, void* dx,
        long long rows, int H, cudaStream_t st) {
  constexpr int n = 16 / sizeof(T);
  const bool vec = H % n == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* rt = static_cast<const float*>(rstd);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (fits_cache(H, n, vec, w))
    rms_bwd_cached<T><<<grid_for(rows), kThreads, 0, st>>>(xt, wt, rt, dyt, dxt, rows, H);
  else
    rms_bwd_kernel<T><<<grid_for(rows), kThreads, 0, st>>>(xt, wt, rt, dyt, dxt, rows, H, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: contiguous [rows, H] in dtype (0 = float32, 1 = bfloat16, 2 =
// float16); w: fp32 [H]; rstd: fp32 [rows]. Returns cudaGetLastError() after
// the launch (0 = success), cudaErrorInvalidValue for a dtype it does not
// take.
int ptt_rms_norm_fwd(const void* x, const void* w, void* y, void* rstd, long long rows, int H,
                     float eps, int dtype, void* stream) {
  if (rows <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    return fwd<typename decltype(tag)::type>(x, w, y, rstd, rows, H, eps, st);
  });
}

// dx [rows, H] in dtype from x and dy (contiguous, same dtype), fp32 w [H]
// and the forward's fp32 rstd [rows]. Same return codes.
int ptt_rms_norm_bwd(const void* x, const void* w, const void* rstd, const void* dy, void* dx,
                     long long rows, int H, int dtype, void* stream) {
  if (rows <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    return bwd<typename decltype(tag)::type>(x, w, rstd, dy, dx, rows, H, st);
  });
}

}  // extern "C"
