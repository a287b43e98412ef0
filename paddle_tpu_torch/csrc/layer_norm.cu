// LayerNorm forward and dx backward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/pallas/layer_norm.py `_ln_fwd` (kernel body
// `_fwd_kernel`) and `_ln_bwd` (kernel body `_bwd_kernel`):
//
//   forward   y = (x - mean) * rstd * w (+ b), mean = mean(x),
//             var = mean((x - mean)^2) (two passes, as the Pallas kernel),
//             rstd = rsqrt(var + eps); every step in fp32, one rounding to
//             x's dtype; mean and rstd saved fp32 [rows] for the backward;
//   backward  dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//             with xhat = (x - mean) * rstd and dxhat = dy * w.
//
// The weight and bias are fp32 [H] (the wrapper casts other dtypes), so fp32
// affine parameters beside bf16 rows never promote the output. dw and db are
// cross-row reductions left outside the kernel, as the JAX backward leaves
// them to one XLA reduce. The Pallas kernel's [rows, 256] lane-replicated
// statistics are TPU tiling; here they are [rows].
//
// TPU -> Hopper. The Pallas grid walks blocks of ~2 MB of rows in VMEM, with
// a masked edge block. Here (helpers in norm_common.cuh) one warp owns one
// row (8 rows per 256-thread block, any row count: a block's warps past the
// last row exit), reads the row in 16-byte words when H allows it (H a
// multiple of 8 for bf16 and fp16, of 4 for fp32, 16-byte aligned bases) and one
// element a lane otherwise, and reduces its fp32 sums with warp shuffles: no
// shared memory and no block barrier.
// Any H: the composed path takes every width, so the kernel does too.
//
// Bound on an H100 SXM (3.35 TB/s): a row reduction does ~8 FLOPs an element
// against 4 bytes (bf16 in and out) or 6 (backward: x, dy in, dx out), so
// bytes bound both. At the BERT-base step's rows (x [5120, 768] bf16) the
// forward must move 7.9 MB, ~0.0024 ms, and the backward 11.8 MB, ~0.0035 ms.
// This first design reads the row from device memory once per pass (three in
// the forward, two in the backward); the repeated reads of a 1.5 KB row come
// from L1. Keeping the row in registers, and several rows per warp at small H,
// are the next steps.

#include "norm_common.cuh"

using namespace ptt_norm;

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
              T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
              long long rows, int H, float eps, bool vec) {
  const long long row = blockIdx.x * static_cast<long long>(kWarps) + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: no barrier follows
  const T* xr = x + row * H;
  float s = 0.f;
  walk(xr, xr, H, vec, [&](int, float v, float) { s += v; });
  const float mean = warp_sum(s) / H;
  float ss = 0.f;
  walk(xr, xr, H, vec, [&](int, float v, float) {
    const float d = v - mean;
    ss += d * d;
  });
  const float rstd = rsqrtf(warp_sum(ss) / H + eps);
  write_row(xr, xr, y + row * H, H, vec, [&](int i, float v, float) {
    const float t = (v - mean) * rstd * __ldg(w + i);
    return b ? t + __ldg(b + i) : t;
  });
  if (threadIdx.x % 32 == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx, long long rows, int H, bool vec) {
  const long long row = blockIdx.x * static_cast<long long>(kWarps) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * H;
  const T* dyr = dy + row * H;
  const float mu = mean[row], rs = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  walk(xr, dyr, H, vec, [&](int i, float xv, float dyv) {
    const float dxhat = dyv * __ldg(w + i);
    s1 += dxhat;
    s2 += dxhat * ((xv - mu) * rs);
  });
  const float m1 = warp_sum(s1) / H, m2 = warp_sum(s2) / H;
  write_row(xr, dyr, dx + row * H, H, vec, [&](int i, float xv, float dyv) {
    return rs * (dyv * __ldg(w + i) - m1 - (xv - mu) * rs * m2);
  });
}

template <typename T>
int fwd(const void* x, const void* w, const void* b, void* y, void* mean, void* rstd,
        long long rows, int H, float eps, cudaStream_t st) {
  const bool vec = H % (16 / sizeof(T)) == 0 && aligned16(x) && aligned16(y);
  ln_fwd_kernel<T><<<grid_for(rows), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), rows, H, eps,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const void* w, const void* mean, const void* rstd, const void* dy,
        void* dx, long long rows, int H, cudaStream_t st) {
  const bool vec = H % (16 / sizeof(T)) == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  ln_bwd_kernel<T><<<grid_for(rows), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const T*>(dy), static_cast<T*>(dx), rows, H,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: contiguous [rows, H] in dtype (0 = float32, 1 = bfloat16, 2 =
// float16); w: fp32 [H]; b: fp32 [H] or null (no bias); mean, rstd: fp32
// [rows]. Returns cudaGetLastError() after the launch (0 = success),
// cudaErrorInvalidValue for a dtype it does not take.
int ptt_layer_norm_fwd(const void* x, const void* w, const void* b, void* y, void* mean,
                       void* rstd, long long rows, int H, float eps, int dtype, void* stream) {
  if (rows <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    return fwd<typename decltype(tag)::type>(x, w, b, y, mean, rstd, rows, H, eps, st);
  });
}

// dx [rows, H] in dtype from x and dy (contiguous, same dtype), fp32 w [H]
// and the forward's fp32 mean and rstd [rows]. Same return codes.
int ptt_layer_norm_bwd(const void* x, const void* w, const void* mean, const void* rstd,
                       const void* dy, void* dx, long long rows, int H, int dtype,
                       void* stream) {
  if (rows <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    return bwd<typename decltype(tag)::type>(x, w, mean, rstd, dy, dx, rows, H, st);
  });
}

}  // extern "C"
