// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/pallas/rms_norm.py `_rms_fwd` (kernel body
// `_fwd_kernel`) and `_rms_bwd` (kernel body `_bwd_kernel`, and the dw
// reduction the JAX backward leaves to XLA):
//
//   forward   y = x * rstd * w, rstd = rsqrt(mean(x^2) + eps); every step
//             in fp32, one rounding to x's dtype; rstd saved fp32 [rows];
//   backward  dx = rstd * dy * w - rstd^3 * x * sum(dy * w * x) / H,
//             dw = sum over rows of dy * x * rstd (fp32 [H]), one launch.
//
// The weight is fp32 [H] (the wrapper casts other dtypes), so an fp32 weight
// beside bf16 rows never promotes the output. The Pallas kernel's
// [rows, 128] lane-replicated rstd is TPU tiling; here it is [rows].
//
// TPU -> Hopper. The Pallas grid walks blocks of ~2 MB of rows in VMEM. Here
// one warp owns one row, as in layer_norm.cu (helpers in norm_common.cuh):
// fp32 sums by warp shuffles, any row count. Where the row is read in
// 16-byte words (H a multiple of 8 for bf16 and fp16, of 4 for fp32,
// 16-byte aligned bases) and fits kCacheWords words a lane (bf16 and fp16
// H <= 2048, fp32 H <= 1024), the warp keeps it in registers: the forward
// reads x once and writes y once, the backward reads x and dy once and
// writes dx once (x and dy together are 16 words, 64 registers, a lane at
// bf16 H 2048). Other widths read the row again for the second pass.
//
// The backward with dw (rms_bwd_dw_*): one cooperative launch of G blocks,
// G the blocks the card holds at once (one an SM for the held row), each
// owning a contiguous run of rows.
// - Held rows: a lane owns the same columns in every row its warp walks, so
//   it keeps its dw partial (64 fp32 at bf16 H 2048) in registers across
//   rows, with no shared-memory traffic a row; the block's 8 warps then add
//   their partials into one [H] partial in warp order. With one block an
//   SM, a warp keeps two row buffers: its next row loads while it works on
//   one (244 registers at bf16, no spills; one buffer took 0.0682 ms where
//   two take 0.0533 in the same call).
// - Other rows (any width: no limit): steps of 16 rows, one warp a row for
//   the row's sum, then the threads own 16-byte groups of columns across
//   the step's rows (dx, and the columns' dw sums in registers) and add them
//   to the block's [H] partial in device memory, each column always by the
//   same thread: a column-tiled partial with no width limit.
// - The fold, spread over the grid: after a grid-wide barrier (an arrival
//   counter; the cooperative launch guarantees every block is resident),
//   block j folds its own H / G columns over the G partials, 8 columns at a
//   time with the partials split over the block's threads, in a fixed
//   order. No float atomics: two calls give dw bit for bit.
// A call that needs no dw (a frozen weight) takes the dx-only kernels
// (rms_bwd_cached, rms_bwd_kernel): a null dw pointer selects them.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at x [8192, 2048] bf16
// the launch takes 0.0533 ms (profiler/kernels_ab.py) against the dx
// kernel plus composed fp32 dw sum's 0.3489 in the same call; at [4096,
// 4096] (the tiled partial) 0.0651, the same as the dx-only kernels
// (chip_smoke.py phase 19).
//
// Bound on an H100 SXM (3.35 TB/s): ~4 FLOPs an element forward and ~7
// backward (dx and dw) against 4 bytes (bf16 x in, y out) or 6 (x, dy in,
// dx out), so bytes bound both. At the Llama-1.4B step's rows (x [8192,
// 2048] bf16) the forward must move 67.1 MB, ~0.020 ms, and the backward
// 100.7 MB, ~0.030 ms.

#include <algorithm>

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

// ---------------------------------------------------------------------------
// the backward with dw summed in the kernel
constexpr int kStepRows = 16;                 // the tiled path: rows a step
constexpr int kTileThreads = 32 * kStepRows;  // one warp a row of the step

// Every block has written its [H] partial to part[blockIdx.x]. A grid-wide
// barrier (sync[0] counts arrivals), then block j folds columns [j cpb,
// (j + 1) cpb): 8 columns at a time, thread t summing partials t / 8,
// t / 8 + kBlock / 8, ... of column t % 8 in order, then the lanes by
// shuffles and the warps in order, so the order is fixed. sync[1] counts
// departures: the last block out sets both counters back to 0.
template <int kBlock>
__device__ __forceinline__ void fold_partials(const float* part, float* __restrict__ dw,
                                              unsigned* sync, int H) {
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
  const int cpb = ((H + 7) / 8 + G - 1) / G * 8;
  const int c_begin = blockIdx.x * cpb, c_end = min(H, c_begin + cpb);
  const int cl = threadIdx.x % 8, kq = threadIdx.x / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c8 = c_begin; c8 < c_end; c8 += 8) {
    const int col = c8 + cl;
    float s = 0.f;
    if (col < c_end)
      for (int k = kq; k < G; k += kQ) s += __ldcg(part + static_cast<size_t>(k) * H + col);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 8) red[warp][lane] = s;
    __syncthreads();
    if (threadIdx.x < 8 && c8 + threadIdx.x < c_end) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) t += red[w][threadIdx.x];
      dw[c8 + threadIdx.x] = t;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && atomicAdd(&sync[1], 1u) == gridDim.x - 1) {
    atomicExch(&sync[0], 0u);
    atomicExch(&sync[1], 0u);
  }
}

// the held row: rms_bwd_cached over a run of rows, each lane's dw partial
// in registers; dx may be null (x frozen)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rms_bwd_dw_cached(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ rstd, const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ dw, float* part, unsigned* sync, long long rows, int H,
                  long long rows_per_block) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ float4 warp_part4[];  // [kWarps][H] fp32
  float* warp_part = reinterpret_cast<float*>(warp_part4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = H / N;
  float acc[kCacheWords][N];
#pragma unroll
  for (int j = 0; j < kCacheWords; ++j)
#pragma unroll
    for (int k = 0; k < N; ++k) acc[j][k] = 0.f;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  // two row buffers: the warp's next row loads while it works on one
  auto load = [&](uint4 (&bx)[kCacheWords], uint4 (&bd)[kCacheWords], long long row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * H);
#pragma unroll
    for (int j = 0; j < kCacheWords; ++j) {
      const int wi = j * 32 + lane;
      if (wi < nw) {
        bx[j] = __ldg(xr + wi);
        bd[j] = __ldg(dyr + wi);
      }
    }
  };
  auto work = [&](const uint4 (&bx)[kCacheWords], const uint4 (&bd)[kCacheWords],
                  long long row) {
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kCacheWords; ++j) {
      const int wi = j * 32 + lane;
      if (wi < nw) {
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
    uint4* dxr = dx == nullptr ? nullptr : reinterpret_cast<uint4*>(dx + row * H);
#pragma unroll
    for (int j = 0; j < kCacheWords; ++j) {
      const int wi = j * 32 + lane;
      if (wi < nw) {
        const T* vx = reinterpret_cast<const T*>(&bx[j]);
        const T* vd = reinterpret_cast<const T*>(&bd[j]);
#pragma unroll
        for (int k = 0; k < N; ++k) acc[j][k] += to_f32(vd[k]) * to_f32(vx[k]) * rs;
        if (dxr != nullptr) {
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
  };
  uint4 ax[kCacheWords], ad[kCacheWords], bx[kCacheWords], bd[kCacheWords];
  long long row = r0 + warp;
  if (row < r1) load(ax, ad, row);
  for (; row < r1; row += 2 * kWarps) {
    const long long next = row + kWarps;
    if (next < r1) load(bx, bd, next);
    work(ax, ad, row);
    if (next >= r1) break;
    if (next + kWarps < r1) load(ax, ad, next + kWarps);
    work(bx, bd, next);
  }
  // the warps' partials, then the block's in warp order
#pragma unroll
  for (int j = 0; j < kCacheWords; ++j) {
    const int wi = j * 32 + lane;
    if (wi < nw)
#pragma unroll
      for (int k = 0; k < N; k += 4)
        warp_part4[(warp * H + wi * N + k) / 4] =
            make_float4(acc[j][k], acc[j][k + 1], acc[j][k + 2], acc[j][k + 3]);
  }
  __syncthreads();
  float* mine = part + static_cast<size_t>(blockIdx.x) * H;
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += warp_part[wp * H + c];
    mine[c] = s;
  }
  fold_partials<kThreads>(part, dw, sync, H);
}

// any width: steps of kStepRows rows, the column-tiled partial in
// part[blockIdx.x] (V elements a thread a group: a 16-byte word, or one)
template <typename T, int V>
__global__ void __launch_bounds__(kTileThreads, 1)
rms_bwd_dw_tiled(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ rstd, const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ dw, float* part, unsigned* sync, long long rows, int H,
                 long long rows_per_block) {
  __shared__ float s_rs[kStepRows], s_c[kStepRows];
  const int warp = threadIdx.x / 32;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float* mine = part + static_cast<size_t>(blockIdx.x) * H;
  if (r0 >= r1)
    for (int c = threadIdx.x; c < H; c += kTileThreads) mine[c] = 0.f;
  for (long long base = r0; base < r1; base += kStepRows) {
    const long long r = base + warp;
    if (r < r1) {  // one warp a row: the row's sum
      float dot = 0.f;
      walk(x + r * H, dy + r * H, H, V > 1,
           [&](int i, float xv, float dyv) { dot += dyv * __ldg(w + i) * xv; });
      dot = warp_sum(dot);
      if (threadIdx.x % 32 == 0) {
        const float rs = rstd[r];
        s_rs[warp] = rs;
        s_c[warp] = rs * rs * rs * dot / H;
      }
    }
    __syncthreads();
    const int nr = static_cast<int>(min(static_cast<long long>(kStepRows), r1 - base));
    for (int cg = threadIdx.x; cg < H / V; cg += kTileThreads) {
      const int c0 = cg * V;
      float wv[V], g[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        wv[k] = __ldg(w + c0 + k);
        g[k] = 0.f;
      }
      for (int j = 0; j < nr; ++j) {
        const long long off = (base + j) * H + c0;
        const float rs = s_rs[j], c = s_c[j];
        float xv[V], dv[V], o[V];
        load_v<V>(x + off, xv);
        load_v<V>(dy + off, dv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          o[k] = rs * (dv[k] * wv[k]) - c * xv[k];
          g[k] += dv[k] * xv[k] * rs;
        }
        if (dx != nullptr) store_v<V>(dx + off, o);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) mine[c0 + k] = base == r0 ? g[k] : mine[c0 + k] + g[k];
    }
    __syncthreads();
  }
  fold_partials<kTileThreads>(part, dw, sync, H);
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

// The dw backward's path and grid: the held row (1) or the column-tiled
// partial (0), and G, the blocks the card holds at once for that kernel
// (every block must be resident: the fold waits for all), at most one a
// warp's row (held) or a step's (tiled). Shapes and alignment only: the
// launch and the wrapper's workspace ([G, H] fp32) agree on it.
struct DwPlan {
  bool held;
  int blocks;
  long long rows_per_block;
  size_t smem;
  const void* kernel;
  int threads;
};

template <typename T>
int dw_plan(long long rows, int H, bool aligned, DwPlan& p) {
  constexpr int n = 16 / sizeof(T);
  const bool vec = H % n == 0 && aligned;
  p.held = vec && H / n <= 32 * kCacheWords;
  if (p.held) {
    p.kernel = reinterpret_cast<const void*>(rms_bwd_dw_cached<T>);
    p.threads = kThreads;
    p.smem = sizeof(float) * kWarps * static_cast<size_t>(H);
  } else {
    p.kernel = vec ? reinterpret_cast<const void*>(rms_bwd_dw_tiled<T, n>)
                   : reinterpret_cast<const void*>(rms_bwd_dw_tiled<T, 1>);
    p.threads = kTileThreads;
    p.smem = 0;
  }
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, p.kernel, p.threads, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long min_rows = p.held ? kWarps : kStepRows;
  const long long want = std::max(1LL, (rows + min_rows - 1) / min_rows);
  const long long g = std::min<long long>(static_cast<long long>(occ) * sms, want);
  p.rows_per_block = std::max(1LL, (rows + g - 1) / g);
  p.blocks = static_cast<int>(std::max(1LL, (rows + p.rows_per_block - 1) / p.rows_per_block));
  return 0;
}

template <typename T>
int bwd_dw(const void* x, const void* w, const void* rstd, const void* dy, void* dx, void* dw,
           void* part, void* sync, long long rows, int H, int part_rows, cudaStream_t st) {
  const bool aligned = aligned16(x) && aligned16(dy) && (dx == nullptr || aligned16(dx)) &&
                       aligned16(w);
  DwPlan p{};
  const int err = dw_plan<T>(rows, H, aligned, p);
  if (err != 0) return err;
  if (p.blocks > part_rows || part == nullptr || sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* rt = static_cast<const float*>(rstd);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  float* dwt = static_cast<float*>(dw);
  float* pt = static_cast<float*>(part);
  unsigned* syt = static_cast<unsigned*>(sync);
  long long rpb = p.rows_per_block;
  void* args[] = {&xt, &wt, &rt, &dyt, &dxt, &dwt, &pt, &syt, &rows, &H, &rpb};
  return static_cast<int>(cudaLaunchCooperativeKernel(p.kernel, dim3(p.blocks), dim3(p.threads),
                                                      args, p.smem, st));
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

// The backward: dx [rows, H] in dtype from x and dy (contiguous, same dtype),
// fp32 w [H] and the forward's fp32 rstd [rows]; and, when dw is not null,
// dw = sum over rows of dy * x * rstd into fp32 dw [H] in the same launch,
// through part (fp32 [part_rows, H], part_rows at least
// ptt_rms_norm_bwd_plan's blocks) and sync (two uint32, zero before the
// call and left zero; calls that share them run on one stream). dx may be
// null when dw is not (x needs no gradient). Same return codes; the
// cooperative launch's own error when the grid cannot be resident.
int ptt_rms_norm_bwd(const void* x, const void* w, const void* rstd, const void* dy, void* dx,
                     void* dw, void* part, void* sync, long long rows, int H, int part_rows,
                     int dtype, void* stream) {
  if (H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dw != nullptr && rows <= 0)
    return static_cast<int>(cudaMemsetAsync(dw, 0, sizeof(float) * H, st));
  if (rows <= 0) return 0;
  if (dw == nullptr && dx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (dw == nullptr) return bwd<T>(x, w, rstd, dy, dx, rows, H, st);
    return bwd_dw<T>(x, w, rstd, dy, dx, dw, part, sync, rows, H, part_rows, st);
  });
}

// The dw backward's plan for these shapes (no data is read): out[0] 1 for
// the held row, 0 for the column-tiled partial; out[1] the blocks G, the
// rows of the part workspace. aligned: x, dy, dx and w all 16-byte aligned.
int ptt_rms_norm_bwd_plan(long long rows, int H, int dtype, int aligned, int* out) {
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(dtype, [&](auto tag) {
    DwPlan p{};
    const int err = dw_plan<typename decltype(tag)::type>(std::max(rows, 1LL), H, aligned != 0, p);
    out[0] = p.held ? 1 : 0;
    out[1] = p.blocks;
    return err;
  });
}

}  // extern "C"
