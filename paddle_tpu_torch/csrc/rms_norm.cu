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
// writes dx once. Other widths read the row again for the second pass
// (rms_fwd_kernel, rms_bwd_kernel).
//
// The forward's held row (rms_fwd_held): a persistent grid of the
// blocks the card holds at once; each warp walks rows with the grid's warp
// count as its stride, holds its columns' fp32 weights in registers (loaded
// once a warp, where the first design read two float4 of weights for every
// 16-byte word of x) and keeps two row buffers, so the next row's load is in
// flight while this row is normalised and stored. The row's words are a
// template argument (NW <= kCacheWords a lane), so a narrow row holds only
// the registers it needs. 16-bit words are rounded two elements at a time.
// The first design (one row a warp, then the warp exits: every warp loads,
// reduces, stores, with no overlap of its own reads and writes) took 0.0344
// ms at x [8192, 2048] bf16 and 0.0294 in fp16; this one 0.0296 in both
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phases 19 and 32, PERF.md).
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
// - The fold (norm_common.cuh fold_partials, shared with layer_norm.cu):
//   after a grid-wide barrier, block j folds its own H / G columns over the
//   G partials in a fixed order. No float atomics: two calls give dw bit for
//   bit.
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

#include "norm_common.cuh"

using namespace ptt_norm;

namespace {

constexpr int kCacheWords = 8;  // 16-byte words of a row a lane holds

// the forward's held row (norm_common.cuh held_rows: small blocks, so the
// registers of 168 a thread at bf16 H 2048 still admit three blocks an SM),
// the lane's weights in registers; the sum of squares one partial a word, so
// the words' chains run side by side
template <typename T, int NW>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
rms_fwd_held(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
             float* __restrict__ rstd_out, long long rows, int H, float eps) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int nw = H / N;
  float wv[NW][N];
#pragma unroll
  for (int j = 0; j < NW; ++j)
    if (j * 32 + lane < nw) load_w<N>(w + (j * 32 + lane) * N, wv[j]);
  held_rows<T, NW>(x, rows, H, [&](const uint4 (&buf)[NW], long long row) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j * 32 + lane < nw) {
        float f[N], part = 0.f;
        unpack_word<T>(buf[j], f);
#pragma unroll
        for (int k = 0; k < N; ++k) part += f[k] * f[k];
        ss += part;
      }
    const float rstd = rsqrtf(warp_sum(ss) / H + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * H);
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j * 32 + lane < nw) {
        float f[N];
        unpack_word<T>(buf[j], f);
#pragma unroll
        for (int k = 0; k < N; ++k) f[k] = f[k] * rstd * wv[j][k];
        yr[j * 32 + lane] = pack_word<T>(f);
      }
    if (lane == 0) rstd_out[row] = rstd;
  });
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
      float vx[N], vd[N], wv[N];
      unpack_word<T>(bx[j], vx);
      unpack_word<T>(bd[j], vd);
      load_w<N>(w + wi * N, wv);
#pragma unroll
      for (int k = 0; k < N; ++k) dot += vd[k] * wv[k] * vx[k];
    }
  }
  const float rs = rstd[row];
  const float c = rs * rs * rs * warp_sum(dot) / H;
  uint4* dxr = reinterpret_cast<uint4*>(dx + row * H);
#pragma unroll
  for (int j = 0; j < kCacheWords; ++j) {
    const int wi = j * 32 + lane;
    if (wi < nw) {
      float vx[N], vd[N], wv[N], o[N];
      unpack_word<T>(bx[j], vx);
      unpack_word<T>(bd[j], vd);
      load_w<N>(w + wi * N, wv);
#pragma unroll
      for (int k = 0; k < N; ++k) o[k] = rs * (vd[k] * wv[k]) - c * vx[k];
      dxr[wi] = pack_word<T>(o);
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
        float vx[N], vd[N], wv[N];
        unpack_word<T>(bx[j], vx);
        unpack_word<T>(bd[j], vd);
        load_w<N>(w + wi * N, wv);
#pragma unroll
        for (int k = 0; k < N; ++k) dot += vd[k] * wv[k] * vx[k];
      }
    }
    const float rs = rstd[row];
    const float c = rs * rs * rs * warp_sum(dot) / H;
    uint4* dxr = dx == nullptr ? nullptr : reinterpret_cast<uint4*>(dx + row * H);
#pragma unroll
    for (int j = 0; j < kCacheWords; ++j) {
      const int wi = j * 32 + lane;
      if (wi < nw) {
        float vx[N], vd[N];
        unpack_word<T>(bx[j], vx);
        unpack_word<T>(bd[j], vd);
#pragma unroll
        for (int k = 0; k < N; ++k) acc[j][k] += vd[k] * vx[k] * rs;
        if (dxr != nullptr) {
          float wv[N], o[N];
          load_w<N>(w + wi * N, wv);
#pragma unroll
          for (int k = 0; k < N; ++k) o[k] = rs * (vd[k] * wv[k]) - c * vx[k];
          dxr[wi] = pack_word<T>(o);
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

// rms_fwd_held<T, words> for 1 <= words <= kCacheWords
template <typename T, int NW = 1>
const void* fwd_held_kernel(int words) {
  if constexpr (NW > kCacheWords) {
    return nullptr;
  } else {
    if (words == NW) return reinterpret_cast<const void*>(rms_fwd_held<T, NW>);
    return fwd_held_kernel<T, NW + 1>(words);
  }
}

// The forward's route and grid: the held row (a persistent grid of the blocks
// the card holds at once, at most one a warp a row) for whole aligned 16-byte
// words of at most kCacheWords a lane; else the walk (rms_fwd_kernel, one
// warp a row). Shapes and alignment only.
struct FwdPlan {
  bool held;
  int blocks;
  const void* kernel;
};

template <typename T>
int fwd_plan(long long rows, int H, bool aligned, FwdPlan& p) {
  constexpr int n = 16 / sizeof(T);
  const int words = (H / n + 31) / 32;
  p.held = H % n == 0 && aligned && words <= kCacheWords;
  p.kernel = p.held ? fwd_held_kernel<T>(words)
                    : reinterpret_cast<const void*>(rms_fwd_kernel<T>);
  if (!p.held) {
    p.blocks = static_cast<int>(grid_for(rows).x);
    return 0;
  }
  long long rpb = 0;
  return coop_grid(p.kernel, 32 * kFwdWarps, 0, rows, kFwdWarps, p.blocks, rpb);
}

template <typename T>
int fwd(const void* x, const void* w, void* y, void* rstd, long long rows, int H, float eps,
        cudaStream_t st) {
  constexpr int n = 16 / sizeof(T);  // elements per 16-byte word
  const bool vec = H % n == 0 && aligned16(x) && aligned16(y);
  FwdPlan p{};
  const int err = fwd_plan<T>(rows, H, vec && aligned16(w), p);
  if (err != 0) return err;
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* yt = static_cast<T*>(y);
  float* rt = static_cast<float*>(rstd);
  if (p.held) {
    void* args[] = {&xt, &wt, &yt, &rt, &rows, &H, &eps};
    return static_cast<int>(
        cudaLaunchKernel(p.kernel, dim3(p.blocks), dim3(32 * kFwdWarps), args, 0, st));
  }
  rms_fwd_kernel<T><<<p.blocks, kThreads, 0, st>>>(xt, wt, yt, rt, rows, H, eps, vec);
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
  return coop_grid(p.kernel, p.threads, p.smem, rows, p.held ? kWarps : kStepRows, p.blocks,
                   p.rows_per_block);
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

// The forward's plan for these shapes (no data is read): out[0] 1 for the
// held row, 0 for the walk; out[1] the blocks. aligned: x, y and w all
// 16-byte aligned.
int ptt_rms_norm_fwd_plan(long long rows, int H, int dtype, int aligned, int* out) {
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(dtype, [&](auto tag) {
    FwdPlan p{};
    const int err = fwd_plan<typename decltype(tag)::type>(std::max(rows, 1LL), H, aligned != 0, p);
    out[0] = p.held ? 1 : 0;
    out[1] = p.blocks;
    return err;
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
