// LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/pallas/layer_norm.py `_ln_fwd` (kernel body
// `_fwd_kernel`) and `_ln_bwd` (kernel body `_bwd_kernel`):
//
//   forward   y = (x - mean) * rstd * w (+ b), mean = mean(x),
//             var = mean((x - mean)^2) (two passes, as the Pallas kernel),
//             rstd = rsqrt(var + eps); every step in fp32, one rounding to
//             x's dtype; mean and rstd saved fp32 [rows] for the backward;
//   backward  dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//             with xhat = (x - mean) * rstd and dxhat = dy * w, and in
//             the same launch dw = sum over rows of dy * xhat and
//             db = sum over rows of dy (fp32 [H]).
// The same launches serve the tile primitives' layer_norm
// (paddle_tpu/kernels/pallas/primitives.py `_ln_fwd` → `_ln_fwd_kernel` and
// `_ln_bwd_rule` → `_ln_bwd_kernel`: the same arithmetic with a bias, dg
// and db summed in the kernel).
//
// The weight and bias are fp32 [H] (the wrapper casts other dtypes), so fp32
// affine parameters beside bf16 rows never promote the output. The Pallas
// kernel's [rows, 256] lane-replicated statistics are TPU tiling; here they
// are [rows].
//
// TPU -> Hopper. The Pallas grid walks blocks of ~2 MB of rows in VMEM, with
// a masked edge block. Here (helpers in norm_common.cuh) one warp owns one
// row and reduces its fp32 sums with warp shuffles.
//
// The forward's held row (ln_fwd_held), where the row is whole aligned
// 16-byte words of at most kHeldWords a lane (bf16 and fp16 H <= 2048, fp32
// H <= 1024), on the design of rms_norm.cu's rms_fwd_held: a persistent grid
// of the 4-warp blocks the card holds at once; each warp walks rows with the
// grid's warp count as its stride and keeps two row buffers, so the next
// row's load is in flight while this one is normalised and stored. The row
// is read from device memory once: the mean, then the sum of (x - mean)^2,
// then y, all from the registers; 16-bit words are rounded two elements at
// a time. The fp32 weight and bias: a lane's columns in registers while they
// and the two row buffers fit 160 registers (FwdHeld: bf16 and fp16 H <=
// 1536, every fp32 row held), else in the block's shared memory, loaded
// once a block (16 KB at H 2048) and read as float4: both in registers at
// H 2048 would take 128 registers beside the buffers' 64. The row's words are a
// template argument (NW), so a narrow row holds only the registers it
// needs. A lane sums its elements in the order the walk's 16-byte loads
// take them, so mean and rstd are the walk kernel's bit for bit (the
// sums' chains are hidden under the loads of the other warps' rows).
// Other rows (ln_fwd_kernel, the first design, any H): one warp a row, 8 rows
// per 256-thread block (a block's warps past the last row exit), the row read
// in 16-byte words when H allows it (H a multiple of 8 for bf16 and fp16, of
// 4 for fp32, 16-byte aligned bases) and one element a lane otherwise, three
// passes over it (the repeated reads come from L1), w and b read with __ldg
// for every element.
//
// The backward with dw and db: the JAX backward leaves
// dw = sum over rows of dy * xhat and db = sum over rows of dy (fp32 [H],
// db only with a bias) to one XLA reduce; here they are summed inside the
// launch that forms dx, on the design of rms_norm.cu's dw backward: one
// cooperative launch of G blocks (the blocks the card holds at once), each
// owning a contiguous run of rows.
// - Held rows (ln_bwd_held: whole aligned 16-byte words, at most kHeldWords
//   a lane: bf16 and fp16 H <= 2048, fp32 H <= 1024): a lane owns the same
//   columns in every row its warp walks, so it keeps its dw and db partials
//   in registers across rows. The words a lane holds are a template
//   argument (NW: 3 at BERT's bf16 H 768, so 24 dw and 24 db partials), and
//   with it what the registers afford (Held<T, NW>): two row buffers (the
//   next row's x, dy, mean and rstd load while the current row's dx is
//   formed), the lane's weights held across rows, and two blocks an SM for
//   narrow rows. The block's 8 warps add their partials into one partial in
//   shared memory in warp order.
// - Other rows (ln_bwd_tiled, any width: no limit): steps of 16 rows, one
//   warp a row for the row's two means, then the threads own 16-byte groups
//   of columns across the step's rows (dx, and the columns' dw and db sums in
//   registers) and add them to the block's partial row in a [G, W] fp32
//   workspace (W = 2 H with a bias, H without), each column always by the
//   same thread.
// - The fold (norm_common.cuh fold_partials): after a grid-wide barrier,
//   block j folds its own columns of dw and db over the G partials in a
//   fixed order. No float atomics: two calls give the same bits. The two
//   arrival counters are set back to 0 by the kernel.
// A call that needs neither dw nor db (a frozen weight, no trainable bias)
// takes the dx-only ln_bwd_kernel; a bias-less call writes no db; a frozen x
// skips the dx stores (dx null).
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at x [5120, 768] bf16
// with a bias the launch takes 0.0252 ms at two blocks an SM (0.0270 at
// one; the dx kernel alone 0.0173) against the dx kernel plus composed
// fp32 sums' 0.1153; at [41472, 768] 0.0840 (one block an SM 0.0993)
// against 0.7995 (chip_smoke.py phase 15, profiler/kernels_ab.py).
//
// Bound on an H100 SXM (3.35 TB/s): a row reduction does ~8 FLOPs an element
// against 4 bytes (bf16 in and out) or 6 (backward: x, dy in, dx out; ~13
// FLOPs an element with dw and db), so bytes bound both. At the BERT-base
// step's rows (x [5120, 768] bf16) the forward must move 7.9 MB, ~0.0024 ms,
// and the backward 11.8 MB, ~0.0035 ms; at [8192, 2048] bf16 the forward
// 67.2 MB, ~0.0201 ms.

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

// ---------------------------------------------------------------------------
// the forward's held row
constexpr int kHeldWords = 8;  // 16-byte words of a row a lane holds

// What a lane's registers afford at NW words of the forward's held row (N
// elements a word): two row buffers take 8 registers a word, the fp32
// weight and bias 2 N. They stay in registers up to 160; wider, in shared
// memory.
template <typename T, int NW>
struct FwdHeld {
  static constexpr int N = 16 / sizeof(T);
  static constexpr bool kRegs = NW * (8 + 2 * N) <= 160;
};

// N consecutive fp32 values from a 16-byte aligned shared-memory address
template <int N>
__device__ __forceinline__ void load_shared(const float4* p, float* out) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 f = p[k / 4];
    out[k] = f.x;
    out[k + 1] = f.y;
    out[k + 2] = f.z;
    out[k + 3] = f.w;
  }
}

// the rows walked by norm_common.cuh held_rows; w and b (b may be null) in
// registers or, when FwdHeld says they do not fit, in aff4 ([2 H] fp32: w,
// then b)
template <typename T, int NW>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
ln_fwd_held(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
            T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
            long long rows, int H, float eps) {
  using P = FwdHeld<T, NW>;
  constexpr int N = P::N;
  constexpr int WR = P::kRegs ? NW : 1;  // words of the affine held in registers
  extern __shared__ float4 aff4[];
  const int lane = threadIdx.x % 32;
  const int nw = H / N;
  const bool has_b = b != nullptr;
  float wv[WR][N], bv[WR][N];
  if constexpr (P::kRegs) {
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j * 32 + lane < nw) {
        load_w<N>(w + (j * 32 + lane) * N, wv[j]);
        if (has_b) {
          load_w<N>(b + (j * 32 + lane) * N, bv[j]);
        } else {
#pragma unroll
          for (int k = 0; k < N; ++k) bv[j][k] = 0.f;
        }
      }
  } else {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int i = threadIdx.x; i < H / 4; i += 32 * kFwdWarps) {
      aff4[i] = __ldg(w4 + i);
      if (has_b) aff4[H / 4 + i] = __ldg(b4 + i);
    }
    __syncthreads();
  }
  held_rows<T, NW>(x, rows, H, [&](const uint4 (&buf)[NW], long long row) {
    // both sums in the walk's order (word by word, element by element)
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j * 32 + lane < nw) {
        float f[N];
        unpack_word<T>(buf[j], f);
#pragma unroll
        for (int k = 0; k < N; ++k) s += f[k];
      }
    const float mean = warp_sum(s) / H;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j * 32 + lane < nw) {
        float f[N];
        unpack_word<T>(buf[j], f);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float d = f[k] - mean;
          ss += d * d;
        }
      }
    const float rstd = rsqrtf(warp_sum(ss) / H + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * H);
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j * 32 + lane < nw) {
        const int word = j * 32 + lane;
        float f[N], wl[N], bl[N];
        unpack_word<T>(buf[j], f);
        if constexpr (P::kRegs) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            wl[k] = wv[j][k];
            bl[k] = bv[j][k];
          }
        } else {
          load_shared<N>(aff4 + word * N / 4, wl);
          if (has_b) load_shared<N>(aff4 + (H + word * N) / 4, bl);
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float t = (f[k] - mean) * rstd * wl[k];
          f[k] = has_b ? t + bl[k] : t;
        }
        yr[word] = pack_word<T>(f);
      }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  });
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

// ---------------------------------------------------------------------------
// the backward with dw and db summed in the kernel
constexpr int kStepRows = 16;                 // the tiled path: rows a step
constexpr int kTileThreads = 32 * kStepRows;  // one warp a row of the step

// What a lane's registers afford at NW words of a held row (N elements a
// word): two row buffers of x and dy take 16 registers a word, the dw and db
// partials 2 N, the weights N. Narrow rows run two blocks an SM (at most 128
// registers a thread).
template <typename T, int NW>
struct Held {
  static constexpr int N = 16 / sizeof(T);
  static constexpr int kMinBlocks = NW * (16 + 2 * N) <= 96 ? 2 : 1;
  static constexpr int kBudget = kMinBlocks == 2 ? 96 : 168;
  static constexpr bool kHoldW = NW * (16 + 3 * N) <= kBudget;
  static constexpr bool kTwoBuf = kHoldW || NW * (16 + 2 * N) <= kBudget;
};

// The held row: a warp walks rows r0 + warp, r0 + warp + 8, ... of its
// block's run, word j * 32 + lane of each row in buf[j]. The partials go to
// sums' layout: dw at [0, H) when dw_on, db at [db_off, db_off + H) when
// db_off >= 0, W columns in all; dx may be null (x frozen).
template <typename T, int NW>
__global__ void __launch_bounds__(kThreads, (Held<T, NW>::kMinBlocks))
ln_bwd_held(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ mean, const float* __restrict__ rstd,
            const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ sums, float* part,
            unsigned* sync, long long rows, int H, long long rows_per_block, int dw_on,
            int db_off, int W) {
  using P = Held<T, NW>;
  constexpr int N = P::N;
  extern __shared__ float4 blk4[];  // [W / 4]: the block's partial
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = H / N;
  float gw[NW][N], gb[NW][N];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int k = 0; k < N; ++k) gw[j][k] = gb[j][k] = 0.f;
  float wv[P::kHoldW ? NW : 1][N];
  if constexpr (P::kHoldW) {
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j * 32 + lane < nw) load_w<N>(w + (j * 32 + lane) * N, wv[j]);
  }
  auto weights = [&](int j, float (&out)[N]) {
    if constexpr (P::kHoldW) {
#pragma unroll
      for (int k = 0; k < N; ++k) out[k] = wv[j][k];
    } else {
      load_w<N>(w + (j * 32 + lane) * N, out);
    }
  };
  auto load = [&](uint4 (&bx)[NW], uint4 (&bd)[NW], float2& st, long long row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * H);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int wi = j * 32 + lane;
      if (wi < nw) {
        bx[j] = __ldg(xr + wi);
        bd[j] = __ldg(dyr + wi);
      }
    }
    st = make_float2(__ldg(mean + row), __ldg(rstd + row));
  };
  auto work = [&](const uint4 (&bx)[NW], const uint4 (&bd)[NW], float2 st, long long row) {
    const float mu = st.x, rs = st.y;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (j * 32 + lane < nw) {
        float xv[N], dv[N], wl[N], p1 = 0.f, p2 = 0.f;
        unpack_word<T>(bx[j], xv);
        unpack_word<T>(bd[j], dv);
        weights(j, wl);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float xhat = (xv[k] - mu) * rs;
          const float dxhat = dv[k] * wl[k];
          p1 += dxhat;
          p2 += dxhat * xhat;
          gw[j][k] += dv[k] * xhat;
          gb[j][k] += dv[k];
        }
        s1 += p1;  // a partial a word: the words' chains run side by side
        s2 += p2;
      }
    }
    if (dx == nullptr) return;
    const float m1 = warp_sum(s1) / H, m2 = warp_sum(s2) / H;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * H);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int wi = j * 32 + lane;
      if (wi < nw) {
        float xv[N], dv[N], wl[N], o[N];
        unpack_word<T>(bx[j], xv);
        unpack_word<T>(bd[j], dv);
        weights(j, wl);
#pragma unroll
        for (int k = 0; k < N; ++k)
          o[k] = rs * (dv[k] * wl[k] - m1 - (xv[k] - mu) * rs * m2);
        dxr[wi] = pack_word<T>(o);
      }
    }
  };
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  long long row = r0 + warp;
  if constexpr (P::kTwoBuf) {
    uint4 ax[NW], ad[NW], bx[NW], bd[NW];
    float2 as, bs;
    if (row < r1) load(ax, ad, as, row);
    for (; row < r1; row += 2 * kWarps) {
      const long long next = row + kWarps;
      if (next < r1) load(bx, bd, bs, next);
      work(ax, ad, as, row);
      if (next >= r1) break;
      if (next + kWarps < r1) load(ax, ad, as, next + kWarps);
      work(bx, bd, bs, next);
    }
  } else {
    uint4 ax[NW], ad[NW];
    float2 as;
    for (; row < r1; row += kWarps) {
      load(ax, ad, as, row);
      work(ax, ad, as, row);
    }
  }
  // the warps' partials into the block's, in warp order (every warp covers
  // every column: word j * 32 + lane of a row is this lane's in all of them)
  for (int wp = 0; wp < kWarps; ++wp) {
    if (warp == wp) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int wi = j * 32 + lane;
        if (wi < nw) {
#pragma unroll
          for (int k = 0; k < N; k += 4) {
            const int c = (wi * N + k) / 4;
            if (dw_on) {
              const float4 v = make_float4(gw[j][k], gw[j][k + 1], gw[j][k + 2], gw[j][k + 3]);
              float4& d = blk4[c];
              d = wp == 0 ? v : make_float4(d.x + v.x, d.y + v.y, d.z + v.z, d.w + v.w);
            }
            if (db_off >= 0) {
              const float4 v = make_float4(gb[j][k], gb[j][k + 1], gb[j][k + 2], gb[j][k + 3]);
              float4& d = blk4[db_off / 4 + c];
              d = wp == 0 ? v : make_float4(d.x + v.x, d.y + v.y, d.z + v.z, d.w + v.w);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  float4* mine = reinterpret_cast<float4*>(part + static_cast<size_t>(blockIdx.x) * W);
  for (int c = threadIdx.x; c < W / 4; c += kThreads) mine[c] = blk4[c];
  fold_partials<kThreads>(part, sums, sync, W);
}

// any width: steps of kStepRows rows, the column-tiled partial in
// part[blockIdx.x] (V elements a thread a group: a 16-byte word, or one)
template <typename T, int V>
__global__ void __launch_bounds__(kTileThreads, 1)
ln_bwd_tiled(const T* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ sums, float* part,
             unsigned* sync, long long rows, int H, long long rows_per_block, int dw_on,
             int db_off, int W) {
  __shared__ float s_mu[kStepRows], s_rs[kStepRows], s_m1[kStepRows], s_m2[kStepRows];
  const int warp = threadIdx.x / 32;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float* mine = part + static_cast<size_t>(blockIdx.x) * W;
  if (r0 >= r1)
    for (int c = threadIdx.x; c < W; c += kTileThreads) mine[c] = 0.f;
  for (long long base = r0; base < r1; base += kStepRows) {
    const long long r = base + warp;
    if (r < r1) {  // one warp a row: the row's two means
      const float mu = mean[r], rs = rstd[r];
      float s1 = 0.f, s2 = 0.f;
      walk(x + r * H, dy + r * H, H, V > 1, [&](int i, float xv, float dyv) {
        const float dxhat = dyv * __ldg(w + i);
        s1 += dxhat;
        s2 += dxhat * ((xv - mu) * rs);
      });
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (threadIdx.x % 32 == 0) {
        s_mu[warp] = mu;
        s_rs[warp] = rs;
        s_m1[warp] = s1 / H;
        s_m2[warp] = s2 / H;
      }
    }
    __syncthreads();
    const int nr = static_cast<int>(min(static_cast<long long>(kStepRows), r1 - base));
    for (int cg = threadIdx.x; cg < H / V; cg += kTileThreads) {
      const int c0 = cg * V;
      float wv[V], g[V], b[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        wv[k] = __ldg(w + c0 + k);
        g[k] = b[k] = 0.f;
      }
      for (int j = 0; j < nr; ++j) {
        const long long off = (base + j) * H + c0;
        const float mu = s_mu[j], rs = s_rs[j], m1 = s_m1[j], m2 = s_m2[j];
        float xv[V], dv[V], o[V];
        load_v<V>(x + off, xv);
        load_v<V>(dy + off, dv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xhat = (xv[k] - mu) * rs;
          o[k] = rs * (dv[k] * wv[k] - m1 - xhat * m2);
          g[k] += dv[k] * xhat;
          b[k] += dv[k];
        }
        if (dx != nullptr) store_v<V>(dx + off, o);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (dw_on) mine[c0 + k] = base == r0 ? g[k] : mine[c0 + k] + g[k];
        if (db_off >= 0)
          mine[db_off + c0 + k] = base == r0 ? b[k] : mine[db_off + c0 + k] + b[k];
      }
    }
    __syncthreads();
  }
  fold_partials<kTileThreads>(part, sums, sync, W);
}

// ln_fwd_held<T, words> for 1 <= words <= kHeldWords, and whether its w and
// b stay in registers
template <typename T, int NW = 1>
const void* fwd_held_kernel(int words, bool& regs) {
  if constexpr (NW > kHeldWords) {
    return nullptr;
  } else {
    if (words == NW) {
      regs = FwdHeld<T, NW>::kRegs;
      return reinterpret_cast<const void*>(ln_fwd_held<T, NW>);
    }
    return fwd_held_kernel<T, NW + 1>(words, regs);
  }
}

// The forward's route and grid: the held row (a persistent grid of the
// blocks the card holds at once, at most one a warp a row; w and b in
// registers, or 2 H fp32 of shared memory) for whole aligned 16-byte words of
// at most kHeldWords a lane; else the walk (ln_fwd_kernel, one warp a row).
// Shapes and alignment only.
struct FwdPlan {
  bool held;
  int blocks;
  size_t smem;
  const void* kernel;
};

template <typename T>
int fwd_plan(long long rows, int H, bool aligned, FwdPlan& p) {
  constexpr int n = 16 / sizeof(T);
  const int words = (H / n + 31) / 32;
  p.held = H % n == 0 && aligned && words <= kHeldWords;
  p.smem = 0;
  if (!p.held) {
    p.kernel = reinterpret_cast<const void*>(ln_fwd_kernel<T>);
    p.blocks = static_cast<int>(grid_for(rows).x);
    return 0;
  }
  bool regs = true;
  p.kernel = fwd_held_kernel<T>(words, regs);
  if (!regs) p.smem = 2 * sizeof(float) * static_cast<size_t>(H);
  long long rpb = 0;
  return coop_grid(p.kernel, 32 * kFwdWarps, p.smem, rows, kFwdWarps, p.blocks, rpb);
}

template <typename T>
int fwd(const void* x, const void* w, const void* b, void* y, void* mean, void* rstd,
        long long rows, int H, float eps, cudaStream_t st) {
  const bool vec = H % (16 / sizeof(T)) == 0 && aligned16(x) && aligned16(y);
  FwdPlan p{};
  const int err =
      fwd_plan<T>(rows, H, vec && aligned16(w) && (b == nullptr || aligned16(b)), p);
  if (err != 0) return err;
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  float* mt = static_cast<float*>(mean);
  float* rt = static_cast<float*>(rstd);
  if (p.held) {
    void* args[] = {&xt, &wt, &bt, &yt, &mt, &rt, &rows, &H, &eps};
    return static_cast<int>(cudaLaunchKernel(p.kernel, dim3(p.blocks), dim3(32 * kFwdWarps),
                                             args, p.smem, st));
  }
  ln_fwd_kernel<T><<<p.blocks, kThreads, 0, st>>>(xt, wt, bt, yt, mt, rt, rows, H, eps, vec);
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

// ln_bwd_held<T, words> for 1 <= words <= kHeldWords
template <typename T, int NW = 1>
const void* held_kernel(int words) {
  if constexpr (NW > kHeldWords) {
    return nullptr;
  } else {
    if (words == NW) return reinterpret_cast<const void*>(ln_bwd_held<T, NW>);
    return held_kernel<T, NW + 1>(words);
  }
}

// The dw / db backward's route and grid: the held row or the column-tiled
// partial, and G, the blocks the card holds at once for that kernel. Shapes
// and alignment only: the launch and the wrapper's workspace ([G, W] fp32)
// agree on it.
struct BwdPlan {
  bool held;
  int blocks, threads;
  long long rows_per_block;
  size_t smem;
  const void* kernel;
};

template <typename T>
int bwd_plan(long long rows, int H, bool aligned, int W, BwdPlan& p) {
  constexpr int n = 16 / sizeof(T);
  const bool vec = H % n == 0 && aligned;
  const int words = (H / n + 31) / 32;
  p.held = vec && words <= kHeldWords;
  if (p.held) {
    p.kernel = held_kernel<T>(words);
    p.threads = kThreads;
    p.smem = sizeof(float) * static_cast<size_t>(W);
  } else {
    p.kernel = vec ? reinterpret_cast<const void*>(ln_bwd_tiled<T, n>)
                   : reinterpret_cast<const void*>(ln_bwd_tiled<T, 1>);
    p.threads = kTileThreads;
    p.smem = 0;
  }
  return coop_grid(p.kernel, p.threads, p.smem, rows, p.held ? kWarps : kStepRows, p.blocks,
                   p.rows_per_block);
}

template <typename T>
int bwd_sums(const void* x, const void* w, const void* mean, const void* rstd, const void* dy,
             void* dx, void* sums, void* part, void* sync, long long rows, int H, bool need_dw,
             bool need_db, int part_rows, cudaStream_t st) {
  const bool aligned = aligned16(x) && aligned16(dy) && (dx == nullptr || aligned16(dx)) &&
                       aligned16(w);
  int W = H * (need_dw + need_db);
  BwdPlan p{};
  const int err = bwd_plan<T>(rows, H, aligned, W, p);
  if (err != 0) return err;
  if (p.blocks > part_rows || sums == nullptr || part == nullptr || sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* mt = static_cast<const float*>(mean);
  const float* rt = static_cast<const float*>(rstd);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  float* st_ = static_cast<float*>(sums);
  float* pt = static_cast<float*>(part);
  unsigned* syt = static_cast<unsigned*>(sync);
  long long rpb = p.rows_per_block;
  int dw_on = need_dw ? 1 : 0, db_off = need_db ? (need_dw ? H : 0) : -1;
  void* args[] = {&xt, &wt, &mt, &rt, &dyt, &dxt, &st_, &pt, &syt, &rows, &H, &rpb,
                  &dw_on, &db_off, &W};
  return static_cast<int>(cudaLaunchCooperativeKernel(p.kernel, dim3(p.blocks), dim3(p.threads),
                                                      args, p.smem, st));
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

// The forward's plan for these shapes (no data is read): out[0] 1 for the
// held row, 0 for the walk; out[1] the blocks. aligned: x, y, w and b (when
// given) all 16-byte aligned.
int ptt_layer_norm_fwd_plan(long long rows, int H, int dtype, int aligned, int* out) {
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(dtype, [&](auto tag) {
    FwdPlan p{};
    const int err = fwd_plan<typename decltype(tag)::type>(std::max(rows, 1LL), H, aligned != 0, p);
    out[0] = p.held ? 1 : 0;
    out[1] = p.blocks;
    return err;
  });
}

// The backward: dx [rows, H] in dtype from x and dy (contiguous, same
// dtype), fp32 w [H] and the forward's fp32 mean and rstd [rows]; and, in the
// same launch, dw = sum over rows of dy * xhat when need_dw and db = sum over
// rows of dy when need_db, into fp32 sums [W] (dw at [0, H), then db; W = H
// times the sums asked for), through part (fp32 [part_rows, W], part_rows at
// least ptt_layer_norm_bwd_plan's blocks) and sync (two uint32, zero before
// the call and left zero; calls that share them run on one stream). dx may
// be null when a sum is asked for (x needs no gradient); with neither sum,
// the dx-only kernel runs. Same return codes; the cooperative launch's own
// error when the grid cannot be resident.
int ptt_layer_norm_bwd(const void* x, const void* w, const void* mean, const void* rstd,
                       const void* dy, void* dx, void* sums, void* part, void* sync,
                       long long rows, int H, int need_dw, int need_db, int part_rows,
                       int dtype, void* stream) {
  if (H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = H * ((need_dw != 0) + (need_db != 0));
  if (W > 0 && rows <= 0) {
    if (sums == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaMemsetAsync(sums, 0, sizeof(float) * W, st));
  }
  if (rows <= 0) return 0;
  if (W == 0 && dx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (W == 0) return bwd<T>(x, w, mean, rstd, dy, dx, rows, H, st);
    return bwd_sums<T>(x, w, mean, rstd, dy, dx, sums, part, sync, rows, H, need_dw != 0,
                       need_db != 0, part_rows, st);
  });
}

// The dw / db backward's plan for these shapes (no data is read): out[0] 1
// for the held row, 0 for the column-tiled partial; out[1] the blocks G, the
// rows of the part workspace. aligned: x, dy, dx and w all 16-byte
// aligned.
int ptt_layer_norm_bwd_plan(long long rows, int H, int dtype, int aligned, int need_dw,
                            int need_db, int* out) {
  const int W = H * ((need_dw != 0) + (need_db != 0));
  if (H <= 0 || W == 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(dtype, [&](auto tag) {
    BwdPlan p{};
    const int err = bwd_plan<typename decltype(tag)::type>(std::max(rows, 1LL), H, aligned != 0,
                                                           W, p);
    out[0] = p.held ? 1 : 0;
    out[1] = p.blocks;
    return err;
  });
}

}  // extern "C"
