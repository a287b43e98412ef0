// The tile primitives' LayerNorm backward for Hopper (sm_90a): dx, and dg and
// db summed inside the kernel.
//
// Replaces paddle_tpu/kernels/pallas/primitives.py `_ln_bwd_rule` (kernel
// body `_ln_bwd_kernel`):
//
//   xhat = (x - mean) * rstd, dyg = dy * g,
//   dx = (dyg - mean(dyg) - xhat * mean(dyg * xhat)) * rstd  (x's dtype),
//   dg = sum over rows of dy * xhat, db = sum over rows of dy (fp32 [H]),
//
// every step in fp32 from the forward's fp32 mean and rstd [rows]. (The
// forward, `_ln_fwd`, is layer_norm.cu's `ptt_layer_norm_fwd`: the same
// arithmetic.)
//
// TPU -> Hopper. The Pallas grid walks row tiles in order and carries dg and
// db across them in VMEM. Blocks here run in parallel and in no order, so the
// carry becomes: G blocks (about one per SM), each owning a contiguous run of
// rows, each summing dy * xhat and dy per column for its rows in shared
// memory (2 H fp32: 6 KB at H 768, 16 KB at H 2048, 128 KB at H 16384, where
// the block opts in above 48 KB) and writing that [2, H] partial to a
// workspace; the last block to finish, found with __threadfence() and an
// atomic ticket, folds the G partials in block order into dg and db and sets
// the ticket back to 0 for the next call. One launch, no float atomics: a
// row always lands in the same block and every sum runs in a fixed order, so
// two calls give dg and db bit for bit.
//
// A block takes its rows kStepRows at a time: one warp a row forms the row's
// two means (16-byte loads where H allows, warp shuffles), then the threads
// own columns (16 bytes of columns a thread) and walk the step's rows: dx for
// each, and the column sums in registers, added to the block's shared sums
// once a step. The second read of a step's rows comes from L1 / L2.
//
// Bound on an H100 SXM (3.35 TB/s): ~12 FLOPs an element against 6 bytes
// (bf16 x, dy in, dx out), so bytes bound it: at x [8192, 2048] bf16 100.7
// MB, ~0.030 ms. The fold reads G x 2 H fp32 through one block (2.2 MB at H
// 2048 and G 132), which this first design leaves serial.

#include "norm_common.cuh"

using namespace ptt_norm;  // walk, load_v, store_v, warp_sum, by_dtype, aligned16

namespace {

constexpr int kStepRows = 16;  // rows a step, one warp each
constexpr int kBlock = 32 * kStepRows;

struct Step {
  float mu[kStepRows], rs[kStepRows], c1[kStepRows], c2[kStepRows];
};

// the threads own V columns each: dx for the step's nr rows from `base`, and
// the columns' sums of dy * xhat and dy added to the block's (acc_g, acc_b)
template <int V, typename T>
__device__ __forceinline__ void column_pass(const T* __restrict__ x, const float* __restrict__ w,
                                            const T* __restrict__ dy, T* __restrict__ dx,
                                            long long base, int nr, int H, const Step& st,
                                            float* acc_g, float* acc_b) {
  for (int cg = threadIdx.x; cg < H / V; cg += kBlock) {
    const int c0 = cg * V;
    float wv[V], g[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      wv[k] = __ldg(w + c0 + k);
      g[k] = 0.f;
      b[k] = 0.f;
    }
    for (int j = 0; j < nr; ++j) {
      const long long off = (base + j) * H + c0;
      float xv[V], dv[V], o[V];
      load_v<V>(x + off, xv);
      load_v<V>(dy + off, dv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xhat = (xv[k] - st.mu[j]) * st.rs[j];
        o[k] = (dv[k] * wv[k] - st.c1[j] - xhat * st.c2[j]) * st.rs[j];
        g[k] += dv[k] * xhat;
        b[k] += dv[k];
      }
      store_v<V>(dx + off, o);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      acc_g[c0 + k] += g[k];
      acc_b[c0 + k] += b[k];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
kps_ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ dg,
                  float* __restrict__ db, float* __restrict__ part, unsigned int* ticket,
                  long long rows, int H, long long rows_per_block, bool vec) {
  extern __shared__ float acc[];  // acc_g [H], acc_b [H]
  __shared__ Step st;
  __shared__ bool last;
  float* acc_g = acc;
  float* acc_b = acc + H;
  for (int c = threadIdx.x; c < H; c += kBlock) {
    acc_g[c] = 0.f;
    acc_b[c] = 0.f;
  }
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  const int warp = threadIdx.x / 32;
  for (long long base = r0; base < r1; base += kStepRows) {
    const long long r = base + warp;
    if (r < r1) {  // one warp a row: the two means
      const T* xr = x + r * H;
      const T* dyr = dy + r * H;
      const float mu = mean[r], rs = rstd[r];
      float s1 = 0.f, s2 = 0.f;
      walk(xr, dyr, H, vec, [&](int i, float xv, float dyv) {
        const float dyg = dyv * __ldg(w + i);
        s1 += dyg;
        s2 += dyg * ((xv - mu) * rs);
      });
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (threadIdx.x % 32 == 0) {
        st.mu[warp] = mu;
        st.rs[warp] = rs;
        st.c1[warp] = s1 / H;
        st.c2[warp] = s2 / H;
      }
    }
    __syncthreads();
    const int nr = static_cast<int>(min(static_cast<long long>(kStepRows), r1 - base));
    if (vec)
      column_pass<static_cast<int>(16 / sizeof(T)), T>(x, w, dy, dx, base, nr, H, st, acc_g,
                                                      acc_b);
    else
      column_pass<1, T>(x, w, dy, dx, base, nr, H, st, acc_g, acc_b);
    __syncthreads();
  }
  // this block's partial to the workspace, then a ticket
  float* mine = part + static_cast<size_t>(blockIdx.x) * 2 * H;
  for (int c = threadIdx.x; c < H; c += kBlock) {
    mine[c] = acc_g[c];
    mine[H + c] = acc_b[c];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block folds the partials in block order
  for (int c = threadIdx.x; c < H; c += kBlock) {
    float g = 0.f, b = 0.f;
    for (unsigned k = 0; k < gridDim.x; ++k) {
      const float* pk = part + static_cast<size_t>(k) * 2 * H;
      g += __ldcg(pk + c);
      b += __ldcg(pk + H + c);
    }
    dg[c] = g;
    db[c] = b;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T>
int launch(const void* x, const void* w, const void* mean, const void* rstd, const void* dy,
           void* dx, void* dg, void* db, void* part, void* ticket, long long rows, int H,
           int blocks, cudaStream_t st) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(H);
  static size_t smem_allowed = 48 * 1024;  // raised once per larger request
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kps_ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const bool vec = H % (16 / sizeof(T)) == 0 && aligned16(x) && aligned16(dy) && aligned16(dx) &&
                   aligned16(w);
  const long long per_block = (rows + blocks - 1) / blocks;
  kps_ln_bwd_kernel<T><<<blocks, kBlock, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dg), static_cast<float*>(db), static_cast<float*>(part),
      static_cast<unsigned int*>(ticket), rows, H, per_block, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, dy, dx: contiguous [rows, H] in dtype (0 = float32, 1 = bfloat16, 2 =
// float16); w: fp32 [H]; mean, rstd: the forward's fp32 [rows]; dg, db: fp32
// [H]; part: fp32 [blocks, 2, H] workspace; ticket: one 32-bit counter, 0
// before the call and left 0 after it (calls that share a ticket run on one
// stream). Returns cudaGetLastError() after the launch (0 = success),
// cudaErrorInvalidValue for a dtype it does not take or blocks < 1, or the
// error of cudaFuncSetAttribute for an H whose sums do not fit in shared
// memory.
int ptt_kps_layer_norm_bwd(const void* x, const void* w, const void* mean, const void* rstd,
                           const void* dy, void* dx, void* dg, void* db, void* part,
                           void* ticket, long long rows, int H, int blocks, int dtype,
                           void* stream) {
  if (H <= 0) return 0;
  if (blocks < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    return launch<typename decltype(tag)::type>(x, w, mean, rstd, dy, dx, dg, db, part, ticket,
                                                rows, H, blocks, st);
  });
}

}  // extern "C"
