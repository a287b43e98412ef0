// Decode-only paged attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/pallas/paged_attention.py
// `paged_decode_attention` (kernel body `_decode_kernel`), the attention of the
// two-program engine's decode burst: one query token per sequence,
// q [B, H_q, D], over the head-major block pool [H_kv, num_blocks, bs, D]
// through block_tables [B, nb], attending to keys 0 .. seq_len - 1. GQA: the
// g = H_q / H_kv query heads of a kv head share its pages. A row with
// seq_len 0 writes zeros.
//
// TPU -> Hopper. The Pallas grid (B, H_kv, nb) walks the table slots in order
// with m/l/acc in VMEM scratch, and clamps the past-end steps' index map to
// the last used block so they cost nothing. CUDA blocks run in no order, so
// one block of 128 threads owns one (batch row, kv head) with its group's g
// query rows, reads block_tables[b, j] itself and loops over only the row's
// used pages, ceil(seq_len / bs) (at most the table's width nb): the loop
// bound replaces the clamp. The online-softmax state (m, l) sits in shared
// memory and the g x D fp32 accumulator in registers (up to 16 per thread).
//
// Bound on an H100 SXM (published peaks at its 700 W limit: 3.35 TB/s, 989
// TFLOP/s bf16 dense): bytes. A row reads 2 * H_kv * ceil(len/bs) * bs * D *
// itemsize bytes of pages and does 4 * D FLOPs per (query head, key), one
// FLOP per byte or less, far below the card's ~295 FLOP/byte ridge. At the
// serving decode shape (B 8, H 16/16, D 128, bs 32, lens 100..640, bf16) the
// pages are ~25 MB, ~0.0074 ms. This first kernel is simple and right: each
// page is read once with 16-byte coalesced loads into fp32 shared tiles,
// products on the FP32 pipes with fp32 accumulation, no load/compute overlap.
// What holds it back: B * H_kv blocks (128 at the serving shape) on 132 SMs,
// each walking up to 20 pages in sequence, so the time follows the longest
// row. Splitting a row's pages over several blocks (split-KV, a second pass
// to merge the partial softmaxes) is the fix, then cp.async/TMA pipelining.

#include "paged_common.cuh"

namespace {

using namespace ptt_paged;

constexpr int kThreads = 128;
constexpr int kMaxD = 128;
constexpr int kMaxRows = 16;                                 // g * D <= kMaxRows * kMaxD
constexpr int kMaxAcc = kMaxRows * kMaxD / kThreads;         // outputs per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out, long long q_sb,
                    long long q_sh, int Hq, int Hkv, int NB, int bs, int D, int nb,
                    float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = Hq / Hkv;
  const int ldk = D + 1;  // padded K rows: lanes on consecutive keys hit distinct banks
  float* Qs = smem;                  // [g, D + 1], pre-scaled
  float* Ks = Qs + g * ldk;          // [bs, D + 1]
  float* Vs = Ks + bs * ldk;         // [bs, D]
  float* Ps = Vs + bs * D;           // [g, bs] scores, then probabilities
  float* m_s = Ps + g * bs;          // [g] running max
  float* l_s = m_s + g;              // [g] running denominator
  float* a_s = l_s + g;              // [g] this page's rescale factor

  const int len = seq_lens[b];
  for (int e = threadIdx.x; e < g * D; e += kThreads) {
    const int f = e / D, d = e % D;
    Qs[f * ldk + d] = to_f32(q[b * q_sb + (h * g + f) * q_sh + d]) * scale;
  }
  if (threadIdx.x < g) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  // the row's used pages, at most the table's width (the TPU grid's extent)
  const int n_pages = len <= 0 ? 0 : min((len + bs - 1) / bs, nb);
  __syncthreads();

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const int* table = tables + static_cast<size_t>(b) * nb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = 0; j < n_pages; ++j) {
    const size_t base = (static_cast<size_t>(h) * NB + table[j]) * bs * D;
    load_page(k_pool + base, Ks, bs, D, ldk, 1.f, kThreads);
    load_page(v_pool + base, Vs, bs, D, D, 1.f, kThreads);
    __syncthreads();

    // s = q . k for keys before len; the rest keep kNegInf
    for (int e = threadIdx.x; e < g * bs; e += kThreads) {
      const int f = e / bs, k = e % bs;
      float s = kNegInf;
      if (j * bs + k < len) {
        const float* qr = Qs + f * ldk;
        const float* kr = Ks + k * ldk;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      Ps[e] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int f = warp; f < g; f += kThreads / 32) {
      float* pr = Ps + f * bs;
      float mx = kNegInf;
      for (int k = lane; k < bs; k += 32) mx = fmaxf(mx, pr[k]);
      mx = warp_max(mx);
      const float m_prev = m_s[f];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int k = lane; k < bs; k += 32) {
        const float p = (j * bs + k < len) ? expf(pr[k] - m_new) : 0.f;
        pr[k] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[f] = l_s[f] * alpha + sum;
        m_s[f] = m_new;
        a_s[f] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v; output e = tid + i * kThreads is (row e / D, col e % D)
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int f = e / D, d = e % D;
      if (f < g) {
        const float* pr = Ps + f * bs;
        float a = acc[i] * a_s[f];
        for (int k = 0; k < bs; ++k) a = fmaf(pr[k], Vs[k * D + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();  // the next page overwrites Ks / Vs / Ps
  }

  // out [B, H_q, D] contiguous; a row that saw no key writes zeros
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int f = e / D, d = e % D;
    if (f < g) {
      const float l = l_s[f];
      const bool dead = (l == 0.f) || (m_s[f] <= kNegInf * 0.5f);
      out[(static_cast<size_t>(b) * Hq + h * g + f) * D + d] =
          from_f32<T>(dead ? 0.f : acc[i] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* seq_lens, void* out, int B, int Hq, int Hkv, int NB, int bs, int D, int nb,
           long long q_sb, long long q_sh, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const size_t smem = sizeof(float) * (static_cast<size_t>(g) * (D + 1) +
                                       static_cast<size_t>(bs) * (D + 1) +
                                       static_cast<size_t>(bs) * D +
                                       static_cast<size_t>(g) * bs + 3 * g);
  static size_t smem_allowed = 48 * 1024;  // raised once per larger request
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  dim3 grid(Hkv, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(seq_lens), static_cast<T*>(out),
      q_sb, q_sh, Hq, Hkv, NB, bs, D, nb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: [B, H_q, D] with element strides q_sb (batch) and q_sh (head) and a unit
// stride over D; pools contiguous [H_kv, NB, bs, D] of q's dtype;
// block_tables int32 [B, nb]; seq_lens int32 [B]; out contiguous [B, H_q, D].
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError()
// after the launch (0 = success), or cudaErrorInvalidValue before any launch for what
// the kernel does not take: H_q not a multiple of H_kv, head_dim above kMaxD
// or not a whole number of 16-byte vectors, a query group with
// g * D > kMaxRows * kMaxD, pools not 16-byte aligned; a page that does not
// fit in shared memory is refused by cudaFuncSetAttribute.
int ptt_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* tables, const void* seq_lens, void* out, int B,
                               int Hq, int Hkv, int NB, int bs, int D, int nb, long long q_sb,
                               long long q_sh, float scale, int dtype, void* stream) {
  if (B == 0 || Hq == 0) return 0;
  const int vec = 16 / (dtype == 0 ? 4 : 2);
  if (dtype < 0 || dtype > 2 || Hkv <= 0 || Hq % Hkv != 0 || D > kMaxD || D % vec != 0 ||
      (Hq / Hkv) * D > kMaxRows * kMaxD || reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    return launch<typename decltype(tag)::type>(q, k_pool, v_pool, tables, seq_lens, out, B, Hq,
                                                Hkv, NB, bs, D, nb, q_sb, q_sh, scale, s);
  });
}

}  // extern "C"
