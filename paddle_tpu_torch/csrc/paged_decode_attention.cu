// Decode-only paged attention for Hopper (sm_90a): the C entries, and the
// kernel on the CUDA cores for the calls the redesigned kernel
// (paged_decode_hopper.cu) does not take.
//
// Replaces paddle_tpu/kernels/pallas/paged_attention.py
// `paged_decode_attention` (kernel body `_decode_kernel`), the attention of the
// two-program engine's decode burst: one query token per sequence,
// q [B, H_q, D], over the head-major block pool [H_kv, num_blocks, bs, D]
// through block_tables [B, nb], attending to keys 0 .. seq_len - 1 of the
// row's table pages (never past its nb pages). GQA: the g = H_q / H_kv query
// heads of a kv head share its pages. A row with seq_len 0 writes zeros.
//
// Routes (ptt_paged_decode_plan reports them; the wrapper counts each):
// bf16 / fp16 with D a multiple of 8 up to 256, pools 16-byte aligned and
// pages of at most 128 keys that fit the ring go to paged_decode_hopper.cu
// (split key ranges, pages through a bulk-copy ring, all 32 lanes on the
// products); fp32, other head dims up to 256, misaligned pools and larger
// pages to the kernel here. Both take any group size g.
//
// TPU -> Hopper (the kernel here). The Pallas grid (B, H_kv, nb) walks the
// table slots in order with m/l/acc in VMEM scratch, and clamps the
// past-end steps' index map to the last used block. CUDA blocks run in no
// order, so one block of 128 threads owns one (batch row, kv head, chunk of
// up to 2048 / D of the group's query rows), reads block_tables[b, j]
// itself and walks only the row's live keys, 32 at a time (a tile may span
// two pages, a page may span several tiles: any page size), loaded into
// fp32 shared tiles with 16-byte loads where D and the pools allow, one
// element at a time where not. Online softmax in shared memory (m, l), the
// rows x D fp32 accumulator in registers (16 a thread).
//
// Bound on an H100 SXM (3.35 TB/s): bytes, as paged_decode_hopper.cu's
// note says. This kernel reads each page once, does the products on the
// FP32 pipes, and does not overlap loads with math.

#include <algorithm>

#include "paged_common.cuh"

namespace ptt_paged_hopper {
bool takes(int dtype, int bs, int D, bool aligned);
int auto_splits(int B, int Hq, int Hkv, int nb);
int rows_per_block(int g);
int plan_stages(int B, int Hq, int Hkv, int bs, int D, int splits);
int max_splits();
int run(const void* q, const void* k_pool, const void* v_pool, const void* tables,
        const void* seq_lens, void* out, void* part, void* tickets, int B, int Hq, int Hkv,
        int NB, int bs, int D, int nb, long long q_sb, long long q_sh, int splits, float scale,
        int dtype, cudaStream_t stream);
}  // namespace ptt_paged_hopper

namespace {

using namespace ptt_paged;

constexpr int kThreads = 128;
constexpr int kMaxD = 256;
constexpr int kKeyTile = 32;                      // keys a tile
constexpr int kMaxAcc = 16;                       // outputs a thread: rows * D <= 2048
constexpr int kMaxRowsD = kMaxAcc * kThreads;

int rows_per_block(int g, int D) { return std::max(1, std::min(g, kMaxRowsD / D)); }

// keys [t0, t0 + kc) of the row (pages through the table) -> shared fp32
// with row stride ld: 16-byte words when `vec`, else one element a thread
template <typename T>
__device__ __forceinline__ void load_keys(const T* __restrict__ pool, const int* table,
                                          size_t head, int bs, int D, int t0, int kc, float* dst,
                                          int ld, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int per = vec ? D / kVec : D;
  for (int e = threadIdx.x; e < kc * per; e += kThreads) {
    const int kk = e / per, w = e % per, key = t0 + kk;
    const T* row = pool + ((head + table[key / bs]) * bs + key % bs) * static_cast<size_t>(D);
    float* d = dst + kk * ld;
    if (vec) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + w);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) d[w * kVec + i] = to_f32(x[i]);
    } else {
      d[w] = to_f32(row[w]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out, long long q_sb,
                    long long q_sh, int Hq, int Hkv, int NB, int bs, int D, int nb, int rpb,
                    int chunks, float scale, bool vec) {
  extern __shared__ float smem[];
  const int h = blockIdx.x / chunks, chunk = blockIdx.x % chunks, b = blockIdx.y;
  const int g = Hq / Hkv;
  const int row0 = chunk * rpb, rows = min(rpb, g - row0);
  const int ldk = D + 1;  // padded K rows: lanes on consecutive keys hit distinct banks
  float* Qs = smem;                  // [rpb, D + 1], pre-scaled
  float* Ks = Qs + rpb * ldk;        // [kKeyTile, D + 1]
  float* Vs = Ks + kKeyTile * ldk;   // [kKeyTile, D]
  float* Ps = Vs + kKeyTile * D;     // [rpb, kKeyTile] scores, then probabilities
  float* m_s = Ps + rpb * kKeyTile;  // [rpb] running max
  float* l_s = m_s + rpb;            // [rpb] running denominator
  float* a_s = l_s + rpb;            // [rpb] this tile's rescale factor

  const int len = seq_lens[b];
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int f = e / D, d = e % D;
    Qs[f * ldk + d] = to_f32(q[b * q_sb + (h * g + row0 + f) * q_sh + d]) * scale;
  }
  if (threadIdx.x < rows) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  // the row's live keys: never past its table's nb pages
  const int n_keys = len <= 0 ? 0 : min(len, nb * bs);
  __syncthreads();

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const int* table = tables + static_cast<size_t>(b) * nb;
  const size_t head = static_cast<size_t>(h) * NB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t0 = 0; t0 < n_keys; t0 += kKeyTile) {
    const int kc = min(kKeyTile, n_keys - t0);
    load_keys(k_pool, table, head, bs, D, t0, kc, Ks, ldk, vec);
    load_keys(v_pool, table, head, bs, D, t0, kc, Vs, D, vec);
    __syncthreads();

    // s = q . k for the tile's live keys; the rest keep kNegInf
    for (int e = threadIdx.x; e < rows * kKeyTile; e += kThreads) {
      const int f = e / kKeyTile, k = e % kKeyTile;
      float s = kNegInf;
      if (k < kc) {
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
    for (int f = warp; f < rows; f += kThreads / 32) {
      float* pr = Ps + f * kKeyTile;
      const float mx = warp_max(lane < kc ? pr[lane] : kNegInf);
      const float m_prev = m_s[f];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < kc ? expf(pr[lane] - m_new) : 0.f;
      pr[lane] = p;
      const float sum = warp_sum(p);
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
      if (f < rows) {
        const float* pr = Ps + f * kKeyTile;
        float a = acc[i] * a_s[f];
        for (int k = 0; k < kc; ++k) a = fmaf(pr[k], Vs[k * D + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();  // the next tile overwrites Ks / Vs / Ps
  }

  // out [B, H_q, D] contiguous; a row that saw no key writes zeros
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int f = e / D, d = e % D;
    if (f < rows) {
      const float l = l_s[f];
      const bool dead = (l == 0.f) || (m_s[f] <= kNegInf * 0.5f);
      out[(static_cast<size_t>(b) * Hq + h * g + row0 + f) * D + d] =
          from_f32<T>(dead ? 0.f : acc[i] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* seq_lens, void* out, int B, int Hq, int Hkv, int NB, int bs, int D, int nb,
           long long q_sb, long long q_sh, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const int rpb = rows_per_block(g, D), chunks = (g + rpb - 1) / rpb;
  const size_t smem = sizeof(float) * (static_cast<size_t>(rpb) * (D + 1) +
                                       static_cast<size_t>(kKeyTile) * (2 * D + 1) +
                                       static_cast<size_t>(rpb) * kKeyTile + 3 * rpb);
  static size_t smem_allowed = 48 * 1024;  // raised once per larger request
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const bool vec = D % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  dim3 grid(Hkv * chunks, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(seq_lens), static_cast<T*>(out),
      q_sb, q_sh, Hq, Hkv, NB, bs, D, nb, rpb, chunks, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// q: [B, H_q, D] with element strides q_sb (batch) and q_sh (head) and a unit
// stride over D; pools contiguous [H_kv, NB, bs, D] of q's dtype;
// block_tables int32 [B, nb]; seq_lens int32 [B]; out contiguous [B, H_q, D].
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. splits: on the "bulk-ring"
// route (ptt_paged_decode_plan), the splits of a row's pages (1 to 16; 0
// takes the plan's); with more than one, part (fp32 [B, H_kv, chunks,
// splits, rows, D + 2], from the plan) and tickets (uint32 [B, H_kv,
// chunks], zero before the call and left zero; calls that share them run
// on one stream) are the scratch the splits merge through. The other route
// takes splits 0 or 1. Returns cudaGetLastError() after the launch (0 =
// success), or cudaErrorInvalidValue before any launch for what the kernels
// do not take: H_q not a multiple of H_kv, head_dim above 256, a split
// count the route does not take.
int ptt_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* tables, const void* seq_lens, void* out, void* part,
                               void* tickets, int B, int Hq, int Hkv, int NB, int bs, int D,
                               int nb, long long q_sb, long long q_sh, int splits, float scale,
                               int dtype, void* stream) {
  if (B == 0 || Hq == 0) return 0;
  if (dtype < 0 || dtype > 2 || Hkv <= 0 || Hq % Hkv != 0 || D < 1 || D > kMaxD || bs < 1 ||
      nb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(k_pool) && aligned16(v_pool);
  if (ptt_paged_hopper::takes(dtype, bs, D, aligned)) {
    if (splits == 0) splits = ptt_paged_hopper::auto_splits(B, Hq, Hkv, nb);
    return ptt_paged_hopper::run(q, k_pool, v_pool, tables, seq_lens, out, part, tickets, B, Hq,
                                 Hkv, NB, bs, D, nb, q_sb, q_sh, splits, scale, dtype, s);
  }
  if (splits > 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(dtype, [&](auto tag) {
    return launch<typename decltype(tag)::type>(q, k_pool, v_pool, tables, seq_lens, out, B, Hq,
                                                Hkv, NB, bs, D, nb, q_sb, q_sh, scale, s);
  });
}

// How a call of these shapes is served (no data is read): out[0] the route
// (2 = paged_decode_hopper.cu, 0 = the kernel here), out[1] the query rows
// a block, out[2] the ring's stages (0 on the route here), out[3] the split
// count the plan takes (1 on the route here), out[4] the most splits the
// route takes. aligned: both pools 16-byte aligned.
int ptt_paged_decode_plan(int B, int Hq, int Hkv, int bs, int D, int nb, int dtype, int aligned,
                          int* out) {
  if (dtype < 0 || dtype > 2 || Hkv <= 0 || Hq % Hkv != 0 || D < 1 || D > kMaxD || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = Hq / Hkv;
  if (ptt_paged_hopper::takes(dtype, bs, D, aligned != 0)) {
    out[0] = 2;
    out[1] = ptt_paged_hopper::rows_per_block(g);
    out[3] = ptt_paged_hopper::auto_splits(B, Hq, Hkv, nb);
    out[2] = ptt_paged_hopper::plan_stages(B, Hq, Hkv, bs, D, out[3]);
    out[4] = ptt_paged_hopper::max_splits();
  } else {
    out[0] = 0;
    out[1] = rows_per_block(g, D);
    out[2] = 0;
    out[3] = 1;
    out[4] = 1;
  }
  return 0;
}

}  // extern "C"
