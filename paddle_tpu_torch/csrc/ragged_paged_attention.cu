// Unified ragged prefill+decode paged attention for Hopper (sm_90a): the C
// entries, and the kernel on the CUDA cores for the calls the redesigned
// wgmma kernels (ragged_paged_attention_hopper.cu, 16-bit queries;
// ragged_paged_attention_tf32_hopper.cu, fp32 queries) do not take.
//
// Replaces paddle_tpu/kernels/pallas/ragged_paged_attention.py
// `ragged_paged_attention` (kernel body `_ragged_kernel`): one launch serves a
// mixed batch of decode rows (q_len = 1) and chunked-prefill rows (q_len <= C,
// causal inside the chunk) over the head-major block pool
// [H_kv, num_blocks, bs, D]. Query c of row r sits at absolute position
// kv_len[r] - q_len[r] + c and sees keys at or before it; columns c >= q_len
// and rows that see no key emit zeros.
//
// Routes (ptt_ragged_plan reports them; the wrapper counts each), at every
// page size, where D is a whole number of 16-byte words of the pool type
// and the pools are 16-byte aligned: bf16 / fp16 queries over pools of
// their dtype or int8 / fp8 pools go to the wgmma kernel of
// ragged_paged_attention_hopper.cu, fp32 queries over fp32, int8 or fp8
// pools to the TF32 one of ragged_paged_attention_tf32_hopper.cu (key tiles
// of 32 up to D_pad 128, of 16 at 192 and 256), both at every D up to
// kMaxD (256). The 16-bit kernel takes a
// page size that is a multiple of 8 through its TMA ring and any other
// through its gathered ring; the TF32 kernel gathers every page size. Two
// kinds of call stay on the kernel here, at any D up to 256: D not a whole
// number of 16-byte words (fp32 D 99 or 250, bf16 D 100), and pools that
// are not 16-byte aligned.
//
// Quantized pools (the `quantized=True` body of `_ragged_kernel`): int8 or
// fp8-e4m3 pages with fp32 per-(kv head, page) absmax scales [H_kv, NB],
// dequantized as v * scale[h, page] / qmax (qmax 127 or 448) right after the
// load into the fp32 shared tile, so no float page reaches device memory.
//
// TPU -> Hopper (the kernel here). The Pallas grid (R, H_kv, nb) walks a
// row's table slots in order and carries m/l/acc in VMEM scratch from one
// grid step to the next. CUDA blocks run in no order, so here one block owns
// one (row, kv head, tile of 16 folded (c, g) query rows) and loops INSIDE
// the block over the row's pages, reading block_tables[r, j] itself; the
// online-softmax state (m, l) sits in shared memory and the output
// accumulator in registers (16 a thread up to D 128, 32 up to D 256: two
// instances). The loop bound (the row's used pages, at most the table's
// width, cut further by the tile's last causal column) replaces the TPU
// grid's extent and index-map clamp, so past-end table slots are never
// touched and a decode row costs its own pages, never the batch maximum.
//
// Bound on an H100 SXM (published peaks at its 700 W limit: 3.35 TB/s, 989
// TFLOP/s bf16 dense). Decode rows are bandwidth-bound: a row reads
// 2 * H_kv * ceil(kv_len/bs) * bs * D * itemsize bytes of K/V pages and does
// 4 * D FLOPs per (query head, key). Prefill chunks of 128 queries do ~128x
// the FLOPs on the same bytes and sit near the ridge. The kernel here reads
// each page from device memory once per (block, kv head), with 16-byte
// coalesced loads where D and the pools allow and one element a thread where
// not, converted to fp32 in shared memory, and runs both products on the
// FP32 pipes with fp32 accumulation: no load overlaps the math, no tensor
// cores, and a decode block walks its row's pages in sequence. A whole page
// sits in shared memory, so a large page at a large D is refused.

#include <type_traits>

#include "paged_common.cuh"

namespace {

using namespace ptt_paged;

constexpr int kThreads = 128;
constexpr int kTileRows = 16;                                // folded rows per block
constexpr int kMaxD = 256;
constexpr int kNarrowD = 128;    // the kernel here: the narrower of its two instances

// outputs a thread: kTileRows * D / kThreads, for D up to 128 or up to 256
__host__ __device__ constexpr int acc_regs(int D) { return D <= kNarrowD ? 16 : 32; }

// T: the query and output type (fp32, bf16); P: the pool type (T, or int8 /
// fp8 e4m3 with per-page scales); kMaxAcc: acc_regs of the widest D taken.
// vec: the pools read in 16-byte words (else one element a thread).
template <typename T, typename P, int kMaxAcc>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                              const P* __restrict__ v_pool, const int* __restrict__ tables,
                              const int* __restrict__ q_lens, const int* __restrict__ kv_lens,
                              const float* __restrict__ k_scales,
                              const float* __restrict__ v_scales, T* __restrict__ out, int C,
                              int Hq, int Hkv, int NB, int bs, int D, int nb, float scale,
                              float qmax, bool vec) {
  constexpr bool kQuant = !std::is_same<T, P>::value;
  extern __shared__ float smem[];
  const int tile = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int g = Hq / Hkv;
  const int CG = C * g;
  const int f0 = tile * kTileRows;
  const int ql = q_lens[r];
  const int kl = kv_lens[r];
  // folded row f = c * g + j is live while c < q_len: a prefix of the tile
  const int n_rows = max(0, min(kTileRows, min(CG, ql * g) - f0));
  const int ldk = D + 1;  // padded K rows: lanes on consecutive keys hit distinct banks
  float* Qs = smem;                        // [kTileRows, D + 1], pre-scaled
  float* Ks = Qs + kTileRows * ldk;        // [bs, D + 1]
  float* Vs = Ks + bs * ldk;               // [bs, D]
  float* Ps = Vs + bs * D;                 // [kTileRows, bs] scores, then probabilities
  float* m_s = Ps + kTileRows * bs;        // [kTileRows] running max
  float* l_s = m_s + kTileRows;            // [kTileRows] running denominator
  float* a_s = l_s + kTileRows;            // [kTileRows] this page's rescale factor

  const int qpos0 = kl - ql;  // absolute position of chunk column 0
  int n_pages = 0;
  if (n_rows > 0) {
    for (int e = threadIdx.x; e < n_rows * D; e += kThreads) {
      const int f = f0 + e / D, d = e % D;
      const size_t src = ((static_cast<size_t>(r) * C + f / g) * Hq + h * g + f % g) * D + d;
      Qs[(e / D) * ldk + d] = to_f32(q[src]) * scale;
    }
    if (threadIdx.x < kTileRows) {
      m_s[threadIdx.x] = kNegInf;
      l_s[threadIdx.x] = 0.f;
    }
    const int last_col = qpos0 + (f0 + n_rows - 1) / g;  // the tile's last visible key
    // a row's pages stop at its table's width nb, as the TPU grid does:
    // keys past nb * bs are never read
    const int used = min((kl + bs - 1) / bs, nb);
    n_pages = last_col < 0 ? 0 : min(used, last_col / bs + 1);
  }
  __syncthreads();

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const int* table = tables + static_cast<size_t>(r) * nb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = 0; j < n_pages; ++j) {
    const int page = table[j];
    const size_t base = (static_cast<size_t>(h) * NB + page) * bs * D;
    // the dequantization factor, as the reference forms it: scale / qmax
    const float km = kQuant ? k_scales[static_cast<size_t>(h) * NB + page] / qmax : 1.f;
    const float vm = kQuant ? v_scales[static_cast<size_t>(h) * NB + page] / qmax : 1.f;
    load_page(k_pool + base, Ks, bs, D, ldk, km, kThreads, vec);
    load_page(v_pool + base, Vs, bs, D, D, vm, kThreads, vec);
    __syncthreads();

    // s = q . k over the live rows; masked columns keep kNegInf
    for (int e = threadIdx.x; e < n_rows * bs; e += kThreads) {
      const int f = e / bs, k = e % bs;
      float s = kNegInf;
      if (j * bs + k <= qpos0 + (f0 + f) / g) {
        const float* qr = Qs + f * ldk;
        const float* kr = Ks + k * ldk;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      Ps[e] = s;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int f = warp; f < n_rows; f += kThreads / 32) {
      float* pr = Ps + f * bs;
      float mx = kNegInf;
      for (int k = lane; k < bs; k += 32) mx = fmaxf(mx, pr[k]);
      mx = warp_max(mx);
      const float m_prev = m_s[f];
      const float m_new = fmaxf(m_prev, mx);
      const int qpos = qpos0 + (f0 + f) / g;
      float sum = 0.f;
      for (int k = lane; k < bs; k += 32) {
        const float p = (j * bs + k <= qpos) ? expf(pr[k] - m_new) : 0.f;
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
      if (f < n_rows) {
        const float* pr = Ps + f * bs;
        float a = acc[i] * a_s[f];
        for (int k = 0; k < bs; ++k) a = fmaf(pr[k], Vs[k * D + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();  // the next page overwrites Ks / Vs / Ps
  }

  // every (row, col) of the tile is written: live rows normalized, the rest 0
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int f = e / D, d = e % D;
    if (f < kTileRows && f0 + f < CG) {
      float o = 0.f;
      if (f < n_rows) {
        const float l = l_s[f];
        const bool dead = (l == 0.f) || (m_s[f] <= kNegInf * 0.5f);
        o = dead ? 0.f : acc[i] / l;
      }
      const int ff = f0 + f;
      const size_t dst = ((static_cast<size_t>(r) * C + ff / g) * Hq + h * g + ff % g) * D + d;
      out[dst] = from_f32<T>(o);
    }
  }
}

template <typename T, typename P, int kMaxAcc>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* q_lens, const void* kv_lens, const void* k_scales, const void* v_scales,
           void* out, int R, int C, int Hq, int Hkv, int NB, int bs, int D, int nb, float scale,
           float qmax, bool vec, cudaStream_t stream) {
  const int tiles = (C * (Hq / Hkv) + kTileRows - 1) / kTileRows;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kTileRows) * (D + 1) +
                                       static_cast<size_t>(bs) * (D + 1) +
                                       static_cast<size_t>(bs) * D +
                                       static_cast<size_t>(kTileRows) * bs + 3 * kTileRows);
  auto* kernel = ragged_paged_attention_kernel<T, P, kMaxAcc>;
  static size_t smem_allowed = 48 * 1024;  // raised once per larger request
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  dim3 grid(tiles, Hkv, R);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool), static_cast<const P*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<T*>(out), C, Hq, Hkv, NB, bs, D, nb, scale,
      qmax, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_width(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                 const void* q_lens, const void* kv_lens, const void* k_scales,
                 const void* v_scales, void* out, int R, int C, int Hq, int Hkv, int NB, int bs,
                 int D, int nb, float scale, float qmax, bool vec, cudaStream_t s) {
  if (D <= kNarrowD)
    return launch<T, P, acc_regs(kNarrowD)>(q, k_pool, v_pool, tables, q_lens, kv_lens,
                                              k_scales, v_scales, out, R, C, Hq, Hkv, NB, bs, D,
                                              nb, scale, qmax, vec, s);
  return launch<T, P, acc_regs(kMaxD)>(q, k_pool, v_pool, tables, q_lens, kv_lens, k_scales,
                                       v_scales, out, R, C, Hq, Hkv, NB, bs, D, nb, scale, qmax,
                                       vec, s);
}

template <typename T>
int launch_pool(int pool_dtype, const void* q, const void* k_pool, const void* v_pool,
                const void* tables, const void* q_lens, const void* kv_lens, const void* k_scales,
                const void* v_scales, void* out, int R, int C, int Hq, int Hkv, int NB, int bs,
                int D, int nb, float scale, bool vec, cudaStream_t s) {
  const float qmax = qmax_of(pool_dtype);
  if (pool_dtype == 0)
    return launch_width<T, T>(q, k_pool, v_pool, tables, q_lens, kv_lens, nullptr, nullptr, out,
                              R, C, Hq, Hkv, NB, bs, D, nb, scale, qmax, vec, s);
  if (pool_dtype == 1)
    return launch_width<T, int8_t>(q, k_pool, v_pool, tables, q_lens, kv_lens, k_scales,
                                   v_scales, out, R, C, Hq, Hkv, NB, bs, D, nb, scale, qmax, vec,
                                   s);
  return launch_width<T, __nv_fp8_e4m3>(q, k_pool, v_pool, tables, q_lens, kv_lens, k_scales,
                                        v_scales, out, R, C, Hq, Hkv, NB, bs, D, nb, scale, qmax,
                                        vec, s);
}

}  // namespace

namespace ptt_ragged_hopper {
// ragged_paged_attention_hopper.cu
int query_rows();
int key_tile();
int auto_splits(int R, int C, int Hq, int Hkv, int bs, int nb);
int run(const void* q, const void* k_pool, const void* v_pool, const void* tables,
        const void* q_lens, const void* kv_lens, void* out, const void* k_scales,
        const void* v_scales, void* part_o, void* part_ml, int R, int C, int Hq, int Hkv,
        int NB, int bs, int D, int nb, int splits, float scale, int dtype, int pool_code,
        bool gather, cudaStream_t stream);
}  // namespace ptt_ragged_hopper

namespace ptt_ragged_tf32 {
// ragged_paged_attention_tf32_hopper.cu
int query_rows();
int key_tile(int D);
int auto_splits(int R, int C, int Hq, int Hkv, int bs, int nb, int D);
int run(const void* q, const void* k_pool, const void* v_pool, const void* tables,
        const void* q_lens, const void* kv_lens, void* out, const void* k_scales,
        const void* v_scales, void* part_o, void* part_ml, int R, int C, int Hq, int Hkv,
        int NB, int bs, int D, int nb, int splits, float scale, int pool_code,
        cudaStream_t stream);
}  // namespace ptt_ragged_tf32

namespace {

// The routes' design codes (ptt_ragged_plan out[0]; the wrapper's _DESIGNS):
// the 16-bit wgmma kernel with its pages through a TMA ring, or through a
// gathered ring (a page size that is not a multiple of 8), and the TF32
// kernel (its pages always gathered).
enum Design { kCudaCores = 0, kWgmma = 2, kWgmmaTf32 = 3, kWgmmaGather = 4 };

// The wgmma kernels take D a whole number of 16-byte words of the pool type
// and 16-byte aligned pools, at any page size and every D the entry takes:
// 16-bit queries over any pool, fp32 queries over any pool (the TF32
// kernel, key tiles of 16 at D_pad 192 / 256). On the 16-bit kernel a page
// size that is a multiple of 8 takes the TMA ring (a box lands on whole
// 8-row swizzle atoms), any other the gathered ring; the TF32 kernel
// gathers every page size. The rest (D not whole 16-byte words, misaligned
// pools) goes to the kernel here.
Design route(int dtype, int pool_dtype, int bs, int D, bool aligned) {
  const int vec = 16 / pool_itemsize(pool_dtype, dtype == 0 ? 4 : 2);
  if (D % vec != 0 || !aligned) return kCudaCores;
  if (dtype != 0)
    return bs % 8 != 0 ? kWgmmaGather : kWgmma;
  return kWgmmaTf32;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and out). pool_dtype: 0 =
// pools of q's dtype (k_scales / v_scales unused), 1 = int8, 2 = fp8 e4m3, each with
// fp32 [H_kv, NB] scales; every dtype goes with every pool. bs: any page
// size (the wgmma routes take one that is not a multiple of 8 through a
// gathered ring). splits: on the wgmma routes (ptt_ragged_plan),
// the splits of a row's key tiles (1 to 16; 0 takes the plan's); with more
// than one, part_o (fp32 [R, H_kv, tiles, splits, 64, D]) and part_ml (fp32
// [..., 64, 2]) are the scratch the splits merge through (tiles =
// ceil(C H_q / H_kv / 64)). The CUDA-core route takes splits 0 or 1 and no
// scratch. Returns cudaGetLastError() after the launch (0 = success); the
// caller raises on anything else. Shapes the kernels do not take return
// cudaErrorInvalidValue before any launch: head_dim outside [1, 256], H_q
// not a multiple of H_kv, q or out not 16-byte aligned on a wgmma route, a
// quantized pool without its scales, a split count the route does not take,
// or, on the CUDA-core route, a block_size whose page does not fit in shared
// memory (refused by cudaFuncSetAttribute).
int ptt_ragged_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* tables, const void* q_lens, const void* kv_lens,
                               void* out, const void* k_scales, const void* v_scales,
                               void* part_o, void* part_ml, int R, int C, int Hq, int Hkv,
                               int NB, int bs, int D, int nb, int splits, float scale,
                               int dtype, int pool_dtype, void* stream) {
  if (R == 0 || C == 0) return 0;
  if (dtype < 0 || dtype > 2 || pool_dtype < 0 || pool_dtype > 2 || D < 1 || D > kMaxD ||
      Hkv <= 0 || Hq % Hkv != 0 ||
      (pool_dtype != 0 && (k_scales == nullptr || v_scales == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(k_pool) && aligned16(v_pool);
  const Design design = route(dtype, pool_dtype, bs, D, aligned);
  if (design != kCudaCores) {
    if (!aligned16(q) || !aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
    if (design == kWgmmaTf32) {
      if (splits == 0) splits = ptt_ragged_tf32::auto_splits(R, C, Hq, Hkv, bs, nb, D);
      return ptt_ragged_tf32::run(q, k_pool, v_pool, tables, q_lens, kv_lens, out, k_scales,
                                  v_scales, part_o, part_ml, R, C, Hq, Hkv, NB, bs, D, nb, splits,
                                  scale, pool_dtype, s);
    }
    if (splits == 0) splits = ptt_ragged_hopper::auto_splits(R, C, Hq, Hkv, bs, nb);
    return ptt_ragged_hopper::run(q, k_pool, v_pool, tables, q_lens, kv_lens, out, k_scales,
                                  v_scales, part_o, part_ml, R, C, Hq, Hkv, NB, bs, D, nb, splits,
                                  scale, dtype, pool_dtype, design == kWgmmaGather, s);
  }
  if (splits > 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned && D % (16 / pool_itemsize(pool_dtype, dtype == 0 ? 4 : 2)) == 0;
  return by_dtype(dtype, [&](auto tag) {
    return launch_pool<typename decltype(tag)::type>(pool_dtype, q, k_pool, v_pool, tables,
                                                     q_lens, kv_lens, k_scales, v_scales, out, R,
                                                     C, Hq, Hkv, NB, bs, D, nb, scale, vec, s);
  });
}

// What serves a call with these shapes (codes as above; aligned: both pools
// 16-byte aligned): out[0] the design (0: the CUDA-core kernel here, fp32
// tiles in shared memory; 2: wgmma with the pages through a TMA ring; 3:
// fp32 on the TF32 tensor cores, wgmma with each operand split into two
// TF32 halves and three products for each, the pages gathered key row by
// key row by cp.async (1-byte pages raw) and split in shared memory; 4:
// design 2 with the pages gathered, at a page size that is not a multiple
// of 8), out[1] the folded query rows a block,
// out[2] the keys a tile (the kernel here walks a page at a time), out[3]
// the splits of a row's key tiles the entry takes when given 0. Returns 0,
// or cudaErrorInvalidValue for a dtype code or head dim no kernel takes.
int ptt_ragged_plan(int R, int C, int Hq, int Hkv, int bs, int D, int nb, int dtype,
                    int pool_dtype, int aligned, int* out) {
  if (dtype < 0 || dtype > 2 || pool_dtype < 0 || pool_dtype > 2 || Hkv <= 0 || bs <= 0 ||
      D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const Design design = route(dtype, pool_dtype, bs, D, aligned != 0);
  out[0] = design;
  if (design == kWgmmaTf32) {
    out[1] = ptt_ragged_tf32::query_rows();
    out[2] = ptt_ragged_tf32::key_tile(D);
    out[3] = ptt_ragged_tf32::auto_splits(R, C, Hq, Hkv, bs, nb, D);
  } else if (design != kCudaCores) {
    out[1] = ptt_ragged_hopper::query_rows();
    out[2] = ptt_ragged_hopper::key_tile();
    out[3] = ptt_ragged_hopper::auto_splits(R, C, Hq, Hkv, bs, nb);
  } else {
    out[1] = kTileRows;
    out[2] = bs;
    out[3] = 1;
  }
  return 0;
}

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
