// Unified ragged prefill+decode paged attention for Hopper, redesigned for
// sm_90a: the kernel for bf16 and fp16 queries over pools of the same dtype
// or over int8 / fp8 e4m3 pools with per-(kv head, page) scales, any page
// size bs and D <= 256 (a pool row whole 16-byte words), read into D_pad
// 64, 128, 192 or 256 (the columns past D arrive as zeros).
// ragged_paged_attention.cu's entry hands it those calls; fp32 queries go
// to the TF32 kernel (ragged_paged_attention_tf32_hopper.cu) or, at D above
// 128, odd D and misaligned pools, to the CUDA-core kernel there
// (ptt_ragged_plan reports the route). This file is compiled once per D_pad
// and page ring (-DPTT_RAGGED_D=<64|128|192|256> -DPTT_RAGGED_GATHER=<0|1>,
// kernels/_build.py), so they build in parallel; the object of D_pad 64
// with the TMA ring also holds the host entries.
//
// Replaces paddle_tpu/kernels/pallas/ragged_paged_attention.py
// `ragged_paged_attention` (kernel body `_ragged_kernel`) for those calls:
// query c of row r sits at absolute position kv_len[r] - q_len[r] + c and
// sees keys at or before it, among the first nb * bs (the row's table);
// columns c >= q_len and rows that see no key are exact zeros. GQA folds a
// kv head's g query heads with the chunk: folded row f = c g + j.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): a decode row
// reads its K / V pages once (bytes-bound: 0.0074 ms for the serving decode
// batch at D 128, 0.0148 at D 256); a prefill chunk does 4 D FLOPs a
// visible (query head, key) pair on the same pages and stays bytes-bound at
// C = 128 (0.0035 ms for phase 3's mixed batch).
//
// Design. One block of 160 threads owns 64 folded rows of one (row, kv
// head), and one split of the row's key tiles: warps 0-3 are one consumer
// warpgroup, warp 4 the producer (no setmaxnreg: at D_pad <= 128 two blocks
// share an SM, so one's epilogue runs under the other's loads; at D_pad 192
// and 256 Q and the two stages take 120 / 160 KB, one block an SM, and the
// 160 threads have up to 255 registers each with no hand-over: the consumer
// holds o[D_pad / 2], 128 fp32 at D_pad 256, beside 32 scores and 16
// registers of p, as the 16-bit flash forward does at that width).
// - Q: the consumer warpgroup loads the 64 folded rows once (16-byte words,
//   rows c >= q_len as zeros) into the 128-byte-swizzled layout wgmma reads
//   (flash_hopper.cuh: chunk c of row r at chunk c ^ (r % 8)), then a proxy
//   fence.
// - Pages through a TMA ring (bs a multiple of 8): a key tile of 64 keys
//   is 64 / bs pages (or a part of one page when bs > 64), each a
//   contiguous [bs, D] slab of the head-major pool, loaded by TMA over the
//   pool seen as rows (h NB + page) bs + key % bs, in boxes of the largest
//   of 64 / 32 / 16 / 8 rows that divides bs (so every box lands on a
//   1024-byte boundary of the swizzled panel). The producer reads
//   block_tables[r, j] itself; a box past the row's used pages loads the
//   row's last used page again (finite values that the mask drops), so no
//   table slot past them is read. Two stages, `full` / `empty` mbarriers.
// - Pages through a gathered ring (any other bs, G; design "wgmma+gather"):
//   no box of whole 8-row swizzle atoms fits such a page, so the whole
//   producer warp copies each key row with cp.async, 16 bytes a lane a copy
//   (flash_hopper.cuh gather_tile): key k of the tile from pool row (h NB +
//   table[k / bs]) bs + k % bs, chunk c of a 16-bit row to chunk c ^ (k %
//   8) of its panel (the swizzle TMA writes), a 1-byte row raw. A key at or
//   past the tile plan's n_keys is zero-filled (no table slot past the used
//   pages is read). The copies arrive on the stage's `full` barrier
//   (cp.async.mbarrier.arrive, 32 arrivals); the consumer fences the proxy
//   (fence.proxy.async) before wgmma reads a tile that cp.async wrote. A
//   1-byte stage carries each key's scale / qmax, not each box's. The same
//   stages, kernel body and splits as the TMA ring, as a compile-time
//   variant: the TMA instances are unchanged. (A TMA box of one key row,
//   which would land on a 128-byte row inside a 1024-byte swizzle atom,
//   was not tried: the gather takes every page size and width in one code
//   path.)
// - Quantized pools: the stage holds the raw 1-byte pages (TMA boxes of
//   whole rows, unswizzled, or gathered rows) and the scale / qmax of each
//   box (or key), written by the producer; the consumer dequantizes K and
//   V into 16-bit swizzled tiles (rounded to T once, as the reference's
//   fp32 values rounded for the tensor cores), frees the stage and runs the
//   products on those tiles. A decode row then reads 1 byte a cached
//   element. At D_pad 256: Q 32 KB, the raw stages 64 KB and the 16-bit
//   tiles 64 KB.
// - Products on wgmma: S = Q K^T (m64n64k16 from the swizzled tiles), the
//   online softmax on the register fragment (a row's max and sum over the
//   quad), P rounded to T as the register A operand of O += P V (V read
//   MN-major; past 128 columns one wgmma a 128 columns, wgmma_rs_cols), O
//   in registers until the epilogue.
// - Split key ranges: when R x H_kv x the query tiles leave more than half
//   the SMs idle (a few long decode rows), the row's key tiles are cut into
//   `splits` contiguous ranges by the table width (auto_splits below, on the
//   host: no device read, no sync). A split writes its rows' unnormalized O, m and l into fp32
//   scratch that the wrapper allocates ([.., 64, D]: true D columns, not
//   D_pad), and ragged_combine_kernel merges
//   them; with one split the block writes the output itself. Dead rows and
//   splits with no key tile write nothing to the scratch: the combine knows
//   them from the same arithmetic (ragged_tile_plan).

#include <algorithm>
#include <type_traits>

#include "flash_hopper.cuh"
#include "paged_common.cuh"

#if !defined(PTT_RAGGED_D) || !defined(PTT_RAGGED_GATHER)
#error "compile once per D_pad and ring: -DPTT_RAGGED_D=<64|128|192|256> -DPTT_RAGGED_GATHER=<0|1>"
#endif

namespace ptt_ragged_hopper {

struct RaggedArgs {
  const void* q;
  const void* k_pool;  // the gathered ring reads the pools itself
  const void* v_pool;
  const float* k_scales;  // quantized pools: fp32 [H_kv, NB] absmax scales
  const float* v_scales;
  float inv_qmax;         // 1 / 127 (int8) or 1 / 448 (fp8 e4m3)
  const int* tables;
  const int* q_lens;
  const int* kv_lens;
  void* out;
  float* part_o;   // [R, H_kv, tiles, splits, 64, D] unnormalized O
  float* part_ml;  // [R, H_kv, tiles, splits, 64, 2] m, l
  int R, C, Hq, Hkv, NB, bs, D, nb, g, tiles, splits, per_split, box_rows;
  float scale;
};

// the kernels at one D_pad and ring (TMA, or gathered: G; each object of
// this file defines its own)
template <int DP, bool G>
int run_width(const RaggedArgs& a, const void* k_pool, const void* v_pool, int pool_code,
              int dtype, cudaStream_t stream);

namespace {

using ptt_flash::bf16;
using ptt_flash::f16;
namespace hw = ptt_flash::hopper;

constexpr int kRows = 64;     // folded query rows a block (one m64 warpgroup)
constexpr int kBN = 64;       // keys a tile
constexpr int kStages = 2;
constexpr int kMaxSplits = 16;  // splits of a row's key tiles the merge takes
constexpr int kThreadsR = 160;  // one consumer warpgroup and the producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// What a (row r, query tile) of folded rows [f0, f0 + 64) does: its live
// rows (c < q_len), the absolute position of chunk column 0, the keys it
// can see (the tile's last live column's causal limit, cut at the row's
// used pages) and their key tiles. The kernel and the combine share it.
struct TilePlan {
  int n_rows, qpos0, n_keys, nkt;
};

__device__ __forceinline__ TilePlan ragged_tile_plan(const RaggedArgs& a, int r, int tile) {
  const int ql = a.q_lens[r], kl = a.kv_lens[r];
  const int CG = a.C * a.g, f0 = tile * kRows;
  TilePlan t{};
  t.n_rows = max(0, min(kRows, min(CG, ql * a.g) - f0));
  t.qpos0 = kl - ql;
  if (t.n_rows > 0) {
    const int last_col = t.qpos0 + (f0 + t.n_rows - 1) / a.g;
    const int used = min((kl + a.bs - 1) / a.bs, a.nb);
    t.n_keys = last_col < 0 ? 0 : min(last_col + 1, used * a.bs);
    t.nkt = (t.n_keys + kBN - 1) / kBN;
  }
  return t;
}

// P: the pool element (T, or int8 / fp8 e4m3). Float pools: a stage is the
// swizzled 16-bit K and V tiles wgmma reads. Quantized pools: a stage holds
// the raw 1-byte pages ([kBN][D], unswizzled) and the scales (a TMA box's,
// or on the gathered ring G each key's), and the consumer dequantizes it
// into kd / vd, the 16-bit tiles wgmma reads.
template <typename T, typename P, int D, bool G>
struct RaggedSmem {
  static constexpr bool kQuant = !std::is_same<T, P>::value;
  static constexpr int kP = D / 64;
  static constexpr int kStageBytes = kBN * D * static_cast<int>(sizeof(P));
  T q[kP][kRows * 64];
  unsigned char k[kStages][kStageBytes];
  unsigned char v[kStages][kStageBytes];
  T kd[kQuant ? kP : 1][kQuant ? kBN * 64 : 64];
  T vd[kQuant ? kP : 1][kQuant ? kBN * 64 : 64];
  float kmul[kStages][G ? kBN : kBN / 8], vmul[kStages][G ? kBN : kBN / 8];  // scale / qmax
  uint64_t full[kStages], empty[kStages];
};

// Generic-proxy writes to shared memory made visible to wgmma (the async
// proxy) that reads them after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warpgroup alone (named barrier 1, 128 threads).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// A stage's raw [kBN][D] 1-byte page rows -> the swizzled 16-bit panels at
// `dst`, each element times its box's (G: its key's) scale / qmax (rounded
// to T once, as the tile wgmma reads).
template <typename T, typename P, int D, bool G>
__device__ __forceinline__ void dequant_tile(const unsigned char* raw, T* dst, const float* mul,
                                             int box_rows) {
  constexpr int kC16 = D / 16;  // 16-element words a row
  for (int e = threadIdx.x; e < kBN * kC16; e += 128) {
    const int row = e / kC16, c16 = e % kC16;
    const uint4 word = *reinterpret_cast<const uint4*>(raw + row * D + 16 * c16);
    const P* x = reinterpret_cast<const P*>(&word);
    const float m = mul[G ? row : row / box_rows];
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = hw::pack2<T>(ptt_paged::to_f32(x[2 * i]) * m, ptt_paged::to_f32(x[2 * i + 1]) * m);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c8 = 2 * c16 + half;  // the 8-column chunk: panel c8 / 8
      unsigned char* panel = reinterpret_cast<unsigned char*>(dst + (c8 / 8) * kBN * 64);
      *reinterpret_cast<uint4*>(panel + row * 128 + (((c8 % 8) ^ (row % 8)) * 16)) =
          make_uint4(h[4 * half], h[4 * half + 1], h[4 * half + 2], h[4 * half + 3]);
    }
  }
}

template <typename T, typename P, int D, bool G>
__global__ void __launch_bounds__(kThreadsR, D > 128 ? 1 : 2)
    ragged_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const RaggedArgs a) {
  using Smem = RaggedSmem<T, P, D, G>;
  constexpr bool kQuant = Smem::kQuant;
  constexpr int kP = D / 64, kS = kStages;
  const int split = blockIdx.x % a.splits, tile = blockIdx.x / a.splits;
  const int h = blockIdx.y, r = blockIdx.z;
  const TilePlan tp = ragged_tile_plan(a, r, tile);
  const int t_begin = split * a.per_split;
  const int t_end = min(t_begin + a.per_split, tp.nkt);
  const int n_tiles = max(0, t_end - t_begin);
  const int f0 = tile * kRows, CG = a.C * a.g;
  T* out = static_cast<T*>(a.out);

  if (n_tiles == 0) {
    // no key for this split: with one split the block writes its rows'
    // zeros, with more the combine does
    if (a.splits == 1) {
      const int rows = min(kRows, CG - f0), words = a.D / 8;
      for (int e = threadIdx.x; e < rows * words; e += kThreadsR) {
        const int ff = f0 + e / words, col = 8 * (e % words);
        T* dst = out + ((static_cast<long long>(r) * a.C + ff / a.g) * a.Hq + h * a.g +
                        ff % a.g) * a.D + col;
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(hw::align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      hw::mbar_init(&sm.full[st], G ? 32 : 1);  // the TMA lane, or the gathering warp
      hw::mbar_init(&sm.empty[st], 4);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (G && threadIdx.x >= 128) {
    // producer: the warp gathers the split's key tiles, a key row at a time
    constexpr int kChunks = D * static_cast<int>(sizeof(P)) / 16;
    const int* table = a.tables + static_cast<long long>(r) * a.nb;
    const int row_bytes = a.D * static_cast<int>(sizeof(P));
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      hw::mbar_wait(&sm.empty[stage], phase ^ 1);
      float* km = sm.kmul[stage];
      float* vm = sm.vmul[stage];
      hw::gather_tile<kBN, kChunks>(
          sm.k[stage], sm.v[stage], static_cast<const unsigned char*>(a.k_pool),
          static_cast<const unsigned char*>(a.v_pool), row_bytes, table, h, a.NB, a.bs,
          t * kBN, tp.n_keys, row_bytes / 16, &sm.full[stage],
          [](int rr, int c) {
            // 1-byte pools: the raw row; 16-bit: the swizzled panels
            return kQuant ? rr * D + 16 * c
                          : (c / 8) * kBN * 128 + rr * 128 + (((c % 8) ^ (rr % 8)) * 16);
          },
          [&](int rr, int page) {
            if (kQuant) {  // the key's scales, as the TMA ring's boxes take them
              const long long s = static_cast<long long>(h) * a.NB + page;
              km[rr] = page < 0 ? 0.f : a.k_scales[s] * a.inv_qmax;
              vm[rr] = page < 0 ? 0.f : a.v_scales[s] * a.inv_qmax;
            }
          });
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  if (threadIdx.x >= 128) {
    // producer: one lane walks the split's key tiles, a box of pages at a time
    if (threadIdx.x != 128) return;
    hw::tma_prefetch_map(&tk);
    hw::tma_prefetch_map(&tv);
    const int* table = a.tables + static_cast<long long>(r) * a.nb;
    const int used = min((a.kv_lens[r] + a.bs - 1) / a.bs, a.nb);
    const int boxes = kBN / a.box_rows;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      hw::mbar_wait(&sm.empty[stage], phase ^ 1);
      int rows[kBN / 8];
      for (int bx = 0; bx < boxes; ++bx) {
        const int key = t * kBN + bx * a.box_rows;
        const int page = table[min(key / a.bs, used - 1)];
        rows[bx] = (h * a.NB + page) * a.bs + key % a.bs;
        if (kQuant) {  // the box's scales, written before the arrival
          sm.kmul[stage][bx] = a.k_scales[static_cast<long long>(h) * a.NB + page] * a.inv_qmax;
          sm.vmul[stage][bx] = a.v_scales[static_cast<long long>(h) * a.NB + page] * a.inv_qmax;
        }
      }
      hw::mbar_arrive_tx(&sm.full[stage], 2 * Smem::kStageBytes);
      for (int bx = 0; bx < boxes; ++bx) {
        if (kQuant) {
          const int off = bx * a.box_rows * D;
          hw::tma_load_2d(&sm.k[stage][off], &tk, &sm.full[stage], 0, rows[bx]);
          hw::tma_load_2d(&sm.v[stage][off], &tv, &sm.full[stage], 0, rows[bx]);
        } else {
          for (int p = 0; p < kP; ++p) {
            const int off = (p * kBN * 64 + bx * a.box_rows * 64) * 2;
            hw::tma_load_2d(&sm.k[stage][off], &tk, &sm.full[stage], 64 * p, rows[bx]);
            hw::tma_load_2d(&sm.v[stage][off], &tv, &sm.full[stage], 64 * p, rows[bx]);
          }
        }
      }
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: the warpgroup's thread t holds folded rows 16 w + l / 4 (+ 8)
  const int t = threadIdx.x, lane = t % 32;
  const T* q = static_cast<const T*>(a.q);
  {
    // Q's live rows into the swizzled panels (zeros elsewhere)
    constexpr int kChunks = D / 8;
    for (int e = t; e < kRows * kChunks; e += 128) {
      const int rr = e / kChunks, c8 = e % kChunks;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (rr < tp.n_rows && 8 * c8 < a.D) {
        const int ff = f0 + rr;
        val = *reinterpret_cast<const uint4*>(
            q + ((static_cast<long long>(r) * a.C + ff / a.g) * a.Hq + h * a.g + ff % a.g) * a.D +
            8 * c8);
      }
      unsigned char* panel = reinterpret_cast<unsigned char*>(sm.q[c8 / 8]);
      *reinterpret_cast<uint4*>(panel + rr * 128 + (((c8 % 8) ^ (rr % 8)) * 16)) = val;
    }
    fence_proxy_async();
    consumer_sync();
  }

  const int frow[2] = {16 * (t / 32) + lane / 4, 16 * (t / 32) + lane / 4 + 8};
  int qpos[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    live[i] = frow[i] < tp.n_rows;
    qpos[i] = live[i] ? tp.qpos0 + (f0 + frow[i]) / a.g : -1;  // a dead row sees no key
  }
  const int key_cap = tp.n_keys;  // keys at or past it are never visible
  float o[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < D / 2; ++c) o[c] = 0.f;
  const uint32_t qbase = hw::smem_u32(sm.q[0]);
  constexpr uint32_t kPanel = kRows * 128, kKPanel = kBN * 128;
  const float neg_inf = __int_as_float(0xff800000);
  const float scale_log2 = a.scale * kLog2e;

  int stage = 0;
  uint32_t phase = 0;
  for (int tt = t_begin; tt < t_end; ++tt) {
    const int k0 = tt * kBN;
    hw::mbar_wait(&sm.full[stage], phase);
    uint32_t kb = hw::smem_u32(sm.k[stage]), vb = hw::smem_u32(sm.v[stage]);
    // the gathered tiles were written by cp.async (the generic proxy)
    if constexpr (G && !kQuant) fence_proxy_async();
    if constexpr (kQuant) {
      // the previous tile's products are done with kd / vd (every warp
      // waited for them); dequantize this stage into them and free it
      consumer_sync();
      dequant_tile<T, P, D, G>(sm.k[stage], sm.kd[0], sm.kmul[stage], a.box_rows);
      dequant_tile<T, P, D, G>(sm.v[stage], sm.vd[0], sm.vmul[stage], a.box_rows);
      fence_proxy_async();
      consumer_sync();
      if (lane == 0) hw::mbar_arrive(&sm.empty[stage]);
      kb = hw::smem_u32(sm.kd[0]);
      vb = hw::smem_u32(sm.vd[0]);
    }
    float s[kBN / 2];
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss<kBN, T>(s, hw::desc_kmajor(qbase, kPanel, kk), hw::desc_kmajor(kb, kKPanel, kk),
                           kk > 0 ? 1 : 0);
    hw::wgmma_commit();
    hw::wgmma_wait_all();
    hw::reg_fence(s);
    // the online softmax in log2 units on the fragment: column 8 j + 2 (l %
    // 4) + e of register 4 j + 2 i + e
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int rg = 0; rg < kBN / 2; ++rg) {
      const int i = (rg / 2) % 2, col = k0 + 8 * (rg / 4) + 2 * (lane % 4) + rg % 2;
      const bool ok = col <= qpos[i] && col < key_cap;
      s[rg] = ok ? s[rg] * scale_log2 : neg_inf;
      mx[i] = fmaxf(mx[i], s[rg]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = hw::quad_max(mx[i]);
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int rg = 0; rg < kBN / 2; ++rg) {
      const int i = (rg / 2) % 2;
      s[rg] = exp2f(s[rg] - m[i]);
      sum[i] += s[rg];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + hw::quad_sum(sum[i]);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) o[c] *= alpha[(c / 2) % 2];
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        pa[j / 2][2 * (j % 2) + i] = hw::pack2<T>(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      hw::wgmma_rs_cols<D, T>(o, pa[kk], vb, kKPanel, kk);
    hw::wgmma_commit();
    hw::wgmma_wait_all();
    hw::reg_fence(o);
    hw::reg_fence(pa);
    __syncwarp();
    if (!kQuant && lane == 0) hw::mbar_arrive(&sm.empty[stage]);
    if (++stage == kS) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (a.splits == 1) {
    // the output: live rows normalized, dead rows (and rows that saw no
    // key) zeros; folded rows past C g do not exist
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ff = f0 + frow[i];
      if (ff >= CG) continue;
      const bool dead = !live[i] || l[i] == 0.f || m[i] <= kNegInf * 0.5f;
      const float inv = dead ? 0.f : 1.f / l[i];
      T* orow = out + ((static_cast<long long>(r) * a.C + ff / a.g) * a.Hq + h * a.g + ff % a.g) *
                          a.D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        if (col < a.D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              hw::pack2<T>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
    return;
  }
  // a split: the live rows' unnormalized O, m and l into the scratch
  const long long blk = ((static_cast<long long>(r) * a.Hkv + h) * a.tiles + tile) * a.splits +
                        split;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const long long row = blk * kRows + frow[i];
    float* po = a.part_o + row * a.D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < a.D)
        *reinterpret_cast<float2*>(po + col) = make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
    }
    if (lane % 4 == 0) *reinterpret_cast<float2*>(a.part_ml + 2 * row) = make_float2(m[i], l[i]);
  }
}

// Merge the splits of one (row, kv head, query tile): O = sum_s O_s 2^(m_s -
// M) / sum_s l_s 2^(m_s - M) over the splits that had key tiles (m in log2
// units, M their greatest); rows past q_len, rows that saw no key and
// folded rows with no split as exact zeros. One thread a live row forms its
// splits' weights (2^(m_s - M) / L) into shared memory; then each thread
// merges 8 columns of a row at a time, its splits' 16-byte loads
// independent of each other, and stores them as one 16-byte word.
template <typename T>
__global__ void __launch_bounds__(128) ragged_combine_kernel(const RaggedArgs a) {
  __shared__ float wts[kRows][kMaxSplits];
  const int tile = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const TilePlan tp = ragged_tile_plan(a, r, tile);
  const int n_splits = tp.nkt > 0 ? min(a.splits, (tp.nkt + a.per_split - 1) / a.per_split) : 0;
  const int f0 = tile * kRows, rows = min(kRows, a.C * a.g - f0);
  const long long blk0 = ((static_cast<long long>(r) * a.Hkv + h) * a.tiles + tile) * a.splits;
  const int f = threadIdx.x;
  if (f < tp.n_rows && n_splits > 0) {
    float m[kMaxSplits], mmax = kNegInf, lsum = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      m[sp] = sp < n_splits ? a.part_ml[2 * ((blk0 + sp) * kRows + f)] : kNegInf;
      mmax = fmaxf(mmax, m[sp]);
    }
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < n_splits) lsum += a.part_ml[2 * ((blk0 + sp) * kRows + f) + 1] * exp2f(m[sp] - mmax);
    const float inv = mmax > kNegInf * 0.5f && lsum > 0.f ? 1.f / lsum : 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) wts[f][sp] = exp2f(m[sp] - mmax) * inv;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  const int words = a.D / 8;
  for (int e = threadIdx.x; e < rows * words; e += 128) {
    const int fr = e / words, col = 8 * (e % words), ff = f0 + fr;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (fr < tp.n_rows) {
      for (int sp = 0; sp < n_splits; ++sp) {
        const float w = wts[fr][sp];
        const float4* src = reinterpret_cast<const float4*>(
            a.part_o + ((blk0 + sp) * kRows + fr) * a.D + col);
        const float4 x = src[0], y = src[1];
        acc[0] += w * x.x;
        acc[1] += w * x.y;
        acc[2] += w * x.z;
        acc[3] += w * x.w;
        acc[4] += w * y.x;
        acc[5] += w * y.y;
        acc[6] += w * y.z;
        acc[7] += w * y.w;
      }
    }
    uint4 word;
    word.x = hw::pack2<T>(acc[0], acc[1]);
    word.y = hw::pack2<T>(acc[2], acc[3]);
    word.z = hw::pack2<T>(acc[4], acc[5]);
    word.w = hw::pack2<T>(acc[6], acc[7]);
    *reinterpret_cast<uint4*>(
        out + ((static_cast<long long>(r) * a.C + ff / a.g) * a.Hq + h * a.g + ff % a.g) * a.D +
        col) = word;
  }
}

// A 2-D tensor map over the pool seen as [H_kv NB bs rows, D]. 16-bit pools:
// boxes of 64 columns x box_rows rows, 128-byte swizzle (the tile wgmma
// reads). 1-byte pools: boxes of all D_pad columns, unswizzled (the
// consumer dequantizes them). The columns past D arrive as zeros.
int encode_pool(CUtensorMap* map, const void* pool, long long rows, int D, int d_pad,
                int pool_code, int dtype, int box_rows) {
  const hw::EncodeTiled fn = hw::encoder();
  if (fn == nullptr) return hw::kErrTensorMap;
  const bool quant = pool_code != 0;
  const int item = quant ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * item};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(quant ? d_pad : 64),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType type = quant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : dtype == ptt_flash::kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult res =
      fn(map, type, 2, const_cast<void*>(pool), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, quant ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : hw::kErrTensorMap;
}

template <typename T, typename P, int D, bool G>
int launch(const RaggedArgs& a, const void* k_pool, const void* v_pool, int pool_code,
           int dtype, cudaStream_t stream) {
  CUtensorMap tk{}, tv{};  // the gathered ring reads the pools through a.k_pool / a.v_pool
  if (!G) {
    const long long rows = static_cast<long long>(a.Hkv) * a.NB * a.bs;
    int err = encode_pool(&tk, k_pool, rows, a.D, D, pool_code, dtype, a.box_rows);
    if (err == 0) err = encode_pool(&tv, v_pool, rows, a.D, D, pool_code, dtype, a.box_rows);
    if (err != 0) return err;
  }
  auto* kernel = ragged_wgmma_kernel<T, P, D, G>;
  const size_t smem = sizeof(RaggedSmem<T, P, D, G>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.tiles * a.splits, a.Hkv, a.R);
  kernel<<<grid, kThreadsR, smem, stream>>>(tk, tv, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  ragged_combine_kernel<T><<<dim3(a.tiles, a.Hkv, a.R), 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool G>
int launch_pool(const RaggedArgs& a, const void* k_pool, const void* v_pool, int pool_code,
                int dtype, cudaStream_t stream) {
  if (pool_code == 1)
    return launch<T, int8_t, D, G>(a, k_pool, v_pool, pool_code, dtype, stream);
  if (pool_code == 2)
    return launch<T, __nv_fp8_e4m3, D, G>(a, k_pool, v_pool, pool_code, dtype, stream);
  return launch<T, T, D, G>(a, k_pool, v_pool, pool_code, dtype, stream);
}

}  // namespace

template <int DP, bool G>
int run_width(const RaggedArgs& a, const void* k_pool, const void* v_pool, int pool_code,
              int dtype, cudaStream_t stream) {
  if (dtype == ptt_flash::kBF16)
    return launch_pool<bf16, DP, G>(a, k_pool, v_pool, pool_code, dtype, stream);
  return launch_pool<f16, DP, G>(a, k_pool, v_pool, pool_code, dtype, stream);
}
template int run_width<PTT_RAGGED_D, PTT_RAGGED_GATHER != 0>(const RaggedArgs&, const void*,
                                                             const void*, int, int,
                                                             cudaStream_t);

#if PTT_RAGGED_D == 64 && PTT_RAGGED_GATHER == 0  // the host entries, in one object
// the other widths' and the gathered ring's kernels are built in their own
// objects
#define PTT_RAGGED_EXTERN(DP, G)                                                         \
  extern template int run_width<DP, G>(const RaggedArgs&, const void*, const void*, int, \
                                       int, cudaStream_t);
PTT_RAGGED_EXTERN(128, false)
PTT_RAGGED_EXTERN(192, false)
PTT_RAGGED_EXTERN(256, false)
PTT_RAGGED_EXTERN(64, true)
PTT_RAGGED_EXTERN(128, true)
PTT_RAGGED_EXTERN(192, true)
PTT_RAGGED_EXTERN(256, true)
#undef PTT_RAGGED_EXTERN

// The route's tiles and split count (ptt_ragged_plan): folded rows a block,
// keys a tile, and the splits of a row's key tiles. Measured on an H100 SXM
// (decode rows of 640 to 8192 keys, 4 to 256 blocks): a split pays only
// where R x H_kv x the query tiles leave most SMs idle; from half the SMs
// on, the merge's second pass costs more than the parallelism gains (at 128
// blocks, 2 splits were 6-16 % slower than 1). So below SMs / 2 blocks the
// row is split until the grid holds about 1.5 blocks an SM, each split
// keeping at least kSplitMinTiles key tiles of the table, at most
// kMaxSplits.
constexpr int kSplitMinTiles = 4;

int query_rows() { return kRows; }
int key_tile() { return kBN; }

int auto_splits(int R, int C, int Hq, int Hkv, int bs, int nb) {
  static int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return n;
  }();
  const long long tiles = (static_cast<long long>(C) * (Hq / Hkv) + kRows - 1) / kRows;
  const long long base = static_cast<long long>(R) * Hkv * tiles;
  if (base <= 0 || 2 * base >= sms) return 1;
  const long long table_tiles = (static_cast<long long>(nb) * bs + kBN - 1) / kBN;
  const long long want = (3LL * sms / 2 + base - 1) / base;
  return static_cast<int>(std::max(
      1LL, std::min<long long>({want, table_tiles / kSplitMinTiles,
                                static_cast<long long>(kMaxSplits)})));
}

int run(const void* q, const void* k_pool, const void* v_pool, const void* tables,
        const void* q_lens, const void* kv_lens, void* out, const void* k_scales,
        const void* v_scales, void* part_o, void* part_ml, int R, int C, int Hq, int Hkv,
        int NB, int bs, int D, int nb, int splits, float scale, int dtype, int pool_code,
        bool gather, cudaStream_t stream) {
  RaggedArgs a{};
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.inv_qmax = 1.f / ptt_paged::qmax_of(pool_code);
  a.tables = static_cast<const int*>(tables);
  a.q_lens = static_cast<const int*>(q_lens);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.out = out;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.R = R;
  a.C = C;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.NB = NB;
  a.bs = bs;
  a.D = D;
  a.nb = nb;
  a.g = Hq / Hkv;
  a.tiles = (C * a.g + kRows - 1) / kRows;
  a.splits = splits;
  const int table_tiles = (nb * bs + kBN - 1) / kBN;
  a.per_split = (table_tiles + splits - 1) / splits;
  a.box_rows = bs % 64 == 0 ? 64 : bs % 32 == 0 ? 32 : bs % 16 == 0 ? 16 : 8;
  a.scale = scale;
  if (splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // D_pad: the narrowest width of 64, 128, 192, 256 that holds D
#define PTT_RAGGED_WIDTHS(G)                                                     \
  if (D <= 64) return run_width<64, G>(a, k_pool, v_pool, pool_code, dtype, stream);   \
  if (D <= 128) return run_width<128, G>(a, k_pool, v_pool, pool_code, dtype, stream); \
  if (D <= 192) return run_width<192, G>(a, k_pool, v_pool, pool_code, dtype, stream); \
  return run_width<256, G>(a, k_pool, v_pool, pool_code, dtype, stream);
  if (gather) {
    PTT_RAGGED_WIDTHS(true)
  }
  PTT_RAGGED_WIDTHS(false)
#undef PTT_RAGGED_WIDTHS
}
#endif

}  // namespace ptt_ragged_hopper
