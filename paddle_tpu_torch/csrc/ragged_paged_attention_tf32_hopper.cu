// Unified ragged prefill+decode paged attention in fp32 for Hopper (sm_90a),
// on the TF32 tensor cores: fp32 queries over fp32 pools or int8 / fp8 e4m3
// pools with per-(kv head, page) scales, any page size bs, D <= 256 (a pool
// row whole 16-byte words) and 16-byte aligned pools. ragged_paged_attention
// .cu's entry hands it those calls (design "wgmma-3xtf32" in
// ptt_ragged_plan); odd D and misaligned pools keep the CUDA-core kernel
// there. This file is compiled once per D_pad (-DPTT_RAGGED_TF32_D=<64|128|
// 192|256>, kernels/_build.py); the object of D_pad 64 also holds the host
// entries.
//
// Replaces paddle_tpu/kernels/pallas/ragged_paged_attention.py
// `ragged_paged_attention` (kernel body `_ragged_kernel`) for those calls:
// query c of row r sits at absolute position kv_len[r] - q_len[r] + c and
// sees keys at or before it, among the first nb * bs (the row's table);
// columns c >= q_len and rows that see no key are exact zeros. GQA folds a
// kv head's g query heads with the chunk: folded row f = c g + j. It took
// the place of the CUDA-core kernel for fp32 queries over fp32 pools, then
// over 1-byte pools and at the other page sizes, then at D 129-256.
//
// Bound on an H100 SXM (3.35 TB/s, 495 TFLOP/s TF32 dense): a decode row
// reads its fp32 K / V pages once (bytes-bound: 0.0148 ms for the serving
// decode batch, twice the bf16 bytes); a prefill chunk does 4 D FLOPs a
// visible (query head, key) pair, three times on the tensor cores (or once
// at 67 TFLOP/s on the FP32 pipes, the CUDA-core kernel's bound).
//
// Precision. Each fp32 operand x is split into two TF32 halves, hi = T(x)
// and lo = T(x - hi), and each product taken as a_lo b_hi + a_hi b_lo +
// a_hi b_hi in fp32 accumulators (flash_hopper.cuh, "fp32 operands on the
// TF32 tensor cores"): about 2^-21 of a product against TF32's 2^-11. A
// tile's P V product goes to a fresh accumulator that the threads add to
// the running output in fp32 (no chain longer than one tile). A 1-byte
// page's element is first dequantized as x * (scale / qmax) in fp32, the
// reference's own value, then split the same way: the route is held at the
// fp32 gate (no 16-bit rounding of the dequantized page, unlike the 16-bit
// kernel).
//
// Design. One block of 256 threads owns 64 folded rows of one (row, kv
// head), and one split of the row's key tiles: warpgroup 0 is the consumer,
// warpgroup 1 the producer (its warp 0 reads block_tables itself and copies
// the pages, its warps 1-3 split each landed tile). Shared memory limits
// the block to one an SM (a split fp32 element takes 8 bytes; 224 KB at D
// 128 over fp32 pools, 176 KB over 1-byte pools). Key tiles of 32 keys up
// to D_pad 128 and of 16 at 192 and 256, where Q (48 / 64 KB) and two split
// stages of 16 keys (96 / 128 KB, flash_hopper.cuh SplitRing: V^T's rows of
// 32 keys shared by the two stages) leave room for one landed stage of fp32
// pages at 256 (224 KB) and two elsewhere; the 64 x 256 fp32 output is 128
// registers a consumer thread, so gemm_raw keeps two key steps of Q
// fragments in flight there and pv_tile two accumulators of 64 head
// columns.
// - Q: the consumer loads the 64 folded rows once (16-byte words, rows
//   c >= q_len as zeros) raw into the 128-byte-swizzled fp32 panels that
//   frag_raw reads as the register A of S = Q K^T, split there.
// - Pages through a gathered ring, at every page size: producer warp 0
//   copies a key tile key row by key row with cp.async, 16 bytes
//   a lane a copy (flash_hopper.cuh gather_tile): key k from pool row (h NB
//   + table[k / bs]) bs + k % bs, into the swizzled 32-column fp32 panels
//   that split_k_vt reads. A key at or past the tile plan's n_keys is
//   zero-filled and nothing is read for it: no table slot past the row's
//   used pages is touched. The copies arrive on the `raw` barrier (32
//   arrivals); the split warps read the tile with ordinary loads, so no
//   proxy fence stands before them. The landed tiles and the split ones are
//   two rings of two stages each: a landed stage is free again
//   (`raw_empty`) once it is split, not once the products are done, so the
//   copies run up to four tiles ahead of the consumer. Why not TMA: a TMA
//   ring (boxes of the largest of 32 / 16 / 8 rows that divides bs, so only
//   page sizes that are a multiple of 8) ran no faster on an H100 SXM at
//   700 W in one A/B (profiler/kernels_ab.py, the decode batch of 8 rows x
//   16 heads of 128, kv 100-640, pages of 32): fp32 decode 0.0651 / 0.0652
//   ms gathered against 0.0658 / 0.0659 by TMA, fp32 mixed 0.0571 / 0.0569
//   against 0.0574 / 0.0573, fp32 q over int8 / fp8 0.0689 / 0.0681 against
//   0.0719 / 0.0723; at D 64 in a second A/B, decode 0.0405 / 0.0404
//   against 0.0401 / 0.0404, mixed 0.0351 / 0.0350 against 0.0353 / 0.0353,
//   over int8 0.0435 / 0.0435 against 0.0456 / 0.0457. The walk is set by
//   the split and the products, not by how the bytes land.
// - 1-byte pools: a landed stage holds the raw rows ([32 keys][D_pad]
//   unswizzled: 4 KB a tile of K at D 128, a quarter of fp32's) and the
//   scale / qmax of each key, written by the lane that reads the key's
//   table slot before its arrival; the split warps dequantize as they
//   split (split_k_vt_q). 176 KB at D 128, so a third landed stage fits
//   (184 KB), but it did not pay: on an H100 SXM, with the TMA ring, the
//   fp32 decode batch over int8 pools ran 0.0742 / 0.0745 ms with three
//   against 0.0741 / 0.0740 with two: the bytes in flight do not set this
//   walk.
// - The split (producer warps 1-3): K into hi and lo halves, the 8 columns
//   of each key step in perm8 order (the K-major B of S = Q K^T); V
//   transposed, [D][32 keys] hi and lo, the keys
//   of each step in perm8 order: the K-major B of O += P V (flash_hopper.cuh
//   SplitRing, shared with the fp32 flash forward at D_pad 192 / 256). TF32 wgmma takes
//   no transposed B, so the tile is transposed once here, and P stays in
//   the registers: the S accumulator's two columns 8 kk + 2 (l % 4) and + 1
//   of key step kk are the TF32 A fragment's contraction indices l % 4 and
//   l % 4 + 4, which the perm8 order of V^T's keys matches. (The other form,
//   O^T = V^T P^T with P written to shared memory as the dK/dV kernels'
//   dv^T, holds O transposed: the online softmax's per-row rescale would
//   then cross threads through shared memory every tile.)
// - Products on wgmma: S = Q K^T (m64n32k8, m64n16k8 at D_pad 192 / 256;
//   gemm_raw: Q split in registers each key step, K's halves from shared
//   memory), the online softmax on the register fragment (a row's max and
//   sum over the quad), P split in registers as the A of O += P V
//   (m64n64k8 for each 64 head columns, pv_tile), O in registers until the
//   epilogue. Every product is issued and waited
//   for in the loop body that every tile runs (decode rows and prefill
//   chunks alike): no wgmma sits in a data-dependent branch.
// - Split key ranges: when R x H_kv x the query tiles leave more than half
//   the SMs idle, the row's key tiles are cut into `splits` contiguous
//   ranges by the table width (auto_splits, on the host); a split writes its
//   rows' unnormalized O, m and l into fp32 scratch that the wrapper
//   allocates and ragged_tf32_combine_kernel merges them; with one split
//   the block writes the output itself.

#include <algorithm>
#include <type_traits>

#include "flash_hopper.cuh"
#include "paged_common.cuh"

#ifndef PTT_RAGGED_TF32_D
#error "compile once per D_pad: -DPTT_RAGGED_TF32_D=<64|128|192|256>"
#endif

namespace ptt_ragged_tf32 {

namespace hw = ptt_flash::hopper;

constexpr int kRows = 64;       // folded query rows a block (one m64 warpgroup)
constexpr int kStages = 2;      // stages of the split ring
constexpr int kMaxSplits = 16;  // splits of a row's key tiles the merge takes
constexpr int kThreadsT = 256;  // the consumer warpgroup and the producer warpgroup
constexpr int kSplitters = 96;  // producer warps 1-3
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;  // 1-byte pools: fp32 [H_kv, NB] absmax scales
  const float* v_scales;
  float qmax;             // 127 (int8) or 448 (fp8 e4m3)
  const int* tables;
  const int* q_lens;
  const int* kv_lens;
  float* out;
  float* part_o;   // [R, H_kv, tiles, splits, 64, D] unnormalized O
  float* part_ml;  // [R, H_kv, tiles, splits, 64, 2] m, l
  int R, C, Hq, Hkv, NB, bs, D, nb, g, tiles, splits, per_split;
  float scale;
};

// the kernels at one D_pad (each object of this file defines its own)
template <int DP>
int run_width(const Args& a, int pool_code, cudaStream_t stream);

namespace {

// What a (row r, query tile) of folded rows [f0, f0 + 64) does: its live
// rows (c < q_len), the absolute position of chunk column 0, the keys it
// can see (the tile's last live column's causal limit, cut at the row's
// used pages) and their key tiles. The kernel and the combine share it.
struct TilePlan {
  int n_rows, qpos0, n_keys, nkt;
};

template <int kBN>
__device__ __forceinline__ TilePlan tile_plan(const Args& a, int r, int tile) {
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

// fp32 tiles as 32-column panels of 128-byte rows (flash_hopper.cuh
// f32_off); every array starts on a 1024-byte boundary. P: the pool
// element. fp32 pools land in those panels; 1-byte pools land raw
// ([kBN][D] unswizzled, a quarter of the bytes) beside the scale / qmax of
// each key, and the split dequantizes them. Two landed stages where they
// fit (one for fp32 pools at D_pad 256: 64 KB of Q, 32 KB landed and 128
// KB of split stages).
template <int D, typename P>
struct Smem {
  static constexpr bool kQuant = !std::is_same<P, float>::value;
  static constexpr int kP = D / 32, kBN = ptt_flash::tf32_key_tile(D);
  static constexpr int kLandBytes = kBN * D * static_cast<int>(sizeof(P));
  using Ring = hw::SplitRing<D, kStages>;
  static constexpr int kLanded = hw::landed_stages(kRows * D * 4 + sizeof(Ring), kLandBytes);
  float q[kP][kRows * 32];                                        // raw Q, [64][D]
  unsigned char k[kLanded][kLandBytes], v[kLanded][kLandBytes];  // the landed ring
  Ring ring;  // the split ring: K (perm8), V^T [D][32 keys]
  float kmul[kQuant ? kLanded : 1][kBN];  // scale / qmax of each key
  float vmul[kQuant ? kLanded : 1][kBN];
  // raw / raw_empty: the landed ring (the loads, the split); full / empty:
  // the split ring (the split, the products)
  uint64_t raw[kLanded], raw_empty[kLanded], full[kStages], empty[kStages];
};

template <int N>
__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase) {
  if (++stage == N) {
    stage = 0;
    phase ^= 1;
  }
}

// Producer warp 0: the split's key tiles into the landed ring, key row by
// key row with each key's scales, on the `raw` barrier.
template <int D, typename P>
__device__ __forceinline__ void produce(Smem<D, P>& sm, const Args& a, int r, int h,
                                        int t_begin, int t_end, int n_keys) {
  using S = Smem<D, P>;
  constexpr int kBN = S::kBN;
  constexpr int kChunks = D * static_cast<int>(sizeof(P)) / 16;
  const int* table = a.tables + static_cast<long long>(r) * a.nb;
  const int row_bytes = a.D * static_cast<int>(sizeof(P));
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    hw::mbar_wait(&sm.raw_empty[stage], phase ^ 1);
    float* km = sm.kmul[S::kQuant ? stage : 0];
    float* vm = sm.vmul[S::kQuant ? stage : 0];
    hw::gather_tile<kBN, kChunks>(
        sm.k[stage], sm.v[stage], static_cast<const unsigned char*>(a.k_pool),
        static_cast<const unsigned char*>(a.v_pool), row_bytes, table, h, a.NB, a.bs, t * kBN,
        n_keys, row_bytes / 16, &sm.raw[stage],
        [](int rr, int c) {
          // 1-byte pools: the raw row; fp32: the swizzled 32-column panels
          return S::kQuant ? rr * D + 16 * c : static_cast<int>(hw::f32_off(rr, 4 * c, kBN * 128));
        },
        [&](int rr, int page) {
          if (S::kQuant) {  // the key's scale / qmax, as the reference forms it
            const long long s = static_cast<long long>(h) * a.NB + page;
            km[rr] = page < 0 ? 0.f : a.k_scales[s] / a.qmax;
            vm[rr] = page < 0 ? 0.f : a.v_scales[s] / a.qmax;
          }
        });
    next_stage<S::kLanded>(stage, phase);
  }
}

// A landed tile of 1-byte pages ([kBN][D] raw rows) dequantized and split
// by threads [0, n) of the caller: each element x becomes x * (scale /
// qmax) in fp32, the reference's value, then hi and lo as split_k_vt makes
// them (K in the swizzled 32-column panels, each 8 columns in perm8 order;
// V^T [D][32 keys] from column key0, the keys of each step in perm8
// order).
template <int D, int kBN, typename P>
__device__ __forceinline__ void split_k_vt_q(const unsigned char* kraw, float* khi, float* klo,
                                             const unsigned char* vraw, float* vhi, float* vlo,
                                             const float* kmul, const float* vmul, int tid,
                                             int n, int key0) {
  unsigned char* kh = reinterpret_cast<unsigned char*>(khi);
  unsigned char* kl = reinterpret_cast<unsigned char*>(klo);
  // K: 8 columns of a key a unit, a row's units on consecutive threads
  for (int u = tid; u < kBN * (D / 8); u += n) {
    const int key = u / (D / 8), c = 8 * (u % (D / 8));
    const uint2 w = *reinterpret_cast<const uint2*>(kraw + key * D + c);
    const P* x = reinterpret_cast<const P*>(&w);
    const float m = kmul[key];
    const float v[8] = {ptt_paged::to_f32(x[0]) * m, ptt_paged::to_f32(x[2]) * m,
                        ptt_paged::to_f32(x[4]) * m, ptt_paged::to_f32(x[6]) * m,
                        ptt_paged::to_f32(x[1]) * m, ptt_paged::to_f32(x[3]) * m,
                        ptt_paged::to_f32(x[5]) * m, ptt_paged::to_f32(x[7]) * m};  // perm8
    uint32_t h[8], l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) hw::split_tf32(v[i], h[i], l[i]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t off = hw::f32_off(key, c + 4 * half, kBN * 128);
      *reinterpret_cast<uint4*>(kh + off) =
          make_uint4(h[4 * half], h[4 * half + 1], h[4 * half + 2], h[4 * half + 3]);
      *reinterpret_cast<uint4*>(kl + off) =
          make_uint4(l[4 * half], l[4 * half + 1], l[4 * half + 2], l[4 * half + 3]);
    }
  }
  // V transposed: 16 columns of one key a thread, the keys on consecutive
  // threads (each store lands on one V^T row's 32 banks; a quarter warp's
  // 16-byte reads share a bank group, but laid out conflict-free, the K
  // stores too, the split ran 2-3 % slower on an H100 SXM)
  unsigned char* vh = reinterpret_cast<unsigned char*>(vhi);
  unsigned char* vl = reinterpret_cast<unsigned char*>(vlo);
  for (int e = tid; e < kBN * (D / 16); e += n) {
    const int key = e % kBN, c = 16 * (e / kBN);
    const uint4 w = *reinterpret_cast<const uint4*>(vraw + key * D + c);
    const P* x = reinterpret_cast<const P*>(&w);
    const float m = vmul[key];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t hi, lo;
      hw::split_tf32(ptt_paged::to_f32(x[i]) * m, hi, lo);
      const uint32_t off = hw::f32_off(c + i, key0 + hw::perm8(key), 0);
      *reinterpret_cast<uint32_t*>(vh + off) = hi;
      *reinterpret_cast<uint32_t*>(vl + off) = lo;
    }
  }
}

// Producer warps 1-3: a landed stage split into a split stage, K into hi
// and lo (perm8), V into V^T [D][32 keys] (perm8 keys), a 1-byte stage
// dequantized first; the landed stage is freed (`raw_empty`), the split one
// handed on (`full`).
template <int D, typename P>
__device__ __forceinline__ void split_stream(Smem<D, P>& sm, int n_tiles) {
  using S = Smem<D, P>;
  const int tid = threadIdx.x - 160;
  int land = 0, stage = 0;
  uint32_t land_phase = 0, phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    hw::mbar_wait(&sm.raw[land], land_phase);
    hw::mbar_wait(&sm.empty[stage], phase ^ 1);
    if constexpr (S::kQuant)
      split_k_vt_q<D, S::kBN, P>(sm.k[land], sm.ring.khi[stage][0], sm.ring.klo[stage][0],
                                 sm.v[land], sm.ring.vt_hi(stage), sm.ring.vt_lo(stage),
                                 sm.kmul[land], sm.vmul[land], tid, kSplitters,
                                 S::Ring::vt_key0(stage));
    else
      sm.ring.split(stage, reinterpret_cast<const float*>(sm.k[land]),
                    reinterpret_cast<const float*>(sm.v[land]), tid, kSplitters);
    hw::mbar_arrive(&sm.raw_empty[land]);
    hw::fence_proxy_async();
    hw::mbar_arrive(&sm.full[stage]);
    next_stage<S::kLanded>(land, land_phase);
    next_stage<kStages>(stage, phase);
  }
}

template <int D, typename P>
__global__ void __launch_bounds__(kThreadsT, 1) ragged_tf32_kernel(const Args a) {
  using S = Smem<D, P>;
  constexpr int kBN = S::kBN;
  const int split = blockIdx.x % a.splits, tile = blockIdx.x / a.splits;
  const int h = blockIdx.y, r = blockIdx.z;
  const TilePlan tp = tile_plan<kBN>(a, r, tile);
  const int t_begin = split * a.per_split;
  const int t_end = min(t_begin + a.per_split, tp.nkt);
  const int n_tiles = max(0, t_end - t_begin);
  const int f0 = tile * kRows, CG = a.C * a.g;

  if (n_tiles == 0) {
    // no key for this split: with one split the block writes its rows'
    // zeros, with more the combine does
    if (a.splits == 1) {
      const int rows = min(kRows, CG - f0), words = a.D / 4;
      for (int e = threadIdx.x; e < rows * words; e += kThreadsT) {
        const int ff = f0 + e / words, col = 4 * (e % words);
        float* dst = a.out + ((static_cast<long long>(r) * a.C + ff / a.g) * a.Hq + h * a.g +
                              ff % a.g) * a.D + col;
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(hw::align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int st = 0; st < S::kLanded; ++st) {
      hw::mbar_init(&sm.raw[st], 32);  // the gathering warp
      hw::mbar_init(&sm.raw_empty[st], kSplitters);
    }
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(&sm.full[st], kSplitters);
      hw::mbar_init(&sm.empty[st], 4);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x >= 160)
      split_stream<D, P>(sm, n_tiles);
    else
      produce<D, P>(sm, a, r, h, t_begin, t_end, tp.n_keys);
    return;
  }

  // the consumer warpgroup: thread t holds folded rows 16 w + l / 4 (+ 8)
  const int t = threadIdx.x, lane = t % 32;
  {
    // Q's live rows, raw, into the swizzled panels (zeros elsewhere)
    constexpr int kWords = D / 4;
    unsigned char* qt = reinterpret_cast<unsigned char*>(sm.q[0]);
    for (int e = t; e < kRows * kWords; e += 128) {
      const int rr = e / kWords, c = 4 * (e % kWords);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rr < tp.n_rows && c < a.D) {
        const int ff = f0 + rr;
        val = *reinterpret_cast<const float4*>(
            a.q + ((static_cast<long long>(r) * a.C + ff / a.g) * a.Hq + h * a.g + ff % a.g) *
                      a.D + c);
      }
      *reinterpret_cast<float4*>(qt + hw::f32_off(rr, c, kRows * 128)) = val;
    }
    hw::wg_sync(1);
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
  const unsigned char* qt = reinterpret_cast<const unsigned char*>(sm.q[0]);
  constexpr uint32_t kQPanel = kRows * 128, kKPanel = kBN * 128;
  const float neg_inf = __int_as_float(0xff800000);
  const float scale_log2 = a.scale * kLog2e;

  int stage = 0;
  uint32_t phase = 0;
  for (int tt = t_begin; tt < t_end; ++tt) {
    const int k0 = tt * kBN;
    hw::mbar_wait(&sm.full[stage], phase);
    float s[kBN / 2];
    hw::gemm_raw<kBN, D>(s, qt, kQPanel, hw::smem_u32(sm.ring.khi[stage][0]),
                         hw::smem_u32(sm.ring.klo[stage][0]), kKPanel);
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
    // P split in registers, then O += P V (flash_hopper.cuh pv_tile)
    uint32_t phi[kBN / 8][4], plo[kBN / 8][4];
    float part[hw::pv_accs(D)][32];
    hw::split_p<kBN>(s, phi, plo);
    hw::pv_tile<D, kBN / 8>(o, part, phi, plo, hw::smem_u32(sm.ring.vt_hi(stage)),
                            hw::smem_u32(sm.ring.vt_lo(stage)), S::Ring::vt_key0(stage) / 8);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&sm.empty[stage]);
    next_stage<kStages>(stage, phase);
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
      float* orow = a.out + ((static_cast<long long>(r) * a.C + ff / a.g) * a.Hq + h * a.g +
                             ff % a.g) * a.D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        if (col < a.D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
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
// splits' weights into shared memory; then each thread merges 4 columns of
// a row at a time and stores them as one 16-byte word.
template <int kBN>
__global__ void __launch_bounds__(128) ragged_tf32_combine_kernel(const Args a) {
  __shared__ float wts[kRows][kMaxSplits];
  const int tile = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const TilePlan tp = tile_plan<kBN>(a, r, tile);
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
  const int words = a.D / 4;
  for (int e = threadIdx.x; e < rows * words; e += 128) {
    const int fr = e / words, col = 4 * (e % words), ff = f0 + fr;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (fr < tp.n_rows) {
      for (int sp = 0; sp < n_splits; ++sp) {
        const float w = wts[fr][sp];
        const float4 x =
            *reinterpret_cast<const float4*>(a.part_o + ((blk0 + sp) * kRows + fr) * a.D + col);
        acc.x += w * x.x;
        acc.y += w * x.y;
        acc.z += w * x.z;
        acc.w += w * x.w;
      }
    }
    *reinterpret_cast<float4*>(
        a.out + ((static_cast<long long>(r) * a.C + ff / a.g) * a.Hq + h * a.g + ff % a.g) * a.D +
        col) = acc;
  }
}

template <int D, typename P>
int launch(const Args& a, cudaStream_t stream) {
  using S = Smem<D, P>;
  auto* kernel = ragged_tf32_kernel<D, P>;
  const size_t smem = sizeof(S) + 1024;
  static_assert(sizeof(S) + 1024 <= 232448, "over the 227 KB a block may hold");
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.tiles * a.splits, a.Hkv, a.R);
  kernel<<<grid, kThreadsT, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  ragged_tf32_combine_kernel<S::kBN><<<dim3(a.tiles, a.Hkv, a.R), 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

template <int DP>
int run_width(const Args& a, int pool_code, cudaStream_t stream) {
  if (pool_code == 1) return launch<DP, int8_t>(a, stream);
  if (pool_code == 2) return launch<DP, __nv_fp8_e4m3>(a, stream);
  return launch<DP, float>(a, stream);
}
template int run_width<PTT_RAGGED_TF32_D>(const Args&, int, cudaStream_t);

#if PTT_RAGGED_TF32_D == 64  // the host entries, in one object
// the other widths' kernels are built in their own objects
extern template int run_width<128>(const Args&, int, cudaStream_t);
extern template int run_width<192>(const Args&, int, cudaStream_t);
extern template int run_width<256>(const Args&, int, cudaStream_t);

int d_pad_of(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256; }

// The route's tiles and split count (ptt_ragged_plan): folded rows a block,
// keys a tile, and the splits of a row's key tiles. A block holds its SM
// alone (shared memory), so the rule keeps one wave: below SMs / 2 blocks
// the row is split into as many ranges as the grid leaves SMs for (at most
// kMaxSplits), each keeping at least kSplitMinKeys keys (the 16-bit
// kernel's 256: 8 key tiles of 32, 16 of 16 at D_pad 192 / 256). Measured
// on an H100 SXM (`profiler/ragged_splits.py`, one row of 8192 keys over 16
// kv heads, D 128): 8 splits (128 blocks) ran 0.1041 ms, 12 and 13 (two
// waves) 0.1385 and 0.1288.
constexpr int kSplitMinKeys = 256;

int query_rows() { return kRows; }
int key_tile(int D) { return ptt_flash::tf32_key_tile(d_pad_of(D)); }

int auto_splits(int R, int C, int Hq, int Hkv, int bs, int nb, int D) {
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
  const int bn = key_tile(D);
  const long long table_tiles = (static_cast<long long>(nb) * bs + bn - 1) / bn;
  return static_cast<int>(std::max(
      1LL, std::min<long long>({sms / base, table_tiles / (kSplitMinKeys / bn),
                                static_cast<long long>(kMaxSplits)})));
}

int run(const void* q, const void* k_pool, const void* v_pool, const void* tables,
        const void* q_lens, const void* kv_lens, void* out, const void* k_scales,
        const void* v_scales, void* part_o, void* part_ml, int R, int C, int Hq, int Hkv,
        int NB, int bs, int D, int nb, int splits, float scale, int pool_code,
        cudaStream_t stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.qmax = ptt_paged::qmax_of(pool_code);
  a.tables = static_cast<const int*>(tables);
  a.q_lens = static_cast<const int*>(q_lens);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.out = static_cast<float*>(out);
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
  const int bn = key_tile(D), table_tiles = (nb * bs + bn - 1) / bn;
  a.per_split = (table_tiles + splits - 1) / splits;
  a.scale = scale;
  if (splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d_pad_of(D)) {
    case 64:
      return run_width<64>(a, pool_code, stream);
    case 128:
      return run_width<128>(a, pool_code, stream);
    case 192:
      return run_width<192>(a, pool_code, stream);
    default:
      return run_width<256>(a, pool_code, stream);
  }
}
#endif

}  // namespace ptt_ragged_tf32
