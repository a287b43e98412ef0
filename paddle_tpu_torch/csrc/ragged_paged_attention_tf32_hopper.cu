// Unified ragged prefill+decode paged attention in fp32 for Hopper (sm_90a),
// on the TF32 tensor cores: fp32 queries over fp32 pools, a page size bs
// that is a multiple of 8, D <= 128 a multiple of 4 and 16-byte aligned
// pools. ragged_paged_attention.cu's entry hands it those calls (design
// "wgmma-3xtf32" in ptt_ragged_plan); fp32 queries over int8 / fp8 pools,
// the other page sizes and head dims keep the CUDA-core kernel there.
//
// Replaces paddle_tpu/kernels/pallas/ragged_paged_attention.py
// `ragged_paged_attention` (kernel body `_ragged_kernel`) for those calls:
// query c of row r sits at absolute position kv_len[r] - q_len[r] + c and
// sees keys at or before it, among the first nb * bs (the row's table);
// columns c >= q_len and rows that see no key are exact zeros. GQA folds a
// kv head's g query heads with the chunk: folded row f = c g + j. It took
// the place of the CUDA-core kernel for fp32 queries over fp32 pools.
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
// the running output in fp32 (no chain longer than one tile).
//
// Design. One block of 256 threads owns 64 folded rows of one (row, kv
// head), and one split of the row's key tiles: warpgroup 0 is the consumer,
// warpgroup 1 the producer (its warp 0 reads block_tables itself and issues
// the TMA loads, its warps 1-3 split each landed tile). Shared memory limits
// the block to one an SM (a split fp32 element takes 8 bytes; 224 KB at D
// 128).
// - Q: the consumer loads the 64 folded rows once (16-byte words, rows
//   c >= q_len as zeros) raw into the 128-byte-swizzled fp32 panels that
//   frag_raw reads as the register A of S = Q K^T, split there.
// - Pages through a TMA ring: a key tile of 32 keys is 32 / bs pages (or a
//   part of one page when bs > 32), each a contiguous [bs, D] slab of the
//   head-major pool, loaded by TMA over the pool seen as rows (h NB + page)
//   bs + key % bs in boxes of the largest of 32 / 16 / 8 rows that divides
//   bs (every box lands on a 1024-byte boundary of the swizzled panel). A
//   box past the row's used pages loads the row's last used page again
//   (finite values the mask drops): no table slot past them is read. The
//   landed tiles and the split ones are two rings of two stages each: a
//   landed stage is free again (`raw_empty`) once it is split, not once
//   the products are done, so the loads run up to four tiles ahead of the
//   consumer (a decode block's page chain is latency-bound: its bytes in
//   flight set its rate).
// - The split (producer warps 1-3): K into hi and lo halves, the 8 columns
//   of each key step in perm8 order (the K-major B of S = Q K^T); V
//   transposed, [D][32 keys] hi and lo, the keys
//   of each step in perm8 order: the K-major B of O += P V. TF32 wgmma takes
//   no transposed B, so the tile is transposed once here, and P stays in
//   the registers: the S accumulator's two columns 8 kk + 2 (l % 4) and + 1
//   of key step kk are the TF32 A fragment's contraction indices l % 4 and
//   l % 4 + 4, which the perm8 order of V^T's keys matches. (The other form,
//   O^T = V^T P^T with P written to shared memory as the dK/dV kernels'
//   dv^T, holds O transposed: the online softmax's per-row rescale would
//   then cross threads through shared memory every tile.)
// - Products on wgmma: S = Q K^T (m64n32k8, gemm_raw: Q split in registers
//   each key step, K's halves from shared memory), the online softmax on
//   the register fragment (a row's max and sum over the quad), P split in
//   registers as the A of O += P V (m64n64k8 for each 64 head columns),
//   O in registers until the epilogue. Every product is issued and waited
//   for in the loop body that every tile runs (decode rows and prefill
//   chunks alike): no wgmma sits in a data-dependent branch.
// - Split key ranges: when R x H_kv x the query tiles leave more than half
//   the SMs idle, the row's key tiles are cut into `splits` contiguous
//   ranges by the table width (auto_splits, on the host); a split writes its
//   rows' unnormalized O, m and l into fp32 scratch that the wrapper
//   allocates and ragged_tf32_combine_kernel merges them; with one split
//   the block writes the output itself.

#include <algorithm>

#include "flash_hopper.cuh"
#include "paged_common.cuh"

namespace ptt_ragged_tf32 {
namespace {

namespace hw = ptt_flash::hopper;

constexpr int kRows = 64;       // folded query rows a block (one m64 warpgroup)
constexpr int kBN = 32;         // keys a tile
constexpr int kStages = 2;      // stages of each ring, the landed and the split
constexpr int kMaxSplits = 16;  // splits of a row's key tiles the merge takes
constexpr int kThreadsT = 256;  // the consumer warpgroup and the producer warpgroup
constexpr int kSplitters = 96;  // producer warps 1-3
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* q;
  const int* tables;
  const int* q_lens;
  const int* kv_lens;
  float* out;
  float* part_o;   // [R, H_kv, tiles, splits, 64, D] unnormalized O
  float* part_ml;  // [R, H_kv, tiles, splits, 64, 2] m, l
  int R, C, Hq, Hkv, NB, bs, D, nb, g, tiles, splits, per_split, box_rows;
  float scale;
};

// What a (row r, query tile) of folded rows [f0, f0 + 64) does: its live
// rows (c < q_len), the absolute position of chunk column 0, the keys it
// can see (the tile's last live column's causal limit, cut at the row's
// used pages) and their key tiles. The kernel and the combine share it.
struct TilePlan {
  int n_rows, qpos0, n_keys, nkt;
};

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
// f32_off); every array starts on a 1024-byte boundary.
template <int D>
struct Smem {
  static constexpr int kP = D / 32;
  float q[kP][kRows * 32];                             // raw Q, [64][D]
  float k[kStages][kP][kBN * 32], v[kStages][kP][kBN * 32];  // the landed ring
  float khi[kStages][kP][kBN * 32], klo[kStages][kP][kBN * 32];  // the split ring:
  float vhi[kStages][D * 32], vlo[kStages][D * 32];  // K (perm8), V^T [D][32 keys]
  // raw / raw_empty: the landed ring (TMA, the split); full / empty: the
  // split ring (the split, the products)
  uint64_t raw[kStages], raw_empty[kStages], full[kStages], empty[kStages];
};

__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// Producer warp 0: the split's key tiles, a box of pages at a time, on the
// `raw` barrier (one lane).
template <int D>
__device__ __forceinline__ void produce(Smem<D>& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const Args& a, int r, int h,
                                        int t_begin, int t_end) {
  constexpr int kP = Smem<D>::kP;
  hw::tma_prefetch_map(tk);
  hw::tma_prefetch_map(tv);
  const int* table = a.tables + static_cast<long long>(r) * a.nb;
  const int used = min((a.kv_lens[r] + a.bs - 1) / a.bs, a.nb);
  const int boxes = kBN / a.box_rows;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    hw::mbar_wait(&sm.raw_empty[stage], phase ^ 1);
    int rows[kBN / 8];
    for (int bx = 0; bx < boxes; ++bx) {
      const int key = t * kBN + bx * a.box_rows;
      const int page = table[min(key / a.bs, used - 1)];
      rows[bx] = (h * a.NB + page) * a.bs + key % a.bs;
    }
    hw::mbar_arrive_tx(&sm.raw[stage], 2 * kBN * D * 4);
    for (int bx = 0; bx < boxes; ++bx)
      for (int p = 0; p < kP; ++p) {
        const int off = bx * a.box_rows * 32;
        hw::tma_load_2d(&sm.k[stage][p][off], tk, &sm.raw[stage], 32 * p, rows[bx]);
        hw::tma_load_2d(&sm.v[stage][p][off], tv, &sm.raw[stage], 32 * p, rows[bx]);
      }
    next_stage(stage, phase);
  }
}

// Producer warps 1-3: a landed stage split into a split stage, K into hi
// and lo (perm8), V into V^T [D][32 keys] (perm8 keys); the landed stage is
// freed (`raw_empty`), the split one handed on (`full`).
template <int D>
__device__ __forceinline__ void split_stream(Smem<D>& sm, int n_tiles) {
  const int tid = threadIdx.x - 160;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    hw::mbar_wait(&sm.raw[stage], phase);
    hw::mbar_wait(&sm.empty[stage], phase ^ 1);
    hw::split_k_vt<D, kBN>(sm.k[stage][0], sm.khi[stage][0], sm.klo[stage][0], sm.v[stage][0],
                           sm.vhi[stage], sm.vlo[stage], tid, kSplitters);
    hw::mbar_arrive(&sm.raw_empty[stage]);
    hw::fence_proxy_async();
    hw::mbar_arrive(&sm.full[stage]);
    next_stage(stage, phase);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsT, 1)
    ragged_tf32_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Args a) {
  using S = Smem<D>;
  const int split = blockIdx.x % a.splits, tile = blockIdx.x / a.splits;
  const int h = blockIdx.y, r = blockIdx.z;
  const TilePlan tp = tile_plan(a, r, tile);
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
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(&sm.raw[st], 1);
      hw::mbar_init(&sm.raw_empty[st], kSplitters);
      hw::mbar_init(&sm.full[st], kSplitters);
      hw::mbar_init(&sm.empty[st], 4);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x >= 160)
      split_stream<D>(sm, n_tiles);
    else if (threadIdx.x == 128)
      produce<D>(sm, &tk, &tv, a, r, h, t_begin, t_end);
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
    hw::gemm_raw<kBN, D>(s, qt, kQPanel, hw::smem_u32(sm.khi[stage][0]),
                         hw::smem_u32(sm.klo[stage][0]), kKPanel);
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
    // P split in registers: key step kk's A fragment is registers 4 kk ..
    // 4 kk + 3 (contraction index l % 4: column 8 kk + 2 (l % 4), rows i =
    // 0, 1; l % 4 + 4: the column after it)
    uint32_t phi[kBN / 8][4], plo[kBN / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
      hw::split_tf32(s[4 * kk], phi[kk][0], plo[kk][0]);
      hw::split_tf32(s[4 * kk + 2], phi[kk][1], plo[kk][1]);
      hw::split_tf32(s[4 * kk + 1], phi[kk][2], plo[kk][2]);
      hw::split_tf32(s[4 * kk + 3], phi[kk][3], plo[kk][3]);
    }
    // O += P V, each 64 head columns into a fresh accumulator: the small
    // products first, then the large ones
    float part[D / 64][32];
    const uint32_t vhi = hw::smem_u32(sm.vhi[stage]), vlo = hw::smem_u32(sm.vlo[stage]);
    hw::wgmma_fence();
#pragma unroll
    for (int mb = 0; mb < D / 64; ++mb) {
      const uint32_t off = mb * 64 * 128;
#pragma unroll
      for (int kk = 0; kk < kBN / 8; ++kk) {
        hw::wgmma_tf32<64>(part[mb], plo[kk], hw::desc_kmajor(vhi + off, 0, kk), kk > 0 ? 1 : 0);
        hw::wgmma_tf32<64>(part[mb], phi[kk], hw::desc_kmajor(vlo + off, 0, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBN / 8; ++kk)
        hw::wgmma_tf32<64>(part[mb], phi[kk], hw::desc_kmajor(vhi + off, 0, kk), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait_all();
    hw::reg_fence(part);
    hw::reg_fence(phi);
    hw::reg_fence(plo);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&sm.empty[stage]);
#pragma unroll
    for (int mb = 0; mb < D / 64; ++mb)
#pragma unroll
      for (int c = 0; c < 32; ++c) o[32 * mb + c] += part[mb][c];
    next_stage(stage, phase);
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
__global__ void __launch_bounds__(128) ragged_tf32_combine_kernel(const Args a) {
  __shared__ float wts[kRows][kMaxSplits];
  const int tile = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const TilePlan tp = tile_plan(a, r, tile);
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

// A 2-D tensor map over the fp32 pool seen as [H_kv NB bs rows, D]: boxes of
// 32 columns x box_rows rows, 128-byte swizzle (the panels the split reads).
// The columns past D arrive as zeros.
int encode_pool(CUtensorMap* map, const void* pool, long long rows, int D, int box_rows) {
  const hw::EncodeTiled fn = hw::encoder();
  if (fn == nullptr) return hw::kErrTensorMap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(pool), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : hw::kErrTensorMap;
}

template <int D>
int launch(const Args& a, const void* k_pool, const void* v_pool, cudaStream_t stream) {
  auto* kernel = ragged_tf32_kernel<D>;
  const size_t smem = sizeof(Smem<D>) + 1024;
  static_assert(sizeof(Smem<D>) + 1024 <= 232448, "over the 227 KB a block may hold");
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tk, tv;
  const long long rows = static_cast<long long>(a.Hkv) * a.NB * a.bs;
  int err = encode_pool(&tk, k_pool, rows, a.D, a.box_rows);
  if (err == 0) err = encode_pool(&tv, v_pool, rows, a.D, a.box_rows);
  if (err != 0) return err;
  const dim3 grid(a.tiles * a.splits, a.Hkv, a.R);
  kernel<<<grid, kThreadsT, smem, stream>>>(tk, tv, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  ragged_tf32_combine_kernel<<<dim3(a.tiles, a.Hkv, a.R), 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The route's tiles and split count (ptt_ragged_plan): folded rows a block,
// keys a tile, and the splits of a row's key tiles. A block holds its SM
// alone (shared memory), so the rule keeps one wave: below SMs / 2 blocks
// the row is split into as many ranges as the grid leaves SMs for (at most
// kMaxSplits), each keeping at least kSplitMinTiles key tiles of 32 (the
// 16-bit kernel's 256 keys). Measured on an H100 SXM
// (`profiler/ragged_splits.py`, one row of 8192 keys over 16 kv heads):
// 8 splits (128 blocks) ran 0.1041 ms, 12 and 13 (two waves) 0.1385 and
// 0.1288.
constexpr int kSplitMinTiles = 8;

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
  return static_cast<int>(std::max(
      1LL, std::min<long long>({sms / base, table_tiles / kSplitMinTiles,
                                static_cast<long long>(kMaxSplits)})));
}

int run(const void* q, const void* k_pool, const void* v_pool, const void* tables,
        const void* q_lens, const void* kv_lens, void* out, void* part_o, void* part_ml, int R,
        int C, int Hq, int Hkv, int NB, int bs, int D, int nb, int splits, float scale,
        cudaStream_t stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
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
  const int table_tiles = (nb * bs + kBN - 1) / kBN;
  a.per_split = (table_tiles + splits - 1) / splits;
  a.box_rows = bs % 32 == 0 ? 32 : bs % 16 == 0 ? 16 : 8;
  a.scale = scale;
  if (splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return D > 64 ? launch<128>(a, k_pool, v_pool, stream) : launch<64>(a, k_pool, v_pool, stream);
}

}  // namespace ptt_ragged_tf32
