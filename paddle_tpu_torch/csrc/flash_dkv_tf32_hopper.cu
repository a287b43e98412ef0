// Flash attention dK/dV in fp32 for Hopper (sm_90a), on the TF32 tensor
// cores: each fp32 operand split into two TF32 halves and every product
// taken as three wgmma products (flash_hopper.cuh, "fp32 operands on the TF32
// tensor cores"). dk and dv as flash_attention.cu's backward note states
// them, from the forward's lse and the delta that the dQ kernel
// (flash_dq_tf32_hopper.cu) writes first on the same stream. Widths 64, 128,
// 192 and 256 (D_pad 32 and 96 read into 64 and 128 with zero columns): every
// fp32 dK/dV.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_bwd_impl`'s dK/dV
// pallas_call (kernel body `_dkv_kernel`, masks `_mask_scores`) in fp32 on all
// its operands: causal / non-causal and the window as one band, GQA (the
// group's query heads summed inside the block: no atomics, deterministic),
// the bias in its own dtype, segment ids, the flashmask rows and dropout with
// the forward's keep bits. It took the place of an FP32-pipe dK/dV kernel, at
// D_pad <= 128 first and then at 192 and 256, where that kernel went.
//
// Bound on an H100 SXM: 8 D FLOPs a visible pair (s, dP, dv, dk), each
// three times on the tensor cores at 495 TFLOP/s dense TF32 (or 8 D at 67
// TFLOP/s on the FP32 pipes). The kernel does those four products and no
// more.
//
// Design. One block of 384 threads owns 64 keys of one (batch, kv head):
// warpgroup 0 the producer (setmaxnreg 64), warpgroups 1 and 2 consumers over
// the same 64 keys, as the 16-bit kernel's split design (flash_dkv_hopper.cu):
// warpgroup 1 forms S^T, p and dv (setmaxnreg 224), warpgroup 2 dP^T, ds and
// dk (216). The products are taken transposed where the head dim is the
// output's row: dv^T += dO^T P^T and dk^T += Q^T dS^T.
// - K and V land raw by TMA once (32 + 32 KB at D_pad 128, 64 + 64 at 256);
//   S^T = K Q^T and dP^T = V dO^T take them as the register A, split each
//   query tile (gemm_raw).
// - Q and dO stream through a TMA ring of query tiles (flash_common.cuh
//   tf32_dkv_tile / tf32_dkv_stages: two stages of 32 queries up to D_pad
//   128, two of 16 at 192, one of 16 at 256; the group's g query heads times
//   each head's tiles in the band, one list, so dk and dv sum the group in
//   registers). Warp 0 decides the integer masks' skips, writes the tile's
//   lse (+inf on a dead row or one past Sq) and delta into the
//   stage's slot and issues the loads; warps 1-3 split each landed tile in
//   place (perm8) and arrive on `full`. A stage's four halves take 64 KB at
//   D_pad 128, and at 256 (16 queries) as much.
// - Warpgroup 1 writes p, dropped and rescaled, split into the [64 keys][32
//   queries] tiles phi / plo (the B of dv^T: A = dO^T read across the dO
//   tile's rows, frag_t; a tile of 16 queries fills their first 16 columns),
//   and p itself, negated where dropped, into dshi for warpgroup 2
//   (`pready`); warpgroup 2 reads it back from the same places of its own
//   fragment, forms ds = p (dP - delta) and writes it split over it into
//   dshi / dslo (the B of dk^T), then frees the tile on `dsfree` before
//   warpgroup 1 writes the next p there. 32 KB for the four tiles.
// - dk^T and dv^T accumulate in registers (D_pad / 2 each: 128 at D_pad 256,
//   where the products of each tile's 64-column blocks go one at a time into
//   a fresh accumulator, gemm_t_wide) and are written once, dk times the
//   scale.
// Shared memory: 64 + 128 + 32 KB and the slots at D_pad 128 (226 KB of the
// 227), 96 + 96 + 32 at 192, 128 + 64 + 32 at 256: one block an SM.

#include "flash_hopper.cuh"

#ifndef PTT_FLASH_D
#error "compile once per TF32 width: -DPTT_FLASH_D=<64|128|192|256>"
#endif

namespace ptt_flash {
namespace hopper {
namespace {

constexpr int kKB = kTf32DkvBN;  // keys a block (flash_common.cuh)
constexpr int kSplitters = 96;   // producer warps 1-3
// setmaxnreg: the block launches at 168 registers a thread (65536 / 384),
// and the warpgroups' new budgets may sum to no more than 3 x 168: 64 for
// the producer (its warp 0 holds the integer masks' reductions beside the
// split loop of warps 1-3; at 56 the D_pad 64 instances with the integer
// masks spilled 4-8 bytes), 224 for warpgroup 1 (the masks, the bias and
// the dropout bits beside its products) and 216 for warpgroup 2.
constexpr int kProdRegs = 64;
constexpr int kPRegs = 224;
constexpr int kDsRegs = 216;
static_assert(kProdRegs + kPRegs + kDsRegs <= 3 * (65536 / kThreadsH / 8 * 8),
              "setmaxnreg.inc would wait for registers no warpgroup gave back");

template <int D>
struct DkvTf32Smem {
  static constexpr int kP = f32_panels(D);
  static constexpr int kNQ = tf32_dkv_tile(D), kStages = tf32_dkv_stages(D);  // queries a tile
  using QSlot = QSlotT<kNQ>;
  float k[kP][kKB * 32];  // raw, [64][D] in panels of 32 columns
  float v[kP][kKB * 32];
  float qhi[kStages][kP][kNQ * 32], qlo[kStages][kP][kNQ * 32];  // split, perm8
  float dohi[kStages][kP][kNQ * 32], dolo[kStages][kP][kNQ * 32];
  float phi[kKB * 32], plo[kKB * 32];    // [64 keys][32 queries], split
  float dshi[kKB * 32], dslo[kKB * 32];  // p from warpgroup 1, then ds split
  uint64_t raw[kStages], full[kStages], empty[kStages], kvbar, pready, dsfree;
  QSlot slot[kStages];
};

template <int D>
__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase) {
  if (++stage == DkvTf32Smem<D>::kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// Warp 0 of the producer: K and V once, then the group's query tiles through
// the ring, and the end marker (as flash_dkv_hopper.cu's producer).
template <int D>
__device__ __forceinline__ void produce(DkvTf32Smem<D>& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv,
                                        const CUtensorMap* tdo, const Args& a, KeyBlockPos pos,
                                        bool seg, bool fm) {
  constexpr int kP = DkvTf32Smem<D>::kP, kNQ = DkvTf32Smem<D>::kNQ;
  const int k0 = pos.k0, hk = pos.hk, b = pos.b, g = a.H / a.Hkv;
  const int lane = threadIdx.x;
  const bool mine = lane < kNQ;  // a tile of 16 queries: lanes 16-31 hold none
  if (lane == 0) {
    tma_prefetch_map(tq);
    tma_prefetch_map(tdo);
    mbar_arrive_tx(&sm.kvbar, 2 * kKB * D * 4);
    for (int p = 0; p < kP; ++p) {
      tma_load(sm.k[p], tk, &sm.kvbar, 32 * p, k0, hk, b);
      tma_load(sm.v[p], tv, &sm.kvbar, 32 * p, k0, hk, b);
    }
  }
  int klo = INT_MAX, khi = INT_MIN;  // the block's keys' segment-id range
  if (seg) {
#pragma unroll
    for (int u = 0; u < kKB / 32; ++u) {
      const int kp = k0 + lane + 32 * u;
      if (kp < a.Sk) {
        const int id = a.kseg[static_cast<long long>(b) * a.Sk + kp];
        klo = min(klo, id);
        khi = max(khi, id);
      }
    }
    klo = __reduce_min_sync(0xffffffffu, klo);
    khi = __reduce_max_sync(0xffffffffu, khi);
  }
  const int qbegin = blk_query_begin<kNQ>(k0, a), qend = blk_query_end<kKB>(k0, a);
  int stage = 0;
  uint32_t phase = 0;
  int smax = INT_MIN, emin = INT_MAX;
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    if (fm && (hh == 0 || a.fm_hs != 0)) {
      // the block's keys' greatest start and least end for this head (a key
      // past Sk masks every query: it never keeps a tile alive)
      const long long rows = fm_row(a, b, h);
      smax = INT_MIN;
      emin = INT_MAX;
#pragma unroll
      for (int u = 0; u < kKB / 32; ++u) {
        const int kp = k0 + lane + 32 * u;
        smax = max(smax, kp < a.Sk ? a.fms[rows + kp] : INT_MIN);
        emin = min(emin, kp < a.Sk ? a.fme[rows + kp] : INT_MAX);
      }
      smax = __reduce_max_sync(0xffffffffu, smax);
      emin = __reduce_min_sync(0xffffffffu, emin);
    }
    const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
    // the head's query tiles from the last down: the key blocks of a head
    // that run together (key_block_pos) then read the same Q and dO tiles at
    // about the same time, and all but the first find them in L2
    const int ntiles = qend > qbegin ? (qend - qbegin + kNQ - 1) / kNQ : 0;
    for (int i = ntiles - 1; i >= 0; --i) {
      const int q0 = qbegin + i * kNQ;
      const int qp = q0 + lane;
      const bool in = mine && qp < a.Sq;
      int id = 0, qlo = 0, qhi = 0;
      if (seg) {
        id = in ? a.qseg[static_cast<long long>(b) * a.Sq + qp] : 0;
        qlo = __reduce_min_sync(0xffffffffu, in ? id : INT_MAX);
        qhi = __reduce_max_sync(0xffffffffu, in ? id : INT_MIN);
        if (!seg_overlap(qlo, qhi, klo, khi)) continue;
      }
      if (fm && smax <= q0 && emin >= min(q0 + kNQ, a.Sq)) continue;
      mbar_wait(&sm.empty[stage], phase ^ 1);
      auto& sl = sm.slot[stage];
      if (mine) {
        const float l = in ? a.lse[row_base + qp] : kNegInf;
        // a dead row (lse -1e30) or one past Sq: p = exp2(-inf) = 0
        sl.lse[lane] = l <= 0.5f * kNegInf ? __int_as_float(0x7f800000) : l;
        sl.delta[lane] = in ? a.delta[row_base + qp] : 0.f;
        if (seg) sl.qids[lane] = id;
      }
      if (lane == 0) {
        sl.q0 = q0;
        sl.hh = hh;
        sl.qlo = qlo;
        sl.qhi = qhi;
        mbar_arrive_tx(&sm.raw[stage], 2 * kNQ * D * 4);
        for (int p = 0; p < kP; ++p) {
          tma_load(sm.qhi[stage][p], tq, &sm.raw[stage], 32 * p, q0, h, b);
          tma_load(sm.dohi[stage][p], tdo, &sm.raw[stage], 32 * p, q0, h, b);
        }
      } else {
        mbar_arrive(&sm.raw[stage]);
      }
      next_stage<D>(stage, phase);
    }
  }
  mbar_wait(&sm.empty[stage], phase ^ 1);  // the end of the list
  if (lane == 0) sm.slot[stage].q0 = -1;
  mbar_arrive(&sm.raw[stage]);
}

// Warps 1-3 of the producer: split each landed Q / dO tile in place.
template <int D>
__device__ __forceinline__ void split_stream(DkvTf32Smem<D>& sm) {
  constexpr int kBytes = DkvTf32Smem<D>::kP * DkvTf32Smem<D>::kNQ * 128;
  const int tid = threadIdx.x - 32;
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.raw[stage], phase);
    const int q0 = sm.slot[stage].q0;
    if (q0 >= 0) {
      split_tiles(sm.qhi[stage][0], sm.qlo[stage][0], sm.dohi[stage][0], sm.dolo[stage][0],
                  kBytes, tid, kSplitters);
      fence_proxy_async();
    }
    mbar_arrive(&sm.full[stage]);
    next_stage<D>(stage, phase);
    if (q0 < 0) break;
  }
}

// This thread's rows of a [D][64 keys] accumulator (block m, register
// 4 j + 2 i + e: head column 64 m + 16 w + l / 4 + 8 i, key 8 j + 2 (l % 4)
// + e) times `mul` into [B, Sk, H_kv, D].
template <int D>
__device__ __forceinline__ void store_keys_t(void* dst, const float (&acc)[D / 64][32], float mul,
                                             const Args& a, int b, int hk, int k0) {
  const int t = threadIdx.x % 128, lane = t % 32;
  float* out = static_cast<float*>(dst);
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = 64 * m + 16 * (t / 32) + lane / 4 + 8 * i;
      if (d >= a.D) continue;
#pragma unroll
      for (int j = 0; j < kKB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * (lane % 4) + e;
          if (kp < a.Sk)
            out[((static_cast<long long>(b) * a.Sk + kp) * a.Hkv + hk) * a.D + d] =
                acc[m][4 * j + 2 * i + e] * mul;
        }
    }
}

// acc (dv^T or dk^T, [D][64 keys]) += X^T B over a query tile: X the split
// dO or Q tile (frag_t), B the split [64 keys][32 queries] p or ds tile;
// past D_pad 128 one 64-column block at a time into the caller's
// accumulator `part` (gemm_t_wide: acc's 128 registers leave no room for
// two).
template <int D>
__device__ __forceinline__ void key_product(float (&acc)[D / 64][32], float (&part)[1][32],
                                            const float* xhi, const float* xlo, const float* bhi,
                                            const float* blo) {
  constexpr int kNQ = DkvTf32Smem<D>::kNQ;
  const unsigned char* h = reinterpret_cast<const unsigned char*>(xhi);
  const unsigned char* l = reinterpret_cast<const unsigned char*>(xlo);
  if constexpr (D > 128) {
    gemm_t_wide<kKB, D, kNQ / 8, 1>(acc, part, h, l, kNQ * 128, smem_u32(bhi), smem_u32(blo));
  } else {
    gemm_t<kKB, D>(acc, h, l, kNQ * 128, smem_u32(bhi), smem_u32(blo));
  }
}

// Warpgroup 1: S^T, p (its masks, bias and dropout bits), dv.
template <int D, bool kBias, bool kInt, bool kDrop>
__device__ __forceinline__ void consume_p(DkvTf32Smem<D>& sm, const Args& a, KeyBlockPos pos,
                                          bool seg, bool fm) {
  constexpr int kNQ = DkvTf32Smem<D>::kNQ;
  constexpr uint32_t kKPanel = kKB * 128, kQPanel = kNQ * 128;
  const int k0 = pos.k0, hk = pos.hk, b = pos.b, g = a.H / a.Hkv;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int kpos[2] = {k0 + 16 * (t / 32) + lane / 4, k0 + 16 * (t / 32) + lane / 4 + 8};
  float dvt[D / 64][32], prod[1][32];  // prod: key_product's, past D_pad 128
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int c = 0; c < 32; ++c) dvt[m][c] = 0.f;
  const unsigned char* kt = reinterpret_cast<const unsigned char*>(sm.k[0]);
  unsigned char* phi = reinterpret_cast<unsigned char*>(sm.phi);
  unsigned char* plo = reinterpret_cast<unsigned char*>(sm.plo);
  float* pw = sm.dshi;

  mbar_wait(&sm.kvbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int n = 0;; ++n) {
    mbar_wait(&sm.full[stage], phase);
    const auto& sl = sm.slot[stage];
    const int q0 = sl.q0;
    if (q0 < 0) break;
    const bool live = !tile_out_of_band<kKB, kNQ>(q0, k0, a);
    if (live) {
      const int h = hk * g + sl.hh;
      int kid[2] = {0, 0}, fs[2] = {0, 0}, fe[2] = {0, 0};
      if (seg)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          kid[i] = kpos[i] < a.Sk ? a.kseg[static_cast<long long>(b) * a.Sk + kpos[i]] : 0;
      if (fm) key_rows(a, b, h, kpos, fs, fe);
      const uint64_t vis = kt_tile_mask<kInt>(a, sl, seg, fm, q0, k0, kpos, kid, fs, fe);
      const uint64_t keep = kDrop ? kt_keep_bits<kNQ>(a, b, h, q0, kpos[0]) : 0;
      float s[kNQ / 2];
      gemm_raw<kNQ, D>(s, kt, kKPanel, smem_u32(sm.qhi[stage][0]), smem_u32(sm.qlo[stage][0]),
                       kQPanel);
      // p = exp2((scale s + bias - lse) log2 e) in the dQ kernel's order
      // (probs_tile): both kernels then form the same p from the same s, and
      // the delta that the dQ kernel sums balances this kernel's ds too. (As
      // fma(s, scale log2 e, -lse log2 e), p near 1 came out some 1e-6 off
      // the dQ kernel's, and dk drifted past 5e-6 of the plain version on
      // the worst tile where a few keys hold a row.)
#pragma unroll
      for (int r = 0; r < kNQ / 2; ++r) s[r] *= a.scale;
      if (kBias) add_bias_kt<false, kNQ>(s, a, bias_base(a, b, h), q0, kpos, vis);
      if (n > 0) mbar_wait(&sm.dsfree, (n - 1) & 1);  // warpgroup 2 is done with dshi
#pragma unroll
      for (int j = 0; j < kNQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(&sl.lse[8 * j + 2 * (lane % 4)]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i;
          float pd[2], pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = (s[r + e] - (e ? l2.y : l2.x)) * kLog2e;
            const float p = (vis >> (r + e)) & 1u ? exp2f(x) : 0.f;
            const bool kept = !kDrop || ((keep >> (r + e)) & 1u);
            pd[e] = kDrop ? (kept ? p * a.drop_scale : 0.f) : p;
            pv[e] = kept ? p : -p;
          }
          const uint32_t off = frag_pair_off(i, j);
          store_split_pair(phi, plo, off, pd[0], pd[1]);
          store_pair(reinterpret_cast<unsigned char*>(pw), off, pv[0], pv[1]);
        }
      }
      fence_proxy_async();
      mbar_arrive(&sm.pready);
      wg_sync(1);  // every p of the tile written
      key_product<D>(dvt, prod, sm.dohi[stage][0], sm.dolo[stage][0], sm.phi, sm.plo);
    } else {
      if (n > 0) mbar_wait(&sm.dsfree, (n - 1) & 1);
      mbar_arrive(&sm.pready);  // a tile out of the band: nothing to hand over
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    next_stage<D>(stage, phase);
  }
  store_keys_t<D>(a.dv, dvt, 1.f, a, b, hk, k0);
}

// Warpgroup 2: dP^T, ds (from warpgroup 1's p), dk.
template <int D, bool kDrop>
__device__ __forceinline__ void consume_ds(DkvTf32Smem<D>& sm, const Args& a, KeyBlockPos pos) {
  constexpr int kNQ = DkvTf32Smem<D>::kNQ;
  constexpr uint32_t kKPanel = kKB * 128, kQPanel = kNQ * 128;
  const int k0 = pos.k0, hk = pos.hk, b = pos.b;
  const int t = threadIdx.x % 128, lane = t % 32;
  float dkt[D / 64][32], prod[1][32];  // prod: key_product's, past D_pad 128
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int c = 0; c < 32; ++c) dkt[m][c] = 0.f;
  const unsigned char* vt = reinterpret_cast<const unsigned char*>(sm.v[0]);
  unsigned char* dshi = reinterpret_cast<unsigned char*>(sm.dshi);
  unsigned char* dslo = reinterpret_cast<unsigned char*>(sm.dslo);

  mbar_wait(&sm.kvbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int n = 0;; ++n) {
    mbar_wait(&sm.full[stage], phase);
    const auto& sl = sm.slot[stage];
    const int q0 = sl.q0;
    if (q0 < 0) break;
    if (!tile_out_of_band<kKB, kNQ>(q0, k0, a)) {
      float dp[kNQ / 2];
      // one group of V's fragments in flight at D_pad 256: with two, dk^T's
      // 128 registers spilled 96 bytes in every instance (216 a thread)
      gemm_raw<kNQ, D, (D > 128 ? 2 : 4), (D > 192 ? 1 : 2)>(
          dp, vt, kKPanel, smem_u32(sm.dohi[stage][0]), smem_u32(sm.dolo[stage][0]), kQPanel);
      mbar_wait(&sm.pready, n & 1);
#pragma unroll
      for (int j = 0; j < kNQ / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(&sl.delta[8 * j + 2 * (lane % 4)]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i;
          const uint32_t off = frag_pair_off(i, j);
          const float2 w = load_pair(dshi, off);
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = e ? w.y : w.x, p = fabsf(v), del = e ? dl.y : dl.x;
            // a dropped element (v < 0) takes dP 0; p = 0 gives ds = 0 either way
            const float dpv = kDrop ? (v > 0.f ? dp[r + e] * a.drop_scale : 0.f) : dp[r + e];
            ds[e] = p * (dpv - del);
          }
          store_split_pair(dshi, dslo, off, ds[0], ds[1]);
        }
      }
      fence_proxy_async();
      wg_sync(2);  // every ds of the tile written
      key_product<D>(dkt, prod, sm.qhi[stage][0], sm.qlo[stage][0], sm.dshi, sm.dslo);
    } else {
      mbar_wait(&sm.pready, n & 1);
    }
    mbar_arrive(&sm.dsfree);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    next_stage<D>(stage, phase);
  }
  store_keys_t<D>(a.dk, dkt, a.scale, a, b, hk, k0);
}

template <int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const Args a) {
  using Smem = DkvTf32Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int st = 0; st < Smem::kStages; ++st) {
      mbar_init(&sm.raw[st], 32);  // the producer warp's lanes (they write the slot)
      mbar_init(&sm.full[st], kSplitters);
      mbar_init(&sm.empty[st], kConsumerWarps);
    }
    mbar_init(&sm.kvbar, 1);
    mbar_init(&sm.pready, 128);
    mbar_init(&sm.dsfree, 128);
    mbar_fence_init();
  }
  __syncthreads();

  const KeyBlockPos pos = key_block_pos<kKB>(a, static_cast<int>(blockIdx.x));
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;
  if (threadIdx.x < 128) {
    reg_dealloc<kProdRegs>();
    if (threadIdx.x < 32)
      produce<D>(sm, &tq, &tk, &tv, &tdo, a, pos, seg, fm);
    else
      split_stream<D>(sm);
    return;
  }
  if (threadIdx.x < 256) {
    reg_alloc<kPRegs>();
    consume_p<D, kBias, kInt, kDrop>(sm, a, pos, seg, fm);
  } else {
    reg_alloc<kDsRegs>();
    consume_ds<D, kDrop>(sm, a, pos);
  }
}

template <int D, bool kBias, bool kInt, bool kDrop>
int launch(const Args& a, cudaStream_t stream) {
  using Smem = DkvTf32Smem<D>;
  // the attribute first: a runtime call, it makes the device's context current
  // on this thread (autograd runs the backward on a thread of its own, where
  // cuTensorMapEncodeTiled failed as the first CUDA work)
  auto* kernel = flash_dkv_tf32_kernel<D, kBias, kInt, kDrop>;
  const size_t smem = sizeof(Smem) + 1024;
  static_assert(sizeof(Smem) + 1024 <= 232448, "over the 227 KB a block may hold");
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_view(&tq, a.q, a.vq, a.B, a.Sq, a.H, a.D, kF32, Smem::kNQ);
  if (err == 0) err = encode_view(&tdo, a.dout, a.vdo, a.B, a.Sq, a.H, a.D, kF32, Smem::kNQ);
  if (err == 0) err = encode_view(&tk, a.k, a.vk, a.B, a.Sk, a.Hkv, a.D, kF32, kKB);
  if (err == 0) err = encode_view(&tv, a.v, a.vv, a.B, a.Sk, a.Hkv, a.D, kF32, kKB);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>((a.Sk + kKB - 1) / kKB) * a.Hkv * a.B;
  kernel<<<grid, kThreadsH, smem, stream>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBias>
int launch_flags(const Args& a, cudaStream_t s) {
  const bool ints = a.qseg != nullptr || a.fms != nullptr, drop = a.drop != 0;
  if (ints && drop) return launch<D, kBias, true, true>(a, s);
  if (ints) return launch<D, kBias, true, false>(a, s);
  if (drop) return launch<D, kBias, false, true>(a, s);
  return launch<D, kBias, false, false>(a, s);
}

}  // namespace
}  // namespace hopper

template <int D>
int dkv_tf32_run(const Args& a, cudaStream_t s) {
  return a.bias != nullptr ? hopper::launch_flags<D, true>(a, s)
                           : hopper::launch_flags<D, false>(a, s);
}

template int dkv_tf32_run<PTT_FLASH_D>(const Args&, cudaStream_t);

}  // namespace ptt_flash
