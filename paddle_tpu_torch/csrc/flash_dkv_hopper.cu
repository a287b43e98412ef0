// Flash attention dK/dV for Hopper, redesigned for sm_90a: the bf16 and fp16
// kernel at every width (D_pad 64, 128, 192 and 256; the heads of D_pad 32
// and 96 are read into the next of those with zero columns). dk and dv as
// flash_attention.cu's backward note states them, from the forward's lse
// and the delta = rowsum(p * dP) that the dQ kernel (flash_dq_hopper.cu)
// writes first on the same stream.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_bwd_impl`'s dK/dV
// pallas_call (kernel body `_dkv_kernel`, masks `_mask_scores`) on all its
// operands: causal / non-causal and the window as one band, GQA (the group's
// query heads summed inside the block: no atomics, deterministic), the bias
// in its own dtype, segment ids, the flashmask rows and dropout with the
// forward's keep bits. It took the place of a WMMA kernel, first at D_pad
// <= 128, then at 192 and 256 (the split design below), where that kernel
// was deleted.
//
// Bound on an H100 SXM: 8 D FLOPs a visible pair (s, dP, dv, dk) against q,
// k, v, dO, lse, delta and dk, dv moved once: at the GPT flagship call 0.070
// ms of operations. The kernel does those four products and no more.
//
// Design at D_pad <= 128. One block of 384 threads owns 128 keys of one
// (batch, kv head): the producer warp (warpgroup 0, setmaxnreg 40) and two
// consumer warpgroups of 64 keys each (setmaxnreg 232).
// - Loads: K and V once by TMA, kept in shared memory. The producer streams
//   query tiles of 64 rows, Q and dO by TMA through a two-stage ring with
//   `full` and `empty` mbarriers (flash_hopper.cuh), the tile's lse (times
//   log2 e; +inf for a row past Sq or dead, so its p is exp2(-inf) = 0) and
//   delta written into the stage by its lanes. The stream is the group's g
//   query heads times each head's query tiles in the band of the block's
//   keys, one list, so dk and dv sum the group in registers. The producer
//   decides the integer masks' tile skips (disjoint segment ranges; every
//   pair inside the block's keys' flashmask rows) and ends the list with a
//   stage whose q0 is -1.
// - Transposed scores: S^T = K Q^T and dP^T = V dO^T by wgmma (A = the
//   warpgroup's 64 K / V rows, B = Q / dO, both K-major in the 128-byte
//   swizzle), so a thread's fragment rows are keys and its columns queries.
//   p = exp(scale s + bias - lse[query]) takes lse and delta a column, read
//   from the stage as float2. P^T (dropped and rescaled) and dS^T = p (dP -
//   delta), packed to T two by two, are exactly the register A fragments of
//   dV += P^T dO and dK += dS^T Q (B = dO / Q read MN-major, as the
//   forward's p v reads V). dk and dv accumulate in fp32 registers over the
//   whole stream and are written once, dk times the scale. No score, p or ds
//   goes to shared memory. At D_pad 128 a consumer thread holds 32 scores, 32
//   dP, 64 dk and 64 dv (192 registers) and 32 of packed P^T / dS^T.
// - Masks on the key-major fragment: the band and the integer masks as one
//   bit an element, formed while the S^T and dP^T products run (a thread
//   whose tile lies inside the band and whose keys the masks provably spare
//   skips the per-element test); the bias from unconditional clamped loads in
//   chunks (as flash_hopper.cuh add_bias; a fragment column is a query, so
//   the loads are strided by the bias's query stride).
// - Dropout keeps the forward's bit for (b, h, query i, key j): Philox word
//   j % 4 of the counter (j / 4, i, h, b) (flash_common.cuh drop_bits). The
//   four keys of one word sit in four lanes here (lane bits 2-3: fragment
//   rows 4 m + s, s = 0..3), which need one word each of the same call. Per
//   8-column group the four lanes make the four calls the group needs (lane
//   s: column 2 (l % 4) + (s >> 1) of the group, key row s & 1) and
//   exchange words with three shuffles: each thread makes 8 calls a tile,
//   not 32.
// - Order: blocks in groups of 16 (batch, kv head) pairs, the key tiles
//   that see the most queries under causal masking (the first) first in a
//   group, so the grid ends on short work and the blocks in flight share
//   their pairs' Q and dO in L2.
//
// Design at D_pad 192 and 256 (the split). A warpgroup's 64 keys need 64 x
// D_pad fp32 of dk and as much of dv: 96 + 96 or 128 + 128 registers a
// thread, over the 255 cap before the scores. So a block owns 64 keys, and
// its two consumer warpgroups share them: warpgroup 1 forms S^T, the masks,
// the bias, the dropout bits and p, and accumulates dV += P^T dO; warpgroup 2
// forms dP^T and, from warpgroup 1's p, dS^T, and accumulates dK += dS^T Q.
// Each holds one 64 x D_pad accumulator (128 registers at 256) beside 32
// scores and 16 registers of packed A fragment; warpgroup 1, which also
// forms the masks, the bias and the keep bits, takes 248 registers a thread
// and warpgroup 2 216 (setmaxnreg). The products stay the four
// of the bound, two a warpgroup, so the tensor cores see the 8 D FLOPs a
// pair and no recomputed S^T. p crosses in shared memory in fragment order
// (thread t of warpgroup 2 reads the 32 floats thread t of warpgroup 1
// wrote, as 8 float4 with the 128 threads' words adjacent: no bank
// conflict), fp32 and with a dropped element negated, so warpgroup 2 needs
// neither the masks nor the Philox calls; a `pready` mbarrier a stage (128
// arrivals, one a writer thread) orders it, and the stage's `empty` arrival
// of warpgroup 2, after its read, keeps warpgroup 1 from writing that
// stage's p again before it is read. Shared memory at D_pad 256: K and V of
// 64 keys 64 KB, two stages of Q and dO 128 KB, p 32 KB, the slots 1.6 KB:
// 226 KB of the 227 (at 192: 178 KB). Measured (NVIDIA H100 80GB HBM3,
// 700 W, kernels_ab.py at B 8, S 1024, H 16, causal): D 256 bf16 0.4181 ms
// against the WMMA kernel's 1.6355 in the same call (bound 0.1391), D 160
// 0.3318 (1.4318), D 256 fp16 0.4132 (1.1574).

#include "flash_hopper.cuh"

#ifndef PTT_FLASH_D
#error "compile once per redesigned width: -DPTT_FLASH_D=<64|128|192|256>"
#endif

namespace ptt_flash {
namespace hopper {
namespace {

constexpr int kBMQ = kDkvHopperBM;  // queries a streamed tile (flash_common.cuh)
constexpr int kDkvStages = 2;
using QSlot = QSlotT<kBMQ>;

template <typename T, int D>
struct DkvSmem {
  static constexpr int kP = D / 64;
  static constexpr int kBN = dkv_hopper_bn(D);  // keys a block
  static constexpr bool kSplit = D > 128;       // two warpgroups over the same 64 keys
  T k[kP][kBN * 64];
  T v[kP][kBN * 64];
  T q[kDkvStages][kP][kBMQ * 64];
  T dout[kDkvStages][kP][kBMQ * 64];
  // the split's p, [stage][fragment word c][thread]: 8 float4 a thread
  float4 p[kSplit ? kDkvStages * (kBMQ / 8) * 128 : 1];
  uint64_t full[kDkvStages], empty[kDkvStages], pready[kDkvStages], kvbar;
  QSlot slot[kDkvStages];
};

// The stage after `stage`: the ring's next stage, its phase flipped on the
// wrap.
__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase) {
  if (++stage == kDkvStages) {
    stage = 0;
    phase ^= 1;
  }
}

// The producer warp (warp 0 of warpgroup 0): K and V of the block's keys
// once, then the group's query tiles through the ring, and the end marker.
template <typename T, int D>
__device__ __forceinline__ void produce(DkvSmem<T, D>& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv,
                                        const CUtensorMap* tdo, const Args& a, KeyBlockPos pos,
                                        bool seg, bool fm) {
  constexpr int kP = D / 64, kBN = DkvSmem<T, D>::kBN;
  const int k0 = pos.k0, hk = pos.hk, b = pos.b, g = a.H / a.Hkv;
  const int lane = threadIdx.x;
  if (lane == 0) {
    tma_prefetch_map(tq);
    tma_prefetch_map(tdo);
    mbar_arrive_tx(&sm.kvbar, 2 * kBN * D * 2);
    for (int p = 0; p < kP; ++p) {
      tma_load(sm.k[p], tk, &sm.kvbar, 64 * p, k0, hk, b);
      tma_load(sm.v[p], tv, &sm.kvbar, 64 * p, k0, hk, b);
    }
  }
  // the block's keys' segment-id range (keys below Sk)
  int klo = INT_MAX, khi = INT_MIN;
  if (seg) {
#pragma unroll
    for (int u = 0; u < kBN / 32; ++u) {
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
  const int qbegin = blk_query_begin<kBMQ>(k0, a), qend = blk_query_end<kBN>(k0, a);
  int stage = 0;
  uint32_t phase = 0;
  int smax = INT_MIN, emin = INT_MAX;
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    if (fm && (hh == 0 || a.fm_hs != 0)) {
      // the block's keys' greatest start and least end for this head (a
      // key past Sk masks every query: it never keeps a tile alive)
      const long long rows = fm_row(a, b, h);
      smax = INT_MIN;
      emin = INT_MAX;
#pragma unroll
      for (int u = 0; u < kBN / 32; ++u) {
        const int kp = k0 + lane + 32 * u;
        smax = max(smax, kp < a.Sk ? a.fms[rows + kp] : INT_MIN);
        emin = min(emin, kp < a.Sk ? a.fme[rows + kp] : INT_MAX);
      }
      smax = __reduce_max_sync(0xffffffffu, smax);
      emin = __reduce_min_sync(0xffffffffu, emin);
    }
    const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int q0 = qbegin; q0 < qend; q0 += kBMQ) {
      int ids[2] = {0, 0}, qlo = 0, qhi = 0;
      if (seg) {
        qlo = INT_MAX;
        qhi = INT_MIN;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qp = q0 + lane + 32 * u;
          if (qp < a.Sq) {
            ids[u] = a.qseg[static_cast<long long>(b) * a.Sq + qp];
            qlo = min(qlo, ids[u]);
            qhi = max(qhi, ids[u]);
          }
        }
        qlo = __reduce_min_sync(0xffffffffu, qlo);
        qhi = __reduce_max_sync(0xffffffffu, qhi);
        if (!seg_overlap(qlo, qhi, klo, khi)) continue;
      }
      if (fm && smax <= q0 && emin >= min(q0 + kBMQ, a.Sq)) continue;
      mbar_wait(&sm.empty[stage], phase ^ 1);
      QSlot& sl = sm.slot[stage];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = lane + 32 * u, qp = q0 + r;
        const float l = qp < a.Sq ? a.lse[row_base + qp] : kNegInf;
        // a dead row (lse -1e30) or one past Sq: p = exp2(-inf) = 0
        sl.lse[r] = l <= 0.5f * kNegInf ? __int_as_float(0x7f800000) : l * kLog2e;
        sl.delta[r] = qp < a.Sq ? a.delta[row_base + qp] : 0.f;
        if (seg) sl.qids[r] = ids[u];
      }
      if (lane == 0) {
        sl.q0 = q0;
        sl.hh = hh;
        sl.qlo = qlo;
        sl.qhi = qhi;
        mbar_arrive_tx(&sm.full[stage], 2 * kBMQ * D * 2);
        for (int p = 0; p < kP; ++p) {
          tma_load(sm.q[stage][p], tq, &sm.full[stage], 64 * p, q0, h, b);
          tma_load(sm.dout[stage][p], tdo, &sm.full[stage], 64 * p, q0, h, b);
        }
      } else {
        mbar_arrive(&sm.full[stage]);
      }
      next_stage(stage, phase);
    }
  }
  mbar_wait(&sm.empty[stage], phase ^ 1);  // the end of the list
  if (lane == 0) sm.slot[stage].q0 = -1;
  mbar_arrive(&sm.full[stage]);
}

// This thread's rows of a 64 x D accumulator (register 4 j + 2 i + e: key
// row kpos[i], column 8 j + 2 (l % 4) + e) times `mul` into [B, Sk, H_kv, D].
template <typename T, int D>
__device__ __forceinline__ void store_keys(void* dst, const float (&acc)[D / 2], float mul,
                                           const Args& a, int b, int hk, const int (&kpos)[2]) {
  const int lane = threadIdx.x % 32;
  T* out = static_cast<T*>(dst);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= a.Sk) continue;
    const long long off = ((static_cast<long long>(b) * a.Sk + kpos[i]) * a.Hkv + hk) * a.D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < a.D) {
        const int r = 4 * j + 2 * i;
        *reinterpret_cast<uint32_t*>(out + off + col) = pack2<T>(acc[r] * mul, acc[r + 1] * mul);
      }
    }
  }
}

// D_pad <= 128: consumer warpgroup cw owns keys ka .. ka + 63 and holds both
// its dk and dv.
template <typename T, int D, bool kBias, bool kInt, bool kDrop>
__device__ __forceinline__ void consume_pairs(DkvSmem<T, D>& sm, const Args& a, KeyBlockPos pos,
                                              bool seg, bool fm) {
  constexpr int kBN = DkvSmem<T, D>::kBN;
  const int k0 = pos.k0, hk = pos.hk, b = pos.b, g = a.H / a.Hkv;
  const int wg = threadIdx.x / 128;
  const int cw = wg - 1, t = threadIdx.x - 128 * wg, lane = t % 32;
  const int ka = k0 + 64 * cw;
  const int kpos[2] = {ka + 16 * (t / 32) + lane / 4, ka + 16 * (t / 32) + lane / 4 + 8};
  int kid[2] = {0, 0}, fs[2] = {0, 0}, fe[2] = {0, 0};
  if (seg)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      kid[i] = kpos[i] < a.Sk ? a.kseg[static_cast<long long>(b) * a.Sk + kpos[i]] : 0;
  int rows_h = -1;  // the query head whose flashmask rows fs / fe hold
  const bool keys_live = ka < a.Sk;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) dk[c] = dv[c] = 0.f;
  const uint32_t kbase = smem_u32(sm.k[0]) + cw * 64 * 128;
  const uint32_t vbase = smem_u32(sm.v[0]) + cw * 64 * 128;
  constexpr uint32_t kKPanel = kBN * 128, kQPanel = kBMQ * 128;
  const float scale_log2 = a.scale * kLog2e;

  mbar_wait(&sm.kvbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.full[stage], phase);
    const QSlot& sl = sm.slot[stage];
    const int q0 = sl.q0;
    if (q0 >= 0 && keys_live && !tile_out_of_band<64>(q0, ka, a)) {
      const int h = hk * g + sl.hh;
      if (fm && (rows_h < 0 || (a.fm_hs != 0 && rows_h != h))) {
        key_rows(a, b, h, kpos, fs, fe);
        rows_h = h;
      }
      const uint32_t qb = smem_u32(sm.q[stage][0]), dob = smem_u32(sm.dout[stage][0]);
      float s[kBMQ / 2], dp[kBMQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBMQ, T>(s, desc_kmajor(kbase, kKPanel, kk), desc_kmajor(qb, kQPanel, kk),
                          kk > 0 ? 1 : 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBMQ, T>(dp, desc_kmajor(vbase, kKPanel, kk), desc_kmajor(dob, kQPanel, kk),
                          kk > 0 ? 1 : 0);
      wgmma_commit();
      // the masks and the dropout bits are formed while the tensor cores
      // form S^T and dP^T
      const uint64_t vis = kt_tile_mask<kInt>(a, sl, seg, fm, q0, ka, kpos, kid, fs, fe);
      const uint64_t keep = kDrop ? kt_keep_bits<kBMQ>(a, b, h, q0, kpos[0]) : 0;
      wgmma_wait_all();
      reg_fence(s);
      reg_fence(dp);
      if (kBias) {
#pragma unroll
        for (int r = 0; r < kBMQ / 2; ++r) s[r] *= a.scale;
        add_bias_kt<false, kBMQ>(s, a, bias_base(a, b, h), q0, kpos, vis);
      }
      uint32_t pa[kBMQ / 16][4], dsa[kBMQ / 16][4];
#pragma unroll
      for (int j = 0; j < kBMQ / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(&sl.lse[col]);
        const float2 dl = *reinterpret_cast<const float2*>(&sl.delta[col]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i;
          float p[2], pd[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lse2 = e ? l2.y : l2.x, del = e ? dl.y : dl.x;
            const float x = kBias ? s[r + e] * kLog2e - lse2 : fmaf(s[r + e], scale_log2, -lse2);
            p[e] = (vis >> (r + e)) & 1u ? exp2f(x) : 0.f;
            const bool kept = !kDrop || ((keep >> (r + e)) & 1u);
            pd[e] = kDrop ? (kept ? p[e] * a.drop_scale : 0.f) : p[e];
            const float dpv = kDrop ? (kept ? dp[r + e] * a.drop_scale : 0.f) : dp[r + e];
            ds[e] = p[e] * (dpv - del);
          }
          // registers 8 kk + 2 c, + 1 of the fragment are A register c of
          // query step kk: r = 4 j + 2 i, so kk = j / 2, c = 2 (j % 2) + i
          pa[j / 2][2 * (j % 2) + i] = pack2<T>(pd[0], pd[1]);
          dsa[j / 2][2 * (j % 2) + i] = pack2<T>(ds[0], ds[1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBMQ / 16; ++kk) {
        wgmma_rs_cols<D, T>(dv, pa[kk], dob, kQPanel, kk);
        wgmma_rs_cols<D, T>(dk, dsa[kk], qb, kQPanel, kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(pa);
      reg_fence(dsa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    next_stage(stage, phase);
    if (q0 < 0) break;
  }
  store_keys<T, D>(a.dk, dk, a.scale, a, b, hk, kpos);
  store_keys<T, D>(a.dv, dv, 1.f, a, b, hk, kpos);
}

// D_pad 192 / 256, the split: both consumer warpgroups over the block's 64
// keys, each with its own register budget (setmaxnreg; 40 x 128 + 248 x
// 128 + 216 x 128 <= 64 K). Warpgroup 1 (split_p, 248: the masks, the bias
// loads and the Philox calls beside its 128 dv registers and 32 scores;
// under 232 the instances with a bias spilled 4-16 bytes a thread) forms
// S^T, p and dv and hands p over in the stage's p words, a dropped element
// negated; warpgroup 2 (split_ds, 216) forms dP^T, reads p, and forms ds
// and dk.
constexpr int kSplitPRegs = 248;
constexpr int kSplitDsRegs = 216;

// The key rows of this thread's fragment (rows 16 w + l / 4 and + 8 of the
// warpgroup's 64 keys from k0).
__device__ __forceinline__ void split_kpos(int k0, int (&kpos)[2]) {
  const int t = threadIdx.x % 128, lane = t % 32;
  kpos[0] = k0 + 16 * (t / 32) + lane / 4;
  kpos[1] = kpos[0] + 8;
}

template <typename T, int D, bool kBias, bool kInt, bool kDrop>
__device__ __forceinline__ void split_p(DkvSmem<T, D>& sm, const Args& a, KeyBlockPos pos,
                                        bool seg, bool fm) {
  constexpr int kWords = kBMQ / 8;
  const int k0 = pos.k0, hk = pos.hk, b = pos.b, g = a.H / a.Hkv;
  const int t = threadIdx.x % 128, lane = t % 32;
  int kpos[2];
  split_kpos(k0, kpos);
  float dv[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) dv[c] = 0.f;
  const uint32_t kbase = smem_u32(sm.k[0]);
  constexpr uint32_t kKPanel = 64 * 128, kQPanel = kBMQ * 128;
  const float scale_log2 = a.scale * kLog2e;

  mbar_wait(&sm.kvbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.full[stage], phase);
    const QSlot& sl = sm.slot[stage];
    const int q0 = sl.q0;
    if (q0 < 0) break;
    if (!tile_out_of_band<64>(q0, k0, a)) {
      const int h = hk * g + sl.hh;
      // the keys' segment ids and flashmask rows, read again each tile (from
      // L1): held across the stream, they pushed the instances with a bias
      // over the registers
      int kid[2] = {0, 0}, fs[2] = {0, 0}, fe[2] = {0, 0};
      if (seg)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          kid[i] = kpos[i] < a.Sk ? a.kseg[static_cast<long long>(b) * a.Sk + kpos[i]] : 0;
      if (fm) key_rows(a, b, h, kpos, fs, fe);
      const uint32_t qb = smem_u32(sm.q[stage][0]), dob = smem_u32(sm.dout[stage][0]);
      float s[kBMQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBMQ, T>(s, desc_kmajor(kbase, kKPanel, kk), desc_kmajor(qb, kQPanel, kk),
                          kk > 0 ? 1 : 0);
      wgmma_commit();
      const uint64_t vis = kt_tile_mask<kInt>(a, sl, seg, fm, q0, k0, kpos, kid, fs, fe);
      // beside a bias the keep bits wait until it is added (fewer registers
      // live across the bias loads)
      uint64_t keep = kDrop && !kBias ? kt_keep_bits<kBMQ>(a, b, h, q0, kpos[0]) : 0;
      wgmma_wait_all();
      reg_fence(s);
      if (kBias) {
#pragma unroll
        for (int r = 0; r < kBMQ / 2; ++r) s[r] *= a.scale;
        add_bias_kt<true, kBMQ>(s, a, bias_base(a, b, h), q0, kpos, vis);
        if (kDrop) keep = kt_keep_bits<kBMQ>(a, b, h, q0, kpos[0]);
      }
      uint32_t pa[kBMQ / 16][4];
      float4* pw = sm.p + stage * kWords * 128 + t;  // this thread's p words, 128 apart
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(&sl.lse[8 * j + 2 * (lane % 4)]);
        float pv[4];  // registers 4 j .. 4 j + 3: p, negated where dropped
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i;
          float pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lse2 = e ? l2.y : l2.x;
            const float x = kBias ? s[r + e] * kLog2e - lse2 : fmaf(s[r + e], scale_log2, -lse2);
            const float p = (vis >> (r + e)) & 1u ? exp2f(x) : 0.f;
            const bool kept = !kDrop || ((keep >> (r + e)) & 1u);
            pd[e] = kDrop ? (kept ? p * a.drop_scale : 0.f) : p;
            pv[2 * i + e] = kept ? p : -p;
          }
          pa[j / 2][2 * (j % 2) + i] = pack2<T>(pd[0], pd[1]);
        }
        pw[j * 128] = make_float4(pv[0], pv[1], pv[2], pv[3]);
      }
      mbar_arrive(&sm.pready[stage]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBMQ / 16; ++kk) wgmma_rs_cols<D, T>(dv, pa[kk], dob, kQPanel, kk);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dv);
      reg_fence(pa);
    } else {
      mbar_arrive(&sm.pready[stage]);  // a tile out of the band: nothing to hand over
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    next_stage(stage, phase);
  }
  store_keys<T, D>(a.dv, dv, 1.f, a, b, hk, kpos);
}

template <typename T, int D, bool kDrop>
__device__ __forceinline__ void split_ds(DkvSmem<T, D>& sm, const Args& a, KeyBlockPos pos) {
  constexpr int kWords = kBMQ / 8;
  const int k0 = pos.k0, hk = pos.hk, b = pos.b;
  const int t = threadIdx.x % 128, lane = t % 32;
  int kpos[2];
  split_kpos(k0, kpos);
  float dk[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) dk[c] = 0.f;
  const uint32_t vbase = smem_u32(sm.v[0]);
  constexpr uint32_t kKPanel = 64 * 128, kQPanel = kBMQ * 128;

  mbar_wait(&sm.kvbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.full[stage], phase);
    const QSlot& sl = sm.slot[stage];
    const int q0 = sl.q0;
    if (q0 < 0) break;
    if (!tile_out_of_band<64>(q0, k0, a)) {
      const uint32_t qb = smem_u32(sm.q[stage][0]), dob = smem_u32(sm.dout[stage][0]);
      float dp[kBMQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBMQ, T>(dp, desc_kmajor(vbase, kKPanel, kk), desc_kmajor(dob, kQPanel, kk),
                          kk > 0 ? 1 : 0);
      wgmma_commit();
      mbar_wait(&sm.pready[stage], phase);
      wgmma_wait_all();
      reg_fence(dp);
      const float4* pw = sm.p + stage * kWords * 128 + t;
      uint32_t dsa[kBMQ / 16][4];
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(&sl.delta[8 * j + 2 * (lane % 4)]);
        const float4 w = pw[j * 128];
        const float pv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = pv[2 * i + e], p = fabsf(v), del = e ? dl.y : dl.x;
            // a dropped element (v < 0) takes dP 0; p = 0 gives ds = 0 either way
            const float dpv = kDrop ? (v > 0.f ? dp[r + e] * a.drop_scale : 0.f) : dp[r + e];
            ds[e] = p * (dpv - del);
          }
          dsa[j / 2][2 * (j % 2) + i] = pack2<T>(ds[0], ds[1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBMQ / 16; ++kk) wgmma_rs_cols<D, T>(dk, dsa[kk], qb, kQPanel, kk);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dk);
      reg_fence(dsa);
    } else {
      mbar_wait(&sm.pready[stage], phase);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    next_stage(stage, phase);
  }
  store_keys<T, D>(a.dk, dk, a.scale, a, b, hk, kpos);
}

template <typename T, int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, const Args a) {
  using Smem = DkvSmem<T, D>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const KeyBlockPos pos = key_block_pos<Smem::kBN>(a, static_cast<int>(blockIdx.x));
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kDkvStages; ++st) {
      mbar_init(&sm.full[st], 32);  // the producer warp's lanes (they write the slot)
      mbar_init(&sm.empty[st], kConsumerWarps);
      mbar_init(&sm.pready[st], 128);  // the split's p writers
    }
    mbar_init(&sm.kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: warp 0 streams the group's query tiles
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) produce<T, D>(sm, &tq, &tk, &tv, &tdo, a, pos, seg, fm);
    return;
  }
  if constexpr (Smem::kSplit) {
    if (threadIdx.x < 256) {
      reg_alloc<kSplitPRegs>();
      split_p<T, D, kBias, kInt, kDrop>(sm, a, pos, seg, fm);
    } else {
      reg_alloc<kSplitDsRegs>();
      split_ds<T, D, kDrop>(sm, a, pos);
    }
  } else {
    reg_alloc<kConsumerRegs>();
    consume_pairs<T, D, kBias, kInt, kDrop>(sm, a, pos, seg, fm);
  }
}

template <typename T, int D, bool kBias, bool kInt, bool kDrop>
int launch(const Args& a, int dtype, cudaStream_t stream) {
  using Smem = DkvSmem<T, D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_view(&tq, a.q, a.vq, a.B, a.Sq, a.H, a.D, dtype, kBMQ);
  if (err == 0) err = encode_view(&tdo, a.dout, a.vdo, a.B, a.Sq, a.H, a.D, dtype, kBMQ);
  if (err == 0) err = encode_view(&tk, a.k, a.vk, a.B, a.Sk, a.Hkv, a.D, dtype, Smem::kBN);
  if (err == 0) err = encode_view(&tv, a.v, a.vv, a.B, a.Sk, a.Hkv, a.D, dtype, Smem::kBN);
  if (err != 0) return err;
  auto* kernel = flash_dkv_wgmma_kernel<T, D, kBias, kInt, kDrop>;
  const size_t smem = sizeof(Smem) + 1024;
  static_assert(sizeof(Smem) + 1024 <= 232448, "over the 227 KB a block may hold");
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((a.Sk + Smem::kBN - 1) / Smem::kBN) * a.Hkv * a.B;
  kernel<<<grid, kThreadsH, smem, stream>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kBias>
int launch_flags(const Args& a, int dtype, cudaStream_t s) {
  const bool ints = a.qseg != nullptr || a.fms != nullptr, drop = a.drop != 0;
  if (ints && drop) return launch<T, D, kBias, true, true>(a, dtype, s);
  if (ints) return launch<T, D, kBias, true, false>(a, dtype, s);
  if (drop) return launch<T, D, kBias, false, true>(a, dtype, s);
  return launch<T, D, kBias, false, false>(a, dtype, s);
}

template <typename T, int D>
int launch_bias(const Args& a, int dtype, cudaStream_t s) {
  return a.bias != nullptr ? launch_flags<T, D, true>(a, dtype, s)
                           : launch_flags<T, D, false>(a, dtype, s);
}

}  // namespace
}  // namespace hopper

template <int D>
int dkv_hopper_run(const Args& a, int dtype, cudaStream_t s) {
  return dtype == kBF16 ? hopper::launch_bias<bf16, D>(a, dtype, s)
                        : hopper::launch_bias<f16, D>(a, dtype, s);
}

template int dkv_hopper_run<PTT_FLASH_D>(const Args&, int, cudaStream_t);

}  // namespace ptt_flash
