// Flash attention dQ for Hopper, redesigned for sm_90a: the bf16 and fp16
// kernel at D_pad 64, 128, 192 and 256 (and the heads of D_pad 32 and 96,
// read into the next of those with zero columns). dq, delta = rowsum(p * dP) for the
// dK/dV kernel, and the d-bias, as flash_attention.cu's backward note states
// them, with its two passes and its hi / lo split of ds (the note says why
// each exists).
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_bwd_impl`'s dQ
// pallas_call (kernel body `_dq_kernel`, masks `_mask_scores`) on all its
// operands: causal / non-causal and the window, GQA, the bias in its own
// dtype (and its gradient, dS without the scale, fp32 [B, H, Sq, Sk] with
// zeros on every tile the kernel skips), segment ids, the flashmask rows and
// dropout. It took the place of a WMMA kernel at every width; the dK/dV
// kernel reads this kernel's delta.
//
// Bound on an H100 SXM: 6 D FLOPs a visible pair (s, dP, dq) against
// q, k, v, dO and dq moved once: at the GPT flagship call 0.052 ms of
// operations. The kernel does 12 D: its delta pass recomputes s and dP, and
// the lo half of ds doubles the dq product; both stay (converged-keys and
// q / k witness checks in chip_smoke.py).
//
// Design. One block of 384 threads owns 128 query rows of one (batch,
// head): the producer warp (warpgroup 0, setmaxnreg 40) and two consumer
// warpgroups of 64 rows (setmaxnreg 232). Key tiles (flash_common.cuh
// dq_hopper_bn) are 64 keys at D_pad 64 and 128: a consumer thread then
// holds 32 scores, 32 dP, D / 2 dq accumulators and 32 registers of ds (hi
// and lo), within its registers; at D_pad 128, Q and dO (64 KB) and two
// stages of K and V (64 KB) take 128 KB of shared memory. At D_pad 192 and
// 256 they are 32 keys: the dq accumulator takes 96 or 128 registers, and
// Q and dO 96 or 128 KB, so the tile's scores, dP and ds are halved and
// two stages of K and V take 48 or 64 KB. Past 128 columns the dq product
// is one wgmma a 128 columns (wgmma_rs_cols).
// - Loads: Q and dO once by TMA and kept in shared memory; lse read once
//   into registers; K and V through a two-stage TMA ring with `full` and
//   `empty` mbarriers (flash_hopper.cuh). The producer walks the band's
//   tile list twice, once a pass, deciding the integer masks' skips and
//   ending each pass with a stage whose first key is -1.
// - Pass 0: S = Q K^T and dP = dO V^T by wgmma into registers; p from the
//   saved lse, dP masked and rescaled by dropout, rowsum(p dP) summed in
//   fp32 and over the row's quad; delta written to [B, H, Sq].
// - Pass 1: S and dP again; ds = p (dP - delta) scale in registers; the
//   d-bias stored from registers (a float2 a column pair; the tiles this
//   warpgroup skips, and the columns outside its tile list, as zeros); ds
//   split into hi = T(ds) and lo = T(ds - hi), two register A fragments;
//   dq += hi K + lo K by wgmma with K read MN-major, the same shared tile the
//   S product just read K-major.
// - dq accumulates in registers across the whole loop and is written as T
//   at the end. No score, p, dP or ds goes to shared memory. The masks, the
//   bias and the dropout bits act on the fragment as in the forward
//   (flash_fwd_hopper.cu), formed while the S and dP products run.
// - Order: block_pos (flash_hopper.cuh), groups of 16 (batch, head) pairs
//   with the longest causal query tiles first, so the blocks in flight
//   share K and V in L2. One block a query block: each block walks its key
//   tiles twice, so its fixed costs weigh less than in the forward, and
//   the forward's pingpong between the consumer warpgroups measured slower
//   here on an H100 SXM.

#include "flash_hopper.cuh"

#ifndef PTT_FLASH_D
#error "compile once per redesigned width: -DPTT_FLASH_D=<64|128|192|256>"
#endif

namespace ptt_flash {
namespace hopper {
namespace {

constexpr int kDqStages = 2;

template <typename T, int D>
struct DqSmem {
  static constexpr int kP = D / 64, BN = dq_hopper_bn(D);
  T q[kP][kBM * 64];
  T dout[kP][kBM * 64];
  T k[kDqStages][kP][BN * 64];
  T v[kDqStages][kP][BN * 64];
  uint64_t full[kDqStages], empty[kDqStages], qbar;
  Slot<BN> slot[kDqStages];
};

template <typename T, int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const Args a) {
  constexpr int BN = dq_hopper_bn(D), kP = D / 64, kS = kDqStages;
  extern __shared__ unsigned char smem_raw[];
  DqSmem<T, D>& sm = *reinterpret_cast<DqSmem<T, D>*>(align1024(smem_raw));
  const BlockPos pos = block_pos(a, static_cast<int>(blockIdx.x));
  const int q0 = pos.q0, h = pos.h, b = pos.b;
  const int wg = threadIdx.x / 128;
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;
  const int kbegin = blk_key_begin<BN>(q0, a), kend = blk_key_end(q0, kBM, a);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(&sm.full[st], 32);
      mbar_init(&sm.empty[st], kConsumerWarps);
    }
    mbar_init(&sm.qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: warp 0 walks the band's key tiles once a pass
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x, hk = h / (a.H / a.Hkv);
    if (lane == 0) {
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_tx(&sm.qbar, 2 * kBM * D * 2);
      for (int p = 0; p < kP; ++p) {
        tma_load(sm.q[p], &tq, &sm.qbar, 64 * p, q0, h, b);
        tma_load(sm.dout[p], &tdo, &sm.qbar, 64 * p, q0, h, b);
      }
    }
    int qlo = 0, qhi = 0;
    if (seg) block_qseg_range(a, b, q0, qlo, qhi);
    int stage = 0;
    uint32_t phase = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = kbegin; k0 < kend; k0 += BN) {
        KeyMasks<BN> km;
        if (kInt && key_tile_skip<BN>(a, seg, fm, b, h, q0, k0, qlo, qhi, km)) continue;
        mbar_wait(&sm.empty[stage], phase ^ 1);
        if (kInt)
          write_slot<BN>(sm.slot[stage], k0, seg, fm, km);
        else if (lane == 0)
          sm.slot[stage].k0 = k0;
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[stage], 2 * BN * D * 2);
          for (int p = 0; p < kP; ++p) {
            tma_load(sm.k[stage][p], &tk, &sm.full[stage], 64 * p, k0, hk, b);
            tma_load(sm.v[stage][p], &tv, &sm.full[stage], 64 * p, k0, hk, b);
          }
        } else {
          mbar_arrive(&sm.full[stage]);
        }
        if (++stage == kS) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait(&sm.empty[stage], phase ^ 1);  // the end of the pass
      if (lane == 0) sm.slot[stage].k0 = -1;
      mbar_arrive(&sm.full[stage]);
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows qa .. qa + 63
  reg_alloc<kConsumerRegs>();
  const int cw = wg - 1, t = threadIdx.x - 128 * wg, lane = t % 32;
  const int qa = q0 + 64 * cw;
  const int qpos[2] = {qa + 16 * (t / 32) + lane / 4, qa + 16 * (t / 32) + lane / 4 + 8};
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const bool want_db = kBias && a.dbias != nullptr;  // the d-bias: a runtime pointer
  const long long bb = kBias ? bias_base(a, b, h) : 0;
  int qid[2] = {0, 0};
  float lse[2], delta[2] = {0.f, 0.f}, part[2] = {0.f, 0.f};
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = qpos[i] < a.Sq;
    if (seg) qid[i] = in ? a.qseg[static_cast<long long>(b) * a.Sq + qpos[i]] : 0;
    lse[i] = in ? a.lse[row_base + qpos[i]] : kNegInf;
    dead[i] = lse[i] <= 0.5f * kNegInf;
  }
  float dq[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) dq[c] = 0.f;
  if (want_db) zero_dbias_wg(a, row_base, qa, 0, kbegin < a.Sk ? kbegin : a.Sk);
  int next = kbegin;  // pass 1: the first d-bias column not yet written
  const uint32_t qbase = smem_u32(sm.q[0]) + cw * 64 * 128;
  const uint32_t dobase = smem_u32(sm.dout[0]) + cw * 64 * 128;
  constexpr uint32_t kQPanel = kBM * 128, kKPanel = BN * 128;

  mbar_wait(&sm.qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (;;) {
      mbar_wait(&sm.full[stage], phase);
      const int k0 = sm.slot[stage].k0;
      if (k0 >= 0) {
        if (pass == 1 && want_db) zero_dbias_wg(a, row_base, qa, next, k0);
        if (tile_out_of_band<BN>(qa, k0, a)) {
          if (pass == 1 && want_db) zero_dbias_wg(a, row_base, qa, k0, min(k0 + BN, a.Sk));
        } else {
          const uint32_t kb = smem_u32(sm.k[stage][0]), vb = smem_u32(sm.v[stage][0]);
          float s[BN / 2], dp[BN / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BN, T>(s, desc_kmajor(qbase, kQPanel, kk), desc_kmajor(kb, kKPanel, kk),
                            kk > 0 ? 1 : 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BN, T>(dp, desc_kmajor(dobase, kQPanel, kk), desc_kmajor(vb, kKPanel, kk),
                            kk > 0 ? 1 : 0);
          wgmma_commit();
          // the masks and the dropout bits are formed while the tensor cores
          // form S and dP (flash_fwd_hopper.cu)
          const uint64_t vis = tile_mask<BN, kInt>(a, sm.slot[stage], seg, fm, qa, k0, qpos, qid);
          const uint64_t keep = kDrop ? tile_keep_bits<BN>(a, b, h, qpos[0], k0) : 0;
          wgmma_wait_all();
          reg_fence(s);
          reg_fence(dp);
          probs_tile<BN, kBias, kDrop>(s, dp, a, k0, qpos, lse, dead, bb, vis, keep);
          if (pass == 0) {
#pragma unroll
            for (int r = 0; r < BN / 2; ++r) part[(r / 2) % 2] = fmaf(s[r], dp[r], part[(r / 2) % 2]);
          } else {
            uint32_t hi[BN / 16][4], lo[BN / 16][4];
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int r = 4 * j + 2 * i;
                const float d0 = s[r] * (dp[r] - delta[i]), d1 = s[r + 1] * (dp[r + 1] - delta[i]);
                const int kpos = k0 + 8 * j + 2 * (lane % 4);
                if (want_db && qpos[i] < a.Sq) {
                  float* dst = a.dbias + (row_base + qpos[i]) * a.Sk + kpos;
                  if ((a.Sk & 1) == 0 && kpos < a.Sk) {
                    *reinterpret_cast<float2*>(dst) = make_float2(d0, d1);
                  } else {
                    if (kpos < a.Sk) dst[0] = d0;
                    if (kpos + 1 < a.Sk) dst[1] = d1;
                  }
                }
                // registers 8 kk + 2 c, + 1 of the fragment are A register c
                // of key step kk: r = 4 j + 2 i, so kk = j / 2, c = 2 (j % 2) + i
                const float ds0 = d0 * a.scale, ds1 = d1 * a.scale;
                const uint32_t hv = pack2<T>(ds0, ds1);
                const float2 hf = unpack2<T>(hv);
                hi[j / 2][2 * (j % 2) + i] = hv;
                lo[j / 2][2 * (j % 2) + i] = pack2<T>(ds0 - hf.x, ds1 - hf.y);
              }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
              wgmma_rs_cols<D, T>(dq, hi[kk], kb, kKPanel, kk);
              wgmma_rs_cols<D, T>(dq, lo[kk], kb, kKPanel, kk);
            }
            wgmma_commit();
            wgmma_wait_all();
            reg_fence(dq);
            reg_fence(hi);
            reg_fence(lo);
          }
        }
        if (pass == 1) next = k0 + BN;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
      if (k0 < 0) break;
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        delta[i] = quad_sum(part[i]);
        if (qpos[i] < a.Sq && lane % 4 == 0) a.delta[row_base + qpos[i]] = delta[i];
      }
    }
  }
  if (want_db) zero_dbias_wg(a, row_base, qa, next < a.Sk ? next : a.Sk, a.Sk);

  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= a.Sq) continue;
    T* row = dqb + ((static_cast<long long>(b) * a.Sq + qpos[i]) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < a.D)
        *reinterpret_cast<uint32_t*>(row + col) = pack2<T>(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
    }
  }
}

template <typename T, int D, bool kBias, bool kInt, bool kDrop>
int launch(const Args& a, int dtype, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_view(&tq, a.q, a.vq, a.B, a.Sq, a.H, a.D, dtype, kBM);
  if (err == 0) err = encode_view(&tdo, a.dout, a.vdo, a.B, a.Sq, a.H, a.D, dtype, kBM);
  if (err == 0) err = encode_view(&tk, a.k, a.vk, a.B, a.Sk, a.Hkv, a.D, dtype, dq_hopper_bn(D));
  if (err == 0) err = encode_view(&tv, a.v, a.vv, a.B, a.Sk, a.Hkv, a.D, dtype, dq_hopper_bn(D));
  if (err != 0) return err;
  auto* kernel = flash_dq_wgmma_kernel<T, D, kBias, kInt, kDrop>;
  const size_t smem = sizeof(DqSmem<T, D>) + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((a.Sq + kBM - 1) / kBM) * a.H * a.B;
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
int dq_hopper_run(const Args& a, int dtype, cudaStream_t s) {
  return dtype == kBF16 ? hopper::launch_bias<bf16, D>(a, dtype, s)
                        : hopper::launch_bias<f16, D>(a, dtype, s);
}

template int dq_hopper_run<PTT_FLASH_D>(const Args&, int, cudaStream_t);

}  // namespace ptt_flash
