// Flash attention dQ in fp32 for Hopper (sm_90a), on the TF32 tensor cores:
// each fp32 operand split into two TF32 halves and every product taken as
// three wgmma products (flash_hopper.cuh, "fp32 operands on the TF32 tensor
// cores"). dq, delta = rowsum(p * dP) for the dK/dV kernel, and the d-bias,
// as flash_attention.cu's backward note states them, with the same two
// passes over the key tiles (the delta pass: each row's ds sums to zero to
// fp32 rounding). Widths 64, 128, 192 and 256 (D_pad 32 and 96 read into 64
// and 128 with zero columns): every fp32 dQ.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_bwd_impl`'s dQ
// pallas_call (kernel body `_dq_kernel`, masks `_mask_scores`) in fp32 on all
// its operands: causal / non-causal and the window as one band, GQA, the bias
// in its own dtype and its gradient (dS without the scale, fp32
// [B, H, Sq, Sk], zeros on every tile the kernel skips), segment ids, the
// flashmask rows and dropout with the forward's keep bits. It took the place
// of an FP32-pipe dQ kernel, at D_pad <= 128 first and then at 192 and 256,
// where that kernel went.
//
// Bound on an H100 SXM: 6 D FLOPs a visible pair (s, dP, dq); the kernel does
// 10 D (the delta pass repeats s and dP), each three times on the tensor
// cores at 495 TFLOP/s dense TF32 (or 6 D at 67 TFLOP/s on the FP32 pipes,
// the bound the FP32-pipe kernel had).
//
// Design. One block of 384 threads owns 64 query rows of one (batch, head):
// warpgroup 0 the producer (setmaxnreg 64), warpgroups 1 and 2 consumers over
// the same rows (setmaxnreg 224 and 216), split as the dK/dV kernels split
// (flash_dkv_hopper.cu): warpgroup 1 forms S, the masks, the bias, the
// dropout bits and p; warpgroup 2 forms dP, reads p, sums delta (pass 0) or
// forms ds (pass 1). Shared memory is what limits the block: a split operand
// takes 8 bytes an element.
// - Q and dO land raw by TMA once (32 + 32 KB at D_pad 128, 64 + 64 at 256)
//   and stay: S = Q K^T and dP = dO V^T take them as the register A, split
//   each key tile (gemm_raw).
// - K and V stream through a TMA ring of key tiles (flash_common.cuh
//   tf32_dq_tile / tf32_dq_stages: two stages of 32 keys up to D_pad 128,
//   one of 32 at 192, one of 16 at 256). Warp 0 of the producer walks the
//   band's tile list once a pass, decides the integer masks' skips and issues
//   the loads (`raw` mbarrier); warps 1-3 split each landed tile in place
//   into hi / lo halves (perm8 order) and arrive on `full`. A stage's four
//   halves take 64 KB at D_pad 128, 96 at 192, 64 at 256 (16 keys).
// - Warpgroup 1 writes p, negated where dropped, into the [64 queries][32
//   keys] tile dshi (`pready`; a tile of 16 keys fills its first 16
//   columns). Warpgroup 2 reads it back from the same places of its own
//   fragment; in pass 0 it sums rowsum(p dP), in pass 1 it forms ds = p (dP -
//   delta) scale, stores the d-bias from registers and writes ds split over
//   p into dshi / dslo (`dsready`), the B of dq^T += K^T dS (m64n32k8, A =
//   K^T read across the K tile's rows from its halves: frag_t). Each
//   warpgroup then takes dq^T for 32 of the 64 queries (D_pad / 4
//   registers; past D_pad 128 two 64-column blocks in flight, gemm_t_wide),
//   and warpgroup 2 frees the tile (`dsfree`) before warpgroup 1 writes the
//   next p there.
// Shared memory: 64 + 128 + 16 KB and the slots at D_pad 128 (209 KB), 96 +
// 96 + 16 at 192, 128 + 64 + 16 at 256: one block an SM. At 192 / 256 a
// tile's load and split wait for the previous tile's products (one stage).

#include "flash_hopper.cuh"

#ifndef PTT_FLASH_D
#error "compile once per TF32 width: -DPTT_FLASH_D=<64|128|192|256>"
#endif

namespace ptt_flash {
namespace hopper {
namespace {

constexpr int kQR = kTf32DqBM;  // query rows a block (flash_common.cuh)
constexpr int kSplitters = 96;  // producer warps 1-3
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
struct DqTf32Smem {
  static constexpr int kP = f32_panels(D);
  static constexpr int kKN = tf32_dq_tile(D), kStages = tf32_dq_stages(D);  // keys a tile
  float q[kP][kQR * 32];  // raw, [64][D] in panels of 32 columns
  float dout[kP][kQR * 32];
  float khi[kStages][kP][kKN * 32], klo[kStages][kP][kKN * 32];  // split, perm8
  float vhi[kStages][kP][kKN * 32], vlo[kStages][kP][kKN * 32];
  float dshi[kQR * 32], dslo[kQR * 32];  // [64 queries][32 keys]: p, then ds split
  uint64_t raw[kStages], full[kStages], empty[kStages], qbar, pready, dsready, dsfree;
  Slot<kKN> slot[kStages];
};

template <int D>
__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase) {
  if (++stage == DqTf32Smem<D>::kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// Warp 0 of the producer: Q and dO once, then the band's key tiles once a
// pass, each pass ended by a stage whose first key is -1.
template <int D, bool kInt>
__device__ __forceinline__ void produce(DqTf32Smem<D>& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv,
                                        const CUtensorMap* tdo, const Args& a, BlockPos pos,
                                        bool seg, bool fm, int kbegin, int kend) {
  constexpr int kP = DqTf32Smem<D>::kP, kKN = DqTf32Smem<D>::kKN;
  const int q0 = pos.q0, h = pos.h, b = pos.b;
  const int lane = threadIdx.x, hk = h / (a.H / a.Hkv);
  if (lane == 0) {
    tma_prefetch_map(tk);
    tma_prefetch_map(tv);
    mbar_arrive_tx(&sm.qbar, 2 * kQR * D * 4);
    for (int p = 0; p < kP; ++p) {
      tma_load(sm.q[p], tq, &sm.qbar, 32 * p, q0, h, b);
      tma_load(sm.dout[p], tdo, &sm.qbar, 32 * p, q0, h, b);
    }
  }
  int qlo = 0, qhi = 0;
  if (seg) block_qseg_range<kQR>(a, b, q0, qlo, qhi);
  int stage = 0;
  uint32_t phase = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = kbegin; k0 < kend; k0 += kKN) {
      KeyMasks<kKN> km;
      if (kInt && key_tile_skip<kKN, kQR>(a, seg, fm, b, h, q0, k0, qlo, qhi, km)) continue;
      mbar_wait(&sm.empty[stage], phase ^ 1);
      if (kInt)
        write_slot<kKN>(sm.slot[stage], k0, seg, fm, km);
      else if (lane == 0)
        sm.slot[stage].k0 = k0;
      if (lane == 0) {
        mbar_arrive_tx(&sm.raw[stage], 2 * kKN * D * 4);
        for (int p = 0; p < kP; ++p) {
          tma_load(sm.khi[stage][p], tk, &sm.raw[stage], 32 * p, k0, hk, b);
          tma_load(sm.vhi[stage][p], tv, &sm.raw[stage], 32 * p, k0, hk, b);
        }
      } else {
        mbar_arrive(&sm.raw[stage]);
      }
      next_stage<D>(stage, phase);
    }
    mbar_wait(&sm.empty[stage], phase ^ 1);  // the end of the pass
    if (lane == 0) sm.slot[stage].k0 = -1;
    mbar_arrive(&sm.raw[stage]);
    next_stage<D>(stage, phase);
  }
}

// Warps 1-3 of the producer: split each landed K / V tile in place.
template <int D>
__device__ __forceinline__ void split_stream(DqTf32Smem<D>& sm) {
  constexpr int kBytes = DqTf32Smem<D>::kP * DqTf32Smem<D>::kKN * 128;
  const int tid = threadIdx.x - 32;
  int stage = 0;
  uint32_t phase = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (;;) {
      mbar_wait(&sm.raw[stage], phase);
      const int k0 = sm.slot[stage].k0;
      if (k0 >= 0) {
        split_tiles(sm.khi[stage][0], sm.klo[stage][0], sm.vhi[stage][0], sm.vlo[stage][0],
                    kBytes, tid, kSplitters);
        fence_proxy_async();
      }
      mbar_arrive(&sm.full[stage]);
      next_stage<D>(stage, phase);
      if (k0 < 0) break;
    }
  }
}

// dq^T (block m, register 4 j + 2 i + e: head column 64 m + 16 w + l / 4 +
// 8 i, query qa + 8 j + 2 (l % 4) + e) into [B, Sq, H, D].
template <int D>
__device__ __forceinline__ void store_dq_t(const float (&dqt)[D / 64][16], const Args& a, int b,
                                           int h, int qa) {
  const int t = threadIdx.x % 128, lane = t % 32;
  float* dqb = static_cast<float*>(a.dq);
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = 64 * m + 16 * (t / 32) + lane / 4 + 8 * i;
      if (d >= a.D) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = qa + 8 * j + 2 * (lane % 4) + e;
          if (qp < a.Sq)
            dqb[((static_cast<long long>(b) * a.Sq + qp) * a.H + h) * a.D + d] =
                dqt[m][4 * j + 2 * i + e];
        }
    }
}

// dq^T (the warpgroup's 32 queries) += K^T dS over the key tile of `stage`:
// A = K^T from its split halves (frag_t), B = ds's hi / lo rows from byte
// `rows` of dshi / dslo; past D_pad 128 two 64-column blocks in flight into
// the caller's accumulators `part` (gemm_t_wide).
template <int D>
__device__ __forceinline__ void dq_product(float (&dqt)[D / 64][16], float (&part)[2][16],
                                           DqTf32Smem<D>& sm, int stage, uint32_t rows) {
  using S = DqTf32Smem<D>;
  constexpr uint32_t kKPanel = S::kKN * 128;
  const unsigned char* khi = reinterpret_cast<const unsigned char*>(sm.khi[stage][0]);
  const unsigned char* klo = reinterpret_cast<const unsigned char*>(sm.klo[stage][0]);
  if constexpr (D > 128) {
    gemm_t_wide<32, D, S::kKN / 8, 2>(dqt, part, khi, klo, kKPanel, smem_u32(sm.dshi) + rows,
                                      smem_u32(sm.dslo) + rows);
  } else {
    gemm_t<32, D>(dqt, khi, klo, kKPanel, smem_u32(sm.dshi) + rows, smem_u32(sm.dslo) + rows);
  }
}

// The query rows of this thread's fragment and their lse (dead: lse -1e30)
// and segment ids.
struct Rows {
  int qpos[2], qid[2];
  float lse[2];
  bool dead[2];
};

__device__ __forceinline__ Rows block_rows(const Args& a, int b, int q0, long long row_base,
                                           bool seg) {
  const int t = threadIdx.x % 128, lane = t % 32;
  Rows r;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r.qpos[i] = q0 + 16 * (t / 32) + lane / 4 + 8 * i;
    const bool in = r.qpos[i] < a.Sq;
    r.qid[i] = seg && in ? a.qseg[static_cast<long long>(b) * a.Sq + r.qpos[i]] : 0;
    r.lse[i] = in ? a.lse[row_base + r.qpos[i]] : kNegInf;
    r.dead[i] = r.lse[i] <= 0.5f * kNegInf;
  }
  return r;
}

// Warpgroup 1: S, p (its masks, bias and dropout bits); dq^T of queries
// q0 .. q0 + 31.
template <int D, bool kBias, bool kInt, bool kDrop>
__device__ __forceinline__ void consume_p(DqTf32Smem<D>& sm, const Args& a, BlockPos pos,
                                          bool seg, bool fm) {
  constexpr int kKN = DqTf32Smem<D>::kKN;
  constexpr uint32_t kQPanel = kQR * 128, kKPanel = kKN * 128;
  const int q0 = pos.q0, h = pos.h, b = pos.b;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const Rows rw = block_rows(a, b, q0, row_base, seg);
  const long long bb = kBias ? bias_base(a, b, h) : 0;
  float dqt[D / 64][16], prod[2][16];  // prod: dq_product's, past D_pad 128
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) dqt[m][c] = 0.f;
  const unsigned char* qt = reinterpret_cast<const unsigned char*>(sm.q[0]);
  unsigned char* pw = reinterpret_cast<unsigned char*>(sm.dshi);

  mbar_wait(&sm.qbar, 0);
  int stage = 0, n = 0, m = 0;
  uint32_t phase = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (;; ++n) {
      mbar_wait(&sm.full[stage], phase);
      const int k0 = sm.slot[stage].k0;
      if (k0 < 0) {  // the end of the pass: the stage is free for pass 1
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(&sm.empty[stage]);
        next_stage<D>(stage, phase);
        break;
      }
      const bool live = !tile_out_of_band<kKN>(q0, k0, a);
      float s[kKN / 2];
      uint64_t keep = 0;
      if (live) {
        const uint64_t vis = tile_mask<kKN, kInt>(a, sm.slot[stage], seg, fm, q0, k0, rw.qpos,
                                                  rw.qid);
        if (kDrop) keep = tile_keep_bits<kKN>(a, b, h, rw.qpos[0], k0);
        gemm_raw<kKN, D>(s, qt, kQPanel, smem_u32(sm.khi[stage][0]), smem_u32(sm.klo[stage][0]),
                         kKPanel);
        float dummy[kKN / 2];
        probs_tile<kKN, kBias, false>(s, dummy, a, k0, rw.qpos, rw.lse, rw.dead, bb, vis, 0);
      }
      if (n > 0) mbar_wait(&sm.dsfree, (n - 1) & 1);  // warpgroup 2 is done with dshi
      if (live) {
#pragma unroll
        for (int j = 0; j < kKN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * j + 2 * i;
            float pv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              pv[e] = !kDrop || ((keep >> (r + e)) & 1u) ? s[r + e] : -s[r + e];
            store_pair(pw, frag_pair_off(i, j), pv[0], pv[1]);
          }
      }
      mbar_arrive(&sm.pready);
      if (live && pass == 1) {
        mbar_wait(&sm.dsready, m & 1);  // warpgroup 2 wrote ds
        ++m;
        dq_product<D>(dqt, prod, sm, stage, 0);
      }
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(&sm.empty[stage]);
      next_stage<D>(stage, phase);
    }
  }
  store_dq_t<D>(dqt, a, b, h, q0);
}

// Warpgroup 2: dP, delta (pass 0), ds and the d-bias (pass 1); dq^T of
// queries q0 + 32 .. q0 + 63.
template <int D, bool kBias, bool kDrop>
__device__ __forceinline__ void consume_ds(DqTf32Smem<D>& sm, const Args& a, BlockPos pos,
                                           bool seg, int kbegin) {
  constexpr int kKN = DqTf32Smem<D>::kKN;
  constexpr uint32_t kQPanel = kQR * 128, kKPanel = kKN * 128;
  const int q0 = pos.q0, h = pos.h, b = pos.b;
  const int lane = threadIdx.x % 32;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const Rows rw = block_rows(a, b, q0, row_base, seg);
  const bool want_db = kBias && a.dbias != nullptr;  // the d-bias: a runtime pointer
  float delta[2] = {0.f, 0.f}, part[2] = {0.f, 0.f};
  float dqt[D / 64][16], prod[2][16];  // prod: dq_product's, past D_pad 128
#pragma unroll
  for (int m = 0; m < D / 64; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) dqt[m][c] = 0.f;
  if (want_db) zero_dbias_wg(a, row_base, q0, 0, kbegin < a.Sk ? kbegin : a.Sk);
  int next = kbegin;  // pass 1: the first d-bias column not yet written
  const unsigned char* dot = reinterpret_cast<const unsigned char*>(sm.dout[0]);
  unsigned char* dshi = reinterpret_cast<unsigned char*>(sm.dshi);
  unsigned char* dslo = reinterpret_cast<unsigned char*>(sm.dslo);

  mbar_wait(&sm.qbar, 0);
  int stage = 0, n = 0;
  uint32_t phase = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (;; ++n) {
      mbar_wait(&sm.full[stage], phase);
      const int k0 = sm.slot[stage].k0;
      if (k0 < 0) {  // the end of the pass: the stage is free for pass 1
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(&sm.empty[stage]);
        next_stage<D>(stage, phase);
        break;
      }
      if (pass == 1 && want_db) zero_dbias_wg(a, row_base, q0, next, k0);
      const bool live = !tile_out_of_band<kKN>(q0, k0, a);
      float dp[kKN / 2];
      if (live)
        gemm_raw<kKN, D>(dp, dot, kQPanel, smem_u32(sm.vhi[stage][0]),
                         smem_u32(sm.vlo[stage][0]), kKPanel);
      mbar_wait(&sm.pready, n & 1);
      if (!live) {
        if (pass == 1 && want_db) zero_dbias_wg(a, row_base, q0, k0, min(k0 + kKN, a.Sk));
      } else {
#pragma unroll
        for (int j = 0; j < kKN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * j + 2 * i;
            const uint32_t off = frag_pair_off(i, j);
            const float2 w = load_pair(dshi, off);
            float d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = e ? w.y : w.x, p = fabsf(v);
              // a dropped element (v < 0) takes dP 0; p = 0 gives 0 either way
              const float dpv = kDrop ? (v > 0.f ? dp[r + e] * a.drop_scale : 0.f) : dp[r + e];
              if (pass == 0)
                part[i] = fmaf(p, dpv, part[i]);
              else
                d[e] = p * (dpv - delta[i]);
            }
            if (pass == 1) {
              const int kpos = k0 + 8 * j + 2 * (lane % 4);
              if (want_db && rw.qpos[i] < a.Sq) {
                float* dst = a.dbias + (row_base + rw.qpos[i]) * a.Sk + kpos;
                if ((a.Sk & 1) == 0 && kpos < a.Sk) {
                  *reinterpret_cast<float2*>(dst) = make_float2(d[0], d[1]);
                } else {
                  if (kpos < a.Sk) dst[0] = d[0];
                  if (kpos + 1 < a.Sk) dst[1] = d[1];
                }
              }
              store_split_pair(dshi, dslo, off, d[0] * a.scale, d[1] * a.scale);
            }
          }
        if (pass == 1) {
          fence_proxy_async();
          mbar_arrive(&sm.dsready);
          wg_sync(2);  // every ds of the tile written
          dq_product<D>(dqt, prod, sm, stage, 32 * 128);
        }
      }
      if (pass == 1) next = k0 + kKN;
      mbar_arrive(&sm.dsfree);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      next_stage<D>(stage, phase);
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        delta[i] = quad_sum(part[i]);
        if (rw.qpos[i] < a.Sq && lane % 4 == 0) a.delta[row_base + rw.qpos[i]] = delta[i];
      }
    }
  }
  if (want_db) zero_dbias_wg(a, row_base, q0, next < a.Sk ? next : a.Sk, a.Sk);
  store_dq_t<D>(dqt, a, b, h, q0 + 32);
}

template <int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const Args a) {
  using Smem = DqTf32Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const BlockPos pos = block_pos<kQR>(a, static_cast<int>(blockIdx.x));
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;
  const int kbegin = blk_key_begin<Smem::kKN>(pos.q0, a), kend = blk_key_end(pos.q0, kQR, a);

  if (threadIdx.x == 0) {
    for (int st = 0; st < Smem::kStages; ++st) {
      mbar_init(&sm.raw[st], 32);  // the producer warp's lanes (they write the slot)
      mbar_init(&sm.full[st], kSplitters);
      mbar_init(&sm.empty[st], kConsumerWarps);
    }
    mbar_init(&sm.qbar, 1);
    mbar_init(&sm.pready, 128);
    mbar_init(&sm.dsready, 128);
    mbar_init(&sm.dsfree, 128);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    reg_dealloc<kProdRegs>();
    if (threadIdx.x < 32)
      produce<D, kInt>(sm, &tq, &tk, &tv, &tdo, a, pos, seg, fm, kbegin, kend);
    else
      split_stream<D>(sm);
    return;
  }
  if (threadIdx.x < 256) {
    reg_alloc<kPRegs>();
    consume_p<D, kBias, kInt, kDrop>(sm, a, pos, seg, fm);
  } else {
    reg_alloc<kDsRegs>();
    consume_ds<D, kBias, kDrop>(sm, a, pos, seg, kbegin);
  }
}

template <int D, bool kBias, bool kInt, bool kDrop>
int launch(const Args& a, cudaStream_t stream) {
  using Smem = DqTf32Smem<D>;
  // the attribute first: a runtime call, it makes the device's context current
  // on this thread (autograd runs the backward on a thread of its own, where
  // cuTensorMapEncodeTiled failed as the first CUDA work)
  auto* kernel = flash_dq_tf32_kernel<D, kBias, kInt, kDrop>;
  const size_t smem = sizeof(Smem) + 1024;
  static_assert(sizeof(Smem) + 1024 <= 232448, "over the 227 KB a block may hold");
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_view(&tq, a.q, a.vq, a.B, a.Sq, a.H, a.D, kF32, kQR);
  if (err == 0) err = encode_view(&tdo, a.dout, a.vdo, a.B, a.Sq, a.H, a.D, kF32, kQR);
  if (err == 0) err = encode_view(&tk, a.k, a.vk, a.B, a.Sk, a.Hkv, a.D, kF32, Smem::kKN);
  if (err == 0) err = encode_view(&tv, a.v, a.vv, a.B, a.Sk, a.Hkv, a.D, kF32, Smem::kKN);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>((a.Sq + kQR - 1) / kQR) * a.H * a.B;
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
int dq_tf32_run(const Args& a, cudaStream_t s) {
  return a.bias != nullptr ? hopper::launch_flags<D, true>(a, s)
                           : hopper::launch_flags<D, false>(a, s);
}

template int dq_tf32_run<PTT_FLASH_D>(const Args&, cudaStream_t);

}  // namespace ptt_flash
