// Flash attention forward for Hopper, redesigned for sm_90a: the bf16 and
// fp16 kernel at D_pad 64, 128, 192 and 256 (and the heads of D_pad 32 and
// 96, which it reads into the next of those with zero columns). out and the
// row logsumexp, as flash_fwd_tf32_hopper.cu computes them in fp32.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_fwd` (kernel body
// `_fwd_kernel`, masks `_mask_scores`) on all its operands: causal /
// non-causal and the sliding window as one band, GQA (kv head h / (H /
// H_kv)), the additive bias in its own dtype with 0-strides over broadcast
// dims, segment ids, the flashmask rows and dropout, each alone and
// combined. It took the place of a WMMA kernel (flash_fwd_tc_kernel) at
// every width.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 D FLOPs a
// visible (query, key) pair, and q, k, v and out moved once. At the GPT
// flagship call (B 8, S 1024, H 16, D 128, causal) that is ~34 GFLOP against
// ~134 MB, 0.035 ms against 0.040: both bounds are close, so the design has
// to keep the tensor cores fed and move nothing twice.
//
// Design. One block of 384 threads owns 128 query rows of one (batch,
// head): warpgroup 0 is the producer, whose warp 0 issues every load (it
// gives its registers up: setmaxnreg 40), and warpgroups 1 and 2 are the
// consumers, 64 rows each (setmaxnreg 232). Key tiles (flash_common.cuh
// fwd_hopper_bn) are 128 keys at D_pad 64 and 128, and 64 beside a bias or
// at D_pad 192 and 256: at D_pad 128 the two K / V stages (4 x 32 KB) and Q
// (32 KB) take 160 KB of the 227 KB, and a consumer thread holds 64 fp32
// scores, 64 fp32 output columns and 32 registers of p, within 232
// registers with the mask and dropout code; at D_pad 256 the output takes
// 128 registers, beside 32 scores and 16 of p, and Q and the stages take
// 192 KB. Past 128 columns the p v product is one wgmma a 128 columns
// (wgmma_rs_cols). A persistent grid
// (one block an SM walking the query blocks, the next one's Q loading under
// this one's epilogue) measured slower on the causal calls on an H100 SXM:
// a static share of query blocks of unequal length loses the balance the
// hardware's block scheduler gives.
// - Loads: Q once per block and each K / V tile by TMA
//   (cp.async.bulk.tensor over [B, S, H, D] tensor maps built on the host for
//   the call, with the views' own strides, true D and S as extents: the
//   columns past D and the rows past S arrive as zeros), into a ring of two
//   stages. K and V complete on their own `full` mbarriers and are freed
//   through their own `empty` ones (the eight consumer warps arrive): K as
//   soon as S is formed, V once the p v product that reads it is done. The
//   producer alone walks the band's key tiles (blk_key_begin / blk_key_end)
//   and decides the integer masks' tile skips (key_tile_skip, over the
//   block's 128 rows); a skipped tile is never loaded, and the stage carries
//   the tile's first key (-1 ends the list), its segment ids and flashmask
//   rows, and their ranges.
// - Products: S = Q K^T by wgmma from the swizzled tiles (m64n128k16, fp32
//   accumulator in registers); the online softmax works on that fragment in
//   place (a row's columns sit in a quad of lanes: its max and sum are two
//   shuffles, after four partial maxima and sums a thread); p, rounded to
//   T, is the register A operand of O += P V (wgmma with A from registers, V
//   read MN-major), and O stays in registers until the epilogue. No score,
//   p or partial O goes to shared memory.
// - Overlap: tile j's S product is issued with tile j - 1's p v product, and
//   tile j's softmax runs while the latter is on the tensor cores (FA3's
//   intra-warpgroup order; beside a bias the softmax waits for it, whose
//   loads need the registers p holds). The first tile is a prologue and the
//   last p v product an epilogue, so no wgmma is in flight across a branch
//   (ptxas serializes every wgmma of a kernel with one). The two consumer
//   warpgroups issue their products in turns (named barriers 1 and 2,
//   "pingpong"), so one's softmax runs under the other's products.
// - Masks act on the fragment at the (row, column) its layout fixes. While
//   the S product is in flight, two partly unrolled loops form a bit an
//   element: its visibility (tile_mask / tile_visible_bits: the band, the
//   segment ids and the rows from the stage) and its dropout keep bit
//   (Philox words shared between the two lanes that hold one word's
//   columns, drop_keep_bits: the bits of dropout_keep_mask); fully unrolled
//   into the softmax they spilled the D_pad 128 instances. A thread skips
//   the per-element test where the tile lies wholly inside the band and the
//   stage's ranges show the integer masks touch none of its rows. The bias
//   is added on the fragment from unconditional loads, in chunks (add_bias).
// - Order (block_pos): groups of 16 (batch, head) pairs, the longest causal
//   query tiles first inside a group, so the blocks in flight share K and V
//   in L2 and the grid ends on short work.
// A row that sees no key writes zeros and lse = -1e30, as the WMMA kernel.

#include "flash_hopper.cuh"

#ifndef PTT_FLASH_D
#error "compile once per redesigned width: -DPTT_FLASH_D=<64|128|192|256>"
#endif

namespace ptt_flash {
namespace hopper {
namespace {

constexpr int kFwdStages = 2;

template <typename T, int D, int BN>
struct FwdSmem {
  static constexpr int kP = D / 64;
  T q[kP][kBM * 64];
  T k[kFwdStages][kP][BN * 64];
  T v[kFwdStages][kP][BN * 64];
  // K and V complete and are freed apart: K as soon as S is formed, V
  // once the p v product that reads it is done
  uint64_t kfull[kFwdStages], kempty[kFwdStages], vfull[kFwdStages], vempty[kFwdStages], qbar;
  Slot<BN> slot[kFwdStages];
};

// o *= alpha, and p packed to T as the A fragments of the p v product.
template <typename T, int D, int BN>
__device__ __forceinline__ void rescale_pack(const float (&s)[BN / 2], float (&o)[D / 2],
                                             const float (&alpha)[2],
                                             uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= alpha[i];
      o[4 * j + 2 * i + 1] *= alpha[i];
    }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) pa[kk][c] = pack2<T>(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
}

template <typename T, int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Args a) {
  constexpr int BN = fwd_hopper_bn(D, kBias), kP = D / 64, kS = kFwdStages;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<T, D, BN>& sm = *reinterpret_cast<FwdSmem<T, D, BN>*>(align1024(smem_raw));
  const BlockPos pos = block_pos(a, static_cast<int>(blockIdx.x));
  const int q0 = pos.q0, h = pos.h, b = pos.b;
  const int wg = threadIdx.x / 128;
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(&sm.kfull[st], 32);  // the producer warp's lanes (they write the slot)
      mbar_init(&sm.vfull[st], 1);
      mbar_init(&sm.kempty[st], kConsumerWarps);
      mbar_init(&sm.vempty[st], kConsumerWarps);
    }
    mbar_init(&sm.qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: warp 0 walks the band's key tiles
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x, hk = h / (a.H / a.Hkv);
    if (lane == 0) {
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_tx(&sm.qbar, kBM * D * 2);
      for (int p = 0; p < kP; ++p) tma_load(sm.q[p], &tq, &sm.qbar, 64 * p, q0, h, b);
    }
    int qlo = 0, qhi = 0;
    if (seg) block_qseg_range(a, b, q0, qlo, qhi);
    const int kend = blk_key_end(q0, kBM, a);
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = blk_key_begin<BN>(q0, a); k0 < kend; k0 += BN) {
      KeyMasks<BN> km;
      if (kInt && key_tile_skip<BN>(a, seg, fm, b, h, q0, k0, qlo, qhi, km)) continue;
      mbar_wait(&sm.kempty[stage], phase ^ 1);
      if (kInt)
        write_slot<BN>(sm.slot[stage], k0, seg, fm, km);
      else if (lane == 0)
        sm.slot[stage].k0 = k0;
      if (lane == 0) {
        mbar_arrive_tx(&sm.kfull[stage], BN * D * 2);
        for (int p = 0; p < kP; ++p)
          tma_load(sm.k[stage][p], &tk, &sm.kfull[stage], 64 * p, k0, hk, b);
      } else {
        mbar_arrive(&sm.kfull[stage]);
      }
      mbar_wait(&sm.vempty[stage], phase ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(&sm.vfull[stage], BN * D * 2);
        for (int p = 0; p < kP; ++p)
          tma_load(sm.v[stage][p], &tv, &sm.vfull[stage], 64 * p, k0, hk, b);
      }
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(&sm.kempty[stage], phase ^ 1);  // the end of the list (no V)
    if (lane == 0) sm.slot[stage].k0 = -1;
    mbar_arrive(&sm.kfull[stage]);
    return;
  }

  // consumers: warpgroup cw owns rows qa .. qa + 63
  reg_alloc<kConsumerRegs>();
  const int cw = wg - 1, t = threadIdx.x - 128 * wg, lane = t % 32;
  const int qa = q0 + 64 * cw;
  const int qpos[2] = {qa + 16 * (t / 32) + lane / 4, qa + 16 * (t / 32) + lane / 4 + 8};
  int qid[2] = {0, 0};
  if (seg)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qid[i] = qpos[i] < a.Sq ? a.qseg[static_cast<long long>(b) * a.Sq + qpos[i]] : 0;
  const long long bb = kBias ? bias_base(a, b, h) : 0;
  float o[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < D / 2; ++c) o[c] = 0.f;
  uint32_t pa[BN / 16][4];
  const uint32_t qbase = smem_u32(sm.q[0]) + cw * 64 * 128;
  constexpr uint32_t kQPanel = kBM * 128, kKPanel = BN * 128;

  // Tile j's S product is issued, then tile j - 1's p v product, and tile
  // j's softmax runs while the tensor cores do the latter; o is rescaled
  // and the new p packed once it is done. No wgmma is in flight across a
  // branch (ptxas serializes every wgmma of a kernel that has one): the
  // first tile is a prologue, the loop body is the same for every tile, and
  // the last p v product an epilogue. Pingpong: warpgroup cw issues after
  // barrier 1 + cw opens, then opens the other's; warpgroup 0 goes first.
  // Both take the same tiles, so their turns match.
  const int my_bar = 1 + cw, other_bar = 2 - cw;
  if (cw == 1) named_arrive(other_bar);
  mbar_wait(&sm.qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(&sm.kfull[stage], phase);
  int k0 = sm.slot[stage].k0;
  if (k0 >= 0) {
    float s[BN / 2], alpha[2];
    named_sync(my_bar);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN, T>(s, desc_kmajor(qbase, kQPanel, kk),
                      desc_kmajor(smem_u32(sm.k[stage][0]), kKPanel, kk), kk > 0 ? 1 : 0);
    wgmma_commit();
    named_arrive(other_bar);
    uint64_t vis = tile_mask<BN, kInt>(a, sm.slot[stage], seg, fm, qa, k0, qpos, qid);
    uint64_t keep = kDrop ? tile_keep_bits<BN>(a, b, h, qpos[0], k0) : 0;
    wgmma_wait<0>();
    reg_fence(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.kempty[stage]);  // K and the slot are read
    softmax_tile<D, BN, kBias, kDrop>(s, m, l, alpha, a, k0, qpos, bb, vis, keep);
    rescale_pack<T, D, BN>(s, o, alpha, pa);
    int pv_stage = stage;
    uint32_t pv_phase = phase;
    if (++stage == kS) {
      stage = 0;
      phase ^= 1;
    }
    for (;;) {
      mbar_wait(&sm.kfull[stage], phase);
      k0 = sm.slot[stage].k0;
      if (k0 < 0) break;
      mbar_wait(&sm.vfull[pv_stage], pv_phase);
      named_sync(my_bar);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, T>(s, desc_kmajor(qbase, kQPanel, kk),
                        desc_kmajor(smem_u32(sm.k[stage][0]), kKPanel, kk), kk > 0 ? 1 : 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_cols<D, T>(o, pa[kk], smem_u32(sm.v[pv_stage][0]), kKPanel, kk);
      wgmma_commit();
      named_arrive(other_bar);
      // the masks and the dropout bits are formed while the tensor cores work
      vis = tile_mask<BN, kInt>(a, sm.slot[stage], seg, fm, qa, k0, qpos, qid);
      keep = kDrop ? tile_keep_bits<BN>(a, b, h, qpos[0], k0) : 0;
      if constexpr (kBias) {
        // beside a bias the p v product is done first: the bias loads need
        // the registers p holds while it runs
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(o);
        reg_fence(pa);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&sm.kempty[stage]);
          mbar_arrive(&sm.vempty[pv_stage]);
        }
        softmax_tile<D, BN, kBias, kDrop>(s, m, l, alpha, a, k0, qpos, bb, vis, keep);
      } else {
        wgmma_wait<1>();  // S done; the p v product may still run
        reg_fence(s);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.kempty[stage]);
        softmax_tile<D, BN, kBias, kDrop>(s, m, l, alpha, a, k0, qpos, bb, vis, keep);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.vempty[pv_stage]);
      }
      rescale_pack<T, D, BN>(s, o, alpha, pa);
      pv_stage = stage;
      pv_phase = phase;
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(&sm.vfull[pv_stage], pv_phase);
    named_sync(my_bar);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_cols<D, T>(o, pa[kk], smem_u32(sm.v[pv_stage][0]), kKPanel, kk);
    wgmma_commit();
    named_arrive(other_bar);
    wgmma_wait<0>();
    reg_fence(o);
  }

  T* ob = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= a.Sq) continue;
    // no visible key (or no key tile at all), or every score pushed to
    // -1e30 by a bias (then p = exp(0) makes l > 0)
    const bool dead = l[i] == 0.f || m[i] <= kNegInf * 0.5f;
    const float inv = dead ? 0.f : 1.f / l[i];
    T* orow = ob + ((static_cast<long long>(b) * a.Sq + qpos[i]) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < a.D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack2<T>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
    if (lane % 4 == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qpos[i]] =
          dead ? kNegInf : m[i] + logf(l[i]);
  }
}

template <typename T, int D, bool kBias, bool kInt, bool kDrop>
int launch(const Args& a, int dtype, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_view(&tq, a.q, a.vq, a.B, a.Sq, a.H, a.D, dtype, kBM);
  constexpr int BN = fwd_hopper_bn(D, kBias);
  if (err == 0) err = encode_view(&tk, a.k, a.vk, a.B, a.Sk, a.Hkv, a.D, dtype, BN);
  if (err == 0) err = encode_view(&tv, a.v, a.vv, a.B, a.Sk, a.Hkv, a.D, dtype, BN);
  if (err != 0) return err;
  auto* kernel = flash_fwd_wgmma_kernel<T, D, kBias, kInt, kDrop>;
  const size_t smem = sizeof(FwdSmem<T, D, BN>) + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((a.Sq + kBM - 1) / kBM) * a.H * a.B;
  kernel<<<grid, kThreadsH, smem, stream>>>(tq, tk, tv, a);
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
int fwd_hopper_run(const Args& a, int dtype, cudaStream_t s) {
  return dtype == kBF16 ? hopper::launch_bias<bf16, D>(a, dtype, s)
                        : hopper::launch_bias<f16, D>(a, dtype, s);
}

template int fwd_hopper_run<PTT_FLASH_D>(const Args&, int, cudaStream_t);

}  // namespace ptt_flash
