// Flash attention forward in fp32 for Hopper (sm_90a), on the TF32 tensor
// cores: each fp32 operand split into two TF32 halves and every product
// taken as three wgmma products (flash_hopper.cuh, "fp32 operands on the
// TF32 tensor cores"). out and the row logsumexp, as flash_fwd_hopper.cu
// computes them in 16 bits. Widths 64 and 128 (D_pad 32 and 96 read into
// them with zero columns); D_pad 192 and 256 stay on flash_attention_fwd.cu's
// FP32-pipe kernel (flash_common.cuh says why).
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_fwd` (kernel body
// `_fwd_kernel`, masks `_mask_scores`) in fp32 on all its operands: causal /
// non-causal and the sliding window as one band, GQA (kv head h / (H /
// H_kv)), the additive bias in its own dtype with 0-strides over broadcast
// dims, segment ids, the flashmask rows with their tile skips and dropout
// with the backward's Philox keep bits, each alone and combined; lse for
// the backward. It took the place of flash_attention_fwd.cu's FP32-pipe
// forward at D_pad <= 128.
//
// Bound on an H100 SXM: 4 D FLOPs a visible (query, key) pair, each three
// times on the tensor cores at 495 TFLOP/s dense TF32 (the GPT call B 8, S
// 1024, H 16, D 128 causal: 3 x 34.4 GFLOP, 0.2085 ms), or once at 67
// TFLOP/s on the FP32 pipes (0.5133 ms, the bound the FP32-pipe kernel
// had); q, k, v and out moved once (0.08 ms).
//
// Design. One block of 384 threads owns 128 query rows of one (batch,
// head): warpgroup 0 the producer (setmaxnreg 64), warpgroups 1 and 2
// consumers of 64 rows each (setmaxnreg 216), which share every K / V tile.
// Shared memory limits the block to one an SM: a split operand takes 8
// bytes an element (226 KB at D_pad 128).
// - Q lands raw by TMA once (64 KB at D_pad 128) and stays: S = Q K^T takes
//   the warpgroup's 64 rows as the register A, split each key step
//   (gemm_raw).
// - K and V stream through a two-stage TMA ring of 32-key tiles. Warp 0 of
//   the producer walks the band's tile list (blk_key_begin / blk_key_end),
//   decides the integer masks' skips over the block's 128 rows
//   (key_tile_skip: a skipped tile is never loaded) and issues the loads
//   (`raw` mbarrier); the stage's slot carries the tile's first key (-1
//   ends the list), its segment ids and flashmask rows. Warps 1-3 split each
//   landed tile and arrive on `full`: K in place, hi over the raw words and
//   lo beside, perm8 order (the K-major B of S); V transposed into V^T
//   [D_pad][32 keys] hi and lo, perm8 keys (the K-major B of O += P V).
//   TF32 wgmma takes no transposed B, so V is transposed once here and P
//   stays in registers: the S accumulator's columns 8 kk + 2 (l % 4) and + 1
//   of key step kk are the TF32 A fragment's contraction indices l % 4 and
//   l % 4 + 4, which V^T's perm8 keys match. (The other form, O^T = V^T
//   P^T as the dK/dV kernels take dv^T, holds O transposed: the online
//   softmax's per-row rescale would cross threads through shared memory
//   each tile, and p would be written there.)
// - The online softmax on the register fragment (softmax_tile: masks,
//   scale, bias, the row max over the quad, dropout, l of the undropped
//   probabilities), the masks and the dropout bits as the 16-bit forward
//   forms them (tile_mask, tile_keep_bits). Each tile's P V product goes to
//   a fresh accumulator, added to the rescaled running output by the
//   threads in fp32 (no chain longer than one tile: flash_hopper.cuh,
//   "Accumulation").
// - A warpgroup skips the math of a tile that lies wholly outside the band
//   for its rows (tile_out_of_band); it still takes the stage and frees it.
//   Each product is issued and waited for inside that one branch.
// - Order (block_pos): groups of 16 (batch, head) pairs, the longest causal
//   query tiles first inside a group.
// A row that sees no key writes zeros and lse = -1e30.

#include "flash_hopper.cuh"

#ifndef PTT_FLASH_D
#error "compile once per TF32 width: -DPTT_FLASH_D=<64|128>"
#endif

namespace ptt_flash {
namespace hopper {
namespace {

constexpr int kFR = kTf32FwdBM;  // query rows a block (flash_common.cuh)
constexpr int kKN = kTf32FwdBN;  // keys a streamed tile
constexpr int kStages = 2;
constexpr int kSplitters = 96;  // producer warps 1-3
// setmaxnreg: the block launches at 168 registers a thread (65536 / 384);
// the new budgets sum to no more than 3 x 168: 64 for the producer (its
// warp 0 holds the integer masks' reductions beside the split loop), 216
// for each consumer warpgroup (64 of output, the score fragment and two
// key steps' split Q fragments in flight).
constexpr int kProdRegs = 64;
constexpr int kConsRegs = 216;
static_assert(kProdRegs + 2 * kConsRegs <= 3 * (65536 / kThreadsH / 8 * 8),
              "setmaxnreg.inc would wait for registers no warpgroup gave back");

template <int D>
struct FwdTf32Smem {
  static constexpr int kP = f32_panels(D);
  float q[kP][kFR * 32];                    // raw, [128][D] in panels of 32 columns
  float k[kStages][kP][kKN * 32];           // K as landed, then its hi half (perm8)
  float klo[kStages][kP][kKN * 32];         // K's lo half
  float v[kStages][kP][kKN * 32];           // V as landed
  float vhi[kStages][D * 32], vlo[kStages][D * 32];  // V^T [D][32 keys], split, perm8
  uint64_t raw[kStages], full[kStages], empty[kStages], qbar;
  Slot<kKN> slot[kStages];
};

__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// Warp 0 of the producer: Q once, then the band's key tiles, the list ended
// by a stage whose first key is -1.
template <int D, bool kInt>
__device__ __forceinline__ void produce(FwdTf32Smem<D>& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv,
                                        const Args& a, BlockPos pos, bool seg, bool fm) {
  constexpr int kP = FwdTf32Smem<D>::kP;
  const int q0 = pos.q0, h = pos.h, b = pos.b;
  const int lane = threadIdx.x, hk = h / (a.H / a.Hkv);
  if (lane == 0) {
    tma_prefetch_map(tk);
    tma_prefetch_map(tv);
    mbar_arrive_tx(&sm.qbar, kFR * D * 4);
    for (int p = 0; p < kP; ++p) tma_load(sm.q[p], tq, &sm.qbar, 32 * p, q0, h, b);
  }
  int qlo = 0, qhi = 0;
  if (seg) block_qseg_range<kFR>(a, b, q0, qlo, qhi);
  const int kend = blk_key_end(q0, kFR, a);
  int stage = 0;
  uint32_t phase = 0;
  for (int k0 = blk_key_begin<kKN>(q0, a); k0 < kend; k0 += kKN) {
    KeyMasks<kKN> km;
    if (kInt && key_tile_skip<kKN, kFR>(a, seg, fm, b, h, q0, k0, qlo, qhi, km)) continue;
    mbar_wait(&sm.empty[stage], phase ^ 1);
    if (kInt)
      write_slot<kKN>(sm.slot[stage], k0, seg, fm, km);
    else if (lane == 0)
      sm.slot[stage].k0 = k0;
    if (lane == 0) {
      mbar_arrive_tx(&sm.raw[stage], 2 * kKN * D * 4);
      for (int p = 0; p < kP; ++p) {
        tma_load(sm.k[stage][p], tk, &sm.raw[stage], 32 * p, k0, hk, b);
        tma_load(sm.v[stage][p], tv, &sm.raw[stage], 32 * p, k0, hk, b);
      }
    } else {
      mbar_arrive(&sm.raw[stage]);
    }
    next_stage(stage, phase);
  }
  mbar_wait(&sm.empty[stage], phase ^ 1);  // the end of the list
  if (lane == 0) sm.slot[stage].k0 = -1;
  mbar_arrive(&sm.raw[stage]);
}

// Warps 1-3 of the producer: K split in place (hi over the raw words, lo
// beside, perm8), V split into V^T [D][32 keys] (perm8 keys); then `full`.
template <int D>
__device__ __forceinline__ void split_stream(FwdTf32Smem<D>& sm) {
  const int tid = threadIdx.x - 32;
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.raw[stage], phase);
    const int k0 = sm.slot[stage].k0;
    if (k0 >= 0) {
      split_k_vt<D, kKN>(sm.k[stage][0], sm.k[stage][0], sm.klo[stage][0], sm.v[stage][0],
                         sm.vhi[stage], sm.vlo[stage], tid, kSplitters);
      fence_proxy_async();
    }
    mbar_arrive(&sm.full[stage]);
    next_stage(stage, phase);
    if (k0 < 0) break;
  }
}

// Consumer warpgroup cw: rows qa .. qa + 63 of the block.
template <int D, bool kBias, bool kInt, bool kDrop>
__device__ __forceinline__ void consume(FwdTf32Smem<D>& sm, const Args& a, BlockPos pos, int cw,
                                        bool seg, bool fm) {
  constexpr uint32_t kQPanel = kFR * 128, kKPanel = kKN * 128;
  const int h = pos.h, b = pos.b;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int qa = pos.q0 + 64 * cw;
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
  const unsigned char* qt = reinterpret_cast<const unsigned char*>(sm.q[0]) + cw * 64 * 128;

  mbar_wait(&sm.qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.full[stage], phase);
    const int k0 = sm.slot[stage].k0;
    if (k0 < 0) break;
    if (!tile_out_of_band<kKN>(qa, k0, a)) {
      float s[kKN / 2], alpha[2];
      gemm_raw<kKN, D>(s, qt, kQPanel, smem_u32(sm.k[stage][0]), smem_u32(sm.klo[stage][0]),
                       kKPanel);
      // the masks and the keep bits after S: formed before it, they stayed
      // live beside the split Q fragments and spilled the D_pad 128 bias +
      // dropout instance
      const uint64_t vis = tile_mask<kKN, kInt>(a, sm.slot[stage], seg, fm, qa, k0, qpos, qid);
      const uint64_t keep = kDrop ? tile_keep_bits<kKN>(a, b, h, qpos[0], k0) : 0;
      softmax_tile<D, kKN, kBias, kDrop>(s, m, l, alpha, a, k0, qpos, bb, vis, keep);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o[c] *= alpha[(c / 2) % 2];
      // P split in registers: key step kk's A fragment is registers 4 kk ..
      // 4 kk + 3 (contraction index l % 4: column 8 kk + 2 (l % 4), rows i =
      // 0, 1; l % 4 + 4: the column after it)
      uint32_t phi[kKN / 8][4], plo[kKN / 8][4];
#pragma unroll
      for (int kk = 0; kk < kKN / 8; ++kk) {
        split_tf32(s[4 * kk], phi[kk][0], plo[kk][0]);
        split_tf32(s[4 * kk + 2], phi[kk][1], plo[kk][1]);
        split_tf32(s[4 * kk + 1], phi[kk][2], plo[kk][2]);
        split_tf32(s[4 * kk + 3], phi[kk][3], plo[kk][3]);
      }
      // O += P V, each 64 head columns into a fresh accumulator: the small
      // products first, then the large ones
      float part[D / 64][32];
      const uint32_t vhi = smem_u32(sm.vhi[stage]), vlo = smem_u32(sm.vlo[stage]);
      wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < D / 64; ++mb) {
        const uint32_t off = mb * 64 * 128;
#pragma unroll
        for (int kk = 0; kk < kKN / 8; ++kk) {
          wgmma_tf32<64>(part[mb], plo[kk], desc_kmajor(vhi + off, 0, kk), kk > 0 ? 1 : 0);
          wgmma_tf32<64>(part[mb], phi[kk], desc_kmajor(vlo + off, 0, kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < kKN / 8; ++kk)
          wgmma_tf32<64>(part[mb], phi[kk], desc_kmajor(vhi + off, 0, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(part);
      reg_fence(phi);
      reg_fence(plo);
#pragma unroll
      for (int mb = 0; mb < D / 64; ++mb)
#pragma unroll
        for (int c = 0; c < 32; ++c) o[32 * mb + c] += part[mb][c];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    next_stage(stage, phase);
  }

  float* ob = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= a.Sq) continue;
    // no visible key (or no key tile at all), or every score pushed to
    // -1e30 by a bias (then p = exp(0) makes l > 0)
    const bool dead = l[i] == 0.f || m[i] <= kNegInf * 0.5f;
    const float inv = dead ? 0.f : 1.f / l[i];
    float* orow = ob + ((static_cast<long long>(b) * a.Sq + qpos[i]) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < a.D)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
    if (lane % 4 == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qpos[i]] =
          dead ? kNegInf : m[i] + logf(l[i]);
  }
}

template <int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Args a) {
  using Smem = FwdTf32Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const BlockPos pos = block_pos<kFR>(a, static_cast<int>(blockIdx.x));
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.raw[st], 32);  // the producer warp's lanes (they write the slot)
      mbar_init(&sm.full[st], kSplitters);
      mbar_init(&sm.empty[st], kConsumerWarps);
    }
    mbar_init(&sm.qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    reg_dealloc<kProdRegs>();
    if (threadIdx.x < 32)
      produce<D, kInt>(sm, &tq, &tk, &tv, a, pos, seg, fm);
    else
      split_stream<D>(sm);
    return;
  }
  reg_alloc<kConsRegs>();
  consume<D, kBias, kInt, kDrop>(sm, a, pos, threadIdx.x / 128 - 1, seg, fm);
}

template <int D, bool kBias, bool kInt, bool kDrop>
int launch(const Args& a, cudaStream_t stream) {
  using Smem = FwdTf32Smem<D>;
  // the attribute first: a runtime call, it makes the device's context
  // current on this thread before the tensor maps are encoded
  auto* kernel = flash_fwd_tf32_kernel<D, kBias, kInt, kDrop>;
  const size_t smem = sizeof(Smem) + 1024;
  static_assert(sizeof(Smem) + 1024 <= 232448, "over the 227 KB a block may hold");
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv;
  int err = encode_view(&tq, a.q, a.vq, a.B, a.Sq, a.H, a.D, kF32, kFR);
  if (err == 0) err = encode_view(&tk, a.k, a.vk, a.B, a.Sk, a.Hkv, a.D, kF32, kKN);
  if (err == 0) err = encode_view(&tv, a.v, a.vv, a.B, a.Sk, a.Hkv, a.D, kF32, kKN);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>((a.Sq + kFR - 1) / kFR) * a.H * a.B;
  kernel<<<grid, kThreadsH, smem, stream>>>(tq, tk, tv, a);
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
int fwd_tf32_run(const Args& a, cudaStream_t s) {
  return a.bias != nullptr ? hopper::launch_flags<D, true>(a, s)
                           : hopper::launch_flags<D, false>(a, s);
}

template int fwd_tf32_run<PTT_FLASH_D>(const Args&, cudaStream_t);

}  // namespace ptt_flash
