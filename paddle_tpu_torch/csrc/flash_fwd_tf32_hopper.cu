// Flash attention forward in fp32 for Hopper (sm_90a), on the TF32 tensor
// cores: each fp32 operand split into two TF32 halves and every product
// taken as three wgmma products (flash_hopper.cuh, "fp32 operands on the
// TF32 tensor cores"). out and the row logsumexp, as flash_fwd_hopper.cu
// computes them in 16 bits. Widths 64, 128, 192 and 256 (D_pad 32 and 96
// read into 64 and 128 with zero columns): every fp32 forward.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_fwd` (kernel body
// `_fwd_kernel`, masks `_mask_scores`) in fp32 on all its operands: causal /
// non-causal and the sliding window as one band, GQA (kv head h / (H /
// H_kv)), the additive bias in its own dtype with 0-strides over broadcast
// dims, segment ids, the flashmask rows with their tile skips and dropout
// with the backward's Philox keep bits, each alone and combined; lse for
// the backward. It took the place of an FP32-pipe forward, at D_pad <= 128
// first and then at 192 and 256, where that kernel went. flash_attention.cu
// (fwd_width) hands it every fp32 call.
//
// Bound on an H100 SXM: 4 D FLOPs a visible (query, key) pair, each three
// times on the tensor cores at 495 TFLOP/s dense TF32 (the GPT call B 8, S
// 1024, H 16, D 128 causal: 3 x 34.4 GFLOP, 0.2085 ms; at D 256 0.4169
// ms), or once at 67 TFLOP/s on the FP32 pipes (0.5133 / 1.0267 ms, the
// bound the FP32-pipe kernel had); q, k, v and out moved once (0.08 / 0.16
// ms).
//
// Two layouts, one consumer (`consume`), each one block an SM (a split
// operand takes 8 bytes an element):
//
// D_pad 64 / 128 (FwdTf32Smem). One block of 384 threads owns 128 query
// rows of one (batch, head): warpgroup 0 the producer (setmaxnreg 64),
// warpgroups 1 and 2 consumers of 64 rows each (setmaxnreg 216), which
// share every K / V tile. 226 KB at D_pad 128.
// - Q lands raw by TMA once (64 KB at D_pad 128) and stays: S = Q K^T takes
//   the warpgroup's 64 rows as the register A, split each key step
//   (gemm_raw).
// - K and V stream through a two-stage TMA ring of 32-key tiles. Warp 0 of
//   the producer walks the band's tile list (blk_key_begin / blk_key_end),
//   decides the integer masks' skips over the block's rows (key_tile_skip:
//   a skipped tile is never loaded) and issues the loads (`raw` mbarrier);
//   the stage's slot carries the tile's first key (-1 ends the list), its
//   segment ids and flashmask rows. Warps 1-3 split each landed tile and
//   arrive on `full`: K in place, hi over the raw words and lo beside,
//   perm8 order (the K-major B of S); V transposed into V^T [D_pad][32
//   keys] hi and lo, perm8 keys (the K-major B of O += P V).
//
// D_pad 192 / 256 (FwdWideSmem). The same design would need 128 rows of Q
// (128 KB at 256) beside two stages of 32 split keys (160 KB each), far
// past the 227 KB a block may hold, and a 64 x 256 fp32 output is 128
// registers a thread. So one block of 256 threads owns 64 query rows:
// warpgroup 0 the producer, warpgroup 1 the one consumer (no setmaxnreg:
// 255 registers a thread at launch). 224 KB at D_pad 256 (Q 64 KB, one
// landed stage 32 KB, two split stages 64 KB each), 192 KB at 192 (two
// landed stages: hw landed_stages).
// - Key tiles of 16: the loads land in a ring of their own (`raw` /
//   `land_empty`), which warps 1-3 split into the split ring (SplitRing:
//   K's halves, and V^T's halves in 128-byte rows that the two stages share
//   by key halves). A landed stage is free once it is split, so the next
//   tile's load runs under the products of the split ring's two tiles, not
//   after them. The split warps copy the landed slot into the split
//   stage's.
// - gemm_raw issues two key steps a group (32 registers of Q fragments, not
//   64) beside o's 128; P V goes through two accumulators of 64 head
//   columns in flight (pv_tile).
//
// In both: TF32 wgmma takes no transposed B, so V is transposed once by the
// split warps and P stays in registers: the S accumulator's columns 8 kk +
// 2 (l % 4) and + 1 of key step kk are the TF32 A fragment's contraction
// indices l % 4 and l % 4 + 4, which V^T's perm8 keys match. (The other
// form, O^T = V^T P^T as the dK/dV kernels take dv^T, holds O transposed:
// the online softmax's per-row rescale would cross threads through shared
// memory each tile, and p would be written there.) The online softmax runs
// on the register fragment (softmax_tile: masks, scale, bias, the row max
// over the quad, dropout, l of the undropped probabilities), the masks and
// the dropout bits formed as the 16-bit forward forms them (tile_mask,
// tile_keep_bits). Each tile's P V product goes to fresh accumulators,
// added to the rescaled running output by the threads in fp32 (no chain
// longer than one tile: flash_hopper.cuh, "Accumulation"). A warpgroup
// skips the math of a tile that lies wholly outside the band for its rows
// (tile_out_of_band); it still takes the stage and frees it. Each product
// is issued and waited for inside that one branch. Order (block_pos):
// groups of 16 (batch, head) pairs, the longest causal query tiles first
// inside a group. A row that sees no key writes zeros and lse = -1e30.

#include "flash_hopper.cuh"

#ifndef PTT_FLASH_D
#error "compile once per TF32 width: -DPTT_FLASH_D=<64|128|192|256>"
#endif

namespace ptt_flash {
namespace hopper {
namespace {

constexpr int kStages = 2;      // the split ring (both layouts)
constexpr int kSplitters = 96;  // producer warps 1-3
// setmaxnreg (D_pad 64 / 128): the block launches at 168 registers a thread
// (65536 / 384); the new budgets sum to no more than 3 x 168: 64 for the
// producer (its warp 0 holds the integer masks' reductions beside the split
// loop), 216 for each consumer warpgroup (64 of output, the score fragment
// and two key steps' split Q fragments in flight).
constexpr int kProdRegs = 64;
constexpr int kConsRegs = 216;
static_assert(kProdRegs + 2 * kConsRegs <= 3 * (65536 / kThreadsH / 8 * 8),
              "setmaxnreg.inc would wait for registers no warpgroup gave back");

// D_pad 64 / 128: 128 rows, 32-key tiles, K split in place.
template <int D>
struct FwdTf32Smem {
  static constexpr int kP = f32_panels(D), kFR = tf32_fwd_bm(D), kKN = tf32_key_tile(D);
  static constexpr int kThreads = kThreadsH;
  float q[kP][kFR * 32];                    // raw, [128][D] in panels of 32 columns
  float k[kStages][kP][kKN * 32];           // K as landed, then its hi half (perm8)
  float klo[kStages][kP][kKN * 32];         // K's lo half
  float v[kStages][kP][kKN * 32];           // V as landed
  float vhi[kStages][D * 32], vlo[kStages][D * 32];  // V^T [D][32 keys], split, perm8
  uint64_t raw[kStages], full[kStages], empty[kStages], qbar;
  Slot<kKN> slot[kStages];
  // the stages the producer loads: the split ring's, freed by the consumers
  static constexpr int kLoads = kStages;
  __device__ __forceinline__ float* load_k(int st, int p) { return k[st][p]; }
  __device__ __forceinline__ float* load_v(int st, int p) { return v[st][p]; }
  __device__ __forceinline__ uint64_t* load_free(int st) { return &empty[st]; }
  __device__ __forceinline__ Slot<kKN>& load_slot(int st) { return slot[st]; }
  __device__ __forceinline__ uint32_t khi_at(int st) { return smem_u32(k[st][0]); }
  __device__ __forceinline__ uint32_t klo_at(int st) { return smem_u32(klo[st][0]); }
  __device__ __forceinline__ uint32_t vhi_at(int st) { return smem_u32(vhi[st]); }
  __device__ __forceinline__ uint32_t vlo_at(int st) { return smem_u32(vlo[st]); }
  __device__ __forceinline__ static int vt_key0(int) { return 0; }
};

// D_pad 192 / 256: 64 rows, 16-key tiles, a landed ring apart from the
// split ring (two landed stages where they fit).
template <int D>
struct FwdWideSmem {
  static constexpr int kP = f32_panels(D), kFR = tf32_fwd_bm(D), kKN = tf32_key_tile(D);
  static constexpr int kThreads = 256;
  using Ring = SplitRing<D, kStages>;
  static constexpr int kLanded = landed_stages(kFR * D * 4 + sizeof(Ring), kKN * D * 4);
  float q[kP][kFR * 32];                    // raw, [64][D]
  float kraw[kLanded][kP][kKN * 32];        // K and V as landed
  float vraw[kLanded][kP][kKN * 32];
  Ring ring;
  uint64_t raw[kLanded], land_empty[kLanded], full[kStages], empty[kStages], qbar;
  Slot<kKN> lslot[kLanded], slot[kStages];
  // the stages the producer loads: the landed ring's, freed by the split
  static constexpr int kLoads = kLanded;
  __device__ __forceinline__ float* load_k(int st, int p) { return kraw[st][p]; }
  __device__ __forceinline__ float* load_v(int st, int p) { return vraw[st][p]; }
  __device__ __forceinline__ uint64_t* load_free(int st) { return &land_empty[st]; }
  __device__ __forceinline__ Slot<kKN>& load_slot(int st) { return lslot[st]; }
  __device__ __forceinline__ uint32_t khi_at(int st) { return smem_u32(ring.khi[st][0]); }
  __device__ __forceinline__ uint32_t klo_at(int st) { return smem_u32(ring.klo[st][0]); }
  __device__ __forceinline__ uint32_t vhi_at(int st) { return smem_u32(ring.vt_hi(st)); }
  __device__ __forceinline__ uint32_t vlo_at(int st) { return smem_u32(ring.vt_lo(st)); }
  __device__ __forceinline__ static int vt_key0(int st) { return Ring::vt_key0(st); }
};

template <int N>
__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase) {
  if (++stage == N) {
    stage = 0;
    phase ^= 1;
  }
}

// Warp 0 of the producer: Q once, then the band's key tiles into the
// stages it loads (the split ring's at D_pad <= 128, the landed ring's
// above), the list ended by a stage whose first key is -1; a stage is freed
// by the consumers' `empty` or the split warps' `land_empty`.
template <bool kInt, typename S>
__device__ __forceinline__ void produce(S& sm, const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const Args& a, BlockPos pos,
                                        bool seg, bool fm) {
  constexpr int kFR = S::kFR, kKN = S::kKN, kP = S::kP;
  const int q0 = pos.q0, h = pos.h, b = pos.b;
  const int lane = threadIdx.x, hk = h / (a.H / a.Hkv);
  if (lane == 0) {
    tma_prefetch_map(tk);
    tma_prefetch_map(tv);
    mbar_arrive_tx(&sm.qbar, kFR * kP * 32 * 4);
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
    mbar_wait(sm.load_free(stage), phase ^ 1);
    if (kInt)
      write_slot<kKN>(sm.load_slot(stage), k0, seg, fm, km);
    else if (lane == 0)
      sm.load_slot(stage).k0 = k0;
    if (lane == 0) {
      mbar_arrive_tx(&sm.raw[stage], 2 * kKN * kP * 32 * 4);
      for (int p = 0; p < kP; ++p) {
        tma_load(sm.load_k(stage, p), tk, &sm.raw[stage], 32 * p, k0, hk, b);
        tma_load(sm.load_v(stage, p), tv, &sm.raw[stage], 32 * p, k0, hk, b);
      }
    } else {
      mbar_arrive(&sm.raw[stage]);
    }
    next_stage<S::kLoads>(stage, phase);
  }
  mbar_wait(sm.load_free(stage), phase ^ 1);  // the end of the list
  if (lane == 0) sm.load_slot(stage).k0 = -1;
  mbar_arrive(&sm.raw[stage]);
}

// Warps 1-3 of the producer at D_pad <= 128: K split in place (hi over the
// raw words, lo beside, perm8), V split into V^T [D][32 keys] (perm8 keys);
// then `full`.
template <int D>
__device__ __forceinline__ void split_stream(FwdTf32Smem<D>& sm) {
  const int tid = threadIdx.x - 32;
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.raw[stage], phase);
    const int k0 = sm.slot[stage].k0;
    if (k0 >= 0) {
      split_k_vt<D, FwdTf32Smem<D>::kKN>(sm.k[stage][0], sm.k[stage][0], sm.klo[stage][0],
                                         sm.v[stage][0], sm.vhi[stage], sm.vlo[stage], tid,
                                         kSplitters);
      fence_proxy_async();
    }
    mbar_arrive(&sm.full[stage]);
    next_stage<kStages>(stage, phase);
    if (k0 < 0) break;
  }
}

// Warps 1-3 of the producer at D_pad 192 / 256: a landed stage split into a
// split stage (SplitRing), its slot copied beside it; the landed stage freed
// (`land_empty`), the split one handed on (`full`).
template <int D, bool kInt>
__device__ __forceinline__ void split_stream(FwdWideSmem<D>& sm) {
  using S = FwdWideSmem<D>;
  const int tid = threadIdx.x - 32;
  int land = 0, stage = 0;
  uint32_t land_phase = 0, phase = 0;
  for (;;) {
    mbar_wait(&sm.raw[land], land_phase);
    mbar_wait(&sm.empty[stage], phase ^ 1);
    const int k0 = sm.lslot[land].k0;
    if (kInt) {
      constexpr int kWords = static_cast<int>(sizeof(Slot<S::kKN>) / 4);
      const int* src = reinterpret_cast<const int*>(&sm.lslot[land]);
      int* dst = reinterpret_cast<int*>(&sm.slot[stage]);
      for (int w = tid; w < kWords; w += kSplitters) dst[w] = src[w];
    } else if (tid == 0) {
      sm.slot[stage].k0 = k0;
    }
    if (k0 >= 0) sm.ring.split(stage, sm.kraw[land][0], sm.vraw[land][0], tid, kSplitters);
    mbar_arrive(&sm.land_empty[land]);
    fence_proxy_async();
    mbar_arrive(&sm.full[stage]);
    next_stage<S::kLanded>(land, land_phase);
    next_stage<kStages>(stage, phase);
    if (k0 < 0) break;
  }
}

// This thread's rows qpos[i] (< Sq) of out, normalized, and their lse.
template <int D>
__device__ __forceinline__ void store_rows(const Args& a, int b, int h, const int (&qpos)[2],
                                           const float (&o)[D / 2], const float (&m)[2],
                                           const float (&l)[2]) {
  const int lane = threadIdx.x % 32;
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

// Consumer warpgroup cw: rows qa .. qa + 63 of the block, over the split
// stages of either layout.
template <int D, bool kBias, bool kInt, bool kDrop, typename S>
__device__ __forceinline__ void consume(S& sm, const Args& a, BlockPos pos, int cw, bool seg,
                                        bool fm) {
  constexpr int kKN = S::kKN;
  constexpr uint32_t kQPanel = S::kFR * 128, kKPanel = kKN * 128;
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
      gemm_raw<kKN, D>(s, qt, kQPanel, sm.khi_at(stage), sm.klo_at(stage), kKPanel);
      // the masks and the keep bits after S: formed before it, they stayed
      // live beside the split Q fragments and spilled the D_pad 128 bias +
      // dropout instance
      const uint64_t vis = tile_mask<kKN, kInt>(a, sm.slot[stage], seg, fm, qa, k0, qpos, qid);
      const uint64_t keep = kDrop ? tile_keep_bits<kKN>(a, b, h, qpos[0], k0) : 0;
      softmax_tile<D, kKN, kBias, kDrop>(s, m, l, alpha, a, k0, qpos, bb, vis, keep);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o[c] *= alpha[(c / 2) % 2];
      // P split in registers, then O += P V (flash_hopper.cuh pv_tile)
      uint32_t phi[kKN / 8][4], plo[kKN / 8][4];
      float part[pv_accs(D)][32];
      split_p<kKN>(s, phi, plo);
      pv_tile<D, kKN / 8>(o, part, phi, plo, sm.vhi_at(stage), sm.vlo_at(stage),
                          S::vt_key0(stage) / 8);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    next_stage<kStages>(stage, phase);
  }
  store_rows<D>(a, b, h, qpos, o, m, l);
}

template <int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Args a) {
  using Smem = FwdTf32Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const BlockPos pos = block_pos<Smem::kFR>(a, static_cast<int>(blockIdx.x));
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
      produce<kInt>(sm, &tq, &tk, &tv, a, pos, seg, fm);
    else
      split_stream<D>(sm);
    return;
  }
  reg_alloc<kConsRegs>();
  consume<D, kBias, kInt, kDrop>(sm, a, pos, threadIdx.x / 128 - 1, seg, fm);
}

template <int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(256, 1)
    flash_fwd_tf32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, const Args a) {
  using Smem = FwdWideSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const BlockPos pos = block_pos<Smem::kFR>(a, static_cast<int>(blockIdx.x));
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;

  if (threadIdx.x == 0) {
    for (int st = 0; st < Smem::kLanded; ++st) {
      mbar_init(&sm.raw[st], 32);  // the producer warp's lanes (they write the slot)
      mbar_init(&sm.land_empty[st], kSplitters);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], kSplitters);
      mbar_init(&sm.empty[st], 4);  // the consumer warpgroup's warps
    }
    mbar_init(&sm.qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x < 32)
      produce<kInt>(sm, &tq, &tk, &tv, a, pos, seg, fm);
    else
      split_stream<D, kInt>(sm);
    return;
  }
  consume<D, kBias, kInt, kDrop>(sm, a, pos, 0, seg, fm);
}

template <int D, bool kBias, bool kInt, bool kDrop>
int launch(const Args& a, cudaStream_t stream) {
  using Smem = std::conditional_t<(D > 128), FwdWideSmem<D>, FwdTf32Smem<D>>;
  // the attribute first: a runtime call, it makes the device's context
  // current on this thread before the tensor maps are encoded
  auto* kernel = [] {
    if constexpr (D > 128)
      return flash_fwd_tf32_wide_kernel<D, kBias, kInt, kDrop>;
    else
      return flash_fwd_tf32_kernel<D, kBias, kInt, kDrop>;
  }();
  const size_t smem = sizeof(Smem) + 1024;
  static_assert(sizeof(Smem) + 1024 <= 232448, "over the 227 KB a block may hold");
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv;
  int err = encode_view(&tq, a.q, a.vq, a.B, a.Sq, a.H, a.D, kF32, Smem::kFR);
  if (err == 0) err = encode_view(&tk, a.k, a.vk, a.B, a.Sk, a.Hkv, a.D, kF32, Smem::kKN);
  if (err == 0) err = encode_view(&tv, a.v, a.vv, a.B, a.Sk, a.Hkv, a.D, kF32, Smem::kKN);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>((a.Sq + Smem::kFR - 1) / Smem::kFR) * a.H * a.B;
  kernel<<<grid, Smem::kThreads, smem, stream>>>(tq, tk, tv, a);
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
