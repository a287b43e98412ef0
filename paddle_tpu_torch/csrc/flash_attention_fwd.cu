// Flash attention forward for Hopper (sm_90a): out and the row logsumexp.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_fwd` (kernel body
// `_fwd_kernel`) on all its operands: causal / non-causal, GQA, bias,
// segments, dropout, the flashmask rows and the sliding window. For each
// (batch, query head) out = softmax(scale * q k^T + bias [masked]) v over
// [B, S, H, D] views, with lse = m + log(l) per query row saved for the
// backward. Causal masking is bottom-right aligned (key j visible to query i
// iff j <= i + Sk - Sq). A row that sees no key writes
// zeros and lse = -1e30, as the Pallas kernel's finalize does. GQA reads kv
// head h / (H / H_kv); K and V are never repeated. Any Sq and Sk; any D up
// to 256 (flash_common.cuh: compiled for D_pad in {32, 64, 96, 128, 192,
// 256}, zero columns past D); fp32, bf16 or fp16 in, fp32 scores, softmax
// and accumulators.
//
// This file is compiled once per D_pad (-DPTT_FLASH_D=<D_pad>, see
// kernels/_build.py) so the family builds in parallel; flash_attention.cu
// holds the C entry that picks the width.
//
// Additive bias (`_fwd_kernel` with has_bias): a [B, H, Sq, Sk] view in its
// own dtype (fp32, bf16 or fp16) whose four strides may be 0 (a
// [1|B, 1|H, Sq, Sk] mask broadcast in place), added in fp32 to the scaled
// scores before the running max, as `_mask_scores` adds
// bias.astype(float32). The mask is arbitrary, so no tile is skipped beyond
// the causal and segment bounds, and a row whose every score the bias pushed
// to -1e30 is dead (m <= -0.5e30): it writes zeros and lse = -1e30.
// At the padded BERT-base call (B 16, S 512, H 12, D 64, bf16, bias
// [16, 1, 512, 512]) the call must move q, k, v and out (50.3 MB) and the
// bias (8.4 MB), ~0.018 ms at 3.35 TB/s, against ~0.010 ms of operations:
// bytes bound it.
//
// Segment ids (`_fwd_kernel` with has_seg, the packed BERT rows): int32
// [B, Sq] and [B, Sk] read in place, a pair visible iff its two ids are
// equal (pads carry -1, so pads see pads); a key tile whose id range is
// disjoint from the query tile's is skipped, as `_seg_block_overlap` does. A
// row that matches no key is dead: zeros and lse = -1e30.
//
// The sliding window (`_fwd_kernel` with window = (left, right)): key j is
// visible to query i iff i + off - left <= j <= i + off + right with off =
// Sk - Sq, a band beside the causal one (flash_common.cuh visible()); the
// loop runs from the band's first key tile to its last (key_begin, key_end),
// as _block_run and _last_k_block skip the blocks outside it.
//
// Flashmask rows (`_fwd_kernel` with has_fm): int32 [B, 1|H, Sk] start and
// end, key j masked for the raw query index start[j] <= i < end[j]. Each key
// tile loads its 64 pairs with their max start and min end, and a tile
// whose every key masks every query of the block is skipped, which is exact
// (the JAX kernel masks elementwise and runs it). Under a causal document
// mask (start[j] = the end of j's document) most tiles below the diagonal
// go. A row whose every key is masked is dead: zeros and lse = -1e30.
//
// Dropout (`_fwd_kernel` with dropout_p): the keep bit of (b, h, i, j) is a
// Philox4x32-10 word keyed by the seed with (j / 4, i, h, b) as the counter
// (flash_common.cuh drop_bits), kept iff >= floor(p 2^32); the TPU keys its
// bits by tile, which the backward kernels here, tiled otherwise, could not
// regenerate. lse comes from the undropped scores and the kept probabilities
// are scaled by 1 / (1 - p) before the p v product. On the tensor cores a
// thread then owns four adjacent columns of a score row, one Philox call.
// The bias, the integer masks (segments, flashmask rows) and dropout are
// template flags (each changes the inner loop) and combine freely with each
// other and the window; the bias's dtype, and which integer masks are
// present, are runtime branches. (As a runtime branch the bias measured
// slower on the card in the kernels without one: its address arithmetic is
// predicated into the softmax loop.)
//
// TPU -> Hopper. The Pallas grid (B*H, q blocks, k blocks) carries m, l and
// the accumulator across its sequential k axis in VMEM scratch. CUDA blocks
// run in no order, so one block of 256 threads owns one (query tile of 64,
// head, batch) and loops over the key tiles itself, with m and l in
// registers (replicated over the half-warp that owns a row) and the 64 x D
// fp32 accumulator in registers. The band's loop bounds (key_begin,
// key_end) replace _block_run / _last_k_block: tiles outside the causal
// diagonal and the window are never loaded.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the flagship
// shape (B 8, S 1024, H 16, D 128, causal, bf16) the call does 4 * D FLOPs
// per visible (query, key) pair, ~34 GFLOP, and must move q, k, v and out
// once, ~134 MB: both bounds sit near 0.04 ms. This file holds the routing
// of every dtype and width (fwd_run) and the FP32-pipe kernel for fp32 at
// D_pad 192 and 256: the tiles are staged as fp32 (K and Q rows padded to
// D + 1 so the 16 readers of a column hit 16 banks) and both products run
// on the FP32 pipes with 4 x 4 register tiles, exact to fp32 rounding.
// fwd_run hands every bf16 and fp16 call to the wgmma kernel of
// flash_fwd_hopper.cu (scores and output in registers, K / V through a TMA
// ring) and every fp32 call of D_pad <= 128 to the TF32 tensor-core kernel
// of flash_fwd_tf32_hopper.cu (each operand split into two TF32 halves,
// three products for each). The TF32 design does not fit D_pad 192 and
// 256 (flash_common.cuh).

#include "flash_common.cuh"

#ifndef PTT_FLASH_D
#error "compile once per head-dim family member: -DPTT_FLASH_D=<32|64|96|128|192|256>"
#endif

namespace ptt_flash {
namespace {

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1));
}

template <int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ IntTiles it;
  constexpr int ldq = D + 1, ldp = kTile + 1, NC = D / 16;
  float* Qs = smem;                   // [64][D + 1]
  float* Ks = Qs + kTile * ldq;       // [64][D + 1]
  float* Vs = Ks + kTile * ldq;       // [64][D]
  float* Ps = Vs + kTile * D;         // [64][65]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = static_cast<const float*>(a.q) + b * a.vq.b + h * a.vq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.vk.b + hk * a.vk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vv.b + hk * a.vv.h;
  const long long bb = kBias ? bias_base(a, b, h) : 0;

  load_tile<D>(qb, a.vq.s, q0, a.Sq, a.D, Qs, ldq);
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;
  int qlo = 0, qhi = 0;
  if (seg) {
    load_seg(a.qseg + static_cast<long long>(b) * a.Sq, q0, a.Sq, it.qids);
    __syncthreads();
    seg_range(it.qids, a.Sq - q0, qlo, qhi);
  }

  float acc[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kend = key_end(q0, a);
  for (int k0 = key_begin(q0, a); k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done with Ks / Vs / Ps / it
    // the same answer in every thread
    if (kInt && int_tile_skip(a, it, seg, fm, b, h, q0, k0, qlo, qhi)) continue;
    load_tile<D>(kb, a.vk.s, k0, a.Sk, a.D, Ks, ldq);
    load_tile<D>(vb, a.vv.s, k0, a.Sk, a.D, Vs, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: a row's 16 owners are one half-warp
    const unsigned kbits = kInt ? int_keep_bits<false, false>(it, seg, fm, q0) : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = visible(q0 + r, k0 + c, a) && (!kInt || (kbits >> (4 * i + j)) & 1u);
        s[i][j] *= a.scale;
        if (kBias && ok[j]) s[i][j] += bias_at(a, bb, q0 + r, k0 + c);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;  // l sums the undropped probabilities
        Ps[r * ldp + tx + 16 * j] =
            !kDrop ? p
                   : (drop_keep(a, b, h, q0 + r, k0 + tx + 16 * j) ? p * a.drop_scale : 0.f);
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* ob = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    // no visible key (or no key tile at all), or every score pushed to
    // -1e30 by a bias (then p = exp(0) makes l > 0)
    const bool dead = l[i] == 0.f || m[i] <= kNegInf * 0.5f;
    const float inv = dead ? 0.f : 1.f / l[i];
    float* orow = ob + ((static_cast<long long>(b) * a.Sq + qpos) * a.H + h) * a.D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < a.D) orow[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qpos] =
          dead ? kNegInf : m[i] + logf(l[i]);
  }
}

// fp32 at D_pad 192 and 256 only (fwd_run hands the other calls to the
// tensor-core kernels)
template <int D, bool kBias, bool kInt, bool kDrop>
int launch(const Args& a, int dtype, cudaStream_t s) {
  static_assert(D > kTf32MaxD, "the TF32 kernel serves fp32 at D_pad <= 128");
  const dim3 grid((a.Sq + kTile - 1) / kTile, a.H, a.B);
  return launch_kernel(flash_fwd_kernel<D, kBias, kInt, kDrop>, fwd_smem<D>(), grid, a, s);
}

// the variants: integer masks (segments and / or flashmask rows) and dropout
template <int D, bool kBias>
int launch_flags(const Args& a, int dtype, cudaStream_t s) {
  const bool ints = a.qseg != nullptr || a.fms != nullptr, drop = a.drop != 0;
  if (ints && drop) return launch<D, kBias, true, true>(a, dtype, s);
  if (ints) return launch<D, kBias, true, false>(a, dtype, s);
  if (drop) return launch<D, kBias, false, true>(a, dtype, s);
  return launch<D, kBias, false, false>(a, dtype, s);
}

}  // namespace

template <int D>
int fwd_run(const Args& a, int dtype, cudaStream_t s) {
  if (dtype != kF32) return fwd_hopper_run<hopper_width(D)>(a, dtype, s);
  if constexpr (D <= kTf32MaxD)
    return fwd_tf32_run<hopper_width(D)>(a, s);
  else
    return a.bias != nullptr ? launch_flags<D, true>(a, dtype, s)
                             : launch_flags<D, false>(a, dtype, s);
}

template int fwd_run<PTT_FLASH_D>(const Args&, int, cudaStream_t);

}  // namespace ptt_flash
