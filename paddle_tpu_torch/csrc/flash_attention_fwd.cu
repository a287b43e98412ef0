// Flash attention forward for Hopper (sm_90a): out and the row logsumexp.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_fwd` (kernel body
// `_fwd_kernel`) on its causal / non-causal, GQA subset: for each (batch,
// query head) out = softmax(scale * q k^T [masked]) v over [B, S, H, D]
// views, with lse = m + log(l) per query row saved for the backward. Causal
// masking is bottom-right aligned (key j visible to query i iff
// j <= i + Sk - Sq). A row that sees no key writes zeros and lse = -1e30, as
// the Pallas kernel's finalize does. GQA reads kv head h / (H / H_kv); K and
// V are never repeated. Any Sq and Sk; D in {64, 128}; fp32 or bf16 in,
// fp32 scores, softmax and accumulators.
//
// Additive bias (`_fwd_kernel` with has_bias, the two-program serving
// prefill's attention mask): a [B, H, Sq, Sk] view in q's dtype whose four
// strides may be 0 (a [1|B, 1|H, Sq, Sk] mask broadcast in place), added to
// the scaled fp32 scores before the running max, as `_mask_scores` does. The
// mask is arbitrary, so no tile is skipped beyond the causal bound, and a row
// whose every score the bias pushed to -1e30 is dead (m <= -0.5e30): it writes
// zeros and lse = -1e30. The bias is a template flag: the kernels without it
// are the same code as before it existed. At the serving prefill shape (P 8,
// C 128, cap 640, H 16, D 128, bf16, bias [8, 1, 128, 640]) the call must move
// q 4.19 MB, k and v 41.9 MB, the bias 1.31 MB and out 4.19 MB, ~0.0154 ms
// at 3.35 TB/s, against ~0.0054 ms of operations: bytes bound it.
//
// Segment ids (`_fwd_kernel` with has_seg, the packed BERT rows): int32
// [B, Sq] and [B, Sk] read in place, a pair visible iff its two ids are
// equal (pads carry -1, so pads see pads); a key tile whose id range is
// disjoint from the query tile's is skipped, as `_seg_block_overlap` does. A
// row that matches no key is dead: zeros and lse = -1e30.
//
// Dropout (`_fwd_kernel` with dropout_p): the keep bit of (b, h, i, j) is a
// Philox4x32-10 word keyed by the seed with (j / 4, i, h, b) as the counter
// (flash_common.cuh drop_bits), kept iff >= floor(p 2^32); the TPU keys its
// bits by tile, which the backward kernels here, tiled otherwise, could not
// regenerate. lse comes from the undropped scores and the kept probabilities
// are scaled by 1 / (1 - p) before the p v product. On the tensor cores a
// thread then owns four adjacent columns of a score row, one Philox call.
// Segments and dropout are template flags, as the bias is; a bias does not
// combine with either (the C entry refuses it).
//
// TPU -> Hopper. The Pallas grid (B*H, q blocks, k blocks) carries m, l and
// the accumulator across its sequential k axis in VMEM scratch. CUDA blocks
// run in no order, so one block of 256 threads owns one (query tile of 64,
// head, batch) and loops over the key tiles itself, with m and l in
// registers (replicated over the half-warp that owns a row) and the 64 x D
// fp32 accumulator in registers. The causal loop bound (key_end) replaces
// _block_run / _last_k_block: tiles past the diagonal are never loaded.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the flagship
// shape (B 8, S 1024, H 16, D 128, causal, bf16) the call does 4 * D FLOPs
// per visible (query, key) pair, ~34 GFLOP, and must move q, k, v and out
// once, ~134 MB: both bounds sit near 0.04 ms. These first kernels are
// simple and right rather than fast. For bf16 (the training path) both
// products run on the tensor cores through warp-level WMMA (bf16 in, fp32
// accumulate) from bf16 tiles in shared memory; the scores go back to shared
// memory for the fp32 online softmax, and p is rounded to bf16 for the p v
// product, as FlashAttention-2 does. For fp32 the tiles are staged as fp32
// (K and Q rows padded to D + 1 so the 16 readers of a column hit 16 banks)
// and both products run on the FP32 pipes with 4 x 4 register tiles, exact to
// fp32 rounding. Every product round-trips through shared memory and no load
// overlaps the math, so both sit far above the bound: wgmma with the
// accumulator and softmax kept in registers, and a TMA pipeline that loads
// the next key tile during this one's math, are the next steps.

#include "flash_common.cuh"

namespace ptt_flash {
namespace {

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1));
}

// bias[qpos, kpos] of this (batch, head), as fp32
template <typename T>
__device__ __forceinline__ float bias_at(const T* bb, int qpos, int kpos, const Args& a) {
  const T x = bb[qpos * a.vb.q + kpos * a.vb.k];
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(x);
  else
    return x;
}

template <int D, bool kBias, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ int qids[kTile], kids[kTile];
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
  const float* bb = kBias ? static_cast<const float*>(a.bias) + b * a.vb.b + h * a.vb.h : nullptr;

  load_tile<D>(qb, a.vq.s, q0, a.Sq, Qs, ldq);
  int qlo = 0, qhi = 0, klo = 0, khi = 0;
  if (kSeg) {
    load_seg(a.qseg + static_cast<long long>(b) * a.Sq, q0, a.Sq, qids);
    __syncthreads();
    seg_range(qids, a.Sq - q0, qlo, qhi);
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
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done with Ks / Vs / Ps / kids
    if (kSeg) {
      load_seg(a.kseg + static_cast<long long>(b) * a.Sk, k0, a.Sk, kids);
      __syncthreads();
      seg_range(kids, a.Sk - k0, klo, khi);
      if (!seg_overlap(qlo, qhi, klo, khi)) continue;  // the same answer in every thread
    }
    load_tile<D>(kb, a.vk.s, k0, a.Sk, Ks, ldq);
    load_tile<D>(vb, a.vv.s, k0, a.Sk, Vs, D);
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(q0 + r, k0 + tx + 16 * j, a) &&
                (!kSeg || qids[r] == kids[tx + 16 * j]);
        s[i][j] *= a.scale;
        if (kBias && ok[j]) s[i][j] += bias_at(bb, q0 + r, k0 + tx + 16 * j, a);
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
    // no visible key (or no key tile at all); with a bias, also every score
    // pushed to -1e30 (then p = exp(0) makes l > 0)
    const bool dead = l[i] == 0.f || (kBias && m[i] <= kNegInf * 0.5f);
    const float inv = dead ? 0.f : 1.f / l[i];
    float* orow = ob + ((static_cast<long long>(b) * a.Sq + qpos) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qpos] =
          dead ? kNegInf : m[i] + logf(l[i]);
  }
}

// bf16: the same loop with both products on the tensor cores.
template <int D>
constexpr size_t fwd_tc_smem() {
  return sizeof(bf16) * (3 * kTile * tc_ld<D>() + kTile * kLdP) +
         sizeof(float) * (kTile * kLdS + kTile * (D + 4));
}

template <int D, bool kBias, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __shared__ int qids[kTile], kids[kTile];
  constexpr int ld = tc_ld<D>(), ldo = D + 4, NC = D / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);       // [64][D + 8]
  bf16* Ks = Qs + kTile * ld;                         // [64][D + 8]
  bf16* Vs = Ks + kTile * ld;                         // [64][D + 8]
  bf16* Ps = Vs + kTile * ld;                         // [64][72]: p, rounded to bf16
  float* Ss = reinterpret_cast<float*>(Ps + kTile * kLdP);  // [64][68]: scores
  float* Os = Ss + kTile * kLdS;                      // [64][D + 4]: this tile's p v

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.vq.b + h * a.vq.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.vk.b + hk * a.vk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vv.b + hk * a.vv.h;
  const bf16* bb = kBias ? static_cast<const bf16*>(a.bias) + b * a.vb.b + h * a.vb.h : nullptr;

  load_tile_bf16<D>(qb, a.vq.s, q0, a.Sq, Qs, ld);
  int qlo = 0, qhi = 0, klo = 0, khi = 0;
  if (kSeg) {
    load_seg(a.qseg + static_cast<long long>(b) * a.Sq, q0, a.Sq, qids);
    __syncthreads();
    seg_range(qids, a.Sq - q0, qlo, qhi);
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
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done with Ks / Vs / Ps / Os / kids
    if (kSeg) {
      load_seg(a.kseg + static_cast<long long>(b) * a.Sk, k0, a.Sk, kids);
      __syncthreads();
      seg_range(kids, a.Sk - k0, klo, khi);
      if (!seg_overlap(qlo, qhi, klo, khi)) continue;  // the same answer in every thread
    }
    load_tile_bf16<D>(kb, a.vk.s, k0, a.Sk, Ks, ld);
    load_tile_bf16<D>(vb, a.vv.s, k0, a.Sk, Vs, ld);
    __syncthreads();
    mma_abt_64x64<D>(Qs, Ks, Ss);
    __syncthreads();

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool ok[4];
      float s[4], mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = score_col<kDrop>(tx, j);
        ok[j] = visible(q0 + r, k0 + c, a) && (!kSeg || qids[r] == kids[c]);
        s[j] = Ss[r * kLdS + c] * a.scale;
        if (kBias && ok[j]) s[j] += bias_at(bb, q0 + r, k0 + c, a);
        if (ok[j]) mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      alpha[i] = expf(m[i] - m_new);
      // the keep words of this row's four columns 4 tx .. 4 tx + 3
      const uint4 bits = kDrop ? drop_bits(a, b, h, q0 + r, k0 / 4 + tx) : uint4{};
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
        sum += p;  // l sums the undropped probabilities
        const float pd = !kDrop ? p : (word(bits, j) >= a.thresh ? p * a.drop_scale : 0.f);
        Ps[r * kLdP + score_col<kDrop>(tx, j)] = __float2bfloat16_rn(pd);
      }
      l[i] = l[i] * alpha[i] + half_warp_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

    FragC o[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) wmma::fill_fragment(o[j], 0.f);
    mma_ab_64xD<D, wmma::row_major>(Ps, Vs, o);
    store_64xD<D>(Os, o);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[i][c] = acc[i][c] * alpha[i] + Os[(ty + 16 * i) * ldo + tx + 16 * c];
  }

  bf16* ob = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    const bool dead = l[i] == 0.f || (kBias && m[i] <= kNegInf * 0.5f);
    const float inv = dead ? 0.f : 1.f / l[i];
    bf16* orow = ob + ((static_cast<long long>(b) * a.Sq + qpos) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = __float2bfloat16_rn(acc[i][c] * inv);
    if (tx == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qpos] =
          dead ? kNegInf : m[i] + logf(l[i]);
  }
}

template <typename K>
int launch_kernel(K* kernel, size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sq + kTile - 1) / kTile, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBias, bool kSeg, bool kDrop>
int launch(const Args& a, int dtype, cudaStream_t s) {
  return dtype == 0
             ? launch_kernel(flash_fwd_kernel<D, kBias, kSeg, kDrop>, fwd_smem<D>(), a, s)
             : launch_kernel(flash_fwd_tc_kernel<D, kBias, kSeg, kDrop>, fwd_tc_smem<D>(), a, s);
}

// the variants: none, bias, segments, dropout, segments with dropout
template <int D>
int dispatch_flags(const Args& a, int dtype, cudaStream_t s) {
  const bool seg = a.qseg != nullptr, drop = a.drop != 0;
  if (a.bias != nullptr) return launch<D, true, false, false>(a, dtype, s);
  if (seg && drop) return launch<D, false, true, true>(a, dtype, s);
  if (seg) return launch<D, false, true, false>(a, dtype, s);
  if (drop) return launch<D, false, false, true>(a, dtype, s);
  return launch<D, false, false, false>(a, dtype, s);
}

int dispatch_d(const Args& a, int D, int dtype, cudaStream_t s) {
  return D == 64 ? dispatch_flags<64>(a, dtype, s) : dispatch_flags<128>(a, dtype, s);
}

}  // namespace
}  // namespace ptt_flash

extern "C" {

// strides: 13 element strides: (batch, seq, head) of q, k and v, in that
// order, then the bias's (batch, head, query, key), any of which may be 0.
// bias: an additive [B, H, Sq, Sk] view in q's dtype, or null for none (its
// strides are then not read). qseg, kseg: contiguous int32 segment ids
// [B, Sq] and [B, Sk], both or neither. drop = 1: dropout with the Philox key
// (seed0, seed1), keep iff word >= thresh, kept probabilities times
// drop_scale. out is written contiguous [B, Sq, H, D] in the input dtype, lse
// fp32 [B, H, Sq]. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 = success), or cudaErrorInvalidValue
// before any launch for what the kernel does not take: D not in {64, 128}, H
// not a multiple of H_kv, a base pointer or q/k/v stride that is not 16-byte
// aligned, one segment array without the other, a bias with segments or
// dropout.
int ptt_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* qseg, const void* kseg, void* out, void* lse,
                  const long long* strides, int B, int Sq, int Sk, int H, int Hkv, int D,
                  float scale, int causal, int drop, unsigned int seed0, unsigned int seed1,
                  unsigned int thresh, float drop_scale, int dtype, void* stream) {
  using namespace ptt_flash;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const int itemsize = dtype == 0 ? 4 : 2;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.drop = drop;
  a.seed0 = seed0;
  a.seed1 = seed1;
  a.thresh = thresh;
  a.drop_scale = drop_scale;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.vq = view_from(strides);
  a.vk = view_from(strides + 3);
  a.vv = view_from(strides + 6);
  if (bias != nullptr) a.vb = BiasView{strides[9], strides[10], strides[11], strides[12]};
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.scale = scale;
  a.causal = causal;
  if ((dtype != 0 && dtype != 1) || !head_dim_ok(D) || Hkv <= 0 || H % Hkv != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      !aligned(a.vq, itemsize) || !aligned(a.vk, itemsize) || !aligned(a.vv, itemsize) ||
      (qseg == nullptr) != (kseg == nullptr) ||
      (bias != nullptr && (qseg != nullptr || drop != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_d(a, D, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
