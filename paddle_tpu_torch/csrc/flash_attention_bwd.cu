// Flash attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel of the FlashAttention-2 recurrence, from the forward's saved
// logsumexp.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_bwd_impl`: its dQ
// pallas_call (kernel body `_dq_kernel`) and its dK/dV pallas_call (kernel
// body `_dkv_kernel`), on the causal / non-causal, GQA subset. Both kernels
// recompute p = exp(scale * q k^T - lse) tile by tile (zero where masked and
// on rows that saw no key, whose lse is -1e30), dp = dO v^T and
// ds = p (dp - delta) scale with delta = rowsum(p * dp); then dq = ds k,
// dk = ds^T q, dv = p^T dO.
//
// delta. In exact arithmetic rowsum(p * dp) = rowsum(dO * O), which the
// Pallas kernels (and FlashAttention-2) form from the saved O and dO tiles.
// From a bf16 O that sum carries an error of about 2^-9 |dO| |O| that the
// row's ds no longer sum to zero by; dq = ds k then picks up that error
// times the row's mean key. Where the tokens' states have converged (the
// keys nearly equal, the true dq tiny: the deep layers of BERT-base at its
// random init) it swamped the gradient: the query / key projection
// gradients of layer 11 came out two orders of magnitude too large. So the
// dQ kernel walks its key tiles twice: the first pass sums p * dp in fp32
// from the very p and dp (dropout applied) that the second pass uses, so
// each row's ds sum to zero to fp32 rounding; it writes delta to an fp32
// [B, H, Sq] buffer that the dK/dV kernel, launched after it on the same
// stream, reads. Nothing loads O. The first pass costs the dQ kernel two of
// its three products again.
//
// ds in the dq product. The row's ds sum to zero, but rounded to bf16 one by
// one for the tensor cores they no longer do, by about 2^-9 |ds| sqrt(n),
// and dq = ds k again picks that up times the mean key. So the bf16 dQ
// kernel splits ds into hi = bf16(ds) and lo = bf16(ds - hi) and takes
// dq += hi k + lo k: ds to about 2^-17 for one more product per key tile.
// (dk = ds^T q needs no split: a key's column of ds does not sum to zero,
// and its rounding error stays 2^-9 of the true dk.)
//
// Segment ids and dropout, template flags as in the forward: a pair is
// visible only within one segment (disjoint tiles skipped), and the keep bit
// of (b, h, i, j) is the forward's Philox word (flash_common.cuh drop_bits),
// regenerated here from the same seed whatever the loop order: dV takes the
// kept, rescaled p; dP is masked and rescaled the same way before
// dS = p (dP - delta) scale, with p undropped and delta = rowsum(p * dP) of
// the masked, rescaled dP (rowsum(dO * O) of the dropped output), as
// `_dq_kernel` and `_dkv_kernel` do.
//
// TPU -> Hopper. The Pallas dQ grid carries dq across its sequential k axis;
// here one block of 256 threads owns one (query tile of 64, head, batch) and
// loops over the visible key tiles with dq in registers. The Pallas dK/dV
// grid folds (query head of the group, query block) into its innermost axis
// t so that GQA sums accumulate in VMEM; here one block owns one (key tile of
// 64, kv head, batch) and loops over the group's g query heads and their
// visible query tiles itself, with dk and dv in registers: the GQA sum never
// leaves the block, so there are no atomics and the result is deterministic.
// Causal loop bounds skip the tiles past the diagonal in both kernels.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the flagship
// shape the two functions need 2.5x the forward's FLOPs between them (dQ
// three products per visible pair, dK/dV four) on ~4x its bytes, so they
// are FLOP-bound near 0.09 ms together; the dQ kernel does more (five
// products in fp32, six in bf16: the delta pass and the lo half of ds).
// Like the forward, these first kernels run their products on the tensor
// cores through WMMA for bf16 (ds and p rounded to bf16 for the products
// that take them, ds as hi + lo for dq; dq, dk and dv accumulate
// in fp32 fragments across the whole loop) and on the FP32 pipes from padded
// fp32 tiles for fp32. Each product round-trips through shared memory and no
// load overlaps the math, so they sit far above that bound; wgmma and a load
// pipeline are the next steps.

#include "flash_common.cuh"

namespace ptt_flash {
namespace {

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1));
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1));
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two padded tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, float acc[4][4]) {
  constexpr int ld = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// delta[i] = the half-warp's sum of part[i] (row ty + 16 i), written to the
// [B, H, Sq] buffer for the dK/dV kernel.
__device__ __forceinline__ void write_delta(const float (&part)[4], float (&delta)[4], int q0,
                                            long long row_base, const Args& a) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    delta[i] = half_warp_sum(part[i]);
    const int qpos = q0 + ty + 16 * i;
    if (qpos < a.Sq && tx == 0) a.delta[row_base + qpos] = delta[i];
  }
}

// dQ (and delta) -----------------------------------------------------------
template <int D, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ int qids[kTile], kids[kTile];
  constexpr int ld = D + 1, ldp = kTile + 1, NC = D / 16;
  float* Qs = smem;                // [64][D + 1]
  float* dOs = Qs + kTile * ld;    // [64][D + 1]
  float* Ks = dOs + kTile * ld;    // [64][D + 1]
  float* Vs = Ks + kTile * ld;     // [64][D + 1]
  float* dSs = Vs + kTile * ld;    // [64][65]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = static_cast<const float*>(a.q) + b * a.vq.b + h * a.vq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.vk.b + hk * a.vk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vv.b + hk * a.vv.h;
  const float* dob = static_cast<const float*>(a.dout) + b * a.vdo.b + h * a.vdo.h;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;

  load_tile<D>(qb, a.vq.s, q0, a.Sq, Qs, ld);
  load_tile<D>(dob, a.vdo.s, q0, a.Sq, dOs, ld);
  if (kSeg) load_seg(a.qseg + static_cast<long long>(b) * a.Sq, q0, a.Sq, qids);
  __syncthreads();
  int qlo = 0, qhi = 0, klo = 0, khi = 0;
  if (kSeg) seg_range(qids, a.Sq - q0, qlo, qhi);

  float delta[4], lse[4], part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    lse[i] = q0 + r < a.Sq ? a.lse[row_base + q0 + r] : kNegInf;
    delta[i] = part[i] = 0.f;
  }

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;

  // pass 0 sums delta = rowsum(p dp); pass 1 forms ds and accumulates dq
  const int kend = key_end(q0, a);
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < kend; k0 += kTile) {
      __syncthreads();  // readers of Ks / Vs / dSs / kids are done
      if (kSeg) {
        load_seg(a.kseg + static_cast<long long>(b) * a.Sk, k0, a.Sk, kids);
        __syncthreads();
        seg_range(kids, a.Sk - k0, klo, khi);
        if (!seg_overlap(qlo, qhi, klo, khi)) continue;  // the same answer in every thread
      }
      load_tile<D>(kb, a.vk.s, k0, a.Sk, Ks, ld);
      load_tile<D>(vb, a.vv.s, k0, a.Sk, Vs, ld);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<D>(Qs, Ks, s);
      tile_dot<D>(dOs, Vs, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const bool dead = lse[i] <= 0.5f * kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = !dead && visible(q0 + r, k0 + c, a) && (!kSeg || qids[r] == kids[c]);
          const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
          float dpv = dp[i][j];
          if (kDrop) dpv = drop_keep(a, b, h, q0 + r, k0 + c) ? dpv * a.drop_scale : 0.f;
          if (pass == 0)
            part[i] = fmaf(p, dpv, part[i]);
          else
            dSs[r * ldp + c] = p * (dpv - delta[i]) * a.scale;
        }
      }
      if (pass == 0) continue;
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < kTile; ++kk) {
        float dsv[4], kv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * ldp + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * ld + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) dq[i][c] = fmaf(dsv[i], kv[c], dq[i][c]);
      }
    }
    if (pass == 0) write_delta(part, delta, q0, row_base, a);
  }

  float* dqb = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    float* row = dqb + ((static_cast<long long>(b) * a.Sq + qpos) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = dq[i][c];
  }
}

// dK / dV --------------------------------------------------------------------
template <int D, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ int qids[kTile], kids[kTile];
  constexpr int ld = D + 1, ldp = kTile + 1, NC = D / 16;
  float* Ks = smem;                // [64][D + 1]
  float* Vs = Ks + kTile * ld;     // [64][D + 1]
  float* Qs = Vs + kTile * ld;     // [64][D + 1]
  float* dOs = Qs + kTile * ld;    // [64][D + 1]
  float* Ps = dOs + kTile * ld;    // [64 keys][65]: p^T
  float* dSs = Ps + kTile * ldp;   // [64 keys][65]: ds^T

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = static_cast<const float*>(a.k) + b * a.vk.b + hk * a.vk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vv.b + hk * a.vv.h;

  load_tile<D>(kb, a.vk.s, k0, a.Sk, Ks, ld);
  load_tile<D>(vb, a.vv.s, k0, a.Sk, Vs, ld);
  int qlo = 0, qhi = 0, klo = 0, khi = 0;
  if (kSeg) {
    load_seg(a.kseg + static_cast<long long>(b) * a.Sk, k0, a.Sk, kids);
    __syncthreads();
    seg_range(kids, a.Sk - k0, klo, khi);
  }

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the first query that can see key k0: q + Sk - Sq >= k0 under causal
  const int q_first = a.causal ? max(0, k0 - (a.Sk - a.Sq)) : 0;
  const int qt_first = (q_first / kTile) * kTile;
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const float* qb = static_cast<const float*>(a.q) + b * a.vq.b + h * a.vq.h;
    const float* dob = static_cast<const float*>(a.dout) + b * a.vdo.b + h * a.vdo.h;
    const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int q0 = qt_first; q0 < a.Sq; q0 += kTile) {
      __syncthreads();  // readers of Qs / dOs / Ps / dSs / qids are done (Ks, Vs loaded)
      if (kSeg) {
        load_seg(a.qseg + static_cast<long long>(b) * a.Sq, q0, a.Sq, qids);
        __syncthreads();
        seg_range(qids, a.Sq - q0, qlo, qhi);
        if (!seg_overlap(qlo, qhi, klo, khi)) continue;  // the same answer in every thread
      }
      load_tile<D>(qb, a.vq.s, q0, a.Sq, Qs, ld);
      load_tile<D>(dob, a.vdo.s, q0, a.Sq, dOs, ld);
      __syncthreads();

      float lse[4], delta[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        const bool live = qpos < a.Sq;
        lse[j] = live ? a.lse[row_base + qpos] : kNegInf;
        delta[j] = live ? a.delta[row_base + qpos] : 0.f;
      }
      float s[4][4], dp[4][4];
      tile_dot<D>(Ks, Qs, s);    // s^T: rows keys, columns queries
      tile_dot<D>(Vs, dOs, dp);  // dp^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool dead = lse[j] <= 0.5f * kNegInf;
          const bool ok =
              !dead && visible(q0 + c, k0 + r, a) && (!kSeg || qids[c] == kids[r]);
          const float p = ok ? expf(s[i][j] * a.scale - lse[j]) : 0.f;
          const bool keep = !kDrop || drop_keep(a, b, h, q0 + c, k0 + r);
          Ps[r * ldp + c] = keep ? (kDrop ? p * a.drop_scale : p) : 0.f;
          const float dpv = keep ? (kDrop ? dp[i][j] * a.drop_scale : dp[i][j]) : 0.f;
          dSs[r * ldp + c] = p * (dpv - delta[j]) * a.scale;
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[4], dsv[4], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * ldp + qq];
          dsv[i] = dSs[(ty + 16 * i) * ldp + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = dOs[qq * ld + tx + 16 * c];
          qv[c] = Qs[qq * ld + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  float* dkb = static_cast<float*>(a.dk);
  float* dvb = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= a.Sk) continue;
    const long long off = ((static_cast<long long>(b) * a.Sk + kpos) * a.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkb[off + tx + 16 * c] = dk[i][c];
      dvb[off + tx + 16 * c] = dv[i][c];
    }
  }
}

// bf16: the same two kernels with their products on the tensor cores --------
template <int D>
constexpr size_t dq_tc_smem() {
  return sizeof(bf16) * (4 * kTile * tc_ld<D>() + kTile * kLdP) +
         sizeof(float) * 2 * kTile * kLdS;
}

template <int D>
constexpr size_t dkv_tc_smem() {
  return sizeof(bf16) * (4 * kTile * tc_ld<D>() + 2 * kTile * kLdP) +
         sizeof(float) * kTile * kLdS;
}

template <int D, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2) flash_dq_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __shared__ int qids[kTile], kids[kTile];
  constexpr int ld = tc_ld<D>(), NC = D / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // [64][D + 8]
  bf16* dOs = Qs + kTile * ld;                   // [64][D + 8]
  bf16* Ks = dOs + kTile * ld;                   // [64][D + 8]
  bf16* Vs = Ks + kTile * ld;                    // [64][D + 8]
  bf16* dSs = Vs + kTile * ld;                   // [64][72]: ds, rounded to bf16
  float* Ss = reinterpret_cast<float*>(dSs + kTile * kLdP);  // [64][68]: scores
  float* dPs = Ss + kTile * kLdS;                // [64][68]: dO v^T

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.vq.b + h * a.vq.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.vk.b + hk * a.vk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vv.b + hk * a.vv.h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.vdo.b + h * a.vdo.h;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;

  load_tile_bf16<D>(qb, a.vq.s, q0, a.Sq, Qs, ld);
  load_tile_bf16<D>(dob, a.vdo.s, q0, a.Sq, dOs, ld);
  if (kSeg) load_seg(a.qseg + static_cast<long long>(b) * a.Sq, q0, a.Sq, qids);
  __syncthreads();
  int qlo = 0, qhi = 0, klo = 0, khi = 0;
  if (kSeg) seg_range(qids, a.Sq - q0, qlo, qhi);

  float delta[4], lse[4], part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    lse[i] = q0 + r < a.Sq ? a.lse[row_base + q0 + r] : kNegInf;
    delta[i] = part[i] = 0.f;
  }

  FragC dq[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) wmma::fill_fragment(dq[j], 0.f);

  // pass 0 sums delta = rowsum(p dp) in fp32; pass 1 forms ds and
  // accumulates dq += hi k + lo k, ds split into two bf16 tiles
  bf16* dSlo = reinterpret_cast<bf16*>(Ss);  // [64][72] over the scores' buffer
  const int kend = key_end(q0, a);
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < kend; k0 += kTile) {
      __syncthreads();  // readers of Ks / Vs / Ss / dPs / dSs / kids are done
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
      mma_abt_64x64<D>(dOs, Vs, dPs);
      __syncthreads();
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const bool dead = lse[i] <= 0.5f * kNegInf;
        const uint4 bits = kDrop ? drop_bits(a, b, h, q0 + r, k0 / 4 + tx) : uint4{};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = score_col<kDrop>(tx, j);
          const bool ok = !dead && visible(q0 + r, k0 + c, a) && (!kSeg || qids[r] == kids[c]);
          const float p = ok ? expf(Ss[r * kLdS + c] * a.scale - lse[i]) : 0.f;
          float dpv = dPs[r * kLdS + c];
          if (kDrop) dpv = word(bits, j) >= a.thresh ? dpv * a.drop_scale : 0.f;
          if (pass == 0)
            part[i] = fmaf(p, dpv, part[i]);
          else
            ds[i][j] = p * (dpv - delta[i]) * a.scale;
        }
      }
      if (pass == 0) continue;
      __syncthreads();  // every score is read: dSlo overwrites Ss
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (ty + 16 * i) * kLdP + score_col<kDrop>(tx, j);
          const bf16 hi = __float2bfloat16_rn(ds[i][j]);
          dSs[at] = hi;
          dSlo[at] = __float2bfloat16_rn(ds[i][j] - __bfloat162float(hi));
        }
      __syncthreads();
      mma_ab_64xD<D, wmma::row_major>(dSs, Ks, dq);
      mma_ab_64xD<D, wmma::row_major>(dSlo, Ks, dq);
    }
    if (pass == 0) write_delta(part, delta, q0, row_base, a);
  }

  __syncthreads();  // every warp is past its last product before Ss / dPs are reused
  float* st = Ss;   // [64][D + 4] fp32 over Ss and dPs
  store_64xD<D>(st, dq);
  __syncthreads();
  bf16* dqb = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    bf16* row = dqb + ((static_cast<long long>(b) * a.Sq + qpos) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      row[tx + 16 * c] = __float2bfloat16_rn(st[(ty + 16 * i) * (D + 4) + tx + 16 * c]);
  }
}

template <int D, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2) flash_dkv_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __shared__ int qids[kTile], kids[kTile];
  constexpr int ld = tc_ld<D>(), NC = D / 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);  // [64][D + 8]
  bf16* Vs = Ks + kTile * ld;                    // [64][D + 8]
  bf16* Qs = Vs + kTile * ld;                    // [64][D + 8]
  bf16* dOs = Qs + kTile * ld;                   // [64][D + 8]
  bf16* Ps = dOs + kTile * ld;                   // [64 queries][72]: p, bf16
  bf16* dSs = Ps + kTile * kLdP;                 // [64 queries][72]: ds, bf16
  float* Ss = reinterpret_cast<float*>(dSs + kTile * kLdP);  // [64][68]: s, then dp

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.vk.b + hk * a.vk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vv.b + hk * a.vv.h;

  load_tile_bf16<D>(kb, a.vk.s, k0, a.Sk, Ks, ld);
  load_tile_bf16<D>(vb, a.vv.s, k0, a.Sk, Vs, ld);
  int qlo = 0, qhi = 0, klo = 0, khi = 0;
  if (kSeg) {
    load_seg(a.kseg + static_cast<long long>(b) * a.Sk, k0, a.Sk, kids);
    __syncthreads();
    seg_range(kids, a.Sk - k0, klo, khi);
  }

  FragC dk[D / 32], dv[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }

  const int q_first = a.causal ? max(0, k0 - (a.Sk - a.Sq)) : 0;
  const int qt_first = (q_first / kTile) * kTile;
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.vq.b + h * a.vq.h;
    const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.vdo.b + h * a.vdo.h;
    const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int q0 = qt_first; q0 < a.Sq; q0 += kTile) {
      __syncthreads();  // readers of Qs / dOs / Ps / dSs / qids are done (Ks, Vs loaded)
      if (kSeg) {
        load_seg(a.qseg + static_cast<long long>(b) * a.Sq, q0, a.Sq, qids);
        __syncthreads();
        seg_range(qids, a.Sq - q0, qlo, qhi);
        if (!seg_overlap(qlo, qhi, klo, khi)) continue;  // the same answer in every thread
      }
      load_tile_bf16<D>(qb, a.vq.s, q0, a.Sq, Qs, ld);
      load_tile_bf16<D>(dob, a.vdo.s, q0, a.Sq, dOs, ld);
      __syncthreads();
      mma_abt_64x64<D>(Qs, Ks, Ss);  // s: rows queries, columns keys

      float lse[4], delta[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty + 16 * i;
        const bool live = qpos < a.Sq;
        lse[i] = live ? a.lse[row_base + qpos] : kNegInf;
        delta[i] = live ? a.delta[row_base + qpos] : 0.f;
      }
      __syncthreads();
      float p[4][4];
      unsigned keep = 0xFFFFu;  // bit 4 i + j: element (i, j) kept
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const bool dead = lse[i] <= 0.5f * kNegInf;
        const uint4 bits = kDrop ? drop_bits(a, b, h, q0 + r, k0 / 4 + tx) : uint4{};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = score_col<kDrop>(tx, j);
          const bool ok =
              !dead && visible(q0 + r, k0 + c, a) && (!kSeg || qids[r] == kids[c]);
          p[i][j] = ok ? expf(Ss[r * kLdS + c] * a.scale - lse[i]) : 0.f;
          float pd = p[i][j];
          if (kDrop) {
            if (word(bits, j) >= a.thresh) {
              pd *= a.drop_scale;
            } else {
              pd = 0.f;
              keep &= ~(1u << (4 * i + j));
            }
          }
          Ps[r * kLdP + c] = __float2bfloat16_rn(pd);  // dv takes the dropped p
        }
      }
      __syncthreads();
      mma_abt_64x64<D>(dOs, Vs, Ss);  // dp over the scores' buffer
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = score_col<kDrop>(tx, j);
          float dpv = Ss[r * kLdS + c];
          if (kDrop) dpv = (keep >> (4 * i + j)) & 1u ? dpv * a.drop_scale : 0.f;
          dSs[r * kLdP + c] = __float2bfloat16_rn(p[i][j] * (dpv - delta[i]) * a.scale);
        }
      }
      __syncthreads();
      mma_ab_64xD<D, wmma::col_major>(Ps, dOs, dv);   // dv += p^T dO
      mma_ab_64xD<D, wmma::col_major>(dSs, Qs, dk);   // dk += ds^T q
    }
  }

  __syncthreads();  // every warp is past its last product before the tiles are reused
  float* dks = reinterpret_cast<float*>(Qs);  // [64][D + 4] fp32 over Qs and dOs
  float* dvs = reinterpret_cast<float*>(Ps);  // [64][D + 4] fp32 over Ps, dSs and Ss
  store_64xD<D>(dks, dk);
  store_64xD<D>(dvs, dv);
  __syncthreads();
  bf16* dkb = static_cast<bf16*>(a.dk);
  bf16* dvb = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, kpos = k0 + r;
    if (kpos >= a.Sk) continue;
    const long long off = ((static_cast<long long>(b) * a.Sk + kpos) * a.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkb[off + tx + 16 * c] = __float2bfloat16_rn(dks[r * (D + 4) + tx + 16 * c]);
      dvb[off + tx + 16 * c] = __float2bfloat16_rn(dvs[r * (D + 4) + tx + 16 * c]);
    }
  }
}

template <typename K>
int launch_kernel(K* kernel, size_t smem, dim3 grid, const Args& a, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kSeg, bool kDrop>
int launch(const Args& a, int dtype, bool is_dq, cudaStream_t s) {
  if (is_dq) {
    const dim3 grid((a.Sq + kTile - 1) / kTile, a.H, a.B);
    return dtype == 0
               ? launch_kernel(flash_dq_kernel<D, kSeg, kDrop>, dq_smem<D>(), grid, a, s)
               : launch_kernel(flash_dq_tc_kernel<D, kSeg, kDrop>, dq_tc_smem<D>(), grid, a, s);
  }
  const dim3 grid((a.Sk + kTile - 1) / kTile, a.Hkv, a.B);
  return dtype == 0
             ? launch_kernel(flash_dkv_kernel<D, kSeg, kDrop>, dkv_smem<D>(), grid, a, s)
             : launch_kernel(flash_dkv_tc_kernel<D, kSeg, kDrop>, dkv_tc_smem<D>(), grid, a, s);
}

template <int D>
int dispatch_flags(const Args& a, int dtype, bool is_dq, cudaStream_t s) {
  const bool seg = a.qseg != nullptr, drop = a.drop != 0;
  if (seg && drop) return launch<D, true, true>(a, dtype, is_dq, s);
  if (seg) return launch<D, true, false>(a, dtype, is_dq, s);
  if (drop) return launch<D, false, true>(a, dtype, is_dq, s);
  return launch<D, false, false>(a, dtype, is_dq, s);
}

int dispatch(const Args& a, int D, int dtype, bool is_dq, cudaStream_t s) {
  if (D == 64) return dispatch_flags<64>(a, dtype, is_dq, s);
  return dispatch_flags<128>(a, dtype, is_dq, s);
}

// strides: 12 element strides (batch, seq, head) of q, k, v and dO
int run(const void* q, const void* k, const void* v, const void* dout, void* lse, void* delta, void* dq, void* dk, void* dv, const void* qseg,
        const void* kseg, const long long* strides, int B, int Sq, int Sk, int H, int Hkv,
        int D, float scale, int causal, int drop, unsigned int seed0, unsigned int seed1,
        unsigned int thresh, float drop_scale, int dtype, bool is_dq, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.drop = drop;
  a.seed0 = seed0;
  a.seed1 = seed1;
  a.thresh = thresh;
  a.drop_scale = drop_scale;
  a.vq = view_from(strides);
  a.vk = view_from(strides + 3);
  a.vv = view_from(strides + 6);
  a.vdo = view_from(strides + 9);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.scale = scale;
  a.causal = causal;
  if ((dtype != 0 && dtype != 1) || !head_dim_ok(D) || Hkv <= 0 || H % Hkv != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(dout) ||
      !aligned(a.vq, itemsize) || !aligned(a.vk, itemsize) || !aligned(a.vv, itemsize) ||
      !aligned(a.vdo, itemsize) || (qseg == nullptr) != (kseg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || (is_dq ? Sq : Sk) == 0) return 0;
  return dispatch(a, D, dtype, is_dq, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace ptt_flash

extern "C" {

// dQ, and delta = rowsum(p * dP) into an fp32 [B, H, Sq] buffer for the dK/dV
// kernel. dq is written contiguous [B, Sq, H, D]. strides: 12 element strides
// (batch, seq, head) of q, k, v, dO. qseg, kseg, drop, seed0, seed1,
// thresh and drop_scale: the forward's segment ids and dropout, as
// ptt_flash_fwd takes them. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue before any
// launch for D not in {64, 128}, H not a multiple of H_kv, a base pointer or
// stride that is not 16-byte aligned, or one segment array without the other.
int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, void* delta, void* dq, const void* qseg, const void* kseg,
                     const long long* strides, int B, int Sq, int Sk, int H, int Hkv, int D,
                     float scale, int causal, int drop, unsigned int seed0, unsigned int seed1,
                     unsigned int thresh, float drop_scale, int dtype, void* stream) {
  return ptt_flash::run(q, k, v, dout, const_cast<void*>(lse), delta, dq, nullptr, nullptr,
                        qseg, kseg, strides, B, Sq, Sk, H, Hkv, D, scale, causal, drop, seed0,
                        seed1, thresh, drop_scale, dtype, true, stream);
}

// dK and dV, contiguous [B, Sk, H_kv, D], from the delta that
// ptt_flash_bwd_dq wrote (launch it first on the same stream). strides as
// for ptt_flash_bwd_dq. Same return codes.
int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, const void* qseg,
                      const void* kseg, const long long* strides, int B, int Sq, int Sk, int H,
                      int Hkv, int D, float scale, int causal, int drop, unsigned int seed0,
                      unsigned int seed1, unsigned int thresh, float drop_scale, int dtype,
                      void* stream) {
  return ptt_flash::run(q, k, v, dout, const_cast<void*>(lse),
                        const_cast<void*>(delta), nullptr, dk, dv, qseg, kseg, strides, B, Sq,
                        Sk, H, Hkv, D, scale, causal, drop, seed0, seed1, thresh, drop_scale,
                        dtype, false, stream);
}

}  // extern "C"
