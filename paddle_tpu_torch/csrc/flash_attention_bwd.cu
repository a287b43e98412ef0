// Flash attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel of the FlashAttention-2 recurrence, from the forward's saved out and
// logsumexp.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_bwd_impl`: its dQ
// pallas_call (kernel body `_dq_kernel`) and its dK/dV pallas_call (kernel
// body `_dkv_kernel`), on the causal / non-causal, GQA subset. Both kernels
// recompute p = exp(scale * q k^T - lse) tile by tile (zero where masked and
// on rows that saw no key, whose lse is -1e30), dp = dO v^T and
// ds = p (dp - delta) scale with delta = rowsum(dO * O); then dq = ds k,
// dk = ds^T q, dv = p^T dO.
//
// delta. The Pallas kernels each recompute delta in VMEM from the O and dO
// tiles. Here the dQ kernel, which holds a query tile's O and dO anyway,
// computes delta once per query row and writes it to an fp32 [B, H, Sq]
// buffer that the dK/dV kernel, launched after it on the same stream, reads:
// the dK/dV kernel then never loads O.
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
// shape the two kernels do 2.5x the forward's FLOPs between them (dQ three
// products per visible pair, dK/dV four) on ~4x its bytes, so they are
// FLOP-bound near 0.09 ms together. Like the forward, these first kernels
// run their products on the tensor cores through WMMA for bf16 (ds and p
// rounded to bf16 for the products that take them; dq, dk and dv accumulate
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

// dQ (and delta) -----------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1, ldp = kTile + 1, NC = D / 16;
  float* Qs = smem;                // [64][D + 1]
  float* dOs = Qs + kTile * ld;    // [64][D + 1]
  float* Ks = dOs + kTile * ld;    // [64][D + 1]; holds O while delta is formed
  float* Vs = Ks + kTile * ld;     // [64][D + 1]
  float* dSs = Vs + kTile * ld;    // [64][65]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = static_cast<const float*>(a.q) + b * a.vq.b + h * a.vq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.vk.b + hk * a.vk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vv.b + hk * a.vv.h;
  const float* ob = static_cast<const float*>(a.o) + b * a.vo.b + h * a.vo.h;
  const float* dob = static_cast<const float*>(a.dout) + b * a.vdo.b + h * a.vdo.h;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;

  load_tile<D>(qb, a.vq.s, q0, a.Sq, Qs, ld);
  load_tile<D>(dob, a.vdo.s, q0, a.Sq, dOs, ld);
  load_tile<D>(ob, a.vo.s, q0, a.Sq, Ks, ld);
  __syncthreads();

  float delta[4], lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) part = fmaf(dOs[r * ld + tx + 16 * c], Ks[r * ld + tx + 16 * c], part);
    delta[i] = half_warp_sum(part);
    const bool live = q0 + r < a.Sq;
    lse[i] = live ? a.lse[row_base + q0 + r] : kNegInf;
    if (live && tx == 0) a.delta[row_base + q0 + r] = delta[i];
  }

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;

  const int kend = key_end(q0, a);
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // readers of Ks (O at first) / Vs / dSs are done
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
        const float p = (!dead && visible(q0 + r, k0 + c, a))
                            ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        dSs[r * ldp + c] = p * (dp[i][j] - delta[i]) * a.scale;
      }
    }
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
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  extern __shared__ float smem[];
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
      __syncthreads();  // readers of Qs / dOs / Ps / dSs are done (Ks, Vs loaded)
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
          const float p = (!dead && visible(q0 + c, k0 + r, a))
                              ? expf(s[i][j] * a.scale - lse[j]) : 0.f;
          Ps[r * ldp + c] = p;
          dSs[r * ldp + c] = p * (dp[i][j] - delta[j]) * a.scale;
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

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_dq_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  constexpr int ld = tc_ld<D>(), NC = D / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // [64][D + 8]
  bf16* dOs = Qs + kTile * ld;                   // [64][D + 8]
  bf16* Ks = dOs + kTile * ld;                   // [64][D + 8]; holds O while delta is formed
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
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.vo.b + h * a.vo.h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.vdo.b + h * a.vdo.h;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;

  load_tile_bf16<D>(qb, a.vq.s, q0, a.Sq, Qs, ld);
  load_tile_bf16<D>(dob, a.vdo.s, q0, a.Sq, dOs, ld);
  load_tile_bf16<D>(ob, a.vo.s, q0, a.Sq, Ks, ld);
  __syncthreads();

  float delta[4], lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      part = fmaf(__bfloat162float(dOs[r * ld + tx + 16 * c]),
                  __bfloat162float(Ks[r * ld + tx + 16 * c]), part);
    delta[i] = half_warp_sum(part);
    const bool live = q0 + r < a.Sq;
    lse[i] = live ? a.lse[row_base + q0 + r] : kNegInf;
    if (live && tx == 0) a.delta[row_base + q0 + r] = delta[i];
  }

  FragC dq[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) wmma::fill_fragment(dq[j], 0.f);

  const int kend = key_end(q0, a);
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // readers of Ks (O at first) / Vs / dSs are done
    load_tile_bf16<D>(kb, a.vk.s, k0, a.Sk, Ks, ld);
    load_tile_bf16<D>(vb, a.vv.s, k0, a.Sk, Vs, ld);
    __syncthreads();
    mma_abt_64x64<D>(Qs, Ks, Ss);
    mma_abt_64x64<D>(dOs, Vs, dPs);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool dead = lse[i] <= 0.5f * kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (!dead && visible(q0 + r, k0 + c, a))
                            ? expf(Ss[r * kLdS + c] * a.scale - lse[i]) : 0.f;
        dSs[r * kLdP + c] = __float2bfloat16_rn(p * (dPs[r * kLdS + c] - delta[i]) * a.scale);
      }
    }
    __syncthreads();
    mma_ab_64xD<D, wmma::row_major>(dSs, Ks, dq);
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

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_dkv_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
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
      __syncthreads();  // readers of Qs / dOs / Ps / dSs are done (Ks, Vs loaded)
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const bool dead = lse[i] <= 0.5f * kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          p[i][j] = (!dead && visible(q0 + r, k0 + c, a))
                        ? expf(Ss[r * kLdS + c] * a.scale - lse[i]) : 0.f;
          Ps[r * kLdP + c] = __float2bfloat16_rn(p[i][j]);
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
          const int c = tx + 16 * j;
          dSs[r * kLdP + c] =
              __float2bfloat16_rn(p[i][j] * (Ss[r * kLdS + c] - delta[i]) * a.scale);
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

template <int D>
int launch(const Args& a, int dtype, bool is_dq, cudaStream_t s) {
  if (is_dq) {
    const dim3 grid((a.Sq + kTile - 1) / kTile, a.H, a.B);
    return dtype == 0 ? launch_kernel(flash_dq_kernel<D>, dq_smem<D>(), grid, a, s)
                      : launch_kernel(flash_dq_tc_kernel<D>, dq_tc_smem<D>(), grid, a, s);
  }
  const dim3 grid((a.Sk + kTile - 1) / kTile, a.Hkv, a.B);
  return dtype == 0 ? launch_kernel(flash_dkv_kernel<D>, dkv_smem<D>(), grid, a, s)
                    : launch_kernel(flash_dkv_tc_kernel<D>, dkv_tc_smem<D>(), grid, a, s);
}

int dispatch(const Args& a, int D, int dtype, bool is_dq, cudaStream_t s) {
  if (D == 64) return launch<64>(a, dtype, is_dq, s);
  return launch<128>(a, dtype, is_dq, s);
}

// strides: 15 element strides (batch, seq, head) of q, k, v, o and dO
int run(const void* q, const void* k, const void* v, const void* o, const void* dout,
        void* lse, void* delta, void* dq, void* dk, void* dv, const long long* strides, int B,
        int Sq, int Sk, int H, int Hkv, int D, float scale, int causal, int dtype, bool is_dq,
        void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.vq = view_from(strides);
  a.vk = view_from(strides + 3);
  a.vv = view_from(strides + 6);
  a.vo = view_from(strides + 9);
  a.vdo = view_from(strides + 12);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.scale = scale;
  a.causal = causal;
  if ((dtype != 0 && dtype != 1) || !head_dim_ok(D) || Hkv <= 0 || H % Hkv != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(dout) ||
      (is_dq && !aligned(o)) || !aligned(a.vq, itemsize) || !aligned(a.vk, itemsize) ||
      !aligned(a.vv, itemsize) || !aligned(a.vdo, itemsize) ||
      (is_dq && !aligned(a.vo, itemsize)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || (is_dq ? Sq : Sk) == 0) return 0;
  return dispatch(a, D, dtype, is_dq, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace ptt_flash

extern "C" {

// dQ, and delta = rowsum(dO * O) into an fp32 [B, H, Sq] buffer for the dK/dV
// kernel. dq is written contiguous [B, Sq, H, D]. strides: 15 element strides
// (batch, seq, head) of q, k, v, o, dO. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// before any launch for D not in {64, 128}, H not a multiple of H_kv, or
// a base pointer or stride that is not 16-byte aligned.
int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* delta, void* dq,
                     const long long* strides, int B, int Sq, int Sk, int H, int Hkv, int D,
                     float scale, int causal, int dtype, void* stream) {
  return ptt_flash::run(q, k, v, o, dout, const_cast<void*>(lse), delta, dq, nullptr, nullptr,
                        strides, B, Sq, Sk, H, Hkv, D, scale, causal, dtype, true, stream);
}

// dK and dV, contiguous [B, Sk, H_kv, D], from the delta that
// ptt_flash_bwd_dq wrote (launch it first on the same stream). strides as
// for ptt_flash_bwd_dq (the o entries are not read). Same return codes.
int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv,
                      const long long* strides, int B, int Sq, int Sk, int H, int Hkv, int D,
                      float scale, int causal, int dtype, void* stream) {
  return ptt_flash::run(q, k, v, nullptr, dout, const_cast<void*>(lse),
                        const_cast<void*>(delta), nullptr, dk, dv, strides, B, Sq, Sk, H, Hkv,
                        D, scale, causal, dtype, false, stream);
}

}  // extern "C"
