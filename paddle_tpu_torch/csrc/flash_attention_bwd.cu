// Flash attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel of the FlashAttention-2 recurrence, from the forward's saved
// logsumexp.
//
// Replaces paddle_tpu/kernels/pallas/flash_attention.py `_bwd_impl`: its dQ
// pallas_call (kernel body `_dq_kernel`) and its dK/dV pallas_call (kernel
// body `_dkv_kernel`), on all their operands: causal / non-causal, GQA,
// bias, segments, dropout, the flashmask rows and the sliding window. Both
// kernels recompute p = exp(scale * q k^T + bias -
// lse) tile by tile (zero where masked and on rows that saw no key, whose
// lse is -1e30), dp = dO v^T and ds = p (dp - delta) scale with delta =
// rowsum(p * dp); then dq = ds k, dk = ds^T q, dv = p^T dO. Any D up to 256
// and fp32, bf16 or fp16, as the forward (flash_common.cuh); this file is
// compiled twice per D_pad (-DPTT_FLASH_D), once for each kernel, and holds
// the routing of every dtype and width: the FP32-pipe kernels below serve
// fp32 at D_pad 192 and 256 only.
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
// ds in the dq product. The row's ds sum to zero, but rounded to 16 bits one
// by one for the tensor cores they no longer do, by about 2^-9 |ds| sqrt(n)
// in bf16, and dq = ds k again picks that up times the mean key. So the
// 16-bit dQ kernel splits ds into hi = T(ds) and lo = T(ds - hi) and takes
// dq += hi k + lo k: ds to about 2^-17 (bf16) for one more product per key
// tile. (dk = ds^T q needs no split: a key's column of ds does not sum to
// zero, and its rounding error stays 2^-9 of the true dk.)
//
// Additive bias (`_dq_kernel` / `_dkv_kernel` with has_bias): both kernels
// read the [1|B, 1|H, Sq, Sk] bias in place, in its own dtype, with stride 0
// over its broadcast dims, and add it in fp32 to the scaled scores before
// exp(s - lse), as the forward did. A row the bias kills has lse = -1e30
// and gives p = 0. The bias is read by both kernels: twice per backward.
//
// The d-bias (`_dq_kernel` with bias_grad, a runtime pointer here): the dQ
// kernel's second pass writes dS_raw = p (dP - delta), the additive bias's
// gradient (ds without the scale), fp32 [B, H, Sq, Sk], and zeros on the
// tiles it skips (outside the band, disjoint segments, inside the rows'
// bands), as `_zero_db`
// does; the wrapper sums it over the bias's broadcast dims (`_flash_bwd`).
//
// The window and the flashmask rows mask exactly as in the forward
// (`_dkv_kernel` and `_dq_kernel` apply the same _mask_scores): dQ walks the
// band's key tiles (key_begin, key_end) and dK/dV the band's query tiles
// (query_begin, query_end); both skip a tile whose every pair lies inside
// the rows' bands. dK/dV holds one key tile, so it loads that tile's rows
// once (H_mask = 1) or once per query head of its group (H_mask = H: each
// head has its own rows). The rows get no gradient.
//
// The bias, the integer masks (segment ids, flashmask rows) and dropout are
// template flags, as in the forward (the d-bias, the bias's dtype and which
// integer masks are present are runtime branches). A pair is
// visible only within one segment (disjoint tiles skipped), and the keep bit
// of (b, h, i, j) is the forward's Philox word (flash_common.cuh drop_bits),
// regenerated here from the same seed whatever the loop order: dV takes the
// kept, rescaled p; dP is masked and rescaled the same way before
// dS = p (dP - delta) scale, with p undropped and delta = rowsum(p * dP) of
// the masked, rescaled dP (rowsum(dO * O) of the dropped output), as
// `_dq_kernel` and `_dkv_kernel` do. The three combine freely.
//
// TPU -> Hopper. The Pallas dQ grid carries dq across its sequential k axis;
// here one block of 256 threads owns one (query tile of 64, head, batch) and
// loops over the visible key tiles with dq in registers. The Pallas dK/dV
// grid folds (query head of the group, query block) into its innermost axis
// t so that GQA sums accumulate in VMEM; here one block owns one (key tile of
// 64, kv head, batch) and loops over the group's g query heads and their
// visible query tiles itself, with dk and dv in registers: the GQA sum never
// leaves the block, so there are no atomics and the result is deterministic.
// The band's loop bounds skip the tiles past the diagonal and outside the
// window in both kernels.
//
// Shared memory: four [64][D + 1] fp32 tiles do not fit the 227 KB a block
// may hold at D_pad 192 and 256, so these kernels keep one buffer for the
// streamed pair (K then V in dQ, Q then dO in dK/dV) and load K (Q) a second
// time for the last product; their accumulators take one block an SM.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the flagship
// shape the two functions need 2.5x the forward's FLOPs between them (dQ
// three products per visible pair, dK/dV four) on ~4x its bytes, so they
// are FLOP-bound near 0.12 ms together; the dQ kernel does more (five
// products in fp32, six in 16 bits: the delta pass and the lo half of ds).
// Routing (dq_run, dkv_run): bf16 and fp16 go to the wgmma kernels of
// flash_dq_hopper.cu and flash_dkv_hopper.cu at every width; fp32 at D_pad
// <= 128 to the TF32 tensor-core kernels of flash_dq_tf32_hopper.cu and
// flash_dkv_tf32_hopper.cu (each operand split into two TF32 halves, three
// products for each); fp32 at D_pad 192 and 256 to the FP32-pipe kernels
// here, whose products run on the FP32 pipes from padded fp32 tiles. The
// TF32 design does not fit those widths: its raw stationary tiles (Q and dO
// in dQ, K and V in dK/dV) take 96 or 128 KB, and one stage of split
// streamed tiles as much again at 32 rows, beside the written p / ds tiles.

#include "flash_common.cuh"

#if !defined(PTT_FLASH_D) || !defined(PTT_FLASH_DQ)
#error "compile per head-dim family member and kernel: -DPTT_FLASH_D=<D_pad> -DPTT_FLASH_DQ=<1|0>"
#endif

namespace ptt_flash {
namespace {

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * (kTile + 1));
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + 2 * kTile * (kTile + 1));
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

// acc[i][c] += sum_k P[ty + 16 i][k] * X[k][tx + 16 c] over a [64][65] tile P
// and a padded [64][D + 1] tile X
template <int D>
__device__ __forceinline__ void tile_acc(const float* P, const float* X, float (&acc)[4][D / 16]) {
  constexpr int ld = D + 1, ldp = kTile + 1, NC = D / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int kk = 0; kk < kTile; ++kk) {
    float pv[4], xv[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = P[(ty + 16 * i) * ldp + kk];
#pragma unroll
    for (int c = 0; c < NC; ++c) xv[c] = X[kk * ld + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], xv[c], acc[i][c]);
  }
}

// delta[i] = the half-warp's sum of part[i] (row ty + 16 i), written to the
// [B, H, Sq] buffer for the dK/dV kernel.
[[maybe_unused]]
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

// The ends of the d-bias: before the first key tile the dQ block walked and
// past its last, its rows' d-bias is zero.
[[maybe_unused]]
__device__ __forceinline__ void zero_dbias_ends(const Args& a, long long row_base, int q0,
                                                int kbegin, int kend) {
  zero_dbias(a, row_base, q0, 0, kbegin < a.Sk ? kbegin : a.Sk);
  const int walked = ((kend + kTile - 1) / kTile) * kTile;
  zero_dbias(a, row_base, q0, walked < a.Sk ? walked : a.Sk, a.Sk);
}

// dQ (and delta, and the d-bias) ---------------------------------------------
template <int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ IntTiles it;
  // one K / V buffer: K, then V, then K again for ds k
  constexpr int ld = D + 1, ldp = kTile + 1, NC = D / 16;
  float* Qs = smem;               // [64][D + 1]
  float* dOs = Qs + kTile * ld;   // [64][D + 1]
  float* KVs = dOs + kTile * ld;  // [64][D + 1]
  float* dSs = KVs + kTile * ld;  // [64][65]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = static_cast<const float*>(a.q) + b * a.vq.b + h * a.vq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.vk.b + hk * a.vk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vv.b + hk * a.vv.h;
  const float* dob = static_cast<const float*>(a.dout) + b * a.vdo.b + h * a.vdo.h;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const bool want_db = kBias && a.dbias != nullptr;  // the d-bias: a runtime pointer
  const long long bb = kBias ? bias_base(a, b, h) : 0;

  load_tile<D>(qb, a.vq.s, q0, a.Sq, a.D, Qs, ld);
  load_tile<D>(dob, a.vdo.s, q0, a.Sq, a.D, dOs, ld);
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;
  if (seg) load_seg(a.qseg + static_cast<long long>(b) * a.Sq, q0, a.Sq, it.qids);
  __syncthreads();
  int qlo = 0, qhi = 0;
  if (seg) seg_range(it.qids, a.Sq - q0, qlo, qhi);

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
  const int kbegin = key_begin(q0, a), kend = key_end(q0, a);
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = kbegin; k0 < kend; k0 += kTile) {
      __syncthreads();  // readers of KVs / dSs / it are done
      if (kInt && int_tile_skip(a, it, seg, fm, b, h, q0, k0, qlo, qhi)) {
        // the same answer in every thread
        if (pass == 1 && want_db) zero_dbias(a, row_base, q0, k0, min(k0 + kTile, a.Sk));
        continue;
      }
      load_tile<D>(kb, a.vk.s, k0, a.Sk, a.D, KVs, ld);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<D>(Qs, KVs, s);
      __syncthreads();  // every score is read: V overwrites K
      load_tile<D>(vb, a.vv.s, k0, a.Sk, a.D, KVs, ld);
      __syncthreads();
      tile_dot<D>(dOs, KVs, dp);
      const unsigned kbits = kInt ? int_keep_bits<false, false>(it, seg, fm, q0) : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const bool dead = lse[i] <= 0.5f * kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = !dead && visible(q0 + r, k0 + c, a) &&
                          (!kInt || (kbits >> (4 * i + j)) & 1u);
          float sv = s[i][j] * a.scale;
          if (kBias && ok) sv += bias_at(a, bb, q0 + r, k0 + c);
          const float p = ok ? expf(sv - lse[i]) : 0.f;
          float dpv = dp[i][j];
          if (kDrop) dpv = drop_keep(a, b, h, q0 + r, k0 + c) ? dpv * a.drop_scale : 0.f;
          if (pass == 0) {
            part[i] = fmaf(p, dpv, part[i]);
          } else {
            const float dsr = p * (dpv - delta[i]);
            dSs[r * ldp + c] = dsr * a.scale;
            if (want_db && q0 + r < a.Sq && k0 + c < a.Sk)
              a.dbias[(row_base + q0 + r) * a.Sk + k0 + c] = dsr;
          }
        }
      }
      if (pass == 0) continue;
      __syncthreads();
      load_tile<D>(kb, a.vk.s, k0, a.Sk, a.D, KVs, ld);
      __syncthreads();
      tile_acc<D>(dSs, KVs, dq);
    }
    if (pass == 0) write_delta(part, delta, q0, row_base, a);
  }
  if (want_db) zero_dbias_ends(a, row_base, q0, kbegin, kend);

  float* dqb = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    float* row = dqb + ((static_cast<long long>(b) * a.Sq + qpos) * a.H + h) * a.D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < a.D) row[tx + 16 * c] = dq[i][c];
  }
}

// dK / dV --------------------------------------------------------------------
template <int D, bool kBias, bool kInt, bool kDrop>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ IntTiles it;
  // one Q / dO buffer: Q, then dO, then Q again for ds^T q
  constexpr int ld = D + 1, ldp = kTile + 1, NC = D / 16;
  float* Ks = smem;               // [64][D + 1]
  float* Vs = Ks + kTile * ld;    // [64][D + 1]
  float* QOs = Vs + kTile * ld;   // [64][D + 1]
  float* Ps = QOs + kTile * ld;   // [64 keys][65]: p^T
  float* dSs = Ps + kTile * ldp;  // [64 keys][65]: ds^T

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = static_cast<const float*>(a.k) + b * a.vk.b + hk * a.vk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vv.b + hk * a.vv.h;

  load_tile<D>(kb, a.vk.s, k0, a.Sk, a.D, Ks, ld);
  load_tile<D>(vb, a.vv.s, k0, a.Sk, a.D, Vs, ld);
  const bool seg = kInt && a.qseg != nullptr, fm = kInt && a.fms != nullptr;
  int qlo = 0, qhi = 0, klo = 0, khi = 0;
  if (seg) {
    load_seg(a.kseg + static_cast<long long>(b) * a.Sk, k0, a.Sk, it.kids);
    __syncthreads();
    seg_range(it.kids, a.Sk - k0, klo, khi);
  }

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the queries that can see keys k0 .. k0 + 63 (the band)
  const int qt_first = query_begin(k0, a), q_end = query_end(k0, a);
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const float* qb = static_cast<const float*>(a.q) + b * a.vq.b + h * a.vq.h;
    const float* dob = static_cast<const float*>(a.dout) + b * a.vdo.b + h * a.vdo.h;
    const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
    const long long bb = kBias ? bias_base(a, b, h) : 0;
    if (fm && (hh == 0 || a.fm_hs != 0)) {  // this head's rows of the key tile
      __syncthreads();  // the previous head's readers are done with it.fs / fe / red
      load_fm(a, b, h, k0, it);
    }
    for (int q0 = qt_first; q0 < q_end; q0 += kTile) {
      __syncthreads();  // readers of QOs / Ps / dSs / it are done (Ks, Vs, rows loaded)
      if (seg) {
        load_seg(a.qseg + static_cast<long long>(b) * a.Sq, q0, a.Sq, it.qids);
        __syncthreads();
        seg_range(it.qids, a.Sq - q0, qlo, qhi);
        if (!seg_overlap(qlo, qhi, klo, khi)) continue;  // the same answer in every thread
      }
      if (fm && fm_tile_masked(it, q0, a.Sq)) continue;
      load_tile<D>(qb, a.vq.s, q0, a.Sq, a.D, QOs, ld);
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
      tile_dot<D>(Ks, QOs, s);  // s^T: rows keys, columns queries
      __syncthreads();           // every score is read: dO overwrites Q
      load_tile<D>(dob, a.vdo.s, q0, a.Sq, a.D, QOs, ld);
      __syncthreads();
      tile_dot<D>(Vs, QOs, dp);  // dp^T
      const unsigned kbits = kInt ? int_keep_bits<true, false>(it, seg, fm, q0) : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool dead = lse[j] <= 0.5f * kNegInf;
          const bool ok = !dead && visible(q0 + c, k0 + r, a) &&
                          (!kInt || (kbits >> (4 * i + j)) & 1u);
          float sv = s[i][j] * a.scale;
          if (kBias && ok) sv += bias_at(a, bb, q0 + c, k0 + r);
          const float p = ok ? expf(sv - lse[j]) : 0.f;
          const bool keep = !kDrop || drop_keep(a, b, h, q0 + c, k0 + r);
          Ps[r * ldp + c] = keep ? (kDrop ? p * a.drop_scale : p) : 0.f;
          const float dpv = keep ? (kDrop ? dp[i][j] * a.drop_scale : dp[i][j]) : 0.f;
          dSs[r * ldp + c] = p * (dpv - delta[j]) * a.scale;
        }
      }
      __syncthreads();
      tile_acc<D>(Ps, QOs, dv);   // dv += p^T dO
      __syncthreads();            // every dO is read: Q overwrites it
      load_tile<D>(qb, a.vq.s, q0, a.Sq, a.D, QOs, ld);
      __syncthreads();
      tile_acc<D>(dSs, QOs, dk);  // dk += ds^T q
    }
  }

  float* dkb = static_cast<float*>(a.dk);
  float* dvb = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= a.Sk) continue;
    const long long off = ((static_cast<long long>(b) * a.Sk + kpos) * a.Hkv + hk) * a.D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (tx + 16 * c >= a.D) continue;
      dkb[off + tx + 16 * c] = dk[i][c];
      dvb[off + tx + 16 * c] = dv[i][c];
    }
  }
}

// kDq: the dQ kernel, else the dK/dV kernel (one object holds one of them);
// fp32 at D_pad 192 and 256 only
template <bool kDq, int D, bool kBias, bool kInt, bool kDrop>
int launch(const Args& a, cudaStream_t s) {
  static_assert(D > kTf32MaxD, "the TF32 kernels serve fp32 at D_pad <= 128");
  const dim3 grid = kDq ? dim3((a.Sq + kTile - 1) / kTile, a.H, a.B)
                        : dim3((a.Sk + kTile - 1) / kTile, a.Hkv, a.B);
  if constexpr (kDq)
    return launch_kernel(flash_dq_kernel<D, kBias, kInt, kDrop>, dq_smem<D>(), grid, a, s);
  else
    return launch_kernel(flash_dkv_kernel<D, kBias, kInt, kDrop>, dkv_smem<D>(), grid, a, s);
}

// the variants: integer masks (segments and / or flashmask rows) and dropout
template <bool kDq, int D, bool kBias>
int launch_flags(const Args& a, cudaStream_t s) {
  const bool ints = a.qseg != nullptr || a.fms != nullptr, drop = a.drop != 0;
  if (ints && drop) return launch<kDq, D, kBias, true, true>(a, s);
  if (ints) return launch<kDq, D, kBias, true, false>(a, s);
  if (drop) return launch<kDq, D, kBias, false, true>(a, s);
  return launch<kDq, D, kBias, false, false>(a, s);
}

// fp32: the TF32 tensor-core kernels at D_pad <= 128, the FP32-pipe ones
// past it
template <bool kDq, int D>
int bwd_f32(const Args& a, cudaStream_t s) {
  if constexpr (D <= kTf32MaxD && kDq)
    return dq_tf32_run<hopper_width(D)>(a, s);
  else if constexpr (D <= kTf32MaxD)
    return dkv_tf32_run<hopper_width(D)>(a, s);
  else
    return a.bias != nullptr ? launch_flags<kDq, D, true>(a, s)
                             : launch_flags<kDq, D, false>(a, s);
}

}  // namespace

// one object holds the dQ routing of one width (-DPTT_FLASH_DQ=1), another
// its dK/dV routing, so the family builds in parallel
#if PTT_FLASH_DQ
template <int D>
int dq_run(const Args& a, int dtype, cudaStream_t s) {
  if (dtype != kF32) return dq_hopper_run<hopper_width(D)>(a, dtype, s);
  return bwd_f32<true, D>(a, s);
}
template int dq_run<PTT_FLASH_D>(const Args&, int, cudaStream_t);
#else
template <int D>
int dkv_run(const Args& a, int dtype, cudaStream_t s) {
  if (dtype != kF32) return dkv_hopper_run<hopper_width(D)>(a, dtype, s);
  return bwd_f32<false, D>(a, s);
}
template int dkv_run<PTT_FLASH_D>(const Args&, int, cudaStream_t);
#endif

}  // namespace ptt_flash
