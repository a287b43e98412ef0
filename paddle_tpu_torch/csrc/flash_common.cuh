// Shared pieces of the flash attention kernels (flash_attention_bwd.cu, the
// tensor-core kernels through flash_hopper.cuh, and the C entries in
// flash_attention.cu): tile
// sizes, the argument block, element types, tile loads and the visibility
// rule.
//
// Layouts. q, k, v and dO arrive as [B, S, H, D] views with element
// strides (batch, seq, head) and a unit stride over D, so the model's
// head-major qkv [B, S, H, 3, D] is read in place with no transpose copy.
// out, dq, dk and dv are written contiguous [B, S, H, D]; lse and delta are
// fp32 [B, H, Sq]; the d-bias, when asked for, fp32 [B, H, Sq, Sk].
//
// Head dims. Each kernel is compiled for a family of padded widths D_pad
// (kDPads) and takes any true D <= D_pad whose row is a whole number of
// 16-byte words: a tile is loaded with zeros in the columns past D, which
// add nothing to q k^T, and the columns of out, dq, dk and dv past D are
// never stored. The wrapper copies a head whose row is not a multiple of 16
// bytes into a padded buffer first.
//
// Element types. The FP32-pipe kernels take float; the tensor-core kernels
// take bf16 or fp16 (T), or float split into two TF32 halves (the forward
// at every width, the backward at D_pad <= 128), with fp32 accumulators and
// softmax either way.
// The bias is read in its own dtype (fp32, bf16 or fp16, a runtime code)
// and added in fp32, as the reference's _mask_scores adds
// bias.astype(float32).
//
// Masks. Causal masking and the sliding window are one band of key
// offsets from the bottom-right aligned diagonal (Args band_lo / band_hi,
// runtime state: no instance of their own). The integer mask operands,
// segment ids and the flashmask rows, share one template flag (kInt); inside
// its instances each is a runtime pointer tested once a block, and their
// verdict on a thread's 16 score elements is formed once a tile
// (int_keep_bits). (Tested element by element, the rows' runtime branch
// slowed the calls with segments alone: the packed BERT forward by 8.6 %
// on the card.)
//
// Instances, each x 8 (bias, integer masks, dropout: template flags): the
// FP32-pipe kernels (dQ and dK/dV at D_pad 192 and 256: 32), the fp32
// forward on the TF32 tensor cores (4 widths: 32) and dQ and dK/dV there (2
// widths: 32), and in bf16 and fp16 the redesigned forward, dQ and dK/dV
// (wgmma + TMA, 3 kernels x 4 widths: 192): 288, built as 32 objects in
// parallel.
//
// Threads. A block of 256 threads works on 64 x 64 tiles as a 16 x 16 grid:
// thread (ty, tx) owns rows ty + 16 i (i < 4) and columns tx + 16 j (j < 4)
// of a score tile, and rows ty + 16 i, columns tx + 16 c (c < D / 16) of an
// output tile, so a row's 16 owners are one half-warp and a row reduction
// is four shuffles. Shared-memory rows that are read by 16 threads at one
// column are padded to D + 1 floats, which puts those reads on 16 banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "philox.cuh"

namespace ptt_flash {

constexpr int kTile = 64;      // queries and keys per tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr float kNegInf = -1e30f;
constexpr int kBandInf = 1 << 30;  // a band side with no bound
// the compiled head-dim family (kernels/_build.py FLASH_D_PADS builds one
// object of each flash source per member)
constexpr int kDPads[] = {32, 64, 96, 128, 192, 256};
constexpr int kMaxD = 256;

struct View {  // element strides of a [B, S, H, D] view, D stride 1
  long long b, s, h;
};

struct BiasView {  // element strides of an additive [B, H, Sq, Sk] bias, any may be 0
  long long b, h, q, k;
};

// element codes of the C entries: q / k / v / dO, and the bias
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  const void* bias;  // additive bias in its own dtype (bias_dtype), or null
  float* dbias;      // dQ kernel: fp32 [B, H, Sq, Sk] dS without the scale, or null
  const int* qseg;   // segment ids, contiguous int32 [B, Sq], or null
  const int* kseg;   // contiguous int32 [B, Sk] (null iff qseg is)
  // flashmask rows: key column j of (batch b, query head h) is masked for
  // queries fms[j] <= q < fme[j] (the raw query index); contiguous int32
  // [B, Hm, Sk] with Hm 1 or H, or null (both or neither)
  const int* fms;
  const int* fme;
  int fm_hs;         // the rows' head stride: 0 (Hm = 1) or Sk (Hm = H)
  View vq, vk, vv, vdo;
  BiasView vb;
  int B, Sq, Sk, H, Hkv;
  int D;           // the true head dim (<= the kernel's D_pad): columns read and stored
  int bias_dtype;  // Dtype of the bias
  float scale;
  // causal masking and the window: key k is visible to query q iff
  // band_lo <= k - q - (Sk - Sq) <= band_hi (+-kBandInf: no bound)
  int band_lo, band_hi;
  // dropout: keep (query i, key j) of (batch b, query head h) iff the Philox
  // word for (b, h, i, j) is >= thresh; kept probabilities are scaled by
  // drop_scale = 1 / (1 - p)
  int drop;
  uint32_t seed0, seed1, thresh;
  float drop_scale;
};

// The backward's width-family entries, one explicit instantiation per D_pad
// in each per-width object (flash_attention_bwd.cu compiled with
// -DPTT_FLASH_D=<D_pad>, -DPTT_FLASH_DQ=1 for dQ and 0 for dK/dV). dtype:
// the element code of q, k, v and dO.
template <int D>
int dq_run(const Args& a, int dtype, cudaStream_t stream);
template <int D>
int dkv_run(const Args& a, int dtype, cudaStream_t stream);
// The redesigned bf16 / fp16 forward and dQ kernels (wgmma and a TMA ring:
// flash_fwd_hopper.cu, flash_dq_hopper.cu), one object per width in {64,
// 128, 192, 256}; fwd_width / dq_run hand them every 16-bit call, D_pad 32
// and 96 to the next of those widths (hopper_width: a TMA box row is 64
// columns).
template <int D>
int fwd_hopper_run(const Args& a, int dtype, cudaStream_t stream);
template <int D>
int dq_hopper_run(const Args& a, int dtype, cudaStream_t stream);
// The redesigned bf16 / fp16 dK/dV (flash_dkv_hopper.cu), one object per
// width in {64, 128, 192, 256}; dkv_run hands it every 16-bit call.
template <int D>
int dkv_hopper_run(const Args& a, int dtype, cudaStream_t stream);
__host__ __device__ constexpr int hopper_width(int d_pad) { return (d_pad + 63) / 64 * 64; }

// Their tiles, here alone (the C entry ptt_flash_plan reports them): blocks
// of 128 query rows; the forward's key tiles of 128, and of 64 beside a bias
// (its loads need registers a 128-key tile's scores and p leave short) or at
// D_pad > 128 (the 64 x D_pad fp32 output takes 96 or 128 registers a
// thread); dQ's of 64, and of 32 at D_pad > 128 (the dq accumulator as wide,
// and Q and dO, 96 or 128 KB, leave shared memory for two stages of K and V
// of 32 keys).
constexpr int kHopperBM = 128;
__host__ __device__ constexpr int fwd_hopper_bn(int d_pad, bool bias) {
  return bias || d_pad > 128 ? 64 : 128;
}
__host__ __device__ constexpr int dq_hopper_bn(int d_pad) { return d_pad > 128 ? 32 : 64; }
// dK/dV's: a block owns 128 keys (two consumer warpgroups of 64 keys each)
// at D_pad <= 128, and 64 keys at 192 and 256 (two warpgroups over the same
// keys, one holding dv and one dk: a 64 x D_pad fp32 accumulator is 96 or
// 128 registers a thread); it streams query tiles of 64 rows.
__host__ __device__ constexpr int dkv_hopper_bn(int d_pad) { return d_pad > 128 ? 64 : 128; }
constexpr int kDkvHopperBM = 64;

// The fp32 forward, dQ and dK/dV on the TF32 tensor cores, each operand
// split in two halves (flash_fwd_tf32_hopper.cu, flash_dq_tf32_hopper.cu,
// flash_dkv_tf32_hopper.cu): fwd_width / dq_run / dkv_run hand them every fp32
// call up to their widest width (D_pad 32 and 96 read into the next width
// with zero columns). A split fp32 tile takes 8 bytes an element. The
// forward takes every width, one object each in {64, 128, 192, 256}: blocks
// of 128 query rows (two consumer warpgroups) over key tiles of 32 up to
// D_pad 128 (the raw Q tile and two stages of split tiles fill 226 KB), and
// of 64 rows (one consumer warpgroup, a 64 x D_pad fp32 output of 96 or 128
// registers a thread) over key tiles of 16 at 192 and 256 (Q 48 / 64 KB,
// the landed ring and two split stages of 16 keys: 192 / 224 KB). dQ and
// dK/dV take D_pad <= 128, one object each in {64, 128}: dQ blocks of 64
// query rows over key tiles of 32, dK/dV blocks of 64 keys over query tiles
// of 32 (their stationary raw tiles, two stages of split tiles and the
// written ds / p tiles fill 209-226 KB). Their D_pad 192 and 256 stay on
// the FP32-pipe kernels of flash_attention_bwd.cu: the same design there
// needs 96 or 128 KB of raw stationary tiles beside 96 or 128 KB a stage.
template <int D>
int fwd_tf32_run(const Args& a, cudaStream_t stream);
template <int D>
int dq_tf32_run(const Args& a, cudaStream_t stream);
template <int D>
int dkv_tf32_run(const Args& a, cudaStream_t stream);
constexpr int kTf32MaxD = 128;  // dQ's and dK/dV's widest D_pad (the forward's: kMaxD)
__host__ __device__ constexpr int tf32_fwd_bm(int d_pad) { return d_pad > 128 ? 64 : 128; }
// The key tile of the TF32 kernels that keep P in registers (the fp32
// forward and ragged_paged_attention_tf32_hopper.cu): 32, and 16 past D_pad
// 128, where a split stage of 32 keys (K and V^T, hi and lo) would be 192 /
// 256 KB.
__host__ __device__ constexpr int tf32_key_tile(int d_pad) { return d_pad > 128 ? 16 : 32; }
constexpr int kTf32DqBM = 64, kTf32DqBN = 32;
constexpr int kTf32DkvBM = 32, kTf32DkvBN = 64;

// ---------------------------------------------------------------------------
// element types
using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ f16 from_f32<f16>(float x) { return __float2half_rn(x); }

// The bias of (batch b, query head h): element offset of its [Sq, Sk] slab.
__device__ __forceinline__ long long bias_base(const Args& a, int b, int h) {
  return b * a.vb.b + h * a.vb.h;
}

// bias[qpos, kpos] of the slab at `base`, read in its own dtype, as fp32.
// Read element by element inside the softmax loop, where the load overlaps
// the rest of the loop's work (a separate pass over the scores tile in
// shared memory, coalesced and with the dtype branched on once a tile,
// measured slower on the card: its loads wait behind one more barrier).
__device__ __forceinline__ float bias_at(const Args& a, long long base, int qpos, int kpos) {
  const long long off = base + qpos * a.vb.q + kpos * a.vb.k;
  switch (a.bias_dtype) {
    case kBF16:
      return __bfloat162float(static_cast<const bf16*>(a.bias)[off]);
    case kF16:
      return __half2float(static_cast<const f16*>(a.bias)[off]);
    default:
      return static_cast<const float*>(a.bias)[off];
  }
}

// Rows row0 .. row0 + 63 of one (batch, head) fp32 slab -> shared memory
// with row stride ld; rows at or past n_rows and columns at or past d are
// zero (a zero V row times p = 0 must not make a NaN). 16-byte loads: d * 4
// and the strides are 16-byte multiples and the base is 16-byte aligned
// (checked by the C entries).
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ base, long long row_stride,
                                          int row0, int n_rows, int d, float* dst, int ld) {
  constexpr int kPerRow = D / 4;
  for (int e = threadIdx.x; e < kTile * kPerRow; e += kThreads) {
    const int r = e / kPerRow, cv = e % kPerRow;
    float* o = dst + r * ld + cv * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows && cv * 4 < d)
      x = __ldg(reinterpret_cast<const float4*>(base + (row0 + r) * row_stride) + cv);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
}

// Key kpos is visible to query qpos: both in range and kpos inside the band
// around the bottom-right aligned diagonal (kpos <= qpos + Sk - Sq under
// causal masking; kpos >= qpos + Sk - Sq - left and <= ... + right under a
// window), as the reference's _mask_scores masks them.
__device__ __forceinline__ bool visible(int qpos, int kpos, const Args& a) {
  const int d = kpos - qpos - (a.Sk - a.Sq);
  return qpos < a.Sq && kpos < a.Sk && d >= a.band_lo && d <= a.band_hi;
}

// Keys [key_begin, key_end) can be visible to queries [q0, q0 + 64): the
// loop bounds that skip the tiles outside the band (_block_run,
// _last_k_block). key_begin is a tile multiple, as the Philox column words
// and the d-bias zeroing count on.
__device__ __forceinline__ int key_begin(int q0, const Args& a) {
  const long long first = static_cast<long long>(q0) + a.Sk - a.Sq + a.band_lo;
  return first <= 0 ? 0 : static_cast<int>(first / kTile) * kTile;
}

__device__ __forceinline__ int key_end(int q0, const Args& a) {
  // one past the tile's last visible key
  const long long last = static_cast<long long>(q0) + kTile + a.Sk - a.Sq + a.band_hi;
  return last <= 0 ? 0 : static_cast<int>(last < a.Sk ? last : a.Sk);
}

// Queries [query_begin, query_end) can see keys [k0, k0 + 64): the dK/dV
// kernel's loop bounds (query_begin a tile multiple).
__device__ __forceinline__ int query_begin(int k0, const Args& a) {
  const long long first = static_cast<long long>(k0) - (a.Sk - a.Sq) - a.band_hi;
  return first <= 0 ? 0 : static_cast<int>(first / kTile) * kTile;
}

__device__ __forceinline__ int query_end(int k0, const Args& a) {
  const long long last = static_cast<long long>(k0) + kTile - (a.Sk - a.Sq) - a.band_lo;
  return last <= 0 ? 0 : static_cast<int>(last < a.Sq ? last : a.Sq);
}

// Segment ids of positions row0 .. row0 + 63 of one batch row -> ids[64] in
// shared memory (positions past n are never compared: visible() checks the
// range first).
__device__ __forceinline__ void load_seg(const int* __restrict__ base, int row0, int n,
                                         int* ids) {
  const int t = threadIdx.x;
  if (t < kTile) ids[t] = row0 + t < n ? base[row0 + t] : 0;
}

// [lo, hi] of the first n ids (n <= 64). Every thread reads the same shared
// ids, so the result is the same across the block.
__device__ __forceinline__ void seg_range(const int* ids, int n, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int r = 0; r < n && r < kTile; ++r) {
    lo = min(lo, ids[r]);
    hi = max(hi, ids[r]);
  }
}

// A query tile and a key tile whose id ranges are disjoint have no visible
// pair: skipping the tile is exact (the JAX `_seg_block_overlap`). For
// first-fit packing (ids ascend along a row) it removes about
// 1 - sum(len^2) / S^2 of the tiles.
__device__ __forceinline__ bool seg_overlap(int alo, int ahi, int blo, int bhi) {
  return alo <= bhi && blo <= ahi;
}

// The integer mask operands of one block in shared memory: the query and key
// tiles' segment ids, and a key tile's flashmask rows with red = {max start
// of warp 0, of warp 1, min end of warp 0, of warp 1}.
struct IntTiles {
  int qids[kTile], kids[kTile];
  int fs[kTile], fe[kTile], red[4];
};

// The flashmask rows of key columns k0 .. k0 + 63 of (batch b, query head h)
// -> t.fs / t.fe, with their max start and min end in t.red (warps 0 and 1
// load and reduce; a __syncthreads() must follow before they are read). A
// key at or past Sk counts as masked for every query: it never keeps a tile
// from being skipped, and visible() drops it.
__device__ __forceinline__ void load_fm(const Args& a, int b, int h, int k0, IntTiles& t) {
  const int i = threadIdx.x;
  if (i >= kTile) return;
  const long long row = (static_cast<long long>(b) * (a.fm_hs ? a.H : 1)) * a.Sk +
                        static_cast<long long>(h) * a.fm_hs + k0 + i;
  const bool in = k0 + i < a.Sk;
  const int s = in ? a.fms[row] : INT_MIN;
  const int e = in ? a.fme[row] : INT_MAX;
  t.fs[i] = s;
  t.fe[i] = e;
  const int mx = __reduce_max_sync(0xffffffffu, s);
  const int mn = __reduce_min_sync(0xffffffffu, e);
  if ((i & 31) == 0) {
    t.red[i >> 5] = mx;
    t.red[2 + (i >> 5)] = mn;
  }
}

// Every key of the loaded tile masks every query of [q0, min(q0 + 64, Sq)):
// no pair survives the rows and skipping the tile is exact (the flashmask
// counterpart of seg_overlap; the reference masks elementwise and runs it).
__device__ __forceinline__ bool fm_tile_masked(const IntTiles& t, int q0, int Sq) {
  const int qn = q0 + kTile < Sq ? q0 + kTile : Sq;
  return max(t.red[0], t.red[1]) <= q0 && min(t.red[2], t.red[3]) >= qn;
}

// The fwd / dQ loops' step into key tile k0 for query tile [q0, q0 + 64) of
// (b, h): load its key ids and flashmask rows, then whether the tile can be
// skipped (segment ranges disjoint, or every pair inside the rows' bands).
// Holds a __syncthreads(); every thread gets the same answer.
__device__ __forceinline__ bool int_tile_skip(const Args& a, IntTiles& t, bool seg, bool fm,
                                              int b, int h, int q0, int k0, int qlo, int qhi) {
  if (seg) load_seg(a.kseg + static_cast<long long>(b) * a.Sk, k0, a.Sk, t.kids);
  if (fm) load_fm(a, b, h, k0, t);
  __syncthreads();
  if (seg) {
    int klo, khi;
    seg_range(t.kids, a.Sk - k0, klo, khi);
    if (!seg_overlap(qlo, qhi, klo, khi)) return true;
  }
  return fm && fm_tile_masked(t, q0, a.Sq);
}

// The Philox words of (batch b, query head h, query row, key columns
// 4 c4 .. 4 c4 + 3): one call, keyed by the seed, with the coordinates as the
// counter, so the mask is a function of (seed, b, h, row, column) alone and
// every kernel regenerates it whatever its tiling.
__device__ __forceinline__ uint4 drop_bits(const Args& a, int b, int h, int row, int c4) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(c4), static_cast<uint32_t>(row),
                                  static_cast<uint32_t>(h), static_cast<uint32_t>(b)),
                       a.seed0, a.seed1);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// Whether (row, col) is kept: the one-element form for the fp32 kernels,
// whose threads own columns 16 apart.
__device__ __forceinline__ bool drop_keep(const Args& a, int b, int h, int row, int col) {
  return word(drop_bits(a, b, h, row, col >> 2), col & 3) >= a.thresh;
}

// The score-tile column of a thread's j-th element (j < 4): tx + 16 j, or,
// for the dropout kernels on the tensor cores, the four adjacent columns
// 4 tx + j that one Philox call covers.
template <bool kQuad>
__device__ __forceinline__ int score_col(int tx, int j) {
  return kQuad ? 4 * tx + j : tx + 16 * j;
}

// The integer masks' verdict on the thread's 4 x 4 elements of a score
// tile, as bits 4 i + j: element (i, j) is row ty + 16 i and column
// score_col<kQuad>(tx, j), the row a query of the loaded query tile and the
// column a key of the key tile (kT: the row a key and the column a query,
// dK/dV's transposed fp32 tile). A pair survives within one segment and with
// its query q0 + row outside the key's flashmask band [start, end).
// Computed once a tile, so the softmax loop tests one bit, and only the
// masks present are read (an absent one passes every pair).
template <bool kT, bool kQuad>
__device__ __forceinline__ unsigned int_keep_bits(const IntTiles& t, bool seg, bool fm, int q0) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  int qr[4], kc[4], qid[4], kid[4], lo[4], hi[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int row = ty + 16 * n, col = score_col<kQuad>(tx, n);
    qr[n] = kT ? col : row;
    kc[n] = kT ? row : col;
    qid[n] = seg ? t.qids[qr[n]] : 0;
    kid[n] = seg ? t.kids[kc[n]] : 0;
    lo[n] = fm ? t.fs[kc[n]] : INT_MAX;
    hi[n] = fm ? t.fe[kc[n]] : INT_MAX;
  }
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = kT ? j : i, b = kT ? i : j;  // the query's and the key's slot
      const int qpos = q0 + qr[a];
      if (qid[a] == kid[b] && (qpos < lo[b] || qpos >= hi[b])) bits |= 1u << (4 * i + j);
    }
  return bits;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Zeros into rows q0 .. q0 + 63 (those < Sq), key columns [c0, c1) of the
// d-bias slab whose row 0 is at element row_base * Sk: the tiles a dQ block
// skips still own their part of the d-bias (the reference's _zero_db).
__device__ __forceinline__ void zero_dbias(const Args& a, long long row_base, int q0, int c0,
                                           int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int e = threadIdx.x; e < kTile * w; e += kThreads) {
    const int r = e / w, c = e % w;
    if (q0 + r < a.Sq) a.dbias[(row_base + q0 + r) * a.Sk + c0 + c] = 0.f;
  }
}

// Raise a kernel's dynamic shared-memory cap once, when it needs more than 48 KB.
template <typename K>
inline cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename K>
int launch_kernel(K* kernel, size_t smem, dim3 grid, const Args& a, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ptt_flash
