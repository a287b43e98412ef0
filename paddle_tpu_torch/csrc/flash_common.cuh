// Shared pieces of the flash attention kernels (the tensor-core kernels
// through flash_hopper.cuh, and the C entries in flash_attention.cu): the
// kernels' widths and tiles, the argument block, element types and the
// visibility rule.
//
// Layouts. q, k, v and dO arrive as [B, S, H, D] views with element
// strides (batch, seq, head) and a unit stride over D, so the model's
// head-major qkv [B, S, H, 3, D] is read in place with no transpose copy.
// out, dq, dk and dv are written contiguous [B, S, H, D]; lse and delta are
// fp32 [B, H, Sq]; the d-bias, when asked for, fp32 [B, H, Sq, Sk].
//
// Head dims. The family of padded widths D_pad (kDPads) takes any true D
// <= 256 whose row is a whole number of 16-byte words; each kernel is
// compiled once per Hopper width in {64, 128, 192, 256} (hopper_width: D_pad
// 32 and 96 read into 64 and 128), its tiles loaded by TMA with zeros in the
// columns past D, which add nothing to q k^T, and the columns of out, dq, dk
// and dv past D never stored. The wrapper copies a head whose row is not a
// multiple of 16 bytes into a padded buffer first.
//
// Element types. The kernels take bf16 or fp16 (T), or float split into two
// TF32 halves, with fp32 accumulators and softmax either way. The bias is
// read in its own dtype (fp32, bf16 or fp16, a runtime code) and added in
// fp32, as the reference's _mask_scores adds bias.astype(float32).
//
// Masks. Causal masking and the sliding window are one band of key
// offsets from the bottom-right aligned diagonal (Args band_lo / band_hi,
// runtime state: no instance of their own). The integer mask operands,
// segment ids and the flashmask rows, share one template flag (kInt); inside
// its instances each is a runtime pointer tested once a block, and their
// verdict on a thread's score elements is formed once a tile
// (flash_hopper.cuh tile_mask, kt_tile_mask). (Tested element by element,
// the rows' runtime branch slowed the calls with segments alone: the packed
// BERT forward by 8.6 % on the card.)
//
// Instances, each x 8 (bias, integer masks, dropout: template flags): the
// forward, dQ and dK/dV in bf16 and fp16 (wgmma + TMA, 3 kernels x 4 widths:
// 192) and in fp32 on the TF32 tensor cores (3 kernels x 4 widths: 96): 288,
// built as 24 objects in parallel (one a kernel and width; the C entries in
// flash_attention.cu one more).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "philox.cuh"

namespace ptt_flash {

constexpr float kNegInf = -1e30f;
constexpr int kBandInf = 1 << 30;  // a band side with no bound
// the head-dim family (kernels/_build.py FLASH_D_PADS)
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

// The redesigned bf16 / fp16 forward and dQ kernels (wgmma and a TMA ring:
// flash_fwd_hopper.cu, flash_dq_hopper.cu), one object per width in {64,
// 128, 192, 256}; flash_attention.cu (fwd_width, bwd_width) hands them
// every 16-bit call, D_pad 32 and 96 to the next of those widths
// (hopper_width: a TMA box row is 64 columns).
template <int D>
int fwd_hopper_run(const Args& a, int dtype, cudaStream_t stream);
template <int D>
int dq_hopper_run(const Args& a, int dtype, cudaStream_t stream);
// The redesigned bf16 / fp16 dK/dV (flash_dkv_hopper.cu), one object per
// width in {64, 128, 192, 256}; bwd_width hands it every 16-bit call.
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
// flash_dkv_tf32_hopper.cu), one object each in {64, 128, 192, 256}:
// fwd_width / bwd_width hand them every fp32 call (D_pad 32 and 96 read into
// the next width with zero columns). A split fp32 tile takes 8 bytes an
// element, so the widest widths stream tiles of 16 rows, not 32. The
// forward: blocks of 128 query rows (two consumer warpgroups) over key
// tiles of 32 up to D_pad 128 (the raw Q tile and two stages of split tiles
// fill 226 KB), and of 64 rows (one consumer warpgroup, a 64 x D_pad fp32
// output of 96 or 128 registers a thread) over key tiles of 16 at 192 and
// 256 (Q 48 / 64 KB, the landed ring and two split stages of 16 keys: 192 /
// 224 KB). dQ: blocks of 64 query rows over key tiles (tf32_dq_tile,
// tf32_dq_stages); dK/dV: blocks of 64 keys over query tiles (tf32_dkv_tile,
// tf32_dkv_stages); each beside two raw stationary tiles (Q and dO, K and V:
// 64, 96 or 128 KB), the split ring of streamed tiles and the written p / ds
// tiles (208-226 KB).
template <int D>
int fwd_tf32_run(const Args& a, cudaStream_t stream);
template <int D>
int dq_tf32_run(const Args& a, cudaStream_t stream);
template <int D>
int dkv_tf32_run(const Args& a, cudaStream_t stream);
__host__ __device__ constexpr int tf32_fwd_bm(int d_pad) { return d_pad > 128 ? 64 : 128; }
// The key tile of the TF32 kernels that keep P in registers (the fp32
// forward and ragged_paged_attention_tf32_hopper.cu): 32, and 16 past D_pad
// 128, where a split stage of 32 keys (K and V^T, hi and lo) would be 192 /
// 256 KB.
__host__ __device__ constexpr int tf32_key_tile(int d_pad) { return d_pad > 128 ? 16 : 32; }
// The backward's: dQ's query rows and dK/dV's keys a block (64: one wgmma
// M); the rows of the tile each streams, with a split stage of 32 rows (two
// operands, hi and lo) 64, 96 or 128 KB. dQ streams key tiles of 32 in two
// stages up to D_pad 128, in one at 192, and of 16 in one at 256 (Q and dO
// take 128 KB there). At 192 one stage of 32 keys ran dQ 1.25x faster than
// two of 16 (the split of Q's and dO's fragments is paid once a tile). dK/dV
// streams query tiles of 32 in two stages up to 128, of 16 in two at 192
// and in one at 256 (one stage of 32 at 192 spilled: dv^T and dk^T take 96
// registers a thread).
constexpr int kTf32DqBM = 64, kTf32DkvBN = 64;
__host__ __device__ constexpr int tf32_dq_tile(int d_pad) { return d_pad > 192 ? 16 : 32; }
__host__ __device__ constexpr int tf32_dq_stages(int d_pad) { return d_pad > 128 ? 1 : 2; }
__host__ __device__ constexpr int tf32_dkv_tile(int d_pad) { return d_pad > 128 ? 16 : 32; }
__host__ __device__ constexpr int tf32_dkv_stages(int d_pad) { return d_pad > 192 ? 1 : 2; }

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

// Key kpos is visible to query qpos: both in range and kpos inside the band
// around the bottom-right aligned diagonal (kpos <= qpos + Sk - Sq under
// causal masking; kpos >= qpos + Sk - Sq - left and <= ... + right under a
// window), as the reference's _mask_scores masks them.
__device__ __forceinline__ bool visible(int qpos, int kpos, const Args& a) {
  const int d = kpos - qpos - (a.Sk - a.Sq);
  return qpos < a.Sq && kpos < a.Sk && d >= a.band_lo && d <= a.band_hi;
}

// A query tile and a key tile whose id ranges are disjoint have no visible
// pair: skipping the tile is exact (the JAX `_seg_block_overlap`). For
// first-fit packing (ids ascend along a row) it removes about
// 1 - sum(len^2) / S^2 of the tiles.
__device__ __forceinline__ bool seg_overlap(int alo, int ahi, int blo, int bhi) {
  return alo <= bhi && blo <= ahi;
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

}  // namespace ptt_flash
