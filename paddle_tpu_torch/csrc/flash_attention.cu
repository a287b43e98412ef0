// The C entries of the flash attention kernels: they check what the kernels
// take, fill the argument block and hand each call to a tensor-core kernel
// at the Hopper width that holds D_pad (fwd_width, bwd_width): bf16 / fp16
// to flash_fwd_hopper.cu, flash_dq_hopper.cu and flash_dkv_hopper.cu, fp32
// to flash_fwd_tf32_hopper.cu, flash_dq_tf32_hopper.cu and
// flash_dkv_tf32_hopper.cu. See kernels/flash_attention.py for the Python
// side.
//
// What the forward computes (paddle_tpu/kernels/pallas/flash_attention.py
// `_fwd`, kernel body `_fwd_kernel`): for each (batch, query head) out =
// softmax(scale * q k^T + bias [masked]) v over [B, S, H, D] views, with
// lse = m + log(l) per query row saved for the backward. Causal masking is
// bottom-right aligned (key j visible to query i iff j <= i + Sk - Sq). A
// row that sees no key writes zeros and lse = -1e30, as the Pallas kernel's
// finalize does. GQA reads kv head h / (H / H_kv); K and V are never
// repeated. Any Sq and Sk; any D up to 256 (zero columns past D); fp32,
// bf16 or fp16 in, fp32 scores, softmax and accumulators.
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
// loop runs from the band's first key tile to its last (blk_key_begin,
// blk_key_end),
// as _block_run and _last_k_block skip the blocks outside it.
//
// Flashmask rows (`_fwd_kernel` with has_fm): int32 [B, 1|H, Sk] start and
// end, key j masked for the raw query index start[j] <= i < end[j]. Each key
// tile loads its pairs with their max start and min end, and a tile
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
// What dQ and dK/dV compute (`_bwd_impl`: its dQ pallas_call, kernel body
// `_dq_kernel`, and its dK/dV pallas_call, kernel body `_dkv_kernel`), from
// the forward's saved logsumexp, on all the forward's operands: both kernels
// recompute p = exp(scale * q k^T + bias - lse) tile by tile (zero where
// masked and on rows that saw no key, whose lse is -1e30), dp = dO v^T and
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
// dQ kernels walk their key tiles twice: the first pass sums p * dp in fp32
// from the very p and dp (dropout applied) that the second pass uses, so
// each row's ds sum to zero to fp32 rounding; it writes delta to an fp32
// [B, H, Sq] buffer that the dK/dV kernel, launched after it on the same
// stream, reads. Nothing loads O. The first pass costs a dQ kernel two of
// its three products again.
//
// ds in the dq product. The row's ds sum to zero, but rounded to 16 bits one
// by one for the tensor cores they no longer do, by about 2^-9 |ds| sqrt(n)
// in bf16, and dq = ds k again picks that up times the mean key. So the
// 16-bit dQ kernel splits ds into hi = T(ds) and lo = T(ds - hi) and takes
// dq += hi k + lo k: ds to about 2^-17 (bf16) for one more product per key
// tile (the fp32 kernels split every operand so). (dk = ds^T q needs no
// split: a key's column of ds does not sum to zero, and its rounding error
// stays 2^-9 of the true dk.)
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
// bands), as `_zero_db` does; the wrapper sums it over the bias's broadcast
// dims (`_flash_bwd`).
//
// The window and the flashmask rows mask exactly as in the forward
// (`_dkv_kernel` and `_dq_kernel` apply the same _mask_scores): dQ walks the
// band's key tiles and dK/dV the band's query tiles; both skip a tile whose
// every pair lies inside the rows' bands. dK/dV holds one key block, so it
// reads that block's rows once (H_mask = 1) or once per query head of its
// group (H_mask = H: each head has its own rows). The rows get no gradient.
//
// The bias, the integer masks (segment ids, flashmask rows) and dropout are
// template flags, as in the forward (the d-bias, the bias's dtype and which
// integer masks are present are runtime branches). A pair is visible only
// within one segment (disjoint tiles skipped), and the keep bit of
// (b, h, i, j) is the forward's Philox word (flash_common.cuh drop_bits),
// regenerated here from the same seed whatever the loop order: dV takes the
// kept, rescaled p; dP is masked and rescaled the same way before
// dS = p (dP - delta) scale, with p undropped and delta = rowsum(p * dP) of
// the masked, rescaled dP (rowsum(dO * O) of the dropped output), as
// `_dq_kernel` and `_dkv_kernel` do. The three combine freely.
//
// TPU -> Hopper. The Pallas dQ grid carries dq across its sequential k axis;
// here one block owns one query tile (128 rows in 16 bits, 64 in fp32) of
// one (batch, head) and loops over the visible key tiles with dq in
// registers. The Pallas dK/dV grid folds (query head of the group, query
// block) into its innermost axis t so that GQA sums accumulate in VMEM; here
// one block owns one key block (128 or 64 keys in 16 bits, 64 in fp32) of
// one (kv head, batch) and loops over the group's g query heads and their
// visible query tiles itself, with dk and dv in registers: the GQA sum never
// leaves the block, so there are no atomics and the result is deterministic.
// The band's loop bounds skip the tiles past the diagonal and outside the
// window in both kernels.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 495 TF32, 3.35 TB/s): at the
// flagship shape the two functions need 2.5x the forward's FLOPs between
// them (dQ three products per visible pair, dK/dV four) on ~4x its bytes,
// so they are FLOP-bound; the dQ kernels do more (five products in fp32,
// six in 16 bits: the delta pass and the lo half of ds), and the fp32 ones
// take each product three times.

#include "flash_common.cuh"

namespace ptt_flash {
namespace {

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
bool aligned(const View& v, int itemsize) {
  return (v.b * itemsize) % 16 == 0 && (v.s * itemsize) % 16 == 0 && (v.h * itemsize) % 16 == 0;
}
View view_from(const long long* s) { return View{s[0], s[1], s[2]}; }
bool dtype_ok(int dt) { return dt == kF32 || dt == kBF16 || dt == kF16; }

// the smallest compiled D_pad that holds D, or 0
int d_pad(int D) {
  for (int p : kDPads)
    if (D <= p) return p;
  return 0;
}

template <int W>
int fwd_at(const Args& a, int dtype, cudaStream_t s) {
  return dtype == kF32 ? fwd_tf32_run<W>(a, s) : fwd_hopper_run<W>(a, dtype, s);
}

// D_pad 32 and 96 read into 64 and 128 with zero columns
int fwd_width(const Args& a, int dtype, cudaStream_t s) {
  switch (hopper_width(d_pad(a.D))) {
    case 64: return fwd_at<64>(a, dtype, s);
    case 128: return fwd_at<128>(a, dtype, s);
    case 192: return fwd_at<192>(a, dtype, s);
    case 256: return fwd_at<256>(a, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int W>
int dq_at(const Args& a, int dtype, cudaStream_t s) {
  return dtype == kF32 ? dq_tf32_run<W>(a, s) : dq_hopper_run<W>(a, dtype, s);
}

template <int W>
int dkv_at(const Args& a, int dtype, cudaStream_t s) {
  return dtype == kF32 ? dkv_tf32_run<W>(a, s) : dkv_hopper_run<W>(a, dtype, s);
}

// dQ (is_dq) or dK/dV, at the widths the forward takes
int bwd_width(const Args& a, int dtype, bool is_dq, cudaStream_t s) {
  switch (hopper_width(d_pad(a.D))) {
    case 64: return is_dq ? dq_at<64>(a, dtype, s) : dkv_at<64>(a, dtype, s);
    case 128: return is_dq ? dq_at<128>(a, dtype, s) : dkv_at<128>(a, dtype, s);
    case 192: return is_dq ? dq_at<192>(a, dtype, s) : dkv_at<192>(a, dtype, s);
    case 256: return is_dq ? dq_at<256>(a, dtype, s) : dkv_at<256>(a, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What every entry refuses before a launch: an unknown dtype, D outside
// [1, 256] or whose row is not a whole number of 16-byte words, H not a
// multiple of H_kv, a base pointer or q / k / v (/ dO) stride that is not
// 16-byte aligned, one segment array without the other, one flashmask array
// without the other or a rows' head stride other than 0 and Sk.
bool args_ok(const Args& a, int dtype, bool with_dout) {
  const int itemsize = dtype == kF32 ? 4 : 2;
  if (!dtype_ok(dtype) || a.D <= 0 || a.D > kMaxD || (a.D * itemsize) % 16 != 0 ||
      a.Hkv <= 0 || a.H % a.Hkv != 0 || (a.qseg == nullptr) != (a.kseg == nullptr) ||
      (a.fms == nullptr) != (a.fme == nullptr) || (a.fm_hs != 0 && a.fm_hs != a.Sk))
    return false;
  if (a.bias != nullptr && !dtype_ok(a.bias_dtype)) return false;
  if (!aligned(a.q) || !aligned(a.k) || !aligned(a.v) || !aligned(a.vq, itemsize) ||
      !aligned(a.vk, itemsize) || !aligned(a.vv, itemsize))
    return false;
  return !with_dout || (aligned(a.dout) && aligned(a.vdo, itemsize));
}

// The band of key offsets from the diagonal (Args band_lo / band_hi) that
// causal masking and a window (left, right; -1 for an open side) leave, as
// the reference's _mask_scores masks them: causal caps the right side at 0.
void set_band(Args& a, int causal, int win_left, int win_right) {
  a.band_lo = win_left >= 0 ? -win_left : -kBandInf;
  a.band_hi = win_right >= 0 ? win_right : kBandInf;
  if (causal && a.band_hi > 0) a.band_hi = 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               const void* qseg, const void* kseg, const void* fms, const void* fme,
               const long long* strides, int n_views, int B, int Sq, int Sk, int H, int Hkv,
               int D, float scale, int causal, int drop, unsigned int seed0,
               unsigned int seed1, unsigned int thresh, float drop_scale, int bias_dtype,
               int fm_hs, int win_left, int win_right) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.fms = static_cast<const int*>(fms);
  a.fme = static_cast<const int*>(fme);
  a.fm_hs = fm_hs;
  a.vq = view_from(strides);
  a.vk = view_from(strides + 3);
  a.vv = view_from(strides + 6);
  if (n_views == 4) a.vdo = view_from(strides + 9);
  const long long* bs = strides + 3 * n_views;
  if (bias != nullptr) a.vb = BiasView{bs[0], bs[1], bs[2], bs[3]};
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.bias_dtype = bias_dtype;
  a.scale = scale;
  set_band(a, causal, win_left, win_right);
  a.drop = drop;
  a.seed0 = seed0;
  a.seed1 = seed1;
  a.thresh = thresh;
  a.drop_scale = drop_scale;
  return a;
}

}  // namespace
}  // namespace ptt_flash

extern "C" {

// Forward. strides: 13 element strides: (batch, seq, head) of q, k and v,
// in that order, then the bias's (batch, head, query, key), any of which may
// be 0. bias: an additive [B, H, Sq, Sk] view in bias_dtype, or null for
// none (its strides and dtype are then not read). qseg, kseg: contiguous
// int32 segment ids [B, Sq] and [B, Sk], both or neither. fms, fme: the
// flashmask rows, contiguous int32 [B, Hm, Sk] (key column j masked for
// queries fms[j] <= q < fme[j]), both or neither, with head stride fm_hs
// (0 for Hm = 1, Sk for Hm = H). win_left, win_right: the sliding window
// around the bottom-right aligned diagonal, -1 for an open side. drop = 1: dropout
// with the Philox key (seed0, seed1), keep iff word >= thresh, kept
// probabilities times drop_scale. out is written contiguous [B, Sq, H, D] in
// the input dtype, lse fp32 [B, H, Sq]. dtype, bias_dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. Returns cudaGetLastError() after the launch
// (0 = success), or cudaErrorInvalidValue before any launch for what the
// kernels do not take (args_ok above).
int ptt_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* qseg, const void* kseg, const void* fms, const void* fme,
                  void* out, void* lse, const long long* strides, int B, int Sq, int Sk,
                  int H, int Hkv, int D, float scale, int causal, int drop,
                  unsigned int seed0, unsigned int seed1, unsigned int thresh,
                  float drop_scale, int dtype, int bias_dtype, int fm_hs, int win_left,
                  int win_right, void* stream) {
  using namespace ptt_flash;
  Args a = make_args(q, k, v, bias, qseg, kseg, fms, fme, strides, 3, B, Sq, Sk, H, Hkv, D,
                     scale, causal, drop, seed0, seed1, thresh, drop_scale, bias_dtype, fm_hs,
                     win_left, win_right);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  if (!args_ok(a, dtype, false) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  return fwd_width(a, dtype, static_cast<cudaStream_t>(stream));
}

// dQ, and delta = rowsum(p * dP) into an fp32 [B, H, Sq] buffer for the dK/dV
// kernel. dq is written contiguous [B, Sq, H, D]. strides: 16 element
// strides: (batch, seq, head) of q, k, v, dO, then the bias's four. bias,
// qseg, kseg, fms, fme, drop, seed0, seed1, thresh, drop_scale, bias_dtype,
// fm_hs, win_left and win_right: as the forward took them. dbias: null, or an fp32 [B, H, Sq, Sk] buffer for dS
// without the scale (the additive bias's gradient before its broadcast
// dims are summed; every element is written). Same return codes as
// ptt_flash_fwd.
int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, void* delta, void* dq, const void* bias, void* dbias,
                     const void* qseg, const void* kseg, const void* fms, const void* fme,
                     const long long* strides, int B, int Sq, int Sk, int H, int Hkv, int D,
                     float scale, int causal, int drop, unsigned int seed0,
                     unsigned int seed1, unsigned int thresh, float drop_scale, int dtype,
                     int bias_dtype, int fm_hs, int win_left, int win_right, void* stream) {
  using namespace ptt_flash;
  Args a = make_args(q, k, v, bias, qseg, kseg, fms, fme, strides, 4, B, Sq, Sk, H, Hkv, D,
                     scale, causal, drop, seed0, seed1, thresh, drop_scale, bias_dtype, fm_hs,
                     win_left, win_right);
  a.dout = dout;
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dbias = static_cast<float*>(dbias);
  if (!args_ok(a, dtype, true) || (dbias != nullptr && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  return bwd_width(a, dtype, true, static_cast<cudaStream_t>(stream));
}

// dK and dV, contiguous [B, Sk, H_kv, D], from the delta that
// ptt_flash_bwd_dq wrote (launch it first on the same stream). strides and
// the rest as for ptt_flash_bwd_dq. Same return codes.
int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, const void* bias,
                      const void* qseg, const void* kseg, const void* fms, const void* fme,
                      const long long* strides, int B, int Sq, int Sk, int H, int Hkv, int D,
                      float scale, int causal, int drop, unsigned int seed0,
                      unsigned int seed1, unsigned int thresh, float drop_scale, int dtype,
                      int bias_dtype, int fm_hs, int win_left, int win_right, void* stream) {
  using namespace ptt_flash;
  Args a = make_args(q, k, v, bias, qseg, kseg, fms, fme, strides, 4, B, Sq, Sk, H, Hkv, D,
                     scale, causal, drop, seed0, seed1, thresh, drop_scale, bias_dtype, fm_hs,
                     win_left, win_right);
  a.dout = dout;
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<float*>(const_cast<void*>(delta));
  a.dk = dk;
  a.dv = dv;
  if (!args_ok(a, dtype, true)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sk == 0) return 0;
  return bwd_width(a, dtype, false, static_cast<cudaStream_t>(stream));
}

// What kernel serves a call of head dim D in `dtype` (codes as above), with
// a bias or without, and how it tiles the scores: kernel 0 the forward, 1
// dQ, 2 dK/dV. out[0] its design (0: bf16 / fp16, wgmma with the scores in
// registers and the streamed operands through a TMA ring; 1: fp32 on the
// TF32 tensor cores, wgmma with each operand split into two TF32 halves and
// three products for each, the streamed operands through a TMA ring and
// split in shared memory), out[1] and out[2] the query rows and keys of a
// tile, out[3] 1 where a block owns a key tile and walks the queries
// (dK/dV), else 0. The constants are the ones the kernels are instantiated
// with. Returns 0, or cudaErrorInvalidValue for a kernel, D or dtype no
// kernel takes.
int ptt_flash_plan(int kernel, int D, int dtype, int bias, int* out) {
  using namespace ptt_flash;
  const int p = d_pad(D);
  if (kernel < 0 || kernel > 2 || p == 0 || !dtype_ok(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = hopper_width(p);
  if (dtype == kF32) {
    out[0] = 1;
    out[1] = kernel == 0 ? tf32_fwd_bm(w) : kernel == 1 ? kTf32DqBM : tf32_dkv_tile(w);
    out[2] = kernel == 0 ? tf32_key_tile(w) : kernel == 1 ? tf32_dq_tile(w) : kTf32DkvBN;
  } else if (kernel == 2) {
    out[0] = 0;
    out[1] = kDkvHopperBM;
    out[2] = dkv_hopper_bn(w);
  } else {
    out[0] = 0;
    out[1] = kHopperBM;
    out[2] = kernel == 0 ? fwd_hopper_bn(w, bias != 0) : dq_hopper_bn(w);
  }
  out[3] = kernel == 2 ? 1 : 0;
  return 0;
}

}  // extern "C"
