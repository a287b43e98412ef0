// One-pass Adam/AdamW leaf update for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/pallas/fused_adam.py `adam_update` (kernel body
// `_kernel`): one pass over a leaf reads p, g, moment1, moment2 (and the fp32
// master when present) and writes p', moment1', moment2' (and master') in
// place, with the fp32 math of optimizer.Adam._adam_core: L2 folded into the
// gradient (Adam) or decoupled decay (AdamW), bias corrections 1 - beta^t
// passed in as fp32 scalars, and an unbiased stochastic rounding of a bf16
// moment2 (optimizer._sr_to_bf16: add 16 random bits below the bf16 cut in
// integer space, then truncate).
//
// Every array has its own float dtype (fp32, bf16 or fp16), as the Pallas
// kernel reads each in its own dtype: p, moment1 and moment2 are template
// parameters (27 instances), g is read in its dtype by a runtime code (the
// branch is the same for every thread) and converted to fp32 on load, so a
// gradient in another dtype than p is never cast on the host.
//
// TPU -> Hopper. The Pallas grid tiles the leaf's native [rows, last] view in
// VMEM and draws its rounding bits from the TPU's in-core PRNG per block. Here
// the leaf is one flat contiguous array; a grid-stride loop hands each thread
// groups of eight contiguous elements, read and written as 16-byte words (one
// for a bf16 or fp16 array, two for an fp32 one), and the eight 16-bit rounding words
// of a group come from ONE Philox4x32-10 call keyed by the wrapper's per-leaf
// seed with the group index as counter: element e takes half e % 8 of the draw
// for group e / 8, on whichever path reads it (an array that is not 16-byte
// aligned, and the tail past the last whole group, go one element per
// thread). It will not give the TPU's bits; the plain version takes its noise
// as a tensor. A leaf that is one rank's shard of a larger leaf (the block
// [start, start + per) of a dim that is full long in the whole leaf, with
// inner elements after it) draws for each element the bits of its index in the
// whole leaf, so a sharded update rounds as the whole leaf's update does: one
// draw still serves eight elements where inner is a multiple of 8, else the
// shard goes one element per thread, each taking its own draw.
//
// Bound on an H100 SXM (3.35 TB/s): the update does ~17 FLOPs and, for the
// bf16 flagship (bf16 p, g, m1, m2), moves 14 bytes per element (4 reads, 3
// writes of 2 bytes), so it is bandwidth-bound with a large margin of ALU
// (Philox is ~2 integer ops per element here). The design reads and writes
// each element exactly once, in full 16-byte words, and does every
// intermediate in registers in fp32, with round-to-nearest intrinsics and no
// FMA contraction, so that with the rounding off it follows the plain PyTorch
// version operation by operation.

#include <stdint.h>

#include "dtypes.cuh"
#include "philox.cuh"

namespace {

using ptt::by_dtype;
using ptt::from_f32;
using ptt::to_f32;

constexpr int kThreads = 256;

struct Scalars {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, l2, dec;
};

// One element's update in fp32; `noise` is the 16-bit rounding word (sr).
template <typename TM2>
__device__ __forceinline__ void adam_element(float pf, float gf, float m1f, float m2f,
                                             const Scalars& s, float& np, float& m1n,
                                             TM2& m2_out, int sr, uint32_t noise) {
  if (s.l2 != 0.f) gf = __fadd_rn(gf, __fmul_rn(s.l2, pf));
  m1n = __fadd_rn(__fmul_rn(s.b1, m1f), __fmul_rn(s.omb1, gf));
  const float m2n = __fadd_rn(__fmul_rn(s.b2, m2f), __fmul_rn(__fmul_rn(s.omb2, gf), gf));
  const float upd =
      __fdiv_rn(__fdiv_rn(m1n, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(m2n, s.c2)), s.eps));
  np = __fsub_rn(pf, __fmul_rn(s.lr, upd));
  if (s.dec != 0.f) np = __fsub_rn(np, __fmul_rn(__fmul_rn(s.lr, s.dec), pf));
  // TM2 is bf16 whenever sr is set (the C entry's rule); the sum's low 16
  // bits are zero, so the conversion is exact
  m2_out = sr ? from_f32<TM2>(__uint_as_float((__float_as_uint(m2n) + noise) & 0xFFFF0000u))
              : from_f32<TM2>(m2n);
}

// the 16-bit rounding word of element e: half e % 8 of group e / 8's draw
__device__ __forceinline__ uint32_t half_word(const uint4& r, int k) {
  const uint32_t w = k < 2 ? r.x : k < 4 ? r.y : k < 6 ? r.z : r.w;
  return (k & 1 ? w >> 16 : w) & 0xFFFFu;
}

__device__ __forceinline__ uint4 group_bits(long long group, uint32_t seed0, uint32_t seed1) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(group),
                                  static_cast<uint32_t>(group >> 32), 0u, 0u),
                       seed0, seed1);
}

// where element e of the leaf lies in the whole leaf it is a shard of
struct Window {
  long long inner, per, full, start;
};

__device__ __forceinline__ long long leaf_index(long long e, const Window& w) {
  if (w.per == w.full) return e;
  const long long row = e / w.inner, k = e - row * w.inner;
  const long long outer = row / w.per, j = row - outer * w.per;
  return (outer * w.full + w.start + j) * w.inner + k;
}

__device__ __forceinline__ uint32_t element_noise(long long e, const Window& w, uint32_t seed0,
                                                  uint32_t seed1) {
  const long long i = leaf_index(e, w);
  return half_word(group_bits(i / 8, seed0, seed1), static_cast<int>(i % 8));
}

template <typename T>
struct alignas(16) Vec8 {
  T v[8];
};

// g's eight elements of group t, or its element e, in fp32 from its dtype code
template <typename T>
__device__ __forceinline__ void g8_as(const void* g, long long t, float (&f)[8]) {
  const Vec8<T> v = reinterpret_cast<const Vec8<T>*>(g)[t];
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = to_f32(v.v[k]);
}

__device__ __forceinline__ void load_g8(const void* g, int code, long long t, float (&f)[8]) {
  if (code == 0)
    g8_as<float>(g, t, f);
  else if (code == 1)
    g8_as<__nv_bfloat16>(g, t, f);
  else
    g8_as<__half>(g, t, f);
}

__device__ __forceinline__ float load_g1(const void* g, int code, long long e) {
  if (code == 0) return static_cast<const float*>(g)[e];
  if (code == 1) return to_f32(static_cast<const __nv_bfloat16*>(g)[e]);
  return to_f32(static_cast<const __half*>(g)[e]);
}

template <typename TP, typename TM1, typename TM2>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(TP* __restrict__ p, const void* __restrict__ g, int g_code,
                  TM1* __restrict__ m1, TM2* __restrict__ m2, float* __restrict__ master,
                  long long n, Scalars s, int sr, uint32_t seed0, uint32_t seed1, Window w,
                  int vec) {
  const long long first = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long groups = vec ? n / 8 : 0;
  for (long long t = first; t < groups; t += stride) {
    // vec holds only where eight aligned elements of the leaf lie at eight
    // aligned ones of the whole leaf: one draw serves the group
    const uint4 bits = sr ? group_bits(leaf_index(t * 8, w) / 8, seed0, seed1)
                          : make_uint4(0u, 0u, 0u, 0u);
    Vec8<TP> pv = reinterpret_cast<const Vec8<TP>*>(p)[t];
    float gv[8];
    load_g8(g, g_code, t, gv);
    Vec8<TM1> m1v = reinterpret_cast<const Vec8<TM1>*>(m1)[t];
    Vec8<TM2> m2v = reinterpret_cast<const Vec8<TM2>*>(m2)[t];
    Vec8<float> mv;
    if (master) mv = reinterpret_cast<const Vec8<float>*>(master)[t];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float pf = master ? mv.v[k] : to_f32(pv.v[k]);
      float np, m1n;
      adam_element<TM2>(pf, gv[k], to_f32(m1v.v[k]), to_f32(m2v.v[k]), s, np, m1n, m2v.v[k],
                        sr, half_word(bits, k));
      pv.v[k] = from_f32<TP>(np);
      m1v.v[k] = from_f32<TM1>(m1n);
      mv.v[k] = np;
    }
    reinterpret_cast<Vec8<TP>*>(p)[t] = pv;
    reinterpret_cast<Vec8<TM1>*>(m1)[t] = m1v;
    reinterpret_cast<Vec8<TM2>*>(m2)[t] = m2v;
    if (master) reinterpret_cast<Vec8<float>*>(master)[t] = mv;
  }
  // the tail past the last whole group, or every element of an unaligned
  // leaf or of a shard whose groups do not lie whole in the whole leaf
  for (long long e = groups * 8 + first; e < n; e += stride) {
    const uint32_t noise = sr ? element_noise(e, w, seed0, seed1) : 0u;
    const float pf = master ? master[e] : to_f32(p[e]);
    float np, m1n;
    adam_element<TM2>(pf, load_g1(g, g_code, e), to_f32(m1[e]), to_f32(m2[e]), s, np, m1n,
                      m2[e], sr, noise);
    p[e] = from_f32<TP>(np);
    m1[e] = from_f32<TM1>(m1n);
    if (master) master[e] = np;
  }
}

template <typename TP, typename TM1, typename TM2>
int launch(void* p, const void* g, int g_code, void* m1, void* m2, void* master, long long n,
           const Scalars& s, int sr, uint32_t seed0, uint32_t seed1, const Window& w,
           int vec, cudaStream_t stream) {
  const long long items = vec ? n / 8 + n % 8 : n;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);  // 16 blocks / SM
  fused_adam_kernel<TP, TM1, TM2><<<blocks, kThreads, 0, stream>>>(
      static_cast<TP*>(p), g, g_code, static_cast<TM1*>(m1), static_cast<TM2*>(m2),
      static_cast<float*>(master), n, s, sr, seed0, seed1, w, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16, one for each of p, g,
// moment1 and moment2; master is null or an fp32 array of n elements. sr = 1
// rounds a bf16 moment2 stochastically (refused for a moment2 of another
// dtype). inner, per, full and start place the leaf in the whole leaf whose
// rounding bits it draws (per == full: the leaf is whole). Returns
// cudaGetLastError() after the launch (0 = success), cudaErrorInvalidValue
// for a combination the kernel does not take.
int ptt_fused_adam(void* p, const void* g, void* m1, void* m2, void* master, long long n,
                   int p_dtype, int g_dtype, int m1_dtype, int m2_dtype, float lr, float c1,
                   float c2, float b1, float omb1, float b2, float omb2, float eps, float l2,
                   float dec, int sr, unsigned int seed0, unsigned int seed1,
                   long long inner, long long per, long long full, long long start,
                   void* stream) {
  if (n <= 0) return 0;
  if ((sr && m2_dtype != 1) || g_dtype < 0 || g_dtype > 2 || inner < 1 || per < 1 ||
      start < 0 || start + per > full || n % (inner * per) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Window w{inner, per, full, start};
  const Scalars s{lr, c1, c2, b1, omb1, b2, omb2, eps, l2, dec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto a16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const int vec = a16(p) && a16(g) && a16(m1) && a16(m2) && (!master || a16(master)) &&
                  (per == full || inner % 8 == 0);
  return by_dtype(p_dtype, [&](auto tp) {
    return by_dtype(m1_dtype, [&](auto t1) {
      return by_dtype(m2_dtype, [&](auto t2) {
        return launch<typename decltype(tp)::type, typename decltype(t1)::type,
                      typename decltype(t2)::type>(p, g, g_dtype, m1, m2, master, n, s, sr,
                                                   seed0, seed1, w, vec, st);
      });
    });
  });
}

}  // extern "C"
