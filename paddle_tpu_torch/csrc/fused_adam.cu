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
// TPU -> Hopper. The Pallas grid tiles the leaf's native [rows, last] view in
// VMEM and draws its rounding bits from the TPU's in-core PRNG per block. Here
// the leaf is one flat contiguous array; a grid-stride loop hands each thread
// groups of eight contiguous elements, read and written as 16-byte words (one
// for a bf16 array, two for an fp32 one), and the eight 16-bit rounding words
// of a group come from ONE Philox4x32-10 call keyed by the wrapper's per-leaf
// seed with the group index as counter: element e takes half e % 8 of the draw
// for group e / 8, on whichever path reads it (an array that is not 16-byte
// aligned, and the tail past the last whole group, go one element per
// thread). It will not give the TPU's bits; the plain version takes its noise
// as a tensor.
//
// Bound on an H100 SXM (3.35 TB/s): the update does ~17 FLOPs and, for the
// bf16 flagship (bf16 p, g, m1, m2), moves 14 bytes per element (4 reads, 3
// writes of 2 bytes), so it is bandwidth-bound with a large margin of ALU
// (Philox is ~2 integer ops per element here). The design reads and writes
// each element exactly once, in full 16-byte words, and does every
// intermediate in registers in fp32, with round-to-nearest intrinsics and no
// FMA contraction, so that with the rounding off it follows the plain PyTorch
// version operation by operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Scalars {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, l2, dec;
};

// One element's update in fp32; `noise` is the 16-bit rounding word (sr).
template <typename TM>
__device__ __forceinline__ void adam_element(float pf, float gf, float m1f, float m2f,
                                             const Scalars& s, float& np, float& m1n,
                                             TM& m2_out, int sr, uint32_t noise) {
  if (s.l2 != 0.f) gf = __fadd_rn(gf, __fmul_rn(s.l2, pf));
  m1n = __fadd_rn(__fmul_rn(s.b1, m1f), __fmul_rn(s.omb1, gf));
  const float m2n = __fadd_rn(__fmul_rn(s.b2, m2f), __fmul_rn(__fmul_rn(s.omb2, gf), gf));
  const float upd =
      __fdiv_rn(__fdiv_rn(m1n, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(m2n, s.c2)), s.eps));
  np = __fsub_rn(pf, __fmul_rn(s.lr, upd));
  if (s.dec != 0.f) np = __fsub_rn(np, __fmul_rn(__fmul_rn(s.lr, s.dec), pf));
  // TM is bf16 whenever sr is set (the C entry's rule); the sum's low 16 bits
  // are zero, so the conversion is exact
  m2_out = sr ? from_f32<TM>(__uint_as_float((__float_as_uint(m2n) + noise) & 0xFFFF0000u))
              : from_f32<TM>(m2n);
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

template <typename T>
struct alignas(16) Vec8 {
  T v[8];
};

template <typename TP, typename TM>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(TP* __restrict__ p, const TP* __restrict__ g, TM* __restrict__ m1,
                  TM* __restrict__ m2, float* __restrict__ master, long long n, Scalars s,
                  int sr, uint32_t seed0, uint32_t seed1, int vec) {
  const long long first = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long groups = vec ? n / 8 : 0;
  for (long long t = first; t < groups; t += stride) {
    const uint4 bits = sr ? group_bits(t, seed0, seed1) : make_uint4(0u, 0u, 0u, 0u);
    Vec8<TP> pv = reinterpret_cast<const Vec8<TP>*>(p)[t];
    const Vec8<TP> gv = reinterpret_cast<const Vec8<TP>*>(g)[t];
    Vec8<TM> m1v = reinterpret_cast<const Vec8<TM>*>(m1)[t];
    Vec8<TM> m2v = reinterpret_cast<const Vec8<TM>*>(m2)[t];
    Vec8<float> mv;
    if (master) mv = reinterpret_cast<const Vec8<float>*>(master)[t];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float pf = master ? mv.v[k] : to_f32(pv.v[k]);
      float np, m1n;
      adam_element<TM>(pf, to_f32(gv.v[k]), to_f32(m1v.v[k]), to_f32(m2v.v[k]), s, np, m1n,
                       m2v.v[k], sr, half_word(bits, k));
      pv.v[k] = from_f32<TP>(np);
      m1v.v[k] = from_f32<TM>(m1n);
      mv.v[k] = np;
    }
    reinterpret_cast<Vec8<TP>*>(p)[t] = pv;
    reinterpret_cast<Vec8<TM>*>(m1)[t] = m1v;
    reinterpret_cast<Vec8<TM>*>(m2)[t] = m2v;
    if (master) reinterpret_cast<Vec8<float>*>(master)[t] = mv;
  }
  // the tail past the last whole group, or every element of an unaligned leaf
  for (long long e = groups * 8 + first; e < n; e += stride) {
    const uint32_t noise = sr ? half_word(group_bits(e / 8, seed0, seed1), e % 8) : 0u;
    const float pf = master ? master[e] : to_f32(p[e]);
    float np, m1n;
    adam_element<TM>(pf, to_f32(g[e]), to_f32(m1[e]), to_f32(m2[e]), s, np, m1n, m2[e], sr,
                     noise);
    p[e] = from_f32<TP>(np);
    m1[e] = from_f32<TM>(m1n);
    if (master) master[e] = np;
  }
}

template <typename TP, typename TM>
int launch(void* p, const void* g, void* m1, void* m2, void* master, long long n,
           const Scalars& s, int sr, uint32_t seed0, uint32_t seed1, int vec,
           cudaStream_t stream) {
  const long long items = vec ? n / 8 + n % 8 : n;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);  // 16 blocks / SM
  fused_adam_kernel<TP, TM><<<blocks, kThreads, 0, stream>>>(
      static_cast<TP*>(p), static_cast<const TP*>(g), static_cast<TM*>(m1),
      static_cast<TM*>(m2), static_cast<float*>(master), n, s, sr, seed0, seed1, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. g has p's dtype, moment2 has
// moment1's; master is null or an fp32 array of n elements. sr = 1 rounds a
// bf16 moment2 stochastically (refused for an fp32 moment2). Returns
// cudaGetLastError() after the launch (0 = success), cudaErrorInvalidValue
// for a combination the kernel does not take.
int ptt_fused_adam(void* p, const void* g, void* m1, void* m2, void* master, long long n,
                   int p_dtype, int m_dtype, float lr, float c1, float c2, float b1, float omb1,
                   float b2, float omb2, float eps, float l2, float dec, int sr,
                   unsigned int seed0, unsigned int seed1, void* stream) {
  if (n <= 0) return 0;
  if (sr && m_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s{lr, c1, c2, b1, omb1, b2, omb2, eps, l2, dec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto a16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const int vec = a16(p) && a16(g) && a16(m1) && a16(m2) && (!master || a16(master));
  if (p_dtype == 0 && m_dtype == 0)
    return launch<float, float>(p, g, m1, m2, master, n, s, sr, seed0, seed1, vec, st);
  if (p_dtype == 0 && m_dtype == 1)
    return launch<float, __nv_bfloat16>(p, g, m1, m2, master, n, s, sr, seed0, seed1, vec, st);
  if (p_dtype == 1 && m_dtype == 0)
    return launch<__nv_bfloat16, float>(p, g, m1, m2, master, n, s, sr, seed0, seed1, vec, st);
  if (p_dtype == 1 && m_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, m1, m2, master, n, s, sr, seed0, seed1,
                                                 vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
