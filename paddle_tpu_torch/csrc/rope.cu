// Rotary position embedding (NeoX half-split) for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/pallas/rope.py `_rope_call` (kernel body
// `_rope_kernel`): x [B, S, H, D] = [x1, x2] halves of the head dim,
//
//   y = [x1 * cos - x2 * sin, x2 * cos + x1 * sin]
//
// with fp32 cos and sin [S, D/2], fp32 math and one rounding to x's dtype.
// neg_sin rotates by -sin: the backward (the inverse rotation) is the same
// kernel.
//
// TPU -> Hopper. The Pallas grid walks (batch, sequence block) tiles of
// [bs, H*D] in VMEM. Here one thread owns one vector of pairs: 16 bytes of
// x1 and the matching 16 bytes of x2 (8 pairs in bf16 / fp16, 4 in fp32), read
// once, with 2 N fp32 table entries at [s, i] (a table row is shared by
// every head and batch row, so its re-reads come from L1 and L2), and the
// 2 N outputs written once. Where D/2 is not a multiple of the vector width,
// or a base or stride is not 16-byte aligned, each thread takes one pair.
// x may be strided over B, S and H (the last dim contiguous), as a view of a
// fused projection is; y is contiguous [B, S, H, D].
//
// Bound on an H100 SXM (3.35 TB/s): 6 FLOPs a pair against 8 bytes (bf16 x
// in, y out), so bytes bound it. At the Llama-1.4B step's q [8, 1024, 16,
// 128] bf16 it must move 67.6 MB with the tables, ~0.020 ms; k [8, 1024, 4,
// 128], 17.3 MB, ~0.005 ms.

#include "norm_common.cuh"  // to_f32, from_f32, by_dtype, aligned16

using ptt_norm::aligned16;
using ptt_norm::by_dtype;
using ptt_norm::from_f32;
using ptt_norm::to_f32;

namespace {

constexpr int kThreads = 256;

// N fp32 table entries; 16-byte loads when VEC (then N is a multiple of 4)
template <int N, bool VEC>
__device__ __forceinline__ void load_table(const float* __restrict__ t, float (&out)[N]) {
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(t + k));
      out[k] = f.x;
      out[k + 1] = f.y;
      out[k + 2] = f.z;
      out[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = __ldg(t + k);
  }
}

// N pairs a thread: a 16-byte word of each half when VEC, else one pair
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, T* __restrict__ y, long long items, int S, int H,
            int half, long long sb, long long ss, long long sh, float sgn) {
  constexpr int N = VEC ? 16 / sizeof(T) : 1;
  const long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (t >= items) return;
  const int per_row = half / N;
  const int i0 = static_cast<int>(t % per_row) * N;
  long long r = t / per_row;  // (b, s, h) row
  const int h = static_cast<int>(r % H);
  r /= H;
  const int s = static_cast<int>(r % S);
  const long long b = r / S;
  const T* xr = x + b * sb + s * ss + h * sh;
  T* yr = y + ((b * S + s) * H + h) * (2LL * half);
  float c[N], sn[N];
  load_table<N, VEC>(cos_t + static_cast<long long>(s) * half + i0, c);
  load_table<N, VEC>(sin_t + static_cast<long long>(s) * half + i0, sn);
  alignas(16) T a[N], bb[N], o1[N], o2[N];
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(a) = __ldg(reinterpret_cast<const uint4*>(xr + i0));
    *reinterpret_cast<uint4*>(bb) = __ldg(reinterpret_cast<const uint4*>(xr + half + i0));
  } else {
    a[0] = xr[i0];
    bb[0] = xr[half + i0];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float x1 = to_f32(a[k]), x2 = to_f32(bb[k]);
    const float sk = sgn * sn[k];
    o1[k] = from_f32<T>(x1 * c[k] - x2 * sk);
    o2[k] = from_f32<T>(x2 * c[k] + x1 * sk);
  }
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(yr + i0) = *reinterpret_cast<const uint4*>(o1);
    *reinterpret_cast<uint4*>(yr + half + i0) = *reinterpret_cast<const uint4*>(o2);
  } else {
    yr[i0] = o1[0];
    yr[half + i0] = o2[0];
  }
}

template <typename T>
int launch(const void* x, const void* cos_t, const void* sin_t, void* y, int B, int S, int H,
           int D, long long sb, long long ss, long long sh, float sgn, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const int half = D / 2;
  const bool vec = half % N == 0 && sb % N == 0 && ss % N == 0 && sh % N == 0 &&
                   aligned16(x) && aligned16(y) && aligned16(cos_t) && aligned16(sin_t);
  const long long items = static_cast<long long>(B) * S * H * (vec ? half / N : half);
  const dim3 grid(static_cast<unsigned>((items + kThreads - 1) / kThreads));
  const T* xt = static_cast<const T*>(x);
  const float* ct = static_cast<const float*>(cos_t);
  const float* snt = static_cast<const float*>(sin_t);
  T* yt = static_cast<T*>(y);
  if (vec)
    rope_kernel<T, true><<<grid, kThreads, 0, st>>>(xt, ct, snt, yt, items, S, H, half, sb, ss,
                                                    sh, sgn);
  else
    rope_kernel<T, false><<<grid, kThreads, 0, st>>>(xt, ct, snt, yt, items, S, H, half, sb, ss,
                                                     sh, sgn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [B, S, H, D] in dtype (0 = float32, 1 = bfloat16, 2 = float16), last
// dim contiguous, element strides sb, ss, sh; cos, sin: contiguous fp32
// [S, D/2]; y: contiguous [B, S, H, D] in dtype. neg_sin != 0 rotates by
// -sin. Returns cudaGetLastError() after the launch (0 = success),
// cudaErrorInvalidValue for a dtype it does not take or an odd D.
int ptt_rope(const void* x, const void* cos_t, const void* sin_t, void* y, int B, int S, int H,
             int D, long long sb, long long ss, long long sh, int neg_sin, int dtype,
             void* stream) {
  if (D % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sgn = neg_sin ? -1.f : 1.f;
  return by_dtype(dtype, [&](auto tag) {
    return launch<typename decltype(tag)::type>(x, cos_t, sin_t, y, B, S, H, D, sb, ss, sh, sgn,
                                                st);
  });
}

}  // extern "C"
