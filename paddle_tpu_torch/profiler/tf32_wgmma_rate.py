"""Clock cycles a TF32 wgmma takes on the card, in the forms the fp32 flash
backward issues them.

    python3 -m paddle_tpu_torch.profiler.tf32_wgmma_rate

The fp32 dQ and dK/dV kernels (``csrc/flash_dq_tf32_hopper.cu``,
``csrc/flash_dkv_tf32_hopper.cu``) take every product as three
``wgmma.m64nNk8.f32.tf32.tf32`` with A from registers: m64n32k8 for S / S^T
and dP / dP^T, m64n64k8 for dk^T and dv^T. This times chains of them, three
a key step into two accumulators as ``gemm_raw`` issues them, by one and by
two warpgroups of a block (the two consumer warpgroups share the SM's
tensor cores), on one SM and on every SM; and m64n32k8 with A from shared
memory beside it. A clock64 span over 2000 steps of 4 key steps each, per
warpgroup; dense TF32 is 1024 FMA a clock an SM, so m64n32k8 takes 16
clocks at the peak and m64n64k8 32. The source is compiled here with the
kernels' header (``csrc/flash_hopper.cuh``) into
``paddle_tpu_torch/_build/tf32_wgmma_rate/``. The last line is JSON with the
card's name and power limit and every reading.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..kernels import _build

_SRC = r'''
#include "flash_hopper.cuh"
using namespace ptt_flash;
using namespace ptt_flash::hopper;

template <int N, bool kSS>
__global__ void rate_kernel(long long* out, int iters) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  float* b = reinterpret_cast<float*>(base);  // [N][32], one panel
  float* a = b + N * 32;                       // [64][32], one panel
  for (int i = threadIdx.x; i < (N + 64) * 32; i += blockDim.x) b[i] = 0.001f * (i % 7);
  __syncthreads();
  fence_proxy_async();
  __syncthreads();
  const uint32_t ar[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
  float d0[N / 2], d1[N / 2];
  for (int i = 0; i < N / 2; ++i) d0[i] = d1[i] = 0.f;
  const uint64_t db = desc_kmajor(smem_u32(b), 0, 0), da = desc_kmajor(smem_u32(a), 0, 0);
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kSS) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
            : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]),
              "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
              "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15])
            : "l"(da), "l"(db), "r"(1));
      } else {
        wgmma_tf32<N>(d0, ar, db, 1);
        wgmma_tf32<N>(d0, ar, db, 1);
        wgmma_tf32<N>(d1, ar, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  reg_fence(d0);
  reg_fence(d1);
  const long long t1 = clock64();
  float sum = 0.f;
  for (int i = 0; i < N / 2; ++i) sum += d0[i] + d1[i];
  if (threadIdx.x % 128 == 0) out[blockIdx.x * 4 + threadIdx.x / 128] = (t1 - t0) + (sum == 12345.f);
}

template <int N, bool kSS>
int run(long long* out, int blocks, int wgs, int iters) {
  const int smem = (N + 64) * 32 * 4 + 1024;
  cudaError_t e = cudaFuncSetAttribute(rate_kernel<N, kSS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rate_kernel<N, kSS><<<blocks, 128 * wgs, smem>>>(out, iters);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int tf32_wgmma_rate(int which, long long* out, int blocks, int wgs, int iters) {
  switch (which) {
    case 0: return run<32, false>(out, blocks, wgs, iters);
    case 1: return run<64, false>(out, blocks, wgs, iters);
    default: return run<32, true>(out, blocks, wgs, iters);
  }
}
'''

# (code, name, wgmma a step of the loop, clocks of one at the peak)
_FORMS = ((0, "m64n32k8, A in registers", 12, 16),
          (1, "m64n64k8, A in registers", 12, 32),
          (2, "m64n32k8, A in shared memory", 4, 16))
_ITERS = 2000


def _library() -> ctypes.CDLL:
    out = _build.BUILD_ROOT / "tf32_wgmma_rate"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "rate.cu", out / "librate.so"
    src.write_text(_SRC)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", str(_build.CSRC), str(src), "-o",
           str(lib)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = _library()
    lib.tf32_wgmma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p] + [
        ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(sms * 4, dtype=torch.int64, device="cuda")
    res = {}
    for code, name, per, peak in _FORMS:
        for wgs in (1, 2):
            for blocks in (1, sms):
                rc = lib.tf32_wgmma_rate(code, out.data_ptr(), blocks, wgs,
                                         _ITERS)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
                clk = out[:blocks * 4].view(blocks, 4)[:, :wgs].double()
                per_wgmma = clk.mean().item() / (_ITERS * per)
                key = f"{name}, {wgs} warpgroup(s), {blocks} block(s)"
                res[key] = per_wgmma
                print(f"{key}: {per_wgmma:.2f} clocks a wgmma of a "
                      f"warpgroup (the peak: {peak * wgs} with {wgs} "
                      f"sharing the tensor cores)  [{card}]", flush=True)
    print(json.dumps({"card": card, "clocks_per_wgmma": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
