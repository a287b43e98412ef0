// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11; the Random123 reference generator), shared by the kernels that
// draw random bits: the fused Adam's stochastic rounding (fused_adam.cu) and
// the flash kernels' attention dropout (the flash forward and backward kernels).
// kernels/flash_attention.py `philox4x32_10` is the same function in plain
// PyTorch; the card tests hold the two bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Counter (c.x, c.y, c.z, c.w), key (k0, k1): ten rounds, the key bumped by
// the Weyl constants after each.
static __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}
