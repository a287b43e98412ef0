// The Hopper pieces of the redesigned 16-bit flash kernels
// (flash_fwd_hopper.cu, the forward; flash_dq_hopper.cu, dQ;
// flash_dkv_hopper.cu, dK/dV) and of the ragged paged-attention kernel
// (ragged_paged_attention_hopper.cu): mbarriers, TMA
// tile loads, wgmma and its shared-memory descriptors, the tensor maps built
// on the host, and the accumulator-fragment coordinates the softmax and the
// masks work on. Inline PTX throughout (no CuTe): each kernel has 16
// instances a width, and CuTe's atoms would multiply their compile time.
//
// Block. 384 threads: warpgroup 0 is the producer (its warp 0 issues every
// load; setmaxnreg gives its registers to the others), warpgroups 1 and 2
// are consumers, 64 query rows each, kBM = 128 rows a block.
//
// Tiles in shared memory. A [rows][D_pad] tile of 16-bit elements is kept
// as D_pad / 64 panels of [rows][64]: a panel row is 128 bytes, written by
// TMA with the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)), which is the canonical SW128 layout wgmma reads. Every panel
// starts on a 1024-byte boundary. The descriptors (desc_kmajor,
// desc_mnmajor) read such a panel K-major (q, k and dO as the A / B of
// q k^T and dO v^T: the head dim is the contraction) or MN-major (v and k
// as the B of p v and ds k: the keys are the contraction, the head dim is
// contiguous, the transposed B that wgmma allows for 16-bit types).
//
// Fragments. The fp32 accumulator of an m64nNk16 wgmma gives thread t of
// the warpgroup (warp w = t / 32, lane l) rows 16 w + l / 4 and that + 8,
// and in each 8-column group j columns 8 j + 2 (l % 4) and + 1: register
// 4 j + 2 i + e holds row 16 w + l / 4 + 8 i, column 8 j + 2 (l % 4) + e.
// A row is spread over the four lanes of a quad (a max or a sum is two
// shuffles), and the registers of key step kk (columns 16 kk .. 16 kk + 15)
// packed two by two are exactly the A fragment of an m64nNk16 wgmma that
// takes A from registers, so p and ds never leave the registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "flash_common.cuh"

namespace ptt_flash {
namespace hopper {

constexpr int kBM = kHopperBM;  // query rows a block (flash_common.cuh)
constexpr int kConsumerWGs = 2;
constexpr int kThreadsH = 128 * (1 + kConsumerWGs);
constexpr int kConsumerWarps = 4 * kConsumerWGs;
constexpr int kProducerRegs = 40;   // setmaxnreg: 40 x 128 + 232 x 256 <= 64 K
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Named barriers 1 and 2 (0 is __syncthreads) order the two consumer
// warpgroups' GEMM issue: a warpgroup waits on its own barrier before it
// issues and then arrives on the other's, so the two take the tensor cores
// in turns and one's softmax runs under the other's products.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N of the latest committed groups are pending (the
// older ones are complete: groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler may
// neither move their uses above the wait nor reuse them before it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A 128-byte-swizzled shared-memory matrix descriptor: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (SW128) in bits
// 62-63. Shared addresses are below 2^18, so the 14-bit address field never
// carries into the offsets.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand (rows x the head dim, contracted over the head dim) of a
// tile at `base` whose panels are `panel` bytes apart: key step kk covers
// head columns 16 kk .. 16 kk + 15, 32 bytes into panel kk / 4; 8-row groups
// are 1024 bytes apart (SBO); LBO is unused for a swizzled K-major operand.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t base, uint32_t panel, int kk) {
  return desc_sw128(base + (kk >> 2) * panel + (kk & 3) * 32, 16, 1024);
}

// MN-major B operand ([keys][head dim] contracted over the keys, the head
// dim contiguous): key step kk covers keys 16 kk .. 16 kk + 15, 2048 bytes
// on; 8-key groups 1024 bytes apart (SBO), 64-column panels `panel` bytes
// apart (LBO).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t base, uint32_t panel, int kk) {
  return desc_sw128(base + kk * 2048, panel, 1024);
}

// m64nNk16, fp32 accumulate, 16-bit A and B. wgmma_ss: A and B K-major in
// shared memory. wgmma_rs: A from registers (the packed fragment), B MN-major
// in shared memory. scale_d = 0 overwrites the accumulator.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d, bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d, f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d, bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d, bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d, bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d, bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d, f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d, f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d, f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d, f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "m64nNk16 for N in {32, 64, 128}");
  if constexpr (N == 32)
    wgmma_ss_n32(d, da, db, scale_d, T{});
  else if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d, T{});
  else
    wgmma_ss_n128(d, da, db, scale_d, T{});
}

template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "m64nNk16 for N in {64, 128}");
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db, scale_d, T{});
  else
    wgmma_rs_n128(d, a, db, scale_d, T{});
}

// Columns [C, C + N) of a fragment of D columns: its registers C / 2 ..
// (C + N) / 2 - 1 (register 4 j + 2 i + e holds column 8 j + ...).
template <int N, int C, int D>
__device__ __forceinline__ float (&frag_cols(float (&d)[D / 2]))[N / 2] {
  return *reinterpret_cast<float(*)[N / 2]>(d + C / 2);
}

// d (64 x D, fp32) += a (the register A fragment of key step kk) times the
// MN-major B of key step kk in the tile at `base` (64-column panels `panel`
// bytes apart): one wgmma for D <= 128, else one a 128 columns (two panels)
// and one for the rest, which start `2 panel` bytes on.
template <int D, typename T, int C = 0>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[D / 2], const uint32_t (&a)[4],
                                              uint32_t base, uint32_t panel, int kk) {
  constexpr int N = D - C < 128 ? D - C : 128;
  wgmma_rs<N, T>(frag_cols<N, C, D>(d), a, desc_mnmajor(base + (C / 64) * panel, panel, kk), 1);
  if constexpr (C + N < D) wgmma_rs_cols<D, T, C + N>(d, a, base, panel, kk);
}

// two fp32 values -> one register of two T (the lower column in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the two values of a packed register back in fp32
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v);
template <>
__device__ __forceinline__ float2 unpack2<bf16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
template <>
__device__ __forceinline__ float2 unpack2<f16>(uint32_t v) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// The block's plan. The blocks run over groups of kGroupHB (batch, head)
// pairs; inside a group the last query tiles, the longest under causal
// masking, go first (the tail of the grid is short work), and the blocks in
// flight share their pairs' K and V tiles in L2 (16 pairs of a GPT-sized
// call hold ~8 MB of K and V; ordered the other way round, each query tile
// over every pair, nothing was reused and the K / V reads went to HBM each
// wave). Heads of one batch are adjacent, so GQA's heads that read one kv
// head run together.
constexpr int kGroupHB = 16;

struct BlockPos {
  int q0, h, b;
};

__device__ __forceinline__ BlockPos block_pos(const Args& a, int idx) {
  const int nqt = (a.Sq + kBM - 1) / kBM, hbs = a.H * a.B;
  const int group = idx / (kGroupHB * nqt);
  const int g = min(kGroupHB, hbs - group * kGroupHB);  // pairs in this group
  const int r = idx - group * kGroupHB * nqt;
  const int qt = nqt - 1 - r / g, hb = group * kGroupHB + r % g;
  return BlockPos{qt * kBM, hb % a.H, hb / a.H};
}

template <int BN>
__device__ __forceinline__ int blk_key_begin(int q0, const Args& a) {
  const long long first = static_cast<long long>(q0) + a.Sk - a.Sq + a.band_lo;
  return first <= 0 ? 0 : static_cast<int>(first / BN) * BN;
}

__device__ __forceinline__ int blk_key_end(int q0, int rows, const Args& a) {
  const long long last = static_cast<long long>(q0) + rows + a.Sk - a.Sq + a.band_hi;
  return last <= 0 ? 0 : static_cast<int>(last < a.Sk ? last : a.Sk);
}

// Keys [k0, k0 + BN) are all visible to every query of [qa, qa + 64): in
// range and inside the band (no integer masks: the caller checks). Such a
// tile skips the per-element visibility test.
template <int BN>
__device__ __forceinline__ bool tile_in_band(int qa, int k0, const Args& a) {
  if (qa + 64 > a.Sq || k0 + BN > a.Sk) return false;
  const long long off = static_cast<long long>(a.Sk) - a.Sq;
  return k0 - (qa + 63) - off >= a.band_lo && k0 + BN - 1 - qa - off <= a.band_hi;
}

// Keys [k0, k0 + BN) hold no key visible to a query of [qa, qa + 64) by the
// band and the ranges alone: the consumer warpgroup of those rows skips the
// tile's math (it still takes the stage and frees it).
template <int BN>
__device__ __forceinline__ bool tile_out_of_band(int qa, int k0, const Args& a) {
  if (qa >= a.Sq) return true;
  const long long off = static_cast<long long>(a.Sk) - a.Sq;
  const int qlast = min(qa + 64, a.Sq) - 1;
  return k0 + BN - 1 - qa - off < a.band_lo || k0 - qlast - off > a.band_hi;
}

// What the producer hands the consumers with each stage: the key tile's
// first key (-1: the pass ends), and for the integer masks the tile's key
// segment ids and flashmask rows (a key at or past Sk: id 0, rows that mask
// nothing; visible() drops it).
template <int BN>
struct Slot {
  int k0;
  // the tile's key segment ids' range and its flashmask rows' least start
  // and greatest end (tile_mask's per-thread shortcut)
  int klo, khi, smin, emax;
  int kids[BN], fs[BN], fe[BN];
};

// The segment-id range of the block's query rows [q0, min(q0 + kBM, Sq)),
// reduced over the producer warp.
__device__ __forceinline__ void block_qseg_range(const Args& a, int b, int q0, int& lo, int& hi) {
  const int lane = threadIdx.x % 32;
  lo = INT_MAX;
  hi = INT_MIN;
  for (int r = q0 + lane; r < q0 + kBM && r < a.Sq; r += 32) {
    const int id = a.qseg[static_cast<long long>(b) * a.Sq + r];
    lo = min(lo, id);
    hi = max(hi, id);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// The flashmask rows of (batch b, query head h) start at this element.
__device__ __forceinline__ long long fm_row(const Args& a, int b, int h) {
  return (static_cast<long long>(b) * (a.fm_hs ? a.H : 1)) * a.Sk +
         static_cast<long long>(h) * a.fm_hs;
}

// The producer warp's copy of key tile k0's integer masks: lane l holds
// keys k0 + l + 32 u (a key at or past Sk: id 0, rows that mask nothing;
// visible() drops it).
template <int BN>
struct KeyMasks {
  int kid[BN / 32], s[BN / 32], e[BN / 32];
  int klo, khi, smin, emax;  // over the tile's keys below Sk
};

// Load key tile k0's ids and rows (one round trip; the slot is written from
// these registers) and decide whether the tile can be skipped: disjoint
// segment ranges, or every key masking every query of the block's rows
// (flash_common.cuh seg_overlap / fm_tile_masked at kBM rows). Reduced over
// the producer warp; every lane gets the same answer.
template <int BN>
__device__ __forceinline__ bool key_tile_skip(const Args& a, bool seg, bool fm, int b, int h,
                                              int q0, int k0, int qlo, int qhi,
                                              KeyMasks<BN>& km) {
  const int lane = threadIdx.x % 32;
  const long long rows = fm ? fm_row(a, b, h) : 0;
  int klo = INT_MAX, khi = INT_MIN, smax = INT_MIN, emin = INT_MAX, smin = INT_MAX,
      emax = INT_MIN;
#pragma unroll
  for (int u = 0; u < BN / 32; ++u) {
    const int kpos = k0 + lane + 32 * u;
    const bool in = kpos < a.Sk;
    km.kid[u] = seg && in ? a.kseg[static_cast<long long>(b) * a.Sk + kpos] : 0;
    km.s[u] = fm && in ? a.fms[rows + kpos] : INT_MIN;
    km.e[u] = fm && in ? a.fme[rows + kpos] : INT_MAX;
    if (in) {
      klo = min(klo, km.kid[u]);
      khi = max(khi, km.kid[u]);
      smin = min(smin, km.s[u]);
      emax = max(emax, km.e[u]);
    }
    smax = max(smax, km.s[u]);
    emin = min(emin, km.e[u]);
  }
  if (seg) {
    klo = __reduce_min_sync(0xffffffffu, klo);
    khi = __reduce_max_sync(0xffffffffu, khi);
    km.klo = klo;
    km.khi = khi;
    if (!seg_overlap(qlo, qhi, klo, khi)) return true;
  }
  if (fm) {
    smax = __reduce_max_sync(0xffffffffu, smax);
    emin = __reduce_min_sync(0xffffffffu, emin);
    km.smin = __reduce_min_sync(0xffffffffu, smin);
    km.emax = __reduce_max_sync(0xffffffffu, emax);
    const int qn = q0 + kBM < a.Sq ? q0 + kBM : a.Sq;
    if (smax <= q0 && emin >= qn) return true;
  }
  return false;
}

// The stage's slot for key tile k0: its first key, and for the integer
// masks the keys' segment ids and rows.
template <int BN>
__device__ __forceinline__ void write_slot(Slot<BN>& slot, int k0, bool seg, bool fm,
                                           const KeyMasks<BN>& km) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    slot.k0 = k0;
    slot.klo = km.klo;
    slot.khi = km.khi;
    slot.smin = km.smin;
    slot.emax = km.emax;
  }
#pragma unroll
  for (int u = 0; u < BN / 32; ++u) {
    if (seg) slot.kids[lane + 32 * u] = km.kid[u];
    if (fm) {
      slot.fs[lane + 32 * u] = km.s[u];
      slot.fe[lane + 32 * u] = km.e[u];
    }
  }
}

// The visibility of this thread's elements of key tile k0 (BN keys), as a
// mask: bit 4 j + 2 i + e (the fragment register of row i, column
// 8 j + 2 (l % 4) + e) is set iff the pair is in range, inside the band
// (visible()), within one segment and outside the key's flashmask rows
// (from the stage's slot). A loop unrolled by 2, run while the S product is
// in flight: the softmax then tests one bit an element.
template <int BN, bool kInt>
__device__ __forceinline__ uint64_t tile_visible_bits(const Args& a, const Slot<BN>& slot,
                                                      bool seg, bool fm, int k0,
                                                      const int (&qpos)[2], const int (&qid)[2]) {
  static_assert(BN / 8 * 4 <= 64, "one 64-bit mask a tile");
  const int lane = threadIdx.x % 32;
  uint64_t bits = 0;
#pragma unroll 2
  for (int j = 0; j < BN / 8; ++j) {
    unsigned g = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * (lane % 4) + e;
      const int kid = kInt && seg ? slot.kids[col] : 0;
      const int fs = kInt && fm ? slot.fs[col] : 0, fe = kInt && fm ? slot.fe[col] : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bool ok = visible(qpos[i], k0 + col, a);
        if (kInt) ok = ok && (!seg || qid[i] == kid) && (!fm || qpos[i] < fs || qpos[i] >= fe);
        g |= (ok ? 1u : 0u) << (2 * i + e);
      }
    }
    bits |= static_cast<uint64_t>(g) << (4 * j);
  }
  return bits;
}

// The visibility bits of key tile k0 for this thread's rows qpos[0] and
// qpos[0] + 8 (warpgroup rows from qa): all set, with no per-element test,
// where the tile lies wholly inside the band for the warpgroup's rows and
// the integer masks provably mask none of this thread's pairs: the tile's
// keys all carry the rows' one segment id, and every key's flashmask band
// [start, end) misses both rows. Else tile_visible_bits, without the masks
// so proved absent.
template <int BN, bool kInt>
__device__ __forceinline__ uint64_t tile_mask(const Args& a, const Slot<BN>& slot, bool seg,
                                              bool fm, int qa, int k0, const int (&qpos)[2],
                                              const int (&qid)[2]) {
  const bool band = tile_in_band<BN>(qa, k0, a);
  if (!kInt) return band ? ~0ull : tile_visible_bits<BN, false>(a, slot, false, false, k0, qpos, qid);
  const bool seg_free = !seg || (slot.klo == slot.khi && qid[0] == slot.klo && qid[1] == slot.klo);
  const bool fm_free = !fm || slot.smin > qpos[1] || slot.emax <= qpos[0];
  if (band && seg_free && fm_free) return ~0ull;
  return tile_visible_bits<BN, true>(a, slot, seg && !seg_free, fm && !fm_free, k0, qpos, qid);
}

// The dropout keep bits of this thread's elements of one 8-column group j of
// a key tile: (row i, column e) -> bit 2 i + e. The thread's two columns of
// the group are positions 2 (l % 2) and + 1 of the Philox quad
// (k0 + 8 j) / 4 + (l % 4) / 2, which its quad partner l ^ 1 shares: the even
// lane draws the words of its row 0 and the odd lane those of its row 1,
// and each hands the other the two words it needs (flash_common.cuh
// drop_bits; the same bits as dropout_keep_mask).
__device__ __forceinline__ unsigned drop_keep_bits(const Args& a, int b, int h, int row0, int k0,
                                                   int j) {
  const int lane = threadIdx.x % 32;
  const bool odd = lane & 1;
  const uint4 w = drop_bits(a, b, h, odd ? row0 + 8 : row0, (k0 + 8 * j) / 4 + (lane % 4) / 2);
  const uint32_t x = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t y = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  const uint32_t r0a = odd ? x : w.x, r0b = odd ? y : w.y;  // row 0, own columns
  const uint32_t r1a = odd ? w.z : x, r1b = odd ? w.w : y;  // row 1
  return (r0a >= a.thresh ? 1u : 0u) | (r0b >= a.thresh ? 2u : 0u) |
         (r1a >= a.thresh ? 4u : 0u) | (r1b >= a.thresh ? 8u : 0u);
}

// The keep bits of this thread's elements of a whole key tile of BN keys,
// group j at bits 4 j .. 4 j + 3 (drop_keep_bits). Unrolled by 4: four
// Philox chains in flight hide each other's latency (fully unrolled, the
// calls' temporaries spilled beside the score and output fragments).
template <int BN>
__device__ __forceinline__ uint64_t tile_keep_bits(const Args& a, int b, int h, int row0, int k0) {
  static_assert(BN / 8 * 4 <= 64, "one 64-bit mask a tile");
  uint64_t keep = 0;
#pragma unroll 4
  for (int j = 0; j < BN / 8; ++j)
    keep |= static_cast<uint64_t>(drop_keep_bits(a, b, h, row0, k0, j)) << (4 * j);
  return keep;
}

// Zero, in a form the compiler cannot see through: an address offset by it
// waits for `dep` (add_bias_t orders a chunk of loads after the previous
// chunk's sums with it).
__device__ __forceinline__ int opaque_zero(float dep) {
  int z;
  asm volatile("mov.b32 %0, 0;\n" : "=r"(z) : "f"(dep));
  return z;
}

// The bias added to the visible scores of a key tile, in place on the
// fragment (the masked ones keep -inf). Every load is unconditional, from an
// address clamped into the bias (row < Sq, key < Sk), and its value masked
// after: a load under a branch sat in a basic block of its own, and the
// tile's loads went one L2 round trip at a time. They go in chunks that
// hold at most 16 registers of values. The dtype is switched on once a
// tile; a column pair is one load where the bias is contiguous over keys,
// Sk is even and the pair aligned.
template <typename BT, int BN>
__device__ __forceinline__ void add_bias_t(float (&s)[BN / 2], const Args& a, long long bb,
                                           int k0, const int (&qpos)[2], uint64_t vis) {
  const int lane = threadIdx.x % 32;
  const BT* base = static_cast<const BT*>(a.bias) + bb;
  const bool vec = a.vb.k == 1 && a.Sk % 2 == 0 && ((a.vb.q | bb) & 1) == 0 &&
                   reinterpret_cast<uintptr_t>(base) % (2 * sizeof(BT)) == 0;
  const BT* row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    row[i] = base + static_cast<long long>(min(qpos[i], a.Sq - 1)) * a.vb.q;
  if (vec) {
    // column groups whose loads are in flight together: 16 registers of
    // loaded values either way
    constexpr int kChunk = sizeof(BT) == 2 ? 8 : 4;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
#pragma unroll
      for (int j = j0; j < j0 + kChunk; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i, kpos = min(k0 + 8 * j + 2 * (lane % 4), a.Sk - 2);
          float2 v;
          if constexpr (std::is_same<BT, float>::value)
            v = *reinterpret_cast<const float2*>(row[i] + kpos);
          else
            v = unpack2<BT>(*reinterpret_cast<const uint32_t*>(row[i] + kpos));
          s[r] += (vis >> r) & 1u ? v.x : 0.f;
          s[r + 1] += (vis >> (r + 1)) & 1u ? v.y : 0.f;
        }
      // the next chunk's loads wait for this one's sums
      const int z = opaque_zero(s[4 * (j0 + kChunk - 1) + 3]);
      row[0] += z;
      row[1] += z;
    }
  } else {
    constexpr int kChunk = 4;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
#pragma unroll
      for (int j = j0; j < j0 + kChunk; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * j + 2 * i + e;
            const int kpos = min(k0 + 8 * j + 2 * (lane % 4) + e, a.Sk - 1);
            const float v = to_f32(row[i][static_cast<long long>(kpos) * a.vb.k]);
            s[r] += (vis >> r) & 1u ? v : 0.f;
          }
      const int z = opaque_zero(s[4 * (j0 + kChunk - 1) + 3]);
      row[0] += z;
      row[1] += z;
    }
  }
}

template <int BN>
__device__ __forceinline__ void add_bias(float (&s)[BN / 2], const Args& a, long long bb, int k0,
                                         const int (&qpos)[2], uint64_t vis) {
  switch (a.bias_dtype) {
    case kBF16:
      add_bias_t<bf16, BN>(s, a, bb, k0, qpos, vis);
      break;
    case kF16:
      add_bias_t<f16, BN>(s, a, bb, k0, qpos, vis);
      break;
    default:
      add_bias_t<float, BN>(s, a, bb, k0, qpos, vis);
  }
}

// ---------------------------------------------------------------------------
// host: the tensor maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime
// (the library links no -lcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// The code a failed encode returns (not a CUDA runtime error number).
constexpr int kErrTensorMap = 9901;

// A 4-D tensor map over a [B, S, H, D] view of 16-bit elements (dims
// innermost first: D, S, H, B, with the view's own byte strides), boxes of
// 64 columns x `rows` rows of one (batch, head), 128-byte swizzle. The true
// D and S are the extents, so TMA fills the columns past D and the rows past
// S with zeros. A dim of extent 1 gets a stride of its own (any is read the
// same); the wrapper copies a view that broadcasts a longer dim (stride 0).
inline int encode_view(CUtensorMap* map, const void* base, const View& v, int B, int S, int H,
                       int D, int dtype, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrTensorMap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S > 0 ? S : 1),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const long long el[3] = {v.s, v.h, v.b};
  cuuint64_t strides[3];
  cuuint64_t packed = static_cast<cuuint64_t>((D * 2 + 15) / 16 * 16);
  for (int i = 0; i < 3; ++i) {
    const long long s = el[i] * 2;
    if (dims[i + 1] == 1) {
      strides[i] = packed;
    } else {
      if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
      strides[i] = static_cast<cuuint64_t>(s);
    }
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
         const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// The dynamic shared memory rounded up to a 1024-byte boundary (the
// kernels ask for 1024 bytes more than their struct).
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

}  // namespace hopper
}  // namespace ptt_flash
