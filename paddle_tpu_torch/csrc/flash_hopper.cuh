// The Hopper pieces of the redesigned flash kernels (flash_fwd_hopper.cu,
// the forward; flash_dq_hopper.cu, dQ; flash_dkv_hopper.cu, dK/dV; their
// fp32 forms on the TF32 tensor cores, *_tf32_hopper.cu) and of the ragged
// paged-attention kernels (ragged_paged_attention_hopper.cu,
// ragged_paged_attention_tf32_hopper.cu): mbarriers, TMA tile loads and
// the ragged kernels' cp.async page gather, wgmma and its shared-memory
// descriptors, the tensor maps built on the host, and the
// accumulator-fragment coordinates the softmax and the masks work on.
// Inline PTX throughout (no CuTe): each kernel has 16 instances a width,
// and CuTe's atoms would multiply their compile time.
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

// One box of a 2-D tensor map (the ragged kernels' pools seen as rows).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// 16 bytes global -> shared by cp.async (L2 only); src_bytes 0 writes 16
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The executing thread's earlier cp.async copies arrive on `bar` once they
// have landed (the pending count is raised by one first, so the thread
// still arrives itself: mbar_arrive).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// The gathered page ring of the ragged kernels (a page size that is not a
// multiple of 8, where no TMA box of whole 8-row swizzle atoms fits a
// page): the calling warp copies the BN keys [k0, k0 + BN) of one (kv head,
// row) into a stage, key row by key row, 16 bytes a lane a copy. Key k
// comes from pool row (h NB + table[k / bs]) bs + k % bs of `row_bytes`
// bytes; a key at or past n_keys is zero-filled (nothing read: no table
// slot past the row's used pages is touched), as are a row's chunks at or
// past `valid` (the pool row's whole 16-byte chunks; the stage rows are
// kChunks long). dst(r, c): the byte offset in the stage of chunk c of key
// row r, in the layout the stage's reader takes. on_key(r, page) runs in
// the lane that reads key r's table slot (r % 32 == lane), before its
// arrival: a quantized page's scales. The copies and the lane itself
// arrive on `bar`, whose count is 32.
template <int BN, int kChunks, typename Dst, typename OnKey>
__device__ __forceinline__ void gather_tile(unsigned char* k_dst, unsigned char* v_dst,
                                            const unsigned char* k_pool,
                                            const unsigned char* v_pool, long long row_bytes,
                                            const int* table, int h, int NB, int bs, int k0,
                                            int n_keys, int valid, uint64_t* bar, Dst dst,
                                            OnKey on_key) {
  constexpr int kPer = (BN + 31) / 32;  // keys whose table slot a lane reads
  const int lane = threadIdx.x % 32;
  int prow[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = lane + 32 * i, key = k0 + r;
    prow[i] = -1;
    if (BN % 32 != 0 && r >= BN) continue;  // a tile of 16 keys: lanes 16-31 read none
    if (key < n_keys) {
      const int page = table[key / bs];
      prow[i] = (h * NB + page) * bs + key % bs;
      on_key(r, page);
    } else {
      on_key(r, -1);
    }
  }
#pragma unroll 4
  for (int e = lane; e < BN * kChunks; e += 32) {
    const int r = e / kChunks, c = e % kChunks;
    int row = -1;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int x = __shfl_sync(0xffffffffu, prow[i], r % 32);
      if (r / 32 == i) row = x;
    }
    const bool ok = row >= 0 && c < valid;
    const long long off = ok ? row * row_bytes + 16 * c : 0;
    const uint32_t n = ok ? 16 : 0;
    cp_async16(k_dst + dst(r, c), k_pool + off, n);
    cp_async16(v_dst + dst(r, c), v_pool + off, n);
  }
  cp_async_mbar_arrive(bar);
  mbar_arrive(bar);
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

template <int BM = kBM>
__device__ __forceinline__ BlockPos block_pos(const Args& a, int idx) {
  const int nqt = (a.Sq + BM - 1) / BM, hbs = a.H * a.B;
  const int group = idx / (kGroupHB * nqt);
  const int g = min(kGroupHB, hbs - group * kGroupHB);  // pairs in this group
  const int r = idx - group * kGroupHB * nqt;
  const int qt = nqt - 1 - r / g, hb = group * kGroupHB + r % g;
  return BlockPos{qt * BM, hb % a.H, hb / a.H};
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

// Keys [k0, k0 + BN) are all visible to every query of [qa, qa + ROWS): in
// range and inside the band (no integer masks: the caller checks). Such a
// tile skips the per-element visibility test.
template <int BN, int ROWS = 64>
__device__ __forceinline__ bool tile_in_band(int qa, int k0, const Args& a) {
  if (qa + ROWS > a.Sq || k0 + BN > a.Sk) return false;
  const long long off = static_cast<long long>(a.Sk) - a.Sq;
  return k0 - (qa + ROWS - 1) - off >= a.band_lo && k0 + BN - 1 - qa - off <= a.band_hi;
}

// Keys [k0, k0 + BN) hold no key visible to a query of [qa, qa + ROWS) by
// the band and the ranges alone: the consumer warpgroup of those rows skips
// the tile's math (it still takes the stage and frees it).
template <int BN, int ROWS = 64>
__device__ __forceinline__ bool tile_out_of_band(int qa, int k0, const Args& a) {
  if (qa >= a.Sq) return true;
  const long long off = static_cast<long long>(a.Sk) - a.Sq;
  const int qlast = min(qa + ROWS, a.Sq) - 1;
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

// The segment-id range of the block's query rows [q0, min(q0 + BM, Sq)),
// reduced over the producer warp.
template <int BM = kBM>
__device__ __forceinline__ void block_qseg_range(const Args& a, int b, int q0, int& lo, int& hi) {
  const int lane = threadIdx.x % 32;
  lo = INT_MAX;
  hi = INT_MIN;
  for (int r = q0 + lane; r < q0 + BM && r < a.Sq; r += 32) {
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
  static constexpr int kPer = (BN + 31) / 32;  // a tile of 16 keys: lanes 0-15
  int kid[kPer], s[kPer], e[kPer];
  int klo, khi, smin, emax;  // over the tile's keys below Sk
};

// Load key tile k0's ids and rows (one round trip; the slot is written from
// these registers) and decide whether the tile can be skipped: disjoint
// segment ranges, or every key masking every query of the block's rows
// (flash_common.cuh seg_overlap / fm_tile_masked at the block's BM rows).
// Reduced over the producer warp; every lane gets the same answer.
template <int BN, int BM = kBM>
__device__ __forceinline__ bool key_tile_skip(const Args& a, bool seg, bool fm, int b, int h,
                                              int q0, int k0, int qlo, int qhi,
                                              KeyMasks<BN>& km) {
  const int lane = threadIdx.x % 32;
  const long long rows = fm ? fm_row(a, b, h) : 0;
  int klo = INT_MAX, khi = INT_MIN, smax = INT_MIN, emin = INT_MAX, smin = INT_MAX,
      emax = INT_MIN;
#pragma unroll
  for (int u = 0; u < KeyMasks<BN>::kPer; ++u) {
    const int kpos = k0 + lane + 32 * u;
    const bool in = kpos < a.Sk && (BN % 32 == 0 || lane + 32 * u < BN);
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
    const int qn = q0 + BM < a.Sq ? q0 + BM : a.Sq;
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
  for (int u = 0; u < KeyMasks<BN>::kPer; ++u) {
    if (BN % 32 != 0 && lane + 32 * u >= BN) continue;
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
    // loaded values either way, at most the tile's groups
    constexpr int kChunk = (sizeof(BT) == 2 ? 8 : 4) < BN / 8 ? (sizeof(BT) == 2 ? 8 : 4) : BN / 8;
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
    constexpr int kChunk = 4 < BN / 8 ? 4 : BN / 8;
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
// the forward kernels' pieces (flash_fwd_hopper.cu, flash_fwd_tf32_hopper.cu)
// The online softmax of one key tile on the score fragment s: mask, scale
// and bias; the row max over the quad; p (dropped and rescaled) in place on
// s; l and m updated; alpha, the factor the output must be rescaled by once
// the previous tile's p v product is done (rescale_pack).
template <int D, int BN, bool kBias, bool kDrop>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], const Args& a,
                                             int k0, const int (&qpos)[2], long long bb,
                                             uint64_t vis, uint64_t keep) {
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int r = 0; r < BN / 2; ++r)  // a masked score adds exp(-inf) = 0
    s[r] = (vis >> r) & 1u ? s[r] * a.scale : neg_inf;
  if (kBias) add_bias<BN>(s, a, bb, k0, qpos, vis);
  // four partial maxima and sums a row: short dependency chains
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[i][c] = kNegInf;
      sum[i][c] = 0.f;
    }
#pragma unroll
  for (int r = 0; r < BN / 2; ++r)
    mx[(r / 2) % 2][(r / 4) % 4] = fmaxf(mx[(r / 2) % 2][(r / 4) % 4], s[r]);
  float ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float row_max = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
    const float m_new = fmaxf(m[i], quad_max(row_max));
    alpha[i] = exp2f((m[i] - m_new) * kLog2e);
    m[i] = m_new;
    // a row whose scores a bias pushed to -1e30 (dead so far) takes p = 0:
    // fmaf(s, log2 e, -m log2 e) is there the rounding error of m log2 e,
    // up to 2^76, and exp2 of it overflowed to inf (a NaN output after the
    // dead row's 0 x)
    ms[i] = m_new <= kNegInf * 0.5f ? __int_as_float(0x7f800000) : m_new * kLog2e;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 4 * j + 2 * i + e;
        const float p = exp2f(fmaf(s[r], kLog2e, -ms[i]));
        sum[i][j % 4] += p;  // l sums the undropped probabilities
        s[r] = !kDrop ? p : ((keep >> r) & 1u ? p * a.drop_scale : 0.f);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = l[i] * alpha[i] +
           quad_sum((sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]));
}

// ---------------------------------------------------------------------------
// the dQ kernels' pieces (flash_dq_hopper.cu, flash_dq_tf32_hopper.cu)
// Zeros into the d-bias of the warpgroup's rows [qa, qa + 64) (those < Sq),
// key columns [c0, c1).
__device__ __forceinline__ void zero_dbias_wg(const Args& a, long long row_base, int qa, int c0,
                                              int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int e = threadIdx.x % 128; e < 64 * w; e += 128) {
    const int r = e / w, c = e % w;
    if (qa + r < a.Sq) a.dbias[(row_base + qa + r) * a.Sk + c0 + c] = 0.f;
  }
}

// p and the dropout-masked, rescaled dP of one key tile, in place on the
// fragments s and dp: p = exp(scale s + bias - lse), 0 where masked and on a
// dead row.
template <int BN, bool kBias, bool kDrop>
__device__ __forceinline__ void probs_tile(float (&s)[BN / 2], float (&dp)[BN / 2],
                                           const Args& a, int k0, const int (&qpos)[2],
                                           const float (&lse)[2], const bool (&dead)[2],
                                           long long bb, uint64_t vis, uint64_t keep) {
  // a dead row's lse is -1e30: its p is 0, never exp(s + 1e30)
  if (dead[0]) vis &= ~0x3333333333333333ull;
  if (dead[1]) vis &= ~0xCCCCCCCCCCCCCCCCull;
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) s[r] *= a.scale;
  if (kBias) add_bias<BN>(s, a, bb, k0, qpos, vis);
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) {
    const int i = (r / 2) % 2;
    s[r] = (vis >> r) & 1u ? exp2f((s[r] - lse[i]) * kLog2e) : 0.f;
    if (kDrop) dp[r] = (keep >> r) & 1u ? dp[r] * a.drop_scale : 0.f;
  }
}

// ---------------------------------------------------------------------------
// the dK/dV kernels' pieces (flash_dkv_hopper.cu, flash_dkv_tf32_hopper.cu): a
// block owns keys and streams query tiles of NQ rows; the fragments are
// key-major (rows keys, columns queries)
// What the producer hands the consumers with each stage: the query tile's
// first row (-1: the list ends) and its head in the group, the tile's query
// segment ids and their range, and its lse (times log2 e in the 16-bit
// kernel) and delta.
template <int NQ>
struct QSlotT {
  int q0, hh, qlo, qhi;
  float lse[NQ], delta[NQ];
  int qids[NQ];
};

struct KeyBlockPos {
  int k0, hk, b;
};

// Blocks in groups of kGroupHB (batch, kv head) pairs; inside a group the
// key tiles in order from the first, which sees the most queries under
// causal masking.
template <int BN>
__device__ __forceinline__ KeyBlockPos key_block_pos(const Args& a, int idx) {
  const int nkt = (a.Sk + BN - 1) / BN, hbs = a.Hkv * a.B;
  const int group = idx / (kGroupHB * nkt);
  const int g = min(kGroupHB, hbs - group * kGroupHB);
  const int r = idx - group * kGroupHB * nkt;
  const int hb = group * kGroupHB + r % g;
  return KeyBlockPos{(r / g) * BN, hb % a.Hkv, hb / a.Hkv};
}

// Queries [first, end) can see keys [k0, k0 + BN) by the band (first a
// multiple of NQ, the streamed query tile).
template <int NQ>
__device__ __forceinline__ int blk_query_begin(int k0, const Args& a) {
  const long long first = static_cast<long long>(k0) - (a.Sk - a.Sq) - a.band_hi;
  return first <= 0 ? 0 : static_cast<int>(first / NQ) * NQ;
}

template <int BN>
__device__ __forceinline__ int blk_query_end(int k0, const Args& a) {
  const long long last = static_cast<long long>(k0) + BN - (a.Sk - a.Sq) - a.band_lo;
  return last <= 0 ? 0 : static_cast<int>(last < a.Sq ? last : a.Sq);
}

// The visibility bits of this thread's elements of a key-major tile: bit
// 4 j + 2 i + e is key row kpos[i], query q0 + 8 j + 2 (l % 4) + e; set iff
// the pair is in range, inside the band, within one segment and outside the
// key's flashmask rows [fs, fe).
template <bool kInt, int NQ>
__device__ __forceinline__ uint64_t kt_visible_bits(const Args& a, const QSlotT<NQ>& sl, bool seg,
                                                    bool fm, int q0, const int (&kpos)[2],
                                                    const int (&kid)[2], const int (&fs)[2],
                                                    const int (&fe)[2]) {
  const int lane = threadIdx.x % 32;
  uint64_t bits = 0;
#pragma unroll 2
  for (int j = 0; j < NQ / 8; ++j) {
    unsigned g = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * (lane % 4) + e, qpos = q0 + col;
      const int qid = kInt && seg ? sl.qids[col] : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bool ok = visible(qpos, kpos[i], a);
        if (kInt) ok = ok && (!seg || qid == kid[i]) && (!fm || qpos < fs[i] || qpos >= fe[i]);
        g |= (ok ? 1u : 0u) << (2 * i + e);
      }
    }
    bits |= static_cast<uint64_t>(g) << (4 * j);
  }
  return bits;
}

// All bits set, with no per-element test, where the warpgroup's 64 keys
// [ka, ka + 64) lie wholly inside the band for the tile's NQ queries and the
// integer masks provably spare this thread's pairs: the tile's queries all
// carry the one segment id of both keys, and both keys' flashmask bands miss
// the tile's queries. Else kt_visible_bits, without the masks so proved
// absent.
template <bool kInt, int NQ>
__device__ __forceinline__ uint64_t kt_tile_mask(const Args& a, const QSlotT<NQ>& sl, bool seg,
                                                 bool fm, int q0, int ka, const int (&kpos)[2],
                                                 const int (&kid)[2], const int (&fs)[2],
                                                 const int (&fe)[2]) {
  const bool band = tile_in_band<64, NQ>(q0, ka, a);
  if (!kInt) return band ? ~0ull : kt_visible_bits<false, NQ>(a, sl, false, false, q0, kpos, kid, fs, fe);
  const bool seg_free = !seg || (sl.qlo == sl.qhi && kid[0] == sl.qlo && kid[1] == sl.qlo);
  const int qlast = q0 + NQ - 1;
  const bool fm_free = !fm || ((fe[0] <= q0 || fs[0] > qlast || fs[0] >= fe[0]) &&
                               (fe[1] <= q0 || fs[1] > qlast || fs[1] >= fe[1]));
  if (band && seg_free && fm_free) return ~0ull;
  return kt_visible_bits<true, NQ>(a, sl, seg && !seg_free, fm && !fm_free, q0, kpos, kid, fs, fe);
}

// The dropout keep bits of this thread's elements of a key-major tile (bit
// 4 j + 2 i + e as kt_visible_bits). Lane l = 16 m + 4 s + (l % 4) holds key
// rows 4 m + s (+ 8) of its warp's 16, so keys 4 c .. 4 c + 3 of one Philox
// call sit in the four lanes s = 0..3. In group j lane s makes the call of
// column 2 (l % 4) + (s >> 1), key row s & 1, keeps word s and hands word
// s ^ x to lane s ^ x (x = 1, 2, 3): four calls, one a lane, give the four
// lanes all 16 bits of the group.
template <int NQ>
__device__ __forceinline__ uint64_t kt_keep_bits(const Args& a, int b, int h, int q0, int key0) {
  const int lane = threadIdx.x % 32, s = (lane >> 2) & 3;
  const int e_own = s >> 1, i_own = s & 1;
  // key0: the thread's row-0 key; its word is s, its group key0 / 4; row 1
  // is 8 keys on, two groups
  const int c4 = key0 / 4 + 2 * i_own;
  uint64_t keep = 0;
#pragma unroll 2
  for (int j = 0; j < NQ / 8; ++j) {
    const int qpos = q0 + 8 * j + 2 * (lane % 4) + e_own;
    const uint4 w = drop_bits(a, b, h, qpos, c4);
    unsigned g = (word(w, s) >= a.thresh ? 1u : 0u) << (2 * i_own + e_own);
#pragma unroll
    for (int x = 1; x < 4; ++x) {
      const uint32_t got = __shfl_xor_sync(0xffffffffu, word(w, s ^ x), 4 * x);
      const int sp = s ^ x;  // the partner's call: row sp & 1, column sp >> 1
      g |= (got >= a.thresh ? 1u : 0u) << (2 * (sp & 1) + (sp >> 1));
    }
    keep |= static_cast<uint64_t>(g) << (4 * j);
  }
  return keep;
}

// The bias of the key-major tile added in place (masked elements keep their
// value: the caller zeroes their p). Every load is unconditional from an
// address clamped into the bias, in chunks of 4 column groups (16 values);
// the next chunk's loads wait for this one's sums. kChained: the
// next chunk's query rows wait for them too. The split design's warpgroup
// 1 holds 128 registers of dv beside the scores, and there the compiler
// formed every chunk's 64-bit row offsets up front: the D_pad 256
// instances spilled 24-76 bytes a thread (`cuobjdump -sass` put the spills
// on those offsets; smaller chunks alone did not help). Chained, a chunk's
// offsets are formed after the previous chunk's sums (and split_p
// holds neither the integer masks' key data nor the keep bits across them).
template <typename BT, bool kChained, int NQ>
__device__ __forceinline__ void add_bias_kt_t(float (&s)[NQ / 2], const Args& a, long long bb,
                                              int q0, const int (&kpos)[2], uint64_t vis) {
  const int lane = threadIdx.x % 32;
  const BT* base = static_cast<const BT*>(a.bias) + bb;
  long long koff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) koff[i] = static_cast<long long>(min(kpos[i], a.Sk - 1)) * a.vb.k;
  constexpr int kChunk = 4 < NQ / 8 ? 4 : NQ / 8;  // a tile of 16 queries: its 2 groups
  int qz = 0;  // 0, after the previous chunk's sums (kChained)
#pragma unroll
  for (int j0 = 0; j0 < NQ / 8; j0 += kChunk) {
#pragma unroll
    for (int j = j0; j < j0 + kChunk; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qpos = min(q0 + 8 * j + 2 * (lane % 4) + e, a.Sq - 1) + qz;
        const BT* row = base + static_cast<long long>(qpos) * a.vb.q;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i + e;
          const float v = to_f32(row[koff[i]]);
          s[r] += (vis >> r) & 1u ? v : 0.f;
        }
      }
    const int z = opaque_zero(s[4 * (j0 + kChunk - 1) + 3]);
    if (kChained)
      qz = z;
    else
      base += z;
  }
}

template <bool kChained, int NQ>
__device__ __forceinline__ void add_bias_kt(float (&s)[NQ / 2], const Args& a, long long bb,
                                            int q0, const int (&kpos)[2], uint64_t vis) {
  switch (a.bias_dtype) {
    case kBF16:
      add_bias_kt_t<bf16, kChained, NQ>(s, a, bb, q0, kpos, vis);
      break;
    case kF16:
      add_bias_kt_t<f16, kChained, NQ>(s, a, bb, q0, kpos, vis);
      break;
    default:
      add_bias_kt_t<float, kChained, NQ>(s, a, bb, q0, kpos, vis);
  }
}

// The flashmask rows (start, end) of this thread's two keys for query head
// h (a key past Sk: rows that mask nothing; visible() drops it).
__device__ __forceinline__ void key_rows(const Args& a, int b, int h, const int (&kpos)[2],
                                         int (&fs)[2], int (&fe)[2]) {
  const long long rows = fm_row(a, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = kpos[i] < a.Sk;
    fs[i] = in ? a.fms[rows + kpos[i]] : 0;
    fe[i] = in ? a.fme[rows + kpos[i]] : 0;
  }
}

// ---------------------------------------------------------------------------
// fp32 operands on the TF32 tensor cores (flash_fwd_tf32_hopper.cu,
// flash_dq_tf32_hopper.cu, flash_dkv_tf32_hopper.cu,
// ragged_paged_attention_tf32_hopper.cu). Each fp32 operand x is split into hi = T(x) and
// lo = T(x - hi), both exact TF32 values (T: cvt.rna.tf32.f32; x - hi is
// exact in fp32), and a product a b is taken as a_lo b_hi + a_hi b_lo +
// a_hi b_hi in fp32 accumulators: x = hi + lo to about 2^-22 |x|, and the
// dropped a_lo b_lo is about 2^-22 |a b| (TF32 alone keeps 2^-11). No
// product reads the low 13 bits of a word that is not an exact TF32 value.
//
// wgmma takes TF32 only K-major (no transpose), in shared memory for B and in
// shared memory or registers for A. So every product here takes its A from
// registers, gathered from shared memory by the threads and split there:
// - S = Q K^T (dQ) and S^T = K Q^T (dK/dV): A is the block's own 64 rows of
//   a raw fp32 tile (TMA, kept for the whole block; frag_raw), B the
//   streamed tile's hi / lo halves.
// - dq^T = K^T dS, dk^T = Q^T dS^T, dv^T = dO^T P^T: the outputs are taken
//   transposed, [D_pad][64], so A is the streamed tile read across its rows
//   (frag_t, from its hi / lo halves: no transposed copy) and B the ds or p
//   tile that the consumer itself writes, split, into shared memory in the
//   layout wgmma reads ([64][32] K-major: ds rows are queries in dQ, p and
//   ds rows are keys in dK/dV).
// The streamed tile lands raw by TMA and the producer warpgroup's warps 1-3
// split it in place (split_tiles: hi over the raw words, lo into a second
// buffer) before the consumers are told it is ready.
//
// Fragments. The TF32 A fragment of an m64nNk8 wgmma gives thread t of the
// warpgroup (warp w, lane l) rows 16 w + l / 4 (registers 0, 2) and that + 8
// (1, 3), and contraction index l % 4 (registers 0, 1) and l % 4 + 4 (2, 3).
// frag_raw reads contraction index l % 4 from column 2 (l % 4) of the key
// step's 8 and l % 4 + 4 from column 2 (l % 4) + 1 (one 8-byte load a row),
// so every B tile read against a raw A holds its 8 columns in that order:
// split_tiles writes them so (perm8). The accumulator layout is the 16-bit
// products' (the file head).

// one 8-column key step of a [rows][D_pad] fp32 tile is 32 bytes of a
// 128-byte swizzled row, as one of 16 bf16; 32 columns a panel
__host__ __device__ constexpr int f32_panels(int d_pad) { return d_pad / 32; }

// Byte offset of element (r, c) of an fp32 [rows][D_pad] tile kept as
// D_pad / 32 panels of [rows][32] `panel` bytes apart, 128-byte swizzled
// (16-byte chunk j of row r at chunk j ^ (r % 8)), as TMA writes it.
__device__ __forceinline__ uint32_t f32_off(int r, int c, uint32_t panel) {
  return (c >> 5) * panel + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// The place of column c in a split tile: within each group of 8 the even
// columns first, then the odd ones (contraction index k holds column 2 k,
// k + 4 column 2 k + 1: frag_raw's order).
__device__ __forceinline__ int perm8(int c) {
  return (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// One 32-byte unit of a landed tile split in place: hi over the raw words, lo
// into the buffer of the same layout, the 8 columns in perm8 order. The unit
// is one row's group of 8 columns, its two 16-byte chunks swapped where the
// row is odd (chunk j ^ (r % 8)): u's columns 0-3 sit at float4 2 u + odd.
__device__ __forceinline__ void split_unit(float4* h4, float4* l4, int u, float4 x, float4 y) {
  const int a = 2 * u + ((u >> 2) & 1), b = a ^ 1;
  uint32_t h[8], l[8];
  const float v[8] = {x.x, x.z, y.x, y.z, x.y, x.w, y.y, y.w};  // perm8 order
#pragma unroll
  for (int i = 0; i < 8; ++i) split_tf32(v[i], h[i], l[i]);
  h4[a] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                      __uint_as_float(h[3]));
  h4[b] = make_float4(__uint_as_float(h[4]), __uint_as_float(h[5]), __uint_as_float(h[6]),
                      __uint_as_float(h[7]));
  l4[a] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                      __uint_as_float(l[3]));
  l4[b] = make_float4(__uint_as_float(l[4]), __uint_as_float(l[5]), __uint_as_float(l[6]),
                      __uint_as_float(l[7]));
}

// Threads [0, n) of the caller split two landed tiles of `bytes` each in
// place (hi over the raw words, lo into the buffers of the same layout), two
// units a thread in flight: one at a time, the loop waited out each unit's
// loads and its dependent conversions.
__device__ __forceinline__ void split_tiles(float* t0, float* lo0, float* t1, float* lo1, int bytes,
                                            int tid, int n) {
  const int units = bytes / 32;
  for (int u = tid; u < 2 * units; u += 2 * n) {
    const int v = u + n;
    float4* h0 = reinterpret_cast<float4*>(u < units ? t0 : t1);
    float4* l0 = reinterpret_cast<float4*>(u < units ? lo0 : lo1);
    const int u0 = u < units ? u : u - units;
    const int a0 = 2 * u0 + ((u0 >> 2) & 1);
    const float4 x0 = h0[a0], y0 = h0[a0 ^ 1];
    float4 x1 = x0, y1 = y0;
    float4 *h1 = h0, *l1 = l0;
    int u1 = 0;
    if (v < 2 * units) {
      h1 = reinterpret_cast<float4*>(v < units ? t0 : t1);
      l1 = reinterpret_cast<float4*>(v < units ? lo0 : lo1);
      u1 = v < units ? v : v - units;
      const int a1 = 2 * u1 + ((u1 >> 2) & 1);
      x1 = h1[a1];
      y1 = h1[a1 ^ 1];
    }
    split_unit(h0, l0, u0, x0, y0);
    if (v < 2 * units) split_unit(h1, l1, u1, x1, y1);
  }
}

// Threads [0, n) of the caller split a landed key tile of BN keys: K
// ([BN][D] raw in 32-column panels at kraw) into khi / klo of the same
// layout, perm8 columns (in place where khi is kraw), and V (raw at vraw)
// transposed into vhi / vlo, V^T [D][32 keys] (128-byte rows) with the keys
// of each 8-key step in perm8 order, the tile's keys from column key0 (0,
// or 16 for the second tile of 16 keys that shares the rows: SplitRing):
// the K-major B of O += P V with P the register A (TF32 wgmma takes no
// transposed B). A warp takes the BN keys of 32 / BN groups of 4 head
// columns: its stores land on 32 banks.
template <int D, int BN>
__device__ __forceinline__ void split_k_vt(const float* kraw, float* khi, float* klo,
                                           const float* vraw, float* vhi, float* vlo, int tid,
                                           int n, int key0 = 0) {
  const float4* r4 = reinterpret_cast<const float4*>(kraw);
  float4* h4 = reinterpret_cast<float4*>(khi);
  float4* l4 = reinterpret_cast<float4*>(klo);
  for (int u = tid; u < f32_panels(D) * BN * 4; u += n) {
    const int a0 = 2 * u + ((u >> 2) & 1);
    const float4 x = r4[a0], y = r4[a0 ^ 1];
    split_unit(h4, l4, u, x, y);
  }
  const unsigned char* vr = reinterpret_cast<const unsigned char*>(vraw);
  unsigned char* vh = reinterpret_cast<unsigned char*>(vhi);
  unsigned char* vl = reinterpret_cast<unsigned char*>(vlo);
  for (int e = tid; e < BN * (D / 4); e += n) {
    const int key = e % BN, c = 4 * (e / BN);
    const float4 x = *reinterpret_cast<const float4*>(vr + f32_off(key, c, BN * 128));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t hi, lo;
      split_tf32(xs[i], hi, lo);
      const uint32_t off = f32_off(c + i, key0 + perm8(key), 0);
      *reinterpret_cast<uint32_t*>(vh + off) = hi;
      *reinterpret_cast<uint32_t*>(vl + off) = lo;
    }
  }
}

// The split ring of the TF32 kernels that keep P in registers
// (flash_fwd_tf32_hopper.cu at D_pad 192 / 256,
// ragged_paged_attention_tf32_hopper.cu): KS stages of a key tile of kBN
// keys (tf32_key_tile: 32, 16 past D_pad 128). K's halves [kBN][D] in
// 32-column panels, one pair a stage; V^T's [D][32 keys] in rows of 128
// bytes (the SW128 K-major B that desc_kmajor reads): one pair a stage at
// kBN 32, and at kBN 16 one pair for two stages, stage s in keys 16 (s % 2)
// .. + 15 of every row (a tile of 16 keys would fill half a swizzled row).
// The split of stage s then writes bytes that the products of the other
// stage never read.
template <int D, int KS>
struct SplitRing {
  static constexpr int kBN = tf32_key_tile(D);
  static constexpr int kVt = KS * kBN / 32;  // V^T buffers
  float khi[KS][D / 32][kBN * 32], klo[KS][D / 32][kBN * 32];
  float vhi[kVt][D * 32], vlo[kVt][D * 32];
  __device__ __forceinline__ float* vt_hi(int st) { return vhi[st * kBN / 32]; }
  __device__ __forceinline__ float* vt_lo(int st) { return vlo[st * kBN / 32]; }
  // the first V^T column (key) of stage st
  __device__ __forceinline__ static int vt_key0(int st) { return st * kBN % 32; }
  // threads [0, n) of the caller split a landed fp32 tile into stage st
  __device__ __forceinline__ void split(int st, const float* kraw, const float* vraw, int tid,
                                        int n) {
    split_k_vt<D, kBN>(kraw, khi[st][0], klo[st][0], vraw, vt_hi(st), vt_lo(st), tid, n,
                       vt_key0(st));
  }
};

// The landed ring's stages of a kernel whose split ring is apart
// (SplitRing): two where two landed stages of K and V (`land` bytes each a
// tile) fit beside `fixed` bytes (the raw Q and the split ring) and 2 KB of
// barriers, slots and scales in the 227 KB a block may hold, else one (fp32
// at D_pad 256).
__host__ __device__ constexpr int landed_stages(size_t fixed, size_t land) {
  return fixed + 4 * land + 2048 <= 232448 ? 2 : 1;
}

// Generic-proxy writes to shared memory visible to the wgmma (async proxy)
// reads that a barrier orders after them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A named barrier over one warpgroup's 128 threads (ids 1 and 2 of the
// TF32 kernels; the 16-bit ones pair two warpgroups on named_sync).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// m64nNk8, fp32 accumulate, TF32 A from registers, B K-major in shared
// memory. scale_d = 0 overwrites the accumulator.
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "m64nNk8 for N in {16, 32, 64}");
  if constexpr (N == 16)
    wgmma_tf32_n16(d, a, db, scale_d);
  else if constexpr (N == 32)
    wgmma_tf32_n32(d, a, db, scale_d);
  else
    wgmma_tf32_n64(d, a, db, scale_d);
}

template <int M, int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) reg_fence(r[i]);
}
template <int M, int N>
__device__ __forceinline__ void reg_fence(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) reg_fence(r[i]);
}

// The split A fragment of key step kk of the warpgroup's 64 rows of a raw
// fp32 tile (`panel` bytes a panel): rows 16 w + l / 4 and + 8, columns
// 8 kk + 2 (l % 4) and + 1 (one 8-byte load a row; see the section head).
__device__ __forceinline__ void frag_raw(const unsigned char* tile, uint32_t panel, int kk,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = 16 * (t / 32) + lane / 4, c = 8 * kk + 2 * (lane % 4);
  const float2 x0 = *reinterpret_cast<const float2*>(tile + f32_off(r, c, panel));
  const float2 x1 = *reinterpret_cast<const float2*>(tile + f32_off(r + 8, c, panel));
  split_tf32(x0.x, hi[0], lo[0]);
  split_tf32(x1.x, hi[1], lo[1]);
  split_tf32(x0.y, hi[2], lo[2]);
  split_tf32(x1.y, hi[3], lo[3]);
}

// The A fragment of X^T, rows (head columns) 64 mb + 16 w + l / 4 and + 8,
// from a split [rows][D_pad] tile (hi / lo halves, perm8 order): contraction
// index l % 4 is X's row 8 kk + 2 (l % 4), and l % 4 + 4 the row after it.
// The rows' swizzle (r % 8 = 2 (l % 4)) then puts the warp's 32 reads on 32
// banks; with rows 8 kk + l % 4 and + 4 two quads shared 16-byte chunks,
// two reads a bank. The B it is read against holds its 8 columns in the same
// order (frag_pair_off).
__device__ __forceinline__ void frag_t(const unsigned char* xhi, const unsigned char* xlo,
                                       uint32_t panel, int mb, int kk, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int d = 64 * mb + 16 * (t / 32) + lane / 4, r = 8 * kk + 2 * (lane % 4);
  const uint32_t off[4] = {f32_off(r, perm8(d), panel), f32_off(r, perm8(d + 8), panel),
                           f32_off(r + 1, perm8(d), panel), f32_off(r + 1, perm8(d + 8), panel)};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    hi[c] = *reinterpret_cast<const uint32_t*>(xhi + off[c]);
    lo[c] = *reinterpret_cast<const uint32_t*>(xlo + off[c]);
  }
}

// Accumulation. The tensor cores add each product into the fp32
// accumulator with truncation, so the error of a long chain of wgmma into
// one accumulator grows with its length (measured on the card: dk over 16
// query tiles into one accumulator, 192 additions, came out 6e-6 off the
// plain fp32 backward on its worst tile, against 3e-7 for the FP32-pipe
// kernel). So no chain here is longer than one tile: the small products
// (a_lo b_hi, a_hi b_lo) go to an accumulator of their own, the large ones
// to two that take the key steps in turns, and each tile's dq^T / dk^T / dv^T
// is summed into a fresh accumulator and added to the running sum by the
// threads in fp32.

// acc (64 x N) = A B^T over D columns: A the warpgroup's 64 rows of the raw
// tile `a_tile` (frag_raw), B the split tile at (bhi, blo) of N rows. Issued
// G key steps at a time (4: a panel), NB groups' fragments in flight (two:
// a group is split under the previous one's products; one where 128
// registers of dk^T sit beside them, the D_pad 256 dK/dV); the small
// products into `sm`, the large ones of even and odd key steps into acc and
// `lg`, summed at the end. G 2 at D_pad 192 / 256, where 128 registers of
// output sit beside the fragments (32 of them, not 64).
template <int N, int D, int G = (D > 128 ? 2 : 4), int NB = 2>
__device__ __forceinline__ void gemm_raw(float (&acc)[N / 2], const unsigned char* a_tile,
                                         uint32_t a_panel, uint32_t bhi, uint32_t blo,
                                         uint32_t b_panel) {
  static_assert(G % 2 == 0 && D % (8 * G) == 0, "whole groups of an even count of key steps");
  uint32_t hi[NB][G][4], lo[NB][G][4];
  float sm[N / 2], lg[N / 2];
#pragma unroll
  for (int p = 0; p < D / (8 * G); ++p) {
    const int buf = p % NB;
    if (p >= NB) {
      wgmma_wait<NB - 1>();
      reg_fence(hi[buf]);
      reg_fence(lo[buf]);
    }
#pragma unroll
    for (int s = 0; s < G; ++s) frag_raw(a_tile, a_panel, G * p + s, hi[buf][s], lo[buf][s]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const int kk = G * p + s;
      const uint64_t dh = desc_kmajor(bhi, b_panel, kk), dl = desc_kmajor(blo, b_panel, kk);
      wgmma_tf32<N>(sm, lo[buf][s], dh, kk > 0 ? 1 : 0);
      wgmma_tf32<N>(sm, hi[buf][s], dl, 1);
      if (s & 1)
        wgmma_tf32<N>(lg, hi[buf][s], dh, kk > 1 ? 1 : 0);
      else
        wgmma_tf32<N>(acc, hi[buf][s], dh, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(sm);
  reg_fence(lg);
  reg_fence(hi);
  reg_fence(lo);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += lg[i] + sm[i];
}

// The probabilities of a key tile (the S accumulator fragment, BN keys)
// split into the register A fragments of O += P V: key step kk's are
// registers 4 kk .. 4 kk + 3 (contraction index l % 4: column 8 kk + 2 (l %
// 4), rows i = 0, 1; l % 4 + 4: the column after it), which V^T's perm8
// keys match.
template <int BN>
__device__ __forceinline__ void split_p(const float (&s)[BN / 2], uint32_t (&phi)[BN / 8][4],
                                        uint32_t (&plo)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    split_tf32(s[4 * kk], phi[kk][0], plo[kk][0]);
    split_tf32(s[4 * kk + 2], phi[kk][1], plo[kk][1]);
    split_tf32(s[4 * kk + 1], phi[kk][2], plo[kk][2]);
    split_tf32(s[4 * kk + 3], phi[kk][3], plo[kk][3]);
  }
}

// The products of one group of 64 head columns (rows 64 mb .. of V^T) into
// a fresh accumulator: the small ones first, then the large ones.
template <int KS>
__device__ __forceinline__ void pv_group(float (&part)[32], const uint32_t (&phi)[KS][4],
                                         const uint32_t (&plo)[KS][4], uint32_t vhi, uint32_t vlo,
                                         int kk0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_tf32<64>(part, plo[kk], desc_kmajor(vhi, 0, kk0 + kk), kk > 0 ? 1 : 0);
    wgmma_tf32<64>(part, phi[kk], desc_kmajor(vlo, 0, kk0 + kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_tf32<64>(part, phi[kk], desc_kmajor(vhi, 0, kk0 + kk), 1);
}

// The fresh accumulators pv_tile takes: one a group of 64 head columns up
// to D_pad 128, two in flight above.
__host__ __device__ constexpr int pv_accs(int d_pad) { return d_pad / 64 < 2 ? d_pad / 64 : 2; }

// o (64 x D, the running output) += P V over a key tile of KS key steps: P
// the split fragments (split_p), V^T split at vhi / vlo ([D][32 keys],
// SplitRing), the tile's keys from key step kk0 of its rows. Each group of
// 64 head columns into a fresh accumulator of `part` that the threads add
// to o in fp32 (no chain longer than one tile: "Accumulation"). Up to D_pad
// 128 every group in one commit; above it two groups in flight, so that 64
// registers of accumulators, not 128, sit beside o's 128. `part` is the
// caller's: declared in this inlined body instead, the same code spilled
// 20-76 bytes in each D_pad 128 instance of the fp32 forward's consumer
// (216 registers).
template <int D, int KS>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2], float (&part)[pv_accs(D)][32],
                                        uint32_t (&phi)[KS][4], uint32_t (&plo)[KS][4],
                                        uint32_t vhi, uint32_t vlo, int kk0) {
  constexpr int M = D / 64;
  constexpr uint32_t kGroup = 64 * 128;  // 64 rows of V^T
  if constexpr (M <= 2) {
    wgmma_fence();
#pragma unroll
    for (int mb = 0; mb < M; ++mb)
      pv_group<KS>(part[mb], phi, plo, vhi + mb * kGroup, vlo + mb * kGroup, kk0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(phi);
    reg_fence(plo);
#pragma unroll
    for (int mb = 0; mb < M; ++mb)
#pragma unroll
      for (int c = 0; c < 32; ++c) o[32 * mb + c] += part[mb][c];
  } else {
    wgmma_fence();
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      pv_group<KS>(part[mb], phi, plo, vhi + mb * kGroup, vlo + mb * kGroup, kk0);
      wgmma_commit();
    }
#pragma unroll
    for (int mb = 0; mb < M; ++mb) {
      if (mb + 1 < M)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      reg_fence(part[mb & 1]);
#pragma unroll
      for (int c = 0; c < 32; ++c) o[32 * mb + c] += part[mb & 1][c];
      if (mb + 2 < M) {
        wgmma_fence();
        pv_group<KS>(part[mb & 1], phi, plo, vhi + (mb + 2) * kGroup, vlo + (mb + 2) * kGroup,
                     kk0);
        wgmma_commit();
      }
    }
    reg_fence(phi);
    reg_fence(plo);
  }
}

// The products of one 64-row block mb of X^T B (gemm_t_wide): its A fragments
// read from X's split halves (frag_t), then the small products and the large
// ones into the fresh accumulator `part`, committed as one group.
template <int N, int KS>
__device__ __forceinline__ void t_block(float (&part)[N / 2], uint32_t (&hi)[KS][4],
                                        uint32_t (&lo)[KS][4], const unsigned char* xhi,
                                        const unsigned char* xlo, uint32_t x_panel, int mb,
                                        uint32_t bhi, uint32_t blo) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) frag_t(xhi, xlo, x_panel, mb, kk, hi[kk], lo[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_tf32<N>(part, lo[kk], desc_kmajor(bhi, 0, kk), kk > 0 ? 1 : 0);
    wgmma_tf32<N>(part, hi[kk], desc_kmajor(blo, 0, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_tf32<N>(part, hi[kk], desc_kmajor(bhi, 0, kk), 1);
  wgmma_commit();
}

// run[mb] (rows 64 mb .. of X^T, 64 x N) += X^T B over X's 32 rows: X the
// split tile (xhi, xlo) of 32 rows x D (frag_t), B the split [N][32] tile at
// (bhi, blo) that the caller wrote (one panel). Each 64-row block into a
// fresh accumulator, the small products first, then the large ones; the
// threads add them to run. Every block in one commit (D_pad <= 128;
// gemm_t_wide above).
template <int N, int D>
__device__ __forceinline__ void gemm_t(float (&run)[D / 64][N / 2], const unsigned char* xhi,
                                       const unsigned char* xlo, uint32_t x_panel, uint32_t bhi,
                                       uint32_t blo) {
  constexpr int M = D / 64;
  uint32_t hi[M][4][4], lo[M][4][4];
  float part[M][N / 2];
#pragma unroll
  for (int mb = 0; mb < M; ++mb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag_t(xhi, xlo, x_panel, mb, kk, hi[mb][kk], lo[mb][kk]);
  wgmma_fence();
#pragma unroll
  for (int mb = 0; mb < M; ++mb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32<N>(part[mb], lo[mb][kk], desc_kmajor(bhi, 0, kk), kk > 0 ? 1 : 0);
      wgmma_tf32<N>(part[mb], hi[mb][kk], desc_kmajor(blo, 0, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32<N>(part[mb], hi[mb][kk], desc_kmajor(bhi, 0, kk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(part);
  reg_fence(hi);
  reg_fence(lo);
#pragma unroll
  for (int mb = 0; mb < M; ++mb)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) run[mb][i] += part[mb][i];
}

// gemm_t at D_pad 192 / 256, over X's 8 KS rows (16 or 32; B's first 8 KS
// columns), where run takes 96 or 128 registers a thread (dk^T, dv^T) or 48
// / 64 (dq^T): F blocks in flight (1 or 2), each into a fresh accumulator of
// `part`, which the caller declares (as pv_tile's), and block mb + F issued
// once block mb is summed into run.
template <int N, int D, int KS, int F>
__device__ __forceinline__ void gemm_t_wide(float (&run)[D / 64][N / 2], float (&part)[F][N / 2],
                                            const unsigned char* xhi, const unsigned char* xlo,
                                            uint32_t x_panel, uint32_t bhi, uint32_t blo) {
  constexpr int M = D / 64;
  static_assert(F == 1 || F == 2, "one or two blocks in flight");
  uint32_t hi[F][KS][4], lo[F][KS][4];
#pragma unroll
  for (int f = 0; f < F; ++f) t_block<N, KS>(part[f], hi[f], lo[f], xhi, xlo, x_panel, f, bhi, blo);
#pragma unroll
  for (int mb = 0; mb < M; ++mb) {
    const int f = mb % F;
    if (F == 2 && mb + 1 < M)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    reg_fence(part[f]);
    reg_fence(hi[f]);
    reg_fence(lo[f]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) run[mb][i] += part[f][i];
    if (mb + F < M)
      t_block<N, KS>(part[f], hi[f], lo[f], xhi, xlo, x_panel, mb + F, bhi, blo);
  }
}

// The byte offset, in a [64][32] tile written for frag_t's products, of this
// thread's accumulator element (row 16 w + l / 4 + 8 i, column 8 j + 2 (l %
// 4)), kept in perm8 order: at column 8 j + l % 4. Its neighbour (column + 1)
// sits at column 8 j + l % 4 + 4, the other 16-byte chunk of the group: at
// the offset ^ 16.
// The thread index is read through a volatile asm: both consumer warpgroups
// form these offsets, and read plainly the compiler formed them once, above
// the warpgroups' setmaxnreg, and spilled them across it (4 bytes in the
// D_pad 64 dK/dV instances).
__device__ __forceinline__ uint32_t frag_pair_off(int i, int j) {
  uint32_t tid;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  const int t = static_cast<int>(tid % 128), lane = t % 32;
  return f32_off(16 * (t / 32) + lane / 4 + 8 * i, 8 * j + lane % 4, 0);
}

__device__ __forceinline__ void store_pair(unsigned char* tile, uint32_t off, float x0, float x1) {
  *reinterpret_cast<float*>(tile + off) = x0;
  *reinterpret_cast<float*>(tile + (off ^ 16)) = x1;
}

__device__ __forceinline__ float2 load_pair(const unsigned char* tile, uint32_t off) {
  return make_float2(*reinterpret_cast<const float*>(tile + off),
                     *reinterpret_cast<const float*>(tile + (off ^ 16)));
}

// The pair (x0, x1) split into the [64][32] tiles at hi and lo at `off`.
__device__ __forceinline__ void store_split_pair(unsigned char* hi, unsigned char* lo, uint32_t off,
                                                 float x0, float x1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(x0, h0, l0);
  split_tf32(x1, h1, l1);
  store_pair(hi, off, __uint_as_float(h0), __uint_as_float(h1));
  store_pair(lo, off, __uint_as_float(l0), __uint_as_float(l1));
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

// A 4-D tensor map over a [B, S, H, D] view of 16-bit or fp32 elements
// (dims innermost first: D, S, H, B, with the view's own byte strides),
// boxes of one 128-byte row of columns (64 16-bit, 32 fp32) x `rows` rows of
// one (batch, head), 128-byte swizzle. The true D and S are the extents, so
// TMA fills the columns past D and the rows past S with zeros. A dim of
// extent 1 gets a stride of its own (any is read the same); the wrapper
// copies a view that broadcasts a longer dim (stride 0).
inline int encode_view(CUtensorMap* map, const void* base, const View& v, int B, int S, int H,
                       int D, int dtype, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrTensorMap;
  const int isz = dtype == kF32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S > 0 ? S : 1),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const long long el[3] = {v.s, v.h, v.b};
  cuuint64_t strides[3];
  cuuint64_t packed = static_cast<cuuint64_t>((D * isz + 15) / 16 * 16);
  for (int i = 0; i < 3; ++i) {
    const long long s = el[i] * isz;
    if (dims[i + 1] == 1) {
      strides[i] = packed;
    } else {
      if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
      strides[i] = static_cast<cuuint64_t>(s);
    }
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / isz), static_cast<cuuint32_t>(rows), 1,
                             1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType ty = dtype == kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r =
      fn(map, ty, 4,
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
