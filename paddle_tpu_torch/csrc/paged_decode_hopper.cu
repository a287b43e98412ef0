// Decode-only paged attention for Hopper, redesigned for sm_90a: the kernel
// for fp32, bf16 and fp16 queries over pools of their dtype with a head dim
// that is whole 16-byte words (D % 8 == 0 in 16 bits, D % 4 == 0 in fp32;
// D <= 256), pools 16-byte aligned, and a page of at most 128 keys.
// paged_decode_attention.cu's entry hands it those calls; the others (odd
// head dims, misaligned pools, larger pages) keep the kernel there
// (ptt_paged_decode_plan reports the route).
//
// Replaces paddle_tpu/kernels/pallas/paged_attention.py
// `paged_decode_attention` (kernel body `_decode_kernel`) for those calls:
// one query token per row, q [B, H_q, D] with batch and head strides, over
// the head-major pool [H_kv, NB, bs, D] through block_tables [B, nb]; keys
// 0 .. seq_len - 1 of the row's table pages (never past the table's nb
// pages); fp32 softmax and accumulation; seq_len 0 gives zeros; GQA, the g
// query heads of a kv head sharing its pages.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. A row reads its used K / V pages
// once and does 4 D FLOPs a (query head, key), about one FLOP a byte at
// g = 1. At the serving decode batch (B 8, H 16/16, D 128, bs 32, lens
// 100-640, bf16) the pages are ~25 MB: ~0.0074 ms.
//
// Design (each point answers a cause the first kernel's note named):
// - More blocks and more bytes in flight. A block owns one split of one
//   (row, kv head, chunk of RB query rows of the group): the row's used
//   pages are cut into contiguous ranges of `per_split` pages (from the
//   table width; the host picks the split count from B x H_kv x chunks and
//   nb, see auto_splits), so a short grid of long rows fills the SMs.
//   A block of 160 threads is one producer warp and four consumer warps;
//   at most ~100 KB of shared memory (66 KB at the serving shape) lets two
//   or three blocks share an SM; a grid smaller than the SMs takes a ring
//   twice as deep. In fp32 a page's K and V take twice the bytes: at the
//   serving shape four stages of 32 KB, one block an SM.
// - Pages in their own dtype, loaded asynchronously. A page of one kv head
//   is one contiguous [bs, D] slab, so one 1-D bulk copy (cp.async.bulk, no
//   tensor map) carries it. The producer lane reads block_tables[b, j]
//   itself and keeps up to `stages` pages (K and V; 4 or 8, a multiple of
//   the consumer warps) in a ring of full / empty mbarriers; no fp32 copy of
//   a 16-bit page reaches shared memory. Page i of the split goes to stage
//   i % stages and consumer warp i % 4, so a stage always feeds one warp: the
//   four warps take different pages, each with its own (m, l, acc), merged
//   in shared memory at the end in warp order.
// - A page whose K and V do not fit four stages within kRingMax (fp32 at D
//   256, or pages of 64 keys and more at D 128 in fp32, of 128 keys at D
//   256 in 16 bits) is carried in parts: a stage holds `sub` = bs / 2^n of
//   its keys (rows sub x part .. of the slab, contiguous again, one bulk
//   copy each for K and V), and the ring walks the split's parts as it
//   walks pages. A part holds at least 16 keys (half the warp's lanes busy
//   in q . k at the least).
// - The products on all 32 lanes, fp32 FFMA on the CUDA cores whatever the
//   dtype (no TF32: fp32 pools give the reference's fp32 products). q . k: a
//   lane per key (keys lane + 32 t), reading its key's row in 16-byte words
//   (8 columns in 16 bits, 4 in fp32), the word order rotated by the lane so
//   that a quarter-warp's words sit in distinct banks; q sits in shared
//   memory in fp32, pre-scaled by scale * log2(e), 4 columns a float4 and
//   laid out by k's words (16 bits: the word's two halves in two arrays; fp32:
//   one) so that a quarter-warp reads 8 adjacent float4 too. Two FMA chains
//   a row (a word's halves, or its even and odd columns in fp32). The
//   softmax runs across the warp by shuffles (max) with the sum kept per
//   lane until the end; p . v: each lane owns D_pad / 32 adjacent columns of
//   every row, p broadcast from shared memory.
// - GQA: the group's rows ride one block, RB (1, 2, 4 or 8) at a time; a
//   group wider than 8 rows takes ceil(g / 8) chunks, each over the same
//   pages (L2 serves the repeats).
// - The merge of the splits: in the same launch. Each split writes its
//   rows' unnormalized O, m and l to fp32 scratch, and the last split of a
//   (row, kv head, chunk) to finish (an atomic ticket, set back to 0 by
//   it) merges them in split order. The order of every sum is fixed, so two
//   calls give the same bits. A row with one split that holds pages writes
//   its output directly.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 10; PERF.md):
// the serving decode batch in 0.0219 ms unsplit (0.0237 at 3 splits)
// against the first kernel's 0.1158-0.1166 in the same call, SDPA on
// pre-gathered pages 0.0354 and the ragged kernel on the same batch
// 0.0246. What sets the time there is not a block's page chain (1 to 8
// splits read 0.0219-0.0271 ms) but moving the 25 MB at ~1.5-2 TB/s, as
// the ragged kernel does (its decode over 64 keys a row takes 0.0111 ms
// for 0.0013 of bytes). Splits pay where the grid is short: one row of
// 8192 keys under GQA 16/4 (4 blocks unsplit) runs 7x faster at 16
// splits. With 6 stages for 4 warps (a stage shared by two warps) a warp
// read pages that had not arrived once the loads ran slow: hence stages a
// multiple of the warps. fp32 at the serving decode batch (4 stages of
// whole pages, one split; kernels_ab.py, the same call): 0.0331 / 0.0328
// ms against the fp32-tiles kernel's 0.2491 / 0.2497, bound 0.0148.

#include <algorithm>
#include <type_traits>

#include "dtypes.cuh"
#include "flash_hopper.cuh"

namespace ptt_paged_hopper {
namespace {

namespace hw = ptt_flash::hopper;
using ptt::from_f32;
using ptt::to_f32;

constexpr int kWarps = 4;                   // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // and the producer warp
constexpr int kMaxStages = 2 * kWarps;
constexpr int kMaxSplits = 16;
constexpr int kMaxKeySlots = 4;             // keys lane + 32 t: bs <= 128
constexpr int kRingBudget = 96 * 1024;      // two blocks an SM
constexpr int kRingMax = 200 * 1024;        // at least kWarps stages
constexpr int kMinPagesPerSplit = 2;
constexpr int kMinPartKeys = 16;            // a page carried in parts: keys a part
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct DecodeArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* lens;
  void* out;
  float* part;        // [B, H_kv, chunks, splits, RB, D + 2]: O, then m, l
  unsigned* tickets;  // [B, H_kv, chunks], 0 between calls
  long long q_sb, q_sh;
  int B, Hq, Hkv, NB, bs, D, nb, g, rb, chunks, splits, per_split, stages;
  int sub;  // keys a stage carries: the page (bs) or a part of it
  float scale_log2;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// floats a consumer warp's region holds: p of its stage's keys, then its
// (acc, m, l) for the merge
__host__ __device__ inline int warp_floats(int bs, int D) { return round4(bs > D + 2 ? bs : D + 2); }

struct Layout {
  int part_bytes, ring, q, warp;  // K (or V) bytes a stage; offsets: ring, q, the warps' regions
  int total;
};

// sub: the keys a stage carries
__host__ __device__ inline Layout layout(int sub, int D, int rb, int stages, int elem) {
  Layout l{};
  l.part_bytes = sub * D * elem;
  l.ring = 256;  // the mbarriers (128 bytes) and a flag first
  l.q = l.ring + stages * 2 * l.part_bytes;
  l.warp = l.q + rb * D * 4;
  l.total = l.warp + kWarps * rb * warp_floats(sub, D) * 4;
  return l;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(hw::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(hw::smem_u32(bar))
      : "memory");
}

// The consumer warps alone (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CPL adjacent values at `p` (16-bit: 4, 8 or 16 bytes; fp32: 8, 16 or 32)
// in fp32
template <typename T, int CPL>
__device__ __forceinline__ void load_cols(const T* p, float (&f)[CPL]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (CPL == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      f[0] = v.x;
      f[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < CPL / 4; ++i) {
        const float4 v = reinterpret_cast<const float4*>(p)[i];
        f[4 * i] = v.x; f[4 * i + 1] = v.y; f[4 * i + 2] = v.z; f[4 * i + 3] = v.w;
      }
    }
  } else if constexpr (CPL == 2) {
    const float2 v = hw::unpack2<T>(*reinterpret_cast<const uint32_t*>(p));
    f[0] = v.x;
    f[1] = v.y;
  } else if constexpr (CPL == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 a = hw::unpack2<T>(w.x), b = hw::unpack2<T>(w.y);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = hw::unpack2<T>(u[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
}

// Two blocks an SM where the ring lets them share one; at D_pad 256, where
// four stages take 128 KB (whole pages of 32 keys in 16 bits, parts of 16
// keys in fp32) and a block has the SM to itself, the registers of one
// (the 8-row instances spilled 68-104 bytes a thread under the two-block
// bound).
template <typename T, int RB, int DP>
__global__ void __launch_bounds__(kThreads, DP > 128 ? 1 : 2)
    paged_decode_hopper_kernel(const DecodeArgs a) {
  constexpr int CPL = DP / 32;  // columns a lane owns in p . v
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kWordCols = 16 / sizeof(T);  // columns a 16-byte word of k holds
  const int split = blockIdx.x % a.splits, chunk = blockIdx.x / a.splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int len = a.lens[b];
  const int n_pages = len <= 0 ? 0 : min((len + a.bs - 1) / a.bs, a.nb);
  const int key_end = min(len, a.nb * a.bs);
  const int p0 = split * a.per_split, p1 = min(p0 + a.per_split, n_pages);
  const int n_active = (n_pages + a.per_split - 1) / a.per_split;  // splits that hold pages
  const int row0 = chunk * RB, rows = min(RB, a.g - row0);
  const int D = a.D, NC = D / kWordCols;
  T* out = static_cast<T*>(a.out);
  const long long out_row0 = (static_cast<long long>(b) * a.Hq + h * a.g + row0) * D;

  if (p1 <= p0) {
    // no page for this split; an empty row's zeros come from split 0
    if (split == 0 && n_pages == 0)
      for (int e = threadIdx.x; e < rows * D; e += kThreads) out[out_row0 + e] = from_f32<T>(0.f);
    return;
  }
  // the split's stages: its pages, or their parts of `sub` keys up to its
  // last live key
  const int sub = a.sub, nsub = a.bs / sub;
  const int n = (min(key_end, p1 * a.bs) - p0 * a.bs + sub - 1) / sub;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(sub, D, RB, a.stages, sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* last_flag = reinterpret_cast<int*>(empty + kMaxStages);
  unsigned char* ring = smem + L.ring;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  const int wf = warp_floats(sub, D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < a.stages; ++st) {
      hw::mbar_init(&full[st], 1);
      hw::mbar_init(&empty[st], 1);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // producer: one lane walks the split's pages (or their parts) through
    // the ring
    if (lane != 0) return;
    const int* table = a.tables + static_cast<long long>(b) * a.nb;
    const size_t head = static_cast<size_t>(h) * a.NB;
    const size_t page_elems = static_cast<size_t>(a.bs) * D;
    const T* kp = static_cast<const T*>(a.k_pool);
    const T* vp = static_cast<const T*>(a.v_pool);
    for (int i = 0; i < n; ++i) {
      const int st = i % a.stages;
      hw::mbar_wait(&empty[st], ((i / a.stages) & 1) ^ 1);
      const size_t off = (head + table[p0 + i / nsub]) * page_elems +
                         static_cast<size_t>(i % nsub) * sub * D;
      unsigned char* dst = ring + st * 2 * L.part_bytes;
      hw::mbar_arrive_tx(&full[st], 2 * L.part_bytes);
      bulk_load(dst, kp + off, L.part_bytes, &full[st]);
      bulk_load(dst + L.part_bytes, vp + off, L.part_bytes, &full[st]);
    }
    return;
  }

  // consumers: q's rows in fp32, pre-scaled, 4 columns a float4 by the
  // 16-byte words of k: in 16 bits the word's two halves in two arrays,
  // qs[((r * 2 + half) * NC + word) * 4 + j]; in fp32 qs[(r * NC + word) * 4
  // + j], the row as it is
  {
    const T* q = static_cast<const T*>(a.q);
    for (int e = threadIdx.x; e < RB * D; e += 32 * kWarps) {
      const int r = e / D, d = e % D;
      const float v = r < rows ? to_f32(q[b * a.q_sb + (h * a.g + row0 + r) * a.q_sh + d]) *
                                     a.scale_log2
                               : 0.f;
      qs[kF32 ? e : ((r * 2 + (d % 8) / 4) * NC + d / 8) * 4 + d % 4] = v;
    }
    consumer_sync();
  }
  const float4* q4 = reinterpret_cast<const float4*>(qs);

  float acc[RB][CPL], m[RB], lsum[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    lsum[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  }
  float* mine = reinterpret_cast<float*>(smem + L.warp) + warp * RB * wf;
  const int slots = (sub + 31) / 32;
  const int col0 = lane * CPL;
  const int start = lane % NC;  // this lane's first word of a key row

  for (int i = warp; i < n; i += kWarps) {
    const int st = i % a.stages;
    hw::mbar_wait(&full[st], (i / a.stages) & 1);
    const T* ks = reinterpret_cast<const T*>(ring + st * 2 * L.part_bytes);
    const T* vs = ks + sub * D;
    const int nk = min(sub, key_end - p0 * a.bs - i * sub);  // live keys of the stage (>= 1)

    // s = q . k for key lane + 32 t
    float s[kMaxKeySlots][RB];
#pragma unroll
    for (int t = 0; t < kMaxKeySlots; ++t) {
      const int key = lane + 32 * t;
#pragma unroll
      for (int r = 0; r < RB; ++r) s[t][r] = 0.f;
      if (t < slots && key < nk) {
        float s2[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) s2[r] = 0.f;
        const uint4* krow = reinterpret_cast<const uint4*>(ks + key * D);
        int w = start;
        for (int c = 0; c < NC; ++c) {
          const uint4 kw = krow[w];
          if constexpr (kF32) {
            const float4 k4 = *reinterpret_cast<const float4*>(&kw);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              // two independent chains: the word's even and odd columns
              const float4 qa = q4[r * NC + w];
              float d = s[t][r], e = s2[r];
              d = fmaf(qa.x, k4.x, d);
              e = fmaf(qa.y, k4.y, e);
              d = fmaf(qa.z, k4.z, d);
              e = fmaf(qa.w, k4.w, e);
              s[t][r] = d;
              s2[r] = e;
            }
          } else {
            const float2 k0 = hw::unpack2<T>(kw.x), k1 = hw::unpack2<T>(kw.y);
            const float2 k2 = hw::unpack2<T>(kw.z), k3 = hw::unpack2<T>(kw.w);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              // two independent chains: the word's low and high halves
              const float4 qa = q4[(r * 2) * NC + w], qb = q4[(r * 2 + 1) * NC + w];
              float d = s[t][r], e = s2[r];
              d = fmaf(qa.x, k0.x, d);
              e = fmaf(qb.x, k2.x, e);
              d = fmaf(qa.y, k0.y, d);
              e = fmaf(qb.y, k2.y, e);
              d = fmaf(qa.z, k1.x, d);
              e = fmaf(qb.z, k3.x, e);
              d = fmaf(qa.w, k1.y, d);
              e = fmaf(qb.w, k3.y, e);
              s[t][r] = d;
              s2[r] = e;
            }
          }
          if (++w == NC) w = 0;
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) s[t][r] += s2[r];
      }
    }

    // online softmax in log2 units, a row's max across the warp; p into
    // this warp's region, the sum kept per lane
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kMaxKeySlots; ++t)
        if (t < slots && lane + 32 * t < nk) mx = fmaxf(mx, s[t][r]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxKeySlots; ++t) {
        const int key = lane + 32 * t;
        if (t < slots && key < sub) {
          const float p = key < nk ? exp2f(s[t][r] - m_new) : 0.f;
          sum += p;
          mine[r * wf + key] = p;
        }
      }
      lsum[r] = lsum[r] * alpha + sum;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc += p . v over the live keys, CPL columns a lane
    if (col0 < D) {
      const T* vcol = vs + col0;
#pragma unroll 4
      for (int k = 0; k < nk; ++k) {
        float v[CPL];
        load_cols<T, CPL>(vcol + k * D, v);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float p = mine[r * wf + k];
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[r][c] = fmaf(p, v[c], acc[r][c]);
        }
      }
    }
    __syncwarp();  // the stage and p are read: free the stage
    if (lane == 0) hw::mbar_arrive(&empty[st]);
  }

  // the warp's state into its region: acc [RB][D], then m, l at D, D + 1
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const float l = warp_sum(lsum[r]);
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (col0 + c < D) mine[r * wf + col0 + c] = acc[r][c];
    if (lane == 0) {
      mine[r * wf + D] = m[r];
      mine[r * wf + D + 1] = l;
    }
  }
  consumer_sync();

  // merge the warps in warp order: O = sum_w acc_w 2^(m_w - M), L likewise
  const float* regions = reinterpret_cast<const float*>(smem + L.warp);
  const bool alone = n_active == 1;
  const long long blk =
      ((static_cast<long long>(b) * a.Hkv + h) * a.chunks + chunk) * a.splits + split;
  float* part = a.part + blk * RB * (D + 2);
  for (int e = threadIdx.x; e < rows * D; e += 32 * kWarps) {
    const int r = e / D, d = e % D;
    float mw[kWarps], M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = regions[(w * RB + r) * wf + D];
      M = fmaxf(M, mw[w]);
    }
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(mw[w] - M);
      o += regions[(w * RB + r) * wf + d] * f;
      l += regions[(w * RB + r) * wf + D + 1] * f;
    }
    if (alone) {
      out[out_row0 + e] = from_f32<T>(o / l);
    } else {
      part[r * (D + 2) + d] = o;
      if (d == 0) {
        part[r * (D + 2) + D] = M;
        part[r * (D + 2) + D + 1] = l;
      }
    }
  }
  if (alone) return;

  // the last split of this (row, kv head, chunk) to finish merges them all
  __threadfence();
  consumer_sync();
  unsigned* ticket = a.tickets + (static_cast<long long>(b) * a.Hkv + h) * a.chunks + chunk;
  if (threadIdx.x == 0) *last_flag = atomicAdd(ticket, 1u) == static_cast<unsigned>(n_active - 1);
  consumer_sync();
  if (!*last_flag) return;
  __threadfence();
  const float* part0 = a.part + (blk - split) * RB * (D + 2);
  float* wts = reinterpret_cast<float*>(smem + L.warp);  // [RB][kMaxSplits]
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float M = kNegInf, l = 0.f;
    for (int sp = 0; sp < n_active; ++sp)
      M = fmaxf(M, __ldcg(part0 + (sp * RB + r) * (D + 2) + D));
    for (int sp = 0; sp < n_active; ++sp) {
      const float* ps = part0 + (sp * RB + r) * (D + 2);
      const float f = exp2f(__ldcg(ps + D) - M);
      wts[r * kMaxSplits + sp] = f;
      l += __ldcg(ps + D + 1) * f;
    }
    for (int sp = 0; sp < n_active; ++sp) wts[r * kMaxSplits + sp] /= l;
  }
  consumer_sync();
  for (int e = threadIdx.x; e < rows * D; e += 32 * kWarps) {
    const int r = e / D, d = e % D;
    float o = 0.f;
    for (int sp = 0; sp < n_active; ++sp)
      o += wts[r * kMaxSplits + sp] * __ldcg(part0 + (sp * RB + r) * (D + 2) + d);
    out[out_row0 + e] = from_f32<T>(o);
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T, int RB, int DP>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  auto* kernel = paged_decode_hopper_kernel<T, RB, DP>;
  const int smem = layout(a.sub, a.D, RB, a.stages, sizeof(T)).total;
  static int smem_allowed = 48 * 1024;  // raised once per larger request
  if (smem > smem_allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  kernel<<<dim3(a.splits * a.chunks, a.Hkv, a.B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RB>
int launch_d(const DecodeArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, RB, 64>(a, stream);
  if (a.D <= 128) return launch<T, RB, 128>(a, stream);
  return launch<T, RB, 256>(a, stream);
}

template <typename T>
int launch_rb(const DecodeArgs& a, cudaStream_t stream) {
  switch (a.rb) {
    case 1: return launch_d<T, 1>(a, stream);
    case 2: return launch_d<T, 2>(a, stream);
    case 4: return launch_d<T, 4>(a, stream);
    default: return launch_d<T, 8>(a, stream);
  }
}

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// The query rows a block (1, 2, 4 or 8: the group's width, rounded up,
// at most 8) and the ring's stages for a page of bs x D 16-bit values.
int rows_per_block(int g) { return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8; }

int sm_count() {
  static int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return n;
  }();
  return sms;
}

// The ring's stages: a multiple of the consumer warps, so that a stage
// always feeds the same warp (page i goes to stage i % stages and warp
// i % kWarps, and a warp then waits on a stage's phases in order; with a
// stage shared by two warps, one could wait on the parity of a phase two
// ahead of the stage's and read a page that has not arrived). Two stages a
// warp (its next page loads while it works on one) where the grid leaves
// SMs free or the ring is small; one a warp where the blocks must share
// SMs. Where four stages of whole pages do not fit kRingMax, a stage holds
// a part of a page (`sub` keys, bs halved until four fit; at least
// kMinPartKeys). `blocks`: the launch's grid. stages 0: the ring does not
// take the page.
struct StagePlan {
  int stages, sub;
};

StagePlan stage_plan(int bs, int D, int elem, long long blocks) {
  const int page = 2 * bs * D * elem;
  const int budget = blocks <= sm_count() ? kRingMax : kRingBudget;
  if (kMaxStages * page <= budget) return {kMaxStages, bs};
  int sub = bs;
  while (kWarps * 2 * sub * D * elem > kRingMax && sub % 2 == 0 && sub / 2 >= kMinPartKeys)
    sub /= 2;
  return kWarps * 2 * sub * D * elem <= kRingMax ? StagePlan{kWarps, sub} : StagePlan{0, 0};
}

// The calls this kernel takes (the others go to paged_decode_attention.cu's):
// a head dim of whole 16-byte words, aligned pools, pages of at most 128
// keys that the ring holds (whole or in parts).
bool takes(int dtype, int bs, int D, bool aligned) {
  const int elem = elem_size(dtype);
  return dtype >= 0 && dtype <= 2 && aligned && D % (16 / elem) == 0 && D <= 256 && bs >= 1 &&
         bs <= 32 * kMaxKeySlots && stage_plan(bs, D, elem, 1).stages > 0;
}

int chunks_of(int g) { return (g + rows_per_block(g) - 1) / rows_per_block(g); }

// The split count: as many as keep the grid within one block an SM, where
// every block gets the deep ring. Measured at the serving batch's 128
// (row, kv head) pairs: 1 split (128 blocks, 8 stages) 0.0219 ms, 2-4
// (256-512 blocks, 4 stages) 0.0237-0.0238, 5-8 up to 0.0271; at 4 pairs
// (one row of 8192 keys under GQA 16/4) each doubling up to 16 splits
// faster (0.2162 → 0.0306 ms). Every split keeps at least
// kMinPagesPerSplit pages of the table, and at most kMaxSplits merge. On
// the host, from shapes only: no device read.
int auto_splits(int B, int Hq, int Hkv, int nb) {
  const long long base = static_cast<long long>(B) * Hkv * chunks_of(Hq / Hkv);
  if (base <= 0) return 1;
  const long long want = sm_count() / base;
  const long long most = std::min<long long>(kMaxSplits, std::max(1, nb / kMinPagesPerSplit));
  return static_cast<int>(std::max(1LL, std::min(want, most)));
}

// The stages a launch with `splits` splits takes, and (*sub) the keys a
// stage carries.
int plan_stages(int B, int Hq, int Hkv, int bs, int D, int dtype, int splits, int* sub) {
  const StagePlan sp = stage_plan(bs, D, elem_size(dtype),
                                  static_cast<long long>(B) * Hkv * chunks_of(Hq / Hkv) * splits);
  *sub = sp.sub;
  return sp.stages;
}

int max_splits() { return kMaxSplits; }

// part (fp32, [B, H_kv, chunks, splits, rows_per_block, D + 2]) and tickets
// (uint32 [B, H_kv, chunks], zero before the call and left zero) are needed
// when splits > 1.
int run(const void* q, const void* k_pool, const void* v_pool, const void* tables,
        const void* seq_lens, void* out, void* part, void* tickets, int B, int Hq, int Hkv,
        int NB, int bs, int D, int nb, long long q_sb, long long q_sh, int splits, float scale,
        int dtype, cudaStream_t stream) {
  DecodeArgs a{};
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.tables = static_cast<const int*>(tables);
  a.lens = static_cast<const int*>(seq_lens);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<unsigned*>(tickets);
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.NB = NB;
  a.bs = bs;
  a.D = D;
  a.nb = nb;
  a.g = Hq / Hkv;
  a.rb = rows_per_block(a.g);
  a.chunks = (a.g + a.rb - 1) / a.rb;
  a.splits = splits;
  a.per_split = (nb + splits - 1) / splits;
  a.stages = plan_stages(B, Hq, Hkv, bs, D, dtype, splits, &a.sub);
  a.scale_log2 = scale * kLog2e;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return ptt::by_dtype(dtype, [&](auto tag) {
    return launch_rb<typename decltype(tag)::type>(a, stream);
  });
}

}  // namespace ptt_paged_hopper
