// Hopper (sm_90a) building blocks of the tensor-core flash kernels
// (flash_attention_fwd_sm90.cu, flash_attention_bwd_dkv_sm90.cu,
// flash_attention_bwd_dq_sm90.cu, and the fp32 backward through
// flash_f32_sm90.cuh): the
// swizzled shared-memory tile, its cp.async load, the wgmma descriptors and
// instructions, and the split of an fp32 fragment into bf16 operands.
//
// Tile layout. A tile of R rows by D bf16 columns (D = 64 or 128) is kept as
// D / 64 panels of R x 64; a panel row is 128 bytes, one 128-byte swizzle
// atom row: its 16-byte chunk c lies at chunk c ^ (r & 7). Panels start at
// 1024-byte boundaries. This is the layout that a wgmma descriptor with
// 128-byte swizzling reads, K-major (rows are M or N, the panel's 64
// columns are K) and MN-major (rows are K, columns N) alike, so one tile
// serves both: Q in S = Q K^T and as the B operand of dS^T Q.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"): start address, leading
// and stride byte offsets in 16-byte units, layout 1 = 128-byte swizzle.
// The stride byte offset is 1024 (eight 128-byte rows) in both majors; a
// K-major k16 step moves the start by 32 bytes inside the atom, an MN-major
// k16 step by 16 rows (2048 bytes). Every product here is m64n64k16, so one
// instruction never spans two panels and the leading byte offset is unused.
//
// Fragments (PTX ISA, wgmma register fragments): the fp32 accumulator of an
// m64n64 product gives thread (warp w, lane) rows 16w + lane/4 (a) and
// 16w + lane/4 + 8 (b); element 4j + e holds row a, column 8j + 2(lane%4)
// + e, and element 4j + 2 + e row b. That is also the order of the A
// fragment of the next product, so an accumulator converts to A operands
// in registers with no data movement.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

// A fault planted at build time (nvcc -DFLASH_SM90_FAULT=n, a library of
// its own name) by tools/parity_reach.py, to show what the checks catch.
// The kernels that the package builds leave it undefined: 0, no fault, and
// none of the fault code compiled.
#ifndef FLASH_SM90_FAULT
#define FLASH_SM90_FAULT 0
#endif

namespace flash_sm90 {

typedef __nv_bfloat16 bf16;

enum PlantedFault : int {
  kFirstTermOnly = 1,   // every split product on its first term alone
  kFoldOrder = 2,       // dk/dv: the fold's order rotated from call to call
  kCausalStart = 4,     // dk/dv: the causal query start one tile late
  kCausalLoopShort = 8, // dq: the causal key loop one tile short
  kInputFirstTermOnly = 16,  // fp32 route: q.k^T on the inputs' first
                             // bf16 terms alone (flash_f32_sm90.cuh)
};
constexpr int kFault = FLASH_SM90_FAULT;

constexpr float kNegInf = -1e30f;
constexpr int kPanelRowBytes = 128;

// Byte offset of the 16-byte chunk holding columns 8*cc .. 8*cc + 7 of row
// r in a swizzled tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t chunk_offset(int r, int cc) {
  return static_cast<uint32_t>((cc >> 3) * (R * kPanelRowBytes) +
                               r * kPanelRowBytes +
                               (((cc & 7) ^ (r & 7)) << 4));
}

// Makes this thread's completed shared-memory writes visible to wgmma (the
// async proxy); a barrier then publishes them to the whole block.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows row0 .. row0 + R - 1 of a row-major (n_rows, D) bf16 matrix into the
// swizzled tile at s, by NT threads; rows at or past n_rows read as zeros.
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t s, const bf16* g, int row0,
                                          int n_rows, int tid) {
  constexpr int kChunksPerRow = D / 8;
  constexpr int kChunks = R * kChunksPerRow;
  static_assert(kChunks % NT == 0, "tile chunks must divide the threads");
#pragma unroll
  for (int i = 0; i < kChunks / NT; ++i) {
    const int e = tid + i * NT;
    const int r = e / kChunksPerRow, cc = e % kChunksPerRow;
    const bool in = row0 + r < n_rows;
    const bf16* src = in ? g + (static_cast<size_t>(row0 + r) * D + cc * 8)
                         : g;
    cp_async16(s + chunk_offset<R>(r, cc), src, in ? 16 : 0);
  }
}

// 64 floats at g[row0 ..] into shared memory at s by the first 64 threads;
// entries at or past n read as zeros.
__device__ __forceinline__ void load_row_values(uint32_t s, const float* g,
                                                int row0, int n, int tid) {
  if (tid < 64) {
    const bool in = row0 + tid < n;
    cp_async4(s + 4 * tid, in ? g + row0 + tid : g, in ? 4 : 0);
  }
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  constexpr uint64_t kLeading = 16 >> 4, kStride = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kLeading << 16) |
         (kStride << 32) | (1ull << 62);
}

// Descriptor of k16 step kk of a K-major operand: rows [0, 64) of the tile
// at `tile` (R rows a panel), K columns 16 kk .. 16 kk + 15.
template <int R>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return descriptor(tile + (kk >> 2) * (R * kPanelRowBytes) + (kk & 3) * 32);
}
// Descriptor of an MN-major B operand: rows 16 kk .. 16 kk + 15 (K) of
// panel p (N columns 64 p .. 64 p + 63) of the tile at `tile` (R rows).
template <int R>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int p,
                                                  int kk) {
  return descriptor(tile + p * (R * kPanelRowBytes) +
                    kk * 16 * kPanelRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers across the asynchronous wgmma: the compiler sees them
// written here, after the wait, so it neither reads an accumulator early
// nor reuses an A operand's register while the tensor cores still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[n][i][j])::"memory");
}

#define FLASH_SM90_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define FLASH_SM90_D32_OPS(d)                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (+)= A B, m64n64k16, bf16 in, fp32 out; A and B K-major in shared
// memory. scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_SM90_D32_OPS(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= A B, m64n64k16; A (bf16) from registers, B MN-major in shared
// memory (transposed by the instruction).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_SM90_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo_col, bf16 hi_col) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo_col)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi_col)) << 16);
}

// The fp32 accumulator fragment x (an m64n64 tile) as the A operands of
// four k16 steps, split into N bf16 terms: t0 = bf16(x), t1 = bf16(x - t0),
// ... (each difference exact in fp32). The terms carry about 8N bits of
// x's significand (the rest at most 2^-9N |x|: 2^-18 for hi and lo, 2^-27
// for three terms), and products of bf16 values are exact in fp32, so
// sum_n t_n.B into an fp32 accumulator is the fp32 product within that.
template <int N>
__device__ __forceinline__ void split_terms(const float (&x)[32],
                                            uint32_t (&t)[N][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const bf16 ah = __float2bfloat16_rn(a), bh = __float2bfloat16_rn(b);
        t[n][kk][r] = pack_bf16(ah, bh);
        a -= __bfloat162float(ah);
        b -= __bfloat162float(bh);
      }
    }
}

// d = sum_n t_n.B over the 64-deep K of one tile (four k16 steps a term),
// B the MN-major panel p of the tile at `tile` (R rows).
template <int R, int N>
__device__ __forceinline__ void product_terms(float (&d)[32],
                                              uint32_t (&t)[N][4][4],
                                              uint32_t tile, int p) {
  constexpr int kUsed = (kFault & kFirstTermOnly) ? 1 : N;
  wgmma_fence();
#pragma unroll
  for (int n = 0; n < kUsed; ++n)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(d, t[n][kk], desc_mn_major<R>(tile, p, kk), n | kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
  fence_regs(t);
}

// Row reductions over the four lanes that share a row (lane / 4 equal);
// every lane ends with the same bits (a + b == b + a).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace flash_sm90
