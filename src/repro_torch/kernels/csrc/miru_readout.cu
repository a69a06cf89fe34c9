// Row-exact MiRU readout on Hopper (sm_90a): logits = h @ w_o + b_o.
//
// Not the port of a TPU kernel: the reference leaves `h @ w_o` in
// src/repro/core/miru.py :: miru_apply_readout to XLA. On the card a
// library GEMM picks its kernel, and with it its summation order, by the
// operand's shape, so the same row of h gave other bits in a 1-slot than
// in a 64-slot serve engine. This kernel gives every row the same
// arithmetic whatever M is, and whatever block the row falls in: each
// output sums its k ascending with __fmul_rn/__fadd_rn (no FMA
// contraction), from +0, and adds the bias last, as (h @ w_o) + b_o. The
// plain version (kernels/ref.py :: miru_readout_ref) repeats that order.
//
// What bounds it on the H100: at the serve shape (896 x 100) x (100 x 10)
// it moves about 0.4 MB and does 1.8 MFLOP, some 0.1 microseconds
// (bytes); a launch costs more than that. Each output's sum is a 100-link
// chain of dependent adds (about 4 cycles each, 0.2 microseconds), and
// what lies around it is the latency of the operands' loads. Measured at
// the serve shape (tools/kernel_times.py, PERF.md): 0.0030 ms, over an
// empty launch's 0.0012.
//
// Design. A block owns `rows` rows of h and `cols` output columns (the
// wrapper's miru_readout.py :: geometry: enough row groups to cover the
// SMs at the serve shape, and one row a block at the train shapes, so
// that 32-64 rows still run on 32-64 blocks), one thread an output. It
// stages its rows of h, a K-tile of w_o's columns and the bias in shared
// memory by cp.async (16-byte copies where the operands' layout allows,
// else 4-byte ones, zeros past the edges), waits once, and runs each
// output's chain over the tile from shared memory, unrolled, with h read
// four inputs at a time; the loads lie off the chain, which is the adds
// alone. Where K does not fit one tile the chain carries on across tiles
// in ascending k (one barrier before and after each tile's sums). The
// launch geometry never enters the arithmetic: every output runs the same
// chain over k = 0..K-1.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

// A fault planted at build time (nvcc -DREADOUT_FAULT=1, a library of its
// own name) by tools/parity_reach.py, to show what the checks catch: every
// block past the first sums each tile's k descending. The package's build
// leaves it 0.
#ifndef READOUT_FAULT
#define READOUT_FAULT 0
#endif

namespace {

constexpr int kMaxThreads = 1024;
// A block's shared memory in floats (48 KB, no opt-in): the wrapper's
// geometry keeps its tiles within it.
constexpr int kSmemFloats = 12288;
constexpr int kPad = 4;  // h's row stride is k_tile + kPad: rows on other banks

// Shared-memory layout of a block, in floats (the wrapper's
// miru_readout.py :: smem_floats counts the same).
__host__ __device__ inline int smem_floats(int rows, int cols, int k_tile) {
  return rows * (k_tile + kPad) + k_tile * cols + cols;
}

// Stages rows [m0, m0 + rows) of h and columns k0 .. k0 + kt - 1 into hs
// (row stride k_tile + kPad), and rows k0 .. k0 + kt - 1, columns
// n0 .. n0 + cols - 1 of w into ws (row stride cols); zeros past M, K and
// N. 16-byte copies where a row of h (K % 4 == 0) or the tile of w (all
// of its columns, cols == N) is contiguous and aligned.
__device__ void stage_tile(const float* __restrict__ h,
                           const float* __restrict__ w, float* hs, float* ws,
                           int M, int K, int N, int m0, int n0, int k0,
                           int kt, int rows, int cols, int k_tile, bool vec_h,
                           bool vec_w) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int hstride = k_tile + kPad;
  if (vec_h) {
    const int cpr = (kt + 3) / 4;  // 16-byte chunks a row
    for (int i = tid; i < rows * cpr; i += nt) {
      const int r = i / cpr, j = 4 * (i - r * cpr);
      const int m = m0 + r;
      const bool ok = m < M;
      const float* src = ok ? h + static_cast<size_t>(m) * K + k0 + j : h;
      cp_async16(smem_u32(hs + r * hstride + j), src,
                 ok ? 4 * min(4, kt - j) : 0);
    }
  } else {
    for (int i = tid; i < rows * kt; i += nt) {
      const int r = i / kt, j = i - r * kt;
      const int m = m0 + r;
      const bool ok = m < M;
      const float* src = ok ? h + static_cast<size_t>(m) * K + k0 + j : h;
      cp_async4(smem_u32(hs + r * hstride + j), src, ok ? 4 : 0);
    }
  }
  if (vec_w) {
    const int count = kt * N;  // the tile is rows k0 .. k0 + kt - 1, whole
    const float* base = w + static_cast<size_t>(k0) * N;
    for (int j = 4 * tid; j < count; j += 4 * nt)
      cp_async16(smem_u32(ws + j), base + j, 4 * min(4, count - j));
  } else {
    for (int i = tid; i < kt * cols; i += nt) {
      const int kk = i / cols, c = i - kk * cols;
      const bool ok = n0 + c < N;
      const float* src =
          ok ? w + static_cast<size_t>(k0 + kk) * N + n0 + c : w;
      cp_async4(smem_u32(ws + i), src, ok ? 4 : 0);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
miru_readout_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    int M, int K, int N, int rows, int cols, int k_tile,
                    int vec_h, int vec_w) {
  extern __shared__ __align__(16) float smem[];
  const int hstride = k_tile + kPad;
  float* hs = smem;
  float* ws = hs + rows * hstride;
  float* bs = ws + k_tile * cols;
  const int m0 = blockIdx.x * rows;
  const int n0 = blockIdx.y * cols;
  const int tid = threadIdx.x;
  const int r = tid / cols, c = tid - r * cols;  // this thread's output
  const bool active = r < rows;
  const float* hr = hs + r * hstride;
  const float* wc = ws + c;
  const bool reverse = READOUT_FAULT && blockIdx.x > 0;

  for (int i = tid; i < cols; i += blockDim.x)
    cp_async4(smem_u32(bs + i), b + min(n0 + i, N - 1), n0 + i < N ? 4 : 0);
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += k_tile) {
    const int kt = min(k_tile, K - k0);
    if (k0 > 0) __syncthreads();  // every thread is done with the last tile
    stage_tile(h, w, hs, ws, M, K, N, m0, n0, k0, kt, rows, cols, k_tile,
               vec_h, vec_w);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    if (reverse) {
      for (int k = kt - 1; k >= 0; --k)
        acc = __fadd_rn(acc, __fmul_rn(hr[k], wc[k * cols]));
      continue;
    }
    int k = 0;
#pragma unroll 5
    for (; k + 4 <= kt; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hr + k);
      acc = __fadd_rn(acc, __fmul_rn(hv.x, wc[k * cols]));
      acc = __fadd_rn(acc, __fmul_rn(hv.y, wc[(k + 1) * cols]));
      acc = __fadd_rn(acc, __fmul_rn(hv.z, wc[(k + 2) * cols]));
      acc = __fadd_rn(acc, __fmul_rn(hv.w, wc[(k + 3) * cols]));
    }
    for (; k < kt; ++k) acc = __fadd_rn(acc, __fmul_rn(hr[k], wc[k * cols]));
  }
  const int m = m0 + r;
  if (active && m < M && n0 + c < N)
    out[static_cast<size_t>(m) * N + n0 + c] = __fadd_rn(acc, bs[c]);
}

}  // namespace

// h (M, K), w (K, N), b (N,) -> out (M, N). All f32, contiguous, on the
// current device. A block owns `rows` rows and `cols` columns and stages
// `k_tile` inputs at a time (k_tile a multiple of 4); the launch refuses a
// geometry whose threads or shared memory do not fit. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int miru_readout_launch(const void* h, const void* w, const void* b,
                                   void* out, int M, int K, int N, int rows,
                                   int cols, int k_tile, void* stream) {
  if (M < 1 || K < 1 || N < 1 || rows < 1 || cols < 1 || k_tile < 4 ||
      k_tile % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(rows) * cols;
  const long long grid_y = (static_cast<long long>(N) + cols - 1) / cols;
  if (threads > kMaxThreads || grid_y > 65535 ||
      smem_floats(rows, cols, k_tile) > kSmemFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned block = static_cast<unsigned>((threads + 31) / 32 * 32);
  const dim3 grid(static_cast<unsigned>((M + rows - 1) / rows),
                  static_cast<unsigned>(grid_y));
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_h = K % 4 == 0 && aligned(h);
  const int vec_w = cols == N && aligned(w);
  miru_readout_kernel<<<grid, block,
                        smem_floats(rows, cols, k_tile) * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), M, K, N, rows,
      cols, k_tile, vec_h, vec_w);
  return static_cast<int>(cudaGetLastError());
}
