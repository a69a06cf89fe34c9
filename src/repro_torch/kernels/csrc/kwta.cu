// Per-row approximate k-winner-take-all by threshold bisection on Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kwta.py :: kwta_pallas
// (_kwta_kernel). For each row x of length N, with mag = |x| in fp32:
//
//   lo = 0, hi = max(mag) + 1
//   iters times: mid = 0.5 * (lo + hi);
//                if count(mag > mid) > k then lo = mid else hi = mid
//   theta = hi if count(mag > hi) >= k else lo
//   out = x where mag > theta, else 0            (x's dtype)
//
// Approximate-k by design (ties and near-ties decide the count); the exact
// top-k that the training's zeta uses is another function
// (core/kwta.kwta_global).
//
// Arithmetic. mid is formed with __fadd_rn/__fmul_rn, so nvcc cannot
// contract it; the max is an fmaxf over the magnitudes (exact in any
// order) and every count an integer, so the way a row is spread over
// threads decides nothing: every path below, its plain version
// (kernels/ref.py :: kwta_bisect_ref) and the reference's interpret-mode
// kernel agree bit for bit.
//
// What bounds it on the H100. The function reads x once and writes out
// once (at (64, 1024) f32 about 0.5 MB, 0.16 us at 3.35 TB/s). A row's
// iters + 2 counts are serial, each a reduction over the row that every
// thread of it must wait for: latency, not bytes, bounds it. Measured at
// (64, 1024) (tools/kernel_times.py, PERF.md): 0.0053 ms against an
// empty launch's 0.0012, so at most some 230 cycles a round.
//
// Design: the wrapper's kwta.py :: plan(N) picks one of three paths by N
// (the C launch only checks that the plan it is given holds the row):
// what was fastest at each length timed on an H100 (tools/kernel_times.py,
// PERF.md).
//  (a) N <= 512: one warp a row, four rows a block, no block barrier.
//      Each lane holds its V = N / 32 (rounded up to a power of two)
//      values in registers, as the bits of their magnitudes (a NaN's as
//      +0's, which no count, max or output can tell apart) and a mask of
//      their signs; a round is V compares done as integer subtractions
//      (no predicate register, which a lone warp would wait on value by
//      value) and one redux.sync, so lo and hi stay warp-uniform.
//  (b) N <= 16,384: one block a row, the fewest warps (2 to 32) that hold
//      it at V = 16 values a thread, held as in (a). A round is V
//      compares, a redux.sync a warp, each warp's sum to its slot in one
//      of two shared buffers (alternating by round), one barrier, and a
//      redux.sync over the slots in every warp. (The other plans timed,
//      one warp a row up to 1,024 and 4 or 8 values a thread, are built
//      by tools/kernel_times.py from a copy of this file.)
//  (c) longer rows: one block of 1,024 threads a row, the row read again
//      from global memory (L1/L2) each round, each thread kAhead loads
//      ahead of its compares, with (b)'s one-barrier count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

// A fault planted at build time (nvcc -DKWTA_FAULT=1, a library of its
// own name) by tools/parity_reach.py, to show what the checks catch: in
// every block past the first, lane 31 of each warp leaves its values out
// of the bisection's counts. The package's build leaves it 0.
#ifndef KWTA_FAULT
#define KWTA_FAULT 0
#endif

namespace {

constexpr int kRowWarps = 4;          // (a): rows, one warp each, a block
constexpr int kBlockThreads = 1024;   // (b) at most, (c)
enum Path { kWarp = 0, kBlock = 1, kStream = 2 };  // the wrapper's PATHS

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
// Exact: v is a bf16 value or zero.
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i,
                                        float v) {
  p[i] = __float2bfloat16_rn(v);
}

constexpr unsigned kInf = 0x7f800000u;  // +inf's bits

// |x|'s bits, a NaN's as +0's. For magnitudes and thresholds >= +0 that
// are not NaN the bits order as the floats do, so |x| > t is
// mag_bits(x) > bits(t); a NaN, which no comparison counts, keeps no
// count, no max (fmaxf skips it) and no output as +0 (every threshold is
// >= +0).
__device__ __forceinline__ unsigned mag_bits(float x) {
  const unsigned m = __float_as_uint(x) & 0x7fffffffu;
  return m > kInf ? 0u : m;
}

// 1 where m > tb, else 0, with no predicate: tb - m wraps past 2^31
// exactly where m > tb (both below 2^31).
__device__ __forceinline__ int above(unsigned m, unsigned tb) {
  return static_cast<int>((tb - m) >> 31);
}

__device__ __forceinline__ int planted(int c) {
#if KWTA_FAULT
  if (blockIdx.x > 0 && (threadIdx.x & 31) == 31) return 0;
#endif
  return c;
}

// A round's count, summed over the row's threads and uniform over them:
// one redux.sync where a warp holds the row; where the block does, each
// warp's sum goes to its slot in one of two buffers (alternating by
// round: a thread can write round r + 2's slot only after every thread
// has passed round r + 1's barrier, so after it read round r's), one
// barrier, and every warp sums the slots by redux.sync.
template <bool kWarpRow>
__device__ __forceinline__ int row_sum(int c, int* slots, int& parity) {
  c = __reduce_add_sync(0xffffffffu, c);
  if (kWarpRow) return c;
  const int lane = threadIdx.x & 31;
  int* s = slots + 32 * parity;
  parity ^= 1;
  if (lane == 0) s[threadIdx.x >> 5] = c;
  __syncthreads();
  return __reduce_add_sync(0xffffffffu,
                           lane < static_cast<int>(blockDim.x >> 5) ? s[lane]
                                                                    : 0);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The max of non-negative floats over the row, uniform over its threads.
template <bool kWarpRow>
__device__ __forceinline__ float row_max(float x, float* slots) {
  x = warp_max(x);
  if (kWarpRow) return x;
  const int lane = threadIdx.x & 31;
  if (lane == 0) slots[threadIdx.x >> 5] = x;
  __syncthreads();
  return warp_max(lane < static_cast<int>(blockDim.x >> 5) ? slots[lane]
                                                           : 0.0f);
}

// This thread's count of m > tb over its V magnitudes, in four
// independent sums of integer operations (a compare into a predicate
// register, which one warp a scheduler would wait on value by value,
// takes none).
template <int V>
__device__ __forceinline__ int count_regs(const unsigned (&m)[V],
                                          unsigned tb) {
  int c[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < V; ++j) c[j & 3] += above(m[j], tb);
  return (c[0] + c[1]) + (c[2] + c[3]);
}

// Paths (a) (kWarpRow: a warp a row, kRowWarps rows a block) and (b) (a
// block a row). Value j of thread t is element j * threads_a_row + t,
// held as its magnitude's bits (mag_bits; +0 past N, which no count sees)
// and its sign in bit j of `signs`.
template <typename T, int V, bool kWarpRow>
__global__ void __launch_bounds__(kWarpRow ? kRowWarps * 32 : kBlockThreads)
kwta_regs(const T* __restrict__ x, T* __restrict__ out, int R, int N, int k,
          int iters) {
  __shared__ int slots[64];
  __shared__ float max_slots[32];
  size_t row;
  int t, nt;
  if (kWarpRow) {
    row = static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) +
          (threadIdx.x >> 5);
    if (row >= static_cast<size_t>(R)) return;  // the whole warp
    t = threadIdx.x & 31;
    nt = 32;
  } else {
    row = blockIdx.x;
    t = threadIdx.x;
    nt = blockDim.x;
  }
  const T* xr = x + row * N;
  T* outr = out + row * N;
  // Where the row fills every thread's V values (a uniform test) the
  // loads take no bounds test: a predicate register held per value from
  // the loads to the stores would leave one for the rest, and the
  // compiler then waits on each load before it issues the next.
  const bool full = V * nt == N;
  float xv[V];
  if (full) {
#pragma unroll
    for (int j = 0; j < V; ++j) xv[j] = load_f(xr, j * nt + t);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      xv[j] = j * nt + t < N ? load_f(xr, j * nt + t) : 0.0f;
  }
  unsigned m[V];
  unsigned long long signs = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = mag_bits(xv[j]);
    signs |= static_cast<unsigned long long>(__float_as_uint(xv[j]) >> 31)
             << j;
  }
  float mx = 0.0f;  // every magnitude is >= +0
#pragma unroll
  for (int j = 0; j < V; ++j) mx = fmaxf(mx, __uint_as_float(m[j]));
  float lo = 0.0f;
  float hi = __fadd_rn(row_max<kWarpRow>(mx, max_slots), 1.0f);
  int parity = 0;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const int c = planted(count_regs(m, __float_as_uint(mid)));
    if (row_sum<kWarpRow>(c, slots, parity) > k)
      lo = mid;
    else
      hi = mid;
  }
  const int c = count_regs(m, __float_as_uint(hi));
  const unsigned theta =
      __float_as_uint(row_sum<kWarpRow>(c, slots, parity) >= k ? hi : lo);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = j * nt + t;
    const unsigned bits =
        m[j] | static_cast<unsigned>((signs >> j) & 1ull) << 31;
    if (full || i < N)
      store_f(outr, i, above(m[j], theta) ? __uint_as_float(bits) : 0.0f);
  }
}

// Path (c)'s count over the row read from global memory: each thread
// loads kAhead values, kBlockThreads apart, before it compares any, so
// that kAhead loads a thread are in flight; the tail follows one by one.
// The compares take a predicate each: 32 warps an SM hide its latency.
constexpr int kAhead = 8;
template <typename T>
__device__ __forceinline__ int count_stream(const T* xr, int N, float t) {
  int c = 0;
  int i = threadIdx.x;
  for (; i + (kAhead - 1) * kBlockThreads < N; i += kAhead * kBlockThreads) {
    float v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = load_f(xr, i + u * kBlockThreads);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) c += fabsf(v[u]) > t;
  }
  for (; i < N; i += kBlockThreads) c += fabsf(load_f(xr, i)) > t;
  return c;
}

// Path (c): a block a row, the row read from global memory each round.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
kwta_stream(const T* __restrict__ x, T* __restrict__ out, int N, int k,
            int iters) {
  __shared__ int slots[64];
  __shared__ float max_slots[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * N;
  T* outr = out + row * N;
  float mx = 0.0f;
  int i = threadIdx.x;
  for (; i + (kAhead - 1) * kBlockThreads < N; i += kAhead * kBlockThreads) {
    float v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = load_f(xr, i + u * kBlockThreads);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) mx = fmaxf(mx, fabsf(v[u]));
  }
  for (; i < N; i += kBlockThreads) mx = fmaxf(mx, fabsf(load_f(xr, i)));
  float lo = 0.0f;
  float hi = __fadd_rn(row_max<false>(mx, max_slots), 1.0f);
  int parity = 0;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (row_sum<false>(planted(count_stream(xr, N, mid)), slots, parity) > k)
      lo = mid;
    else
      hi = mid;
  }
  const float theta =
      row_sum<false>(count_stream(xr, N, hi), slots, parity) >= k ? hi : lo;
  for (i = threadIdx.x; i < N; i += kBlockThreads) {
    const float xi = load_f(xr, i);
    store_f(outr, i, fabsf(xi) > theta ? xi : 0.0f);
  }
}

// The register kernels the plan takes (kwta.py's WARP_V, PLAN_V): (a) V
// in 1, 2, 4, 8, 16 under 128 threads a block, (b) V 16 under up to 1,024
// (64 registers a thread).
#define KWTA_REGS(V, W)                                                    \
  case V:                                                                 \
    kwta_regs<T, V, W><<<grid, block, 0, s>>>(x, out, R, N, k, iters);    \
    return cudaGetLastError();

template <typename T>
cudaError_t launch_warp_rows(const T* x, T* out, int R, int N, int k,
                             int iters, int v, dim3 grid, dim3 block,
                             cudaStream_t s) {
  switch (v) {
    KWTA_REGS(1, true)
    KWTA_REGS(2, true)
    KWTA_REGS(4, true)
    KWTA_REGS(8, true)
    KWTA_REGS(16, true)
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_block_rows(const T* x, T* out, int R, int N, int k,
                              int iters, int v, dim3 grid, dim3 block,
                              cudaStream_t s) {
  switch (v) {
    KWTA_REGS(16, false)
    default:
      return cudaErrorInvalidValue;
  }
}
#undef KWTA_REGS

template <typename T>
cudaError_t launch(const T* x, T* out, int R, int N, int k, int iters,
                   int path, int warps, int v, cudaStream_t s) {
  switch (path) {
    case kWarp:  // v values a lane hold the row
      if (warps != 1 || N > 32 * v) return cudaErrorInvalidValue;
      return launch_warp_rows(x, out, R, N, k, iters, v,
                              dim3((R + kRowWarps - 1) / kRowWarps),
                              dim3(32 * kRowWarps), s);
    case kBlock:  // v values a thread of `warps` warps hold the row
      if (warps < 2 || 32 * warps > kBlockThreads || N > 32 * warps * v)
        return cudaErrorInvalidValue;
      return launch_block_rows(x, out, R, N, k, iters, v, dim3(R),
                               dim3(32 * warps), s);
    case kStream:
      if (warps != kBlockThreads / 32 || v != 0) return cudaErrorInvalidValue;
      kwta_stream<T><<<R, kBlockThreads, 0, s>>>(x, out, N, k, iters);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x and out (R, N), contiguous on the current device; bf16 != 0 selects
// bfloat16, else float32. (path, warps, v) is the wrapper's plan: the path
// (0 a warp a row, 1 a block a row, 2 the row streamed from global
// memory), the warps a row (1 on path 0, 32 on path 2) and the values a
// thread holds in registers (0 on path 2). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int kwta_launch(const void* x, void* out, int R, int N, int k,
                           int iters, int bf16, int path, int warps, int v,
                           void* stream) {
  if (R < 1 || N < 1 || k < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(x),
                                   static_cast<__nv_bfloat16*>(out), R, N, k,
                                   iters, path, warps, v, s));
  return static_cast<int>(launch(static_cast<const float*>(x),
                                 static_cast<float*>(out), R, N, k, iters,
                                 path, warps, v, s));
}
