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
// Design. One block per row; each thread strides over the row, and every
// count is a block reduction (warp shuffles, then one warp over the warp
// sums), so lo and hi are uniform across the block. The row is re-read from
// global memory each round (L1/L2 serve it). mid is formed with
// __fadd_rn/__fmul_rn, so nvcc cannot contract it and the integer counts
// decide everything else: the kernel, its plain version
// (kernels/ref.py :: kwta_bisect_ref) and the reference's interpret-mode
// kernel agree bit for bit.
//
// What bounds it on the H100. The function reads x once and writes out
// once (at (64, 1024) f32 about 0.5 MB, 0.16 us at 3.35 TB/s); the kernel
// reads the row iters + 3 times and does iters + 2 block reductions, each a
// chain of barriers, so latency and the rows-per-SM count bound it: R
// blocks on 132 SMs, and for R < 132 most of the card idles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Block-wide sum of one int a thread; every thread gets the total. The
// leading barrier keeps a new call from overwriting sh before every thread
// has read the previous total.
__device__ int block_sum(int x, int* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    x = lane < kWarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) sh[kWarps] = x;
  }
  __syncthreads();
  return sh[kWarps];
}

// The same for a max of non-negative floats.
__device__ float block_max(float x, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    x = lane < kWarps ? sh[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) sh[kWarps] = x;
  }
  __syncthreads();
  return sh[kWarps];
}

template <typename T>
__device__ int count_above(const T* xr, int N, float t) {
  int c = 0;
  for (int i = threadIdx.x; i < N; i += kThreads)
    c += fabsf(load_f(xr, i)) > t;
  return c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kwta_kernel(const T* __restrict__ x, T* __restrict__ out, int N, int k,
            int iters) {
  __shared__ int sh_i[kWarps + 1];
  __shared__ float sh_f[kWarps + 1];
  const size_t row = blockIdx.x;
  const T* xr = x + row * N;
  T* outr = out + row * N;

  float mx = 0.0f;                       // every magnitude is >= +0
  for (int i = threadIdx.x; i < N; i += kThreads)
    mx = fmaxf(mx, fabsf(load_f(xr, i)));
  float lo = 0.0f;
  float hi = __fadd_rn(block_max(mx, sh_f), 1.0f);
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (block_sum(count_above(xr, N, mid), sh_i) > k)
      lo = mid;
    else
      hi = mid;
  }
  const float theta = block_sum(count_above(xr, N, hi), sh_i) >= k ? hi : lo;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const T xi = xr[i];
    outr[i] = fabsf(load_f(xr, i)) > theta ? xi : T(0.0f);
  }
}

}  // namespace

// x and out (R, N), contiguous on the current device; bf16 != 0 selects
// bfloat16, else float32. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int kwta_launch(const void* x, void* out, int R, int N, int k,
                           int iters, int bf16, void* stream) {
  if (R < 1 || N < 1 || k < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    kwta_kernel<__nv_bfloat16><<<R, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        N, k, iters);
  else
    kwta_kernel<float><<<R, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), N, k, iters);
  return static_cast<int>(cudaGetLastError());
}
