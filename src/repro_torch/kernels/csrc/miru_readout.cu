// Row-exact MiRU readout on Hopper (sm_90a): logits = h @ w_o + b_o.
//
// Not the port of a TPU kernel: the reference leaves `h @ w_o` in
// src/repro/core/miru.py :: miru_apply_readout to XLA. On the card a
// library GEMM picks its kernel, and with it its summation order, by the
// operand's shape, so the same row of h gave other bits in a 1-slot than
// in a 64-slot serve engine. This kernel gives every row the same
// arithmetic whatever M is: one thread per output element, the K loop
// ascending with __fmul_rn/__fadd_rn (no FMA contraction), the bias added
// last, as (h @ w_o) + b_o. The plain version (kernels/ref.py ::
// miru_readout_ref) repeats that order.
//
// What bounds it on the H100: at the serve shape (896 x 100) x (100 x 10)
// it moves about 0.4 MB and does 1.8 MFLOP, some 0.1 microseconds
// (bytes); a launch costs more than that, and each thread's 100-deep add
// chain is latency, not bandwidth.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
miru_readout_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    int M, int K, int N) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(M) * N) return;
  const size_t m = idx / N;
  const int n = static_cast<int>(idx % N);
  const float* hm = h + m * K;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn(hm[k], w[static_cast<size_t>(k) * N + n]));
  out[idx] = __fadd_rn(acc, b[n]);
}

}  // namespace

// h (M, K), w (K, N), b (N,) -> out (M, N). All f32, contiguous, on the
// current device. Returns the cudaError_t of the launch (0 on success).
extern "C" int miru_readout_launch(const void* h, const void* w, const void* b,
                                   void* out, int M, int K, int N,
                                   void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(M) * N;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  miru_readout_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
