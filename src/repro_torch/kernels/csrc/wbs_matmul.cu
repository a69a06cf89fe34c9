// Weighted-bit-streaming crossbar product on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wbs_matmul.py ::
// wbs_matmul_pallas (_wbs_kernel), at read_sigma == 0:
//
//   out[m, n] = ADC( norm * sum_tiles sum_b gains[b] *
//                    sum_{k in tile} plane_b[m, k] * sign[m, k] * w[k, n] )
//
// with norm = 2^nb / (2^nb - 1) and the ADC optional.
//
// Design. One block per (kTM x kTN) output tile, one thread per output
// element. The TPU's K-innermost grid and its VMEM scratch accumulator
// become a loop over K tiles inside the thread, carrying the fp32 sum in a
// register (wbs_common.cuh :: plane_tile).
//
// What bounds it on the H100. By linearity the plane sum is one product of
// the decoded operand: 2*M*K*N + 2*M*K*nb float operations. At the serve
// path's shapes ((896, 28) x (28, 100) for the hoisted drive, (64, 100) x
// (100, 100) per recurrent step) that is 5 and 1.3 MFLOP, and about 0.4
// and 0.08 MB to move: a fraction of a microsecond either way, so the
// launch and the serial K x nb loop (which repeats the product per plane)
// bound it. The design does nothing about that yet: decoding the planes
// once, tensor cores, staging the tiles in shared memory and fewer, fatter
// blocks are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "wbs_common.cuh"

namespace {

constexpr int kTM = 8;   // output rows per block
constexpr int kTN = 32;  // output columns per block (one warp)

__global__ void __launch_bounds__(kTM * kTN)
wbs_matmul_kernel(const int8_t* __restrict__ sign,
                  const uint8_t* __restrict__ code,
                  const float* __restrict__ w,
                  const float* __restrict__ gains, float* __restrict__ out,
                  int K, int N, int n_bits, float norm, int use_adc,
                  float step, float lo, float hi) {
  __shared__ float g[wbs::kMaxBits];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < n_bits) g[tid] = gains[tid];
  __syncthreads();

  const int n = blockIdx.x * kTN + threadIdx.x;
  const int m = blockIdx.y * kTM + threadIdx.y;
  const int8_t* s = sign + static_cast<size_t>(m) * K;
  const uint8_t* c = code + static_cast<size_t>(m) * K;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += wbs::kBK) {
    const int kt = K - k0 < wbs::kBK ? K - k0 : wbs::kBK;
    acc = wbs::plane_tile(acc, s + k0, c + k0,
                          w + static_cast<size_t>(k0) * N + n, N, kt, n_bits,
                          g);
  }
  float y = __fmul_rn(acc, norm);
  if (use_adc) y = wbs::adc(y, step, lo, hi);
  out[static_cast<size_t>(m) * N + n] = y;
}

}  // namespace

// sign, code (M, K) int8 / uint8; w (K, N) f32; gains (n_bits,) f32;
// out (M, N) f32. All row-major and contiguous on one device. M must be a
// multiple of 8 and N of 32 (kernels/ops.py pads); K is free. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int wbs_matmul_launch(const void* sign, const void* code,
                                 const void* w, const void* gains, void* out,
                                 int M, int K, int N, int n_bits, float norm,
                                 int use_adc, float step, float lo, float hi,
                                 void* stream) {
  if (M % kTM != 0 || N % kTN != 0 || n_bits < 1 || n_bits > wbs::kMaxBits)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTN, kTM);
  const dim3 grid(N / kTN, M / kTM);
  wbs_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(sign), static_cast<const uint8_t*>(code),
      static_cast<const float*>(w), static_cast<const float*>(gains),
      static_cast<float*>(out), K, N, n_bits, norm, use_adc, step, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
