// Weighted-bit-streaming crossbar product on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wbs_matmul.py ::
// wbs_matmul_pallas (_wbs_kernel), both branches: wbs_matmul_kernel at
// read_sigma == 0, wbs_matmul_read_noise_kernel (further down) with the
// in-kernel per-access read noise of read_sigma > 0:
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

// ---------------------------------------------------------------------------
// Read noise (read_sigma > 0): the crossbar's cycle-to-cycle conductance
// variation, w[k, n] * (1 + sigma * z[k, n]) with z ~ N(0, 1).
//
// On the TPU every (row block, k tile, n tile) grid cell reseeds the
// on-chip PRNG from (seed, cell) and perturbs its weight tile: one fresh
// draw per 128-row block and call. Here z is a pure function of (key, k,
// n): a counter-based generator, Philox4x32-10 keyed by two words the
// wrapper draws from the caller's key, with the element index k * N + n
// as its counter. Every block that reads w[k, n] in one call computes the
// same z, so each call draws one normal per weight element, shared by all
// rows, for any M (the TPU shares a draw within a 128-row block only), and
// the plain version (kernels/ref.py :: read_noise) reproduces it exactly.
//
// z is the TPU kernel's Box-Muller: u = (bits >> 8) * 2^-24 clamped below
// at 2^-24, z = sqrt(-2 ln u1) * cos(2 pi u2), evaluated in double and
// rounded once to float, so libdevice's float logf/cosf play no part and
// the plain version's float64 evaluation gives the same float. The
// perturbation rounds as the plain version writes it, sigma * z, then
// 1 + that, then w * that, with explicit _rn intrinsics so nvcc contracts
// nothing into an FMA; the contraction is wbs_common.cuh :: plane_tile,
// unchanged. At sigma == 0 the perturbed tile is w itself, so the launch
// equals wbs_matmul_kernel's bit for bit.
//
// Design: a block owns a (kTM x kTN) output tile, as above. For each K
// tile it first writes the perturbed (kt x kTN) slab of w into shared
// memory, each of its 256 threads drawing 16 of the 4096 normals, then
// contracts from there: the noise of a column slab is computed once per
// block, not once per output row. Blocks that share a column slab (M / 8
// of them) repeat its draws; at the per-step shape (32 x 100 x 100) that
// is 4x the 10,000 draws. What bounds it: the draws, about 50 double
// operations each for log, cos and sqrt, at H100's 34 TFLOP/s of
// non-tensor fp64 — well under a microsecond at these shapes, so the
// launch and the serial contraction dominate, as for wbs_matmul_kernel.
// ---------------------------------------------------------------------------

// Philox4x32-10 (Salmon et al., SC'11) as Random123 defines it: ten rounds,
// the key bumped by the Weyl constants before every round but the first.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
  }
}

// The read-noise normal of weight element idx = k * N + n.
__device__ __forceinline__ float read_normal(uint32_t idx, uint32_t k0,
                                             uint32_t k1) {
  uint32_t c[4] = {idx, 0u, 0u, 0u};
  philox4x32_10(c, k0, k1);
  const double u1 = fmax(static_cast<double>(c[0] >> 8) * 0x1p-24, 0x1p-24);
  const double u2 = fmax(static_cast<double>(c[1] >> 8) * 0x1p-24, 0x1p-24);
  return static_cast<float>(sqrt(-2.0 * log(u1)) *
                            cos(6.283185307179586 * u2));
}

__global__ void __launch_bounds__(kTM * kTN)
wbs_matmul_read_noise_kernel(const int8_t* __restrict__ sign,
                             const uint8_t* __restrict__ code,
                             const float* __restrict__ w,
                             const float* __restrict__ gains,
                             float* __restrict__ out, int K, int N,
                             int n_cols, int n_bits, float norm, int use_adc,
                             float step, float lo, float hi, float sigma,
                             uint32_t key0, uint32_t key1) {
  __shared__ float g[wbs::kMaxBits];
  __shared__ float slab[wbs::kBK * kTN];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < n_bits) g[tid] = gains[tid];

  const int n0 = blockIdx.x * kTN;
  const int m = blockIdx.y * kTM + threadIdx.y;
  const int8_t* s = sign + static_cast<size_t>(m) * K;
  const uint8_t* c = code + static_cast<size_t>(m) * K;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += wbs::kBK) {
    const int kt = K - k0 < wbs::kBK ? K - k0 : wbs::kBK;
    __syncthreads();  // the previous tile's slab is consumed
    for (int i = tid; i < kt * kTN; i += kTM * kTN) {
      const int k = k0 + i / kTN;
      const int n = n0 + i % kTN;
      // Columns past n_cols are the wrapper's zero padding: no draw.
      const float z = n < n_cols
                          ? read_normal(static_cast<uint32_t>(k) *
                                                static_cast<uint32_t>(n_cols) +
                                            static_cast<uint32_t>(n),
                                        key0, key1)
                          : 0.0f;
      slab[i] = __fmul_rn(w[static_cast<size_t>(k) * N + n],
                          __fadd_rn(1.0f, __fmul_rn(sigma, z)));
    }
    __syncthreads();
    acc = wbs::plane_tile(acc, s + k0, c + k0, slab + threadIdx.x, kTN, kt,
                          n_bits, g);
  }
  float y = __fmul_rn(acc, norm);
  if (use_adc) y = wbs::adc(y, step, lo, hi);
  out[static_cast<size_t>(m) * N + n0 + threadIdx.x] = y;
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

// The read-noise variant: as wbs_matmul_launch, plus sigma and the Philox
// key (key0, key1). n_cols <= N is the weight's true width (its counter
// stride); columns from n_cols on are padding. K * n_cols must fit in 32
// bits.
extern "C" int wbs_matmul_read_noise_launch(
    const void* sign, const void* code, const void* w, const void* gains,
    void* out, int M, int K, int N, int n_cols, int n_bits, float norm,
    int use_adc, float step, float lo, float hi, float sigma,
    unsigned int key0, unsigned int key1, void* stream) {
  if (M % kTM != 0 || N % kTN != 0 || n_bits < 1 ||
      n_bits > wbs::kMaxBits || n_cols < 1 || n_cols > N ||
      static_cast<unsigned long long>(K) * n_cols > 0xFFFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTN, kTM);
  const dim3 grid(N / kTN, M / kTM);
  wbs_matmul_read_noise_kernel<<<grid, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(sign), static_cast<const uint8_t*>(code),
      static_cast<const float*>(w), static_cast<const float*>(gains),
      static_cast<float*>(out), K, N, n_cols, n_bits, norm, use_adc, step,
      lo, hi, sigma, key0, key1);
  return static_cast<int>(cudaGetLastError());
}
