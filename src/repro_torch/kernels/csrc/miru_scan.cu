// Ideal float MiRU recurrence on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/miru_scan.py ::
// miru_scan_pallas (_miru_kernel). Per batch row and time step:
//
//   pre_t = xw_t + (beta * h_{t-1}) @ U
//   h_t   = lam * h_{t-1} + (1 - lam) * tanh(pre_t)
//
// The input projection xw = x @ W_h + b_h has no sequential dependency
// and is computed outside, as the reference does. The kernel writes h_all
// and pre, each (B, T, H).
//
// Design. One block owns kBM batch rows and loops t = 0..T-1 inside the
// kernel: the TPU's sequential T grid axis becomes that loop, with a block
// barrier after beta*h is written and one after the update. h and beta*h
// live in shared memory. U (H x H f32) is copied into shared memory once
// when it fits the block's opt-in limit (H = 100: 40 KB; H = 128: 64 KB,
// above the 48 KB default, hence the dynamic-smem attribute); at H = 256
// (256 KB > 227 KB) it stays in global memory and L2 serves the re-reads.
// Rows past B (the last block of a ragged batch) take part in the
// barriers but touch no global memory.
//
// Arithmetic. Summation order is the only freedom: each thread sums its
// column k ascending with __fmul_rn/__fadd_rn (no FMA contraction), adds
// the sum to xw_t, and takes tanh in double, rounded once. The plain
// PyTorch version (kernels/ref.py :: miru_scan_ref) repeats that order,
// so kernel and plain version agree bit for bit on any device.
//
// What bounds it on the H100. T steps need 2*B*T*H*H float operations and
// move xw in, h_all and pre out, U and h0 once: at B = 64, T = 28, H = 100
// about 36 MFLOP and 2.2 MB, some 0.7 microseconds (bytes). The T loop is
// serial, each thread's K loop is a serial add chain, and B / kBM = 8
// blocks occupy 8 of 132 SMs, so latency bounds it and most of the card
// idles. Retiling (fewer rows per block, a column split across a cluster,
// a tree reduction the plain version repeats) is later work.
#include <cuda_runtime.h>

#include <cstddef>

#include "smem_optin.cuh"

namespace {

constexpr int kBM = 8;          // batch rows per block
constexpr int kThreadsX = 128;  // threads along H; each strides by 128

__global__ void __launch_bounds__(kBM * kThreadsX)
miru_scan_kernel(const float* __restrict__ xw, const float* __restrict__ u,
                 const float* __restrict__ h0, float* __restrict__ h_all,
                 float* __restrict__ pre, int B, int T, int H, float beta,
                 float lam, float one_minus_lam, int u_in_smem) {
  extern __shared__ float smem[];
  float* h_s = smem;                    // kBM * H
  float* bh_s = h_s + kBM * H;          // kBM * H
  float* u_s = bh_s + kBM * H;          // H * H, or none

  const int r = threadIdx.y;
  const size_t row = static_cast<size_t>(blockIdx.x) * kBM + r;
  const bool live = row < static_cast<size_t>(B);
  if (u_in_smem) {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int i = tid; i < H * H; i += blockDim.x * blockDim.y) u_s[i] = u[i];
  }
  for (int n = threadIdx.x; n < H; n += kThreadsX)
    h_s[r * H + n] = live ? h0[row * H + n] : 0.0f;
  const float* uu = u_in_smem ? u_s : u;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int n = threadIdx.x; n < H; n += kThreadsX)
      bh_s[r * H + n] = __fmul_rn(beta, h_s[r * H + n]);
    __syncthreads();
    if (live) {
      const float* bh = bh_s + r * H;
      for (int n = threadIdx.x; n < H; n += kThreadsX) {
        float acc = 0.0f;
        for (int k = 0; k < H; ++k)
          acc = __fadd_rn(acc, __fmul_rn(bh[k], uu[static_cast<size_t>(k) * H + n]));
        const size_t o = (row * T + t) * H + n;
        const float p = __fadd_rn(xw[o], acc);
        const float h = h_s[r * H + n];
        const float th = static_cast<float>(tanh(static_cast<double>(p)));
        const float hn =
            __fadd_rn(__fmul_rn(lam, h), __fmul_rn(one_minus_lam, th));
        h_s[r * H + n] = hn;
        h_all[o] = hn;
        pre[o] = p;
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int H, bool with_u) {
  const size_t base = static_cast<size_t>(2) * kBM * H * sizeof(float);
  return with_u ? base + static_cast<size_t>(H) * H * sizeof(float) : base;
}

}  // namespace

// xw (B, T, H), u (H, H), h0 (B, H); outputs h_all, pre (B, T, H). All f32,
// contiguous, on the current device. Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue where H is too wide for the
// block's shared memory even without U (H > 3632 on an H100).
extern "C" int miru_scan_launch(const void* xw, const void* u, const void* h0,
                                void* h_all, void* pre, int B, int T, int H,
                                float beta, float lam, float one_minus_lam,
                                void* stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  static smem_optin::SmemOptin optin;
  int dev = 0, max_smem = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool u_in_smem = smem_bytes(H, true) <= static_cast<size_t>(max_smem);
  const size_t smem = smem_bytes(H, u_in_smem);
  if (smem > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(miru_scan_kernel),
                          dev, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreadsX, kBM);
  const int grid = (B + kBM - 1) / kBM;
  miru_scan_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const float*>(u),
      static_cast<const float*>(h0), static_cast<float*>(h_all),
      static_cast<float*>(pre), B, T, H, beta, lam, one_minus_lam,
      u_in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
