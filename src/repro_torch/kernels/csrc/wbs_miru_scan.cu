// Fused WBS x MiRU recurrence on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wbs_miru_scan.py ::
// wbs_miru_scan_pallas (_wbs_miru_kernel). Per batch row and time step:
//
//   1. sign-magnitude quantize beta*h to n_bits (the WBS buffer write);
//   2. acc = sum_b gains[t, b] * (plane_b * sign) @ U, MSB first;
//   3. pre = (drive_t + acc * norm * w_scale) + b_h, in that fp order;
//   4. the optional mid-rise ADC;
//   5. h <- lam*h + (1 - lam)*tanh(pre).
//
// It writes h_all, h_prev and pre, each (B, T, H).
//
// Design. One block owns kBM batch rows and loops t = 0..T-1 inside the
// kernel: the TPU's sequential T grid axis becomes that loop, with a block
// barrier after the quantize phase and one after the update. h, the
// quantized sign and code of beta*h live in shared memory. U (H x H f32)
// is copied into shared memory once when it fits the block's opt-in limit
// (H = 100: 40 KB; H = 128: 64 KB, above the 48 KB default, hence the
// dynamic-smem attribute); at H = 256 (256 KB > 227 KB) it stays in
// global memory and L2 serves the re-reads. Step 2 is the routine that
// wbs_matmul.cu uses (wbs_common.cuh), so this kernel and a per-step run
// of wbs_matmul produce the same bits. tanh is taken in double and rounded
// once to float (the correctly rounded float tanh), which the plain
// PyTorch version repeats on any device.
//
// What bounds it on the H100. By linearity the plane sum is one product of
// the decoded beta*h, so T steps need 2*B*T*H*H + 2*B*T*H*nb float
// operations: at B = 64, T = 14, H = 100 about 18 MFLOP and 1.5 MB to
// move, under half a microsecond (bytes). The kernel repeats the product
// per plane, the T loop is serial and B / kBM = 8 blocks occupy 8 of 132
// SMs, so latency (the per-thread K loop and two barriers a step) bounds
// it, and most of the card idles. Retiling the batch
// (fewer rows per block, or splitting columns across a cluster) is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_optin.cuh"
#include "wbs_common.cuh"

namespace {

constexpr int kBM = 8;         // batch rows per block
constexpr int kThreadsX = 128; // threads along H; each strides by 128

__global__ void __launch_bounds__(kBM * kThreadsX)
wbs_miru_scan_kernel(const float* __restrict__ drive,
                     const float* __restrict__ u,
                     const float* __restrict__ h0,
                     const float* __restrict__ b_h,
                     const float* __restrict__ gains,
                     float* __restrict__ h_all, float* __restrict__ h_prev,
                     float* __restrict__ pre, int T, int H, int n_bits,
                     float beta, float lam, float one_minus_lam, float top,
                     float norm, float w_scale, int use_adc, float step,
                     float lo, float hi, int u_in_smem) {
  extern __shared__ float smem[];
  float* h_s = smem;                                       // kBM * H
  float* u_s = h_s + kBM * H;                              // H * H, or none
  int8_t* sign_s =
      reinterpret_cast<int8_t*>(u_s + (u_in_smem ? H * H : 0));  // kBM * H
  uint8_t* code_s = reinterpret_cast<uint8_t*>(sign_s + kBM * H);

  const int r = threadIdx.y;
  const size_t row = static_cast<size_t>(blockIdx.x) * kBM + r;
  if (u_in_smem) {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int i = tid; i < H * H; i += blockDim.x * blockDim.y) u_s[i] = u[i];
  }
  for (int n = threadIdx.x; n < H; n += kThreadsX)
    h_s[r * H + n] = h0[row * H + n];
  const float* uu = u_in_smem ? u_s : u;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // 1. quantize beta*h (each thread its own columns of its row).
    for (int n = threadIdx.x; n < H; n += kThreadsX) {
      const float bh = __fmul_rn(beta, h_s[r * H + n]);
      const float mag = fminf(fmaxf(rintf(__fmul_rn(fabsf(bh), top)), 0.0f),
                              top);
      code_s[r * H + n] = static_cast<uint8_t>(mag);
      sign_s[r * H + n] = static_cast<int8_t>((bh > 0.0f) - (bh < 0.0f));
    }
    __syncthreads();
    // 2-5. plane product against U, integrator, ADC, lambda-update.
    const float* g = gains + static_cast<size_t>(t) * n_bits;
    for (int n = threadIdx.x; n < H; n += kThreadsX) {
      float acc = 0.0f;
      for (int k0 = 0; k0 < H; k0 += wbs::kBK) {
        const int kt = H - k0 < wbs::kBK ? H - k0 : wbs::kBK;
        acc = wbs::plane_tile(acc, sign_s + r * H + k0, code_s + r * H + k0,
                              uu + static_cast<size_t>(k0) * H + n, H, kt,
                              n_bits, g);
      }
      const float y = __fmul_rn(__fmul_rn(acc, norm), w_scale);
      const size_t o = (row * T + t) * H + n;
      float p = __fadd_rn(__fadd_rn(drive[o], y), b_h[n]);
      if (use_adc) p = wbs::adc(p, step, lo, hi);
      const float h = h_s[r * H + n];
      const float th = static_cast<float>(tanh(static_cast<double>(p)));
      const float hn = __fadd_rn(__fmul_rn(lam, h), __fmul_rn(one_minus_lam, th));
      h_s[r * H + n] = hn;
      h_all[o] = hn;
      h_prev[o] = h;
      pre[o] = p;
    }
    __syncthreads();
  }
}

size_t smem_bytes(int H, bool with_u) {
  const size_t base = static_cast<size_t>(kBM) * H * (sizeof(float) + 2);
  return with_u ? base + static_cast<size_t>(H) * H * sizeof(float) : base;
}

}  // namespace

// drive (B, T, H), u (H, H), h0 (B, H), b_h (H,), gains (T, n_bits); outputs
// h_all, h_prev, pre (B, T, H). All f32, contiguous, on the current device.
// B must be a multiple of 8 (kernels/ops.py pads). Returns the cudaError_t
// of the launch (0 on success); cudaErrorInvalidValue where H is too wide
// for the block's shared memory even without U (H > 4842 on an H100).
extern "C" int wbs_miru_scan_launch(
    const void* drive, const void* u, const void* h0, const void* b_h,
    const void* gains, void* h_all, void* h_prev, void* pre, int B, int T,
    int H, int n_bits, float beta, float lam, float one_minus_lam,
    float norm, float w_scale, int use_adc, float step, float lo, float hi,
    void* stream) {
  if (B % kBM != 0 || n_bits < 1 || n_bits > wbs::kMaxBits || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static smem_optin::SmemOptin optin;
  int dev = 0, max_smem = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool u_in_smem = smem_bytes(H, true) <= static_cast<size_t>(max_smem);
  const size_t smem = smem_bytes(H, u_in_smem);
  if (smem > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(wbs_miru_scan_kernel),
                          dev, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float top = static_cast<float>((1 << n_bits) - 1);
  const dim3 block(kThreadsX, kBM);
  wbs_miru_scan_kernel<<<B / kBM, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(drive), static_cast<const float*>(u),
      static_cast<const float*>(h0), static_cast<const float*>(b_h),
      static_cast<const float*>(gains), static_cast<float*>(h_all),
      static_cast<float*>(h_prev), static_cast<float*>(pre), T, H, n_bits,
      beta, lam, one_minus_lam, top, norm, w_scale, use_adc, step, lo, hi,
      u_in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
