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
// Arithmetic. Summation order is the only freedom, and the plain PyTorch
// version (kernels/ref.py :: miru_scan_ref) fixes it: each output sums
// its column k ascending with __fmul_rn/__fadd_rn (no FMA contraction),
// adds the sum to xw_t, takes tanh in double, rounded once, and updates h
// as lam * h + (1 - lam) * tanh, so kernel and plain version agree bit for
// bit on any device. Nothing may split k.
//
// What bounds it on the H100. T steps need 2*B*T*H*H float operations and
// move xw in, h_all and pre out, U and h0 once: at B = 64, T = 28, H = 100
// about 36 MFLOP and 2.2 MB, some 0.7 microseconds (bytes). The T steps
// are serial, and so is each output's sum over k: a step is at least an
// H-long chain of dependent adds (4 cycles each), a double tanh, the
// update and a barrier, some 4 H + 400 cycles (a model: chip_smoke.py's
// serial_floor_model_ms), 0.011 ms at T 28 and H 100. That chain, not the
// bytes or the operations, is what a launch can approach. Measured at
// (64, 28, 100) (tools/kernel_times.py, PERF.md): 0.0185 ms, about 1,300
// cycles a step; its parts_cut_ms time the kernel without the double
// tanh and without the sums, to show where a step goes. Above H 128,
// where U is read from shared or global memory, the chain waits on those
// loads besides: 0.136 ms at (64, 28, 200), 0.209 at (64, 28, 256).
//
// Design. The rows are spread over the card, and U is taken out of the
// loads of the chain:
//  - a block owns one batch row and loops t = 0..T-1 inside the kernel,
//    each thread one output column at a time: B blocks, 64 at train
//    (a)'s shape. One row a block ran fastest at every shape timed
//    (PERF.md): more rows a block put more chains on each warp, and a
//    cluster of 2 blocks that split the columns and shared h by
//    st.async ran slower, its values' round trip longer than a block
//    barrier;
//  - where H <= 128, the thread keeps its column U[:, n] in registers
//    for the whole launch, and its sum runs with no branch over all KU
//    inputs of the shortest chain that holds H (chain_length,
//    row_sum_reg), the next step's xw loaded a step ahead; above that,
//    U stays in shared memory where it fits, else in global memory
//    behind L2 (the wrapper chooses: miru_scan.py :: u_place), and the
//    sum's loads run 32 inputs ahead of its chain (row_sum);
//  - beta*h of the row over all H inputs sits in shared memory, in two
//    buffers, read as 16-byte broadcasts; the thread that owns an output
//    writes the next step's beta*h into the other buffer, and one block
//    barrier a step orders the two.
// A step is then one add chain a thread, its multiplies off the chain,
// one double tanh and one barrier.
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "smem_optin.cuh"

// A fault planted at build time (nvcc -DMIRU_SCAN_FAULT=1, a library of
// its own name) by tools/parity_reach.py, to show what the checks catch:
// the chains of the second block drop their last k. The package's build
// leaves it 0.
#ifndef MIRU_SCAN_FAULT
#define MIRU_SCAN_FAULT 0
#endif

namespace {

constexpr int kRegK = 128;        // H up to which U's column is in registers
constexpr int kMemThreads = 512;  // threads a block where it is not
// Where U is read from (the wrapper's PLACES).
enum UPlace { kGlobal = 0, kSmem = 1, kRegisters = 2 };

// The chain a thread with U's column in registers runs at width H: 32,
// 64, the paper's 100 or kRegK, the shortest that holds H. A link costs
// about 5 cycles, so a chain runs no longer than it must; kRegK is the
// widest column that fits the registers beside the chain and the row's
// state.
__host__ __device__ inline int chain_length(int H) {
  return H <= 32 ? 32 : H <= 64 ? 64 : H <= 100 ? 100 : kRegK;
}

// A buffer of beta*h in floats: H rounded up to whole float4s, or the
// chain's length where U's column is in registers (the chain runs over
// all of it, the inputs past H zeros).
__host__ __device__ inline int row_stride(int H, int place) {
  return place == kRegisters ? chain_length(H) : (H + 3) / 4 * 4;
}

// Shared memory of a block (bytes): two buffers of beta*h, U when kept
// there, and h of the row unless each thread keeps its output's in a
// register. The wrapper (miru_scan.py :: smem_bytes) counts the same; the
// launch refuses a layout that does not fit the device.
__host__ __device__ inline size_t smem_bytes(int H, int place) {
  return static_cast<size_t>(2) * row_stride(H, place) * sizeof(float) +
         (place == kSmem ? static_cast<size_t>(H) * H * sizeof(float) : 0) +
         (place != kRegisters ? static_cast<size_t>(H) * sizeof(float) : 0);
}

// sum_{k < kh} b[k] * u(k), k ascending: the products and sums rounded
// one by one. b is the block's buffer of beta*h, read four inputs at a
// time; u(k) reads U from shared or global memory. Its loads run a group
// of kAhead inputs ahead of the chain (the next group's issued before
// the current group's adds), so that the chain waits on one load's
// latency a group, not one every four inputs; a tail shorter than a
// group follows k by k.
constexpr int kAhead = 32;
template <class U>
__device__ __forceinline__ float row_sum(const float* b, int kh, const U& u) {
  float acc = 0.0f;
  float cur[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) cur[j] = j < kh ? u(j) : 0.0f;
  int k0 = 0;
  for (; k0 + kAhead <= kh; k0 += kAhead) {
    float nxt[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      nxt[j] = k0 + kAhead + j < kh ? u(k0 + kAhead + j) : 0.0f;
#pragma unroll
    for (int j = 0; j < kAhead; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(b + k0 + j);
      acc = __fadd_rn(acc, __fmul_rn(v.x, cur[j]));
      acc = __fadd_rn(acc, __fmul_rn(v.y, cur[j + 1]));
      acc = __fadd_rn(acc, __fmul_rn(v.z, cur[j + 2]));
      acc = __fadd_rn(acc, __fmul_rn(v.w, cur[j + 3]));
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) cur[j] = nxt[j];
  }
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (k0 + j < kh) acc = __fadd_rn(acc, __fmul_rn(b[k0 + j], cur[j]));
  return acc;
}

// The same with U's column in registers: the loop over k unrolled in
// full, so that every u[k] is a register of its own, and run over all KU
// inputs with no branch, so that the compiler issues the loads of
// beta*h ahead of the adds that wait for them (a branch at H kept each
// load behind it, and the chain waited on every one). Past H, beta*h
// and u are +0, and a sum that starts at +0 never becomes -0 in
// round-to-nearest, so each added +0 * +0 leaves its bits as they were:
// the sum of k < H alone.
template <int KU>
__device__ __forceinline__ float row_sum_reg(const float* b,
                                             const float (&u)[KU]) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < KU; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + k);
    acc = __fadd_rn(acc, __fmul_rn(v.x, u[k]));
    acc = __fadd_rn(acc, __fmul_rn(v.y, u[k + 1]));
    acc = __fadd_rn(acc, __fmul_rn(v.z, u[k + 2]));
    acc = __fadd_rn(acc, __fmul_rn(v.w, u[k + 3]));
  }
  return acc;
}

// One output's update: pre and the new h, stored; returns the new h.
__device__ __forceinline__ float update(float x, float acc, float h,
                                       float lam, float one_minus_lam,
                                       float* h_all, float* pre, size_t o) {
  const float p = __fadd_rn(x, acc);
  const float th = static_cast<float>(tanh(static_cast<double>(p)));
  const float hn =
      __fadd_rn(__fmul_rn(lam, h), __fmul_rn(one_minus_lam, th));
  h_all[o] = hn;
  pre[o] = p;
  return hn;
}

// Block b owns batch row b. KU > 0: thread n owns column n and keeps it
// (U's column, KU registers, and the row's h) in registers, its chain
// KU long; KU == 0: thread j owns columns j, j + blockDim.x, ..., with h
// in shared memory and U read from shared memory (u_in_smem) or from
// global memory. One block an SM is all the bounds promise: without the
// 1, ptxas traded registers for occupancy and spilled.
template <int KU>
__global__ void __launch_bounds__(KU ? kRegK : kMemThreads, 1)
miru_scan_kernel(const float* __restrict__ xw, const float* __restrict__ u,
                 const float* __restrict__ h0, float* __restrict__ h_all,
                 float* __restrict__ pre, int T, int H, float beta,
                 float lam, float one_minus_lam, int u_in_smem) {
  const size_t row = blockIdx.x;
  extern __shared__ float4 smem4[];
  constexpr bool REG = KU > 0;
  const int stride = REG ? KU : row_stride(H, kGlobal);
  float* bh = reinterpret_cast<float*>(smem4);           // [2][stride]
  float* u_s = bh + 2 * stride;                          // [H][H]
  float* h_s = u_s + (u_in_smem ? H * H : 0);            // [H]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  int kh = H;                       // the inputs that the sums run over
#if MIRU_SCAN_FAULT
  if (blockIdx.x == 1) kh = H - 1;
#endif

  // beta*h0 of every input into buffer 0, zeros past H in both buffers.
  for (int i = tid; i < 2 * stride; i += nthreads)
    bh[i] = i < H ? __fmul_rn(beta, h0[row * H + i]) : 0.0f;
  if (!REG) {
    for (int n = tid; n < H; n += nthreads) h_s[n] = h0[row * H + n];
    if (u_in_smem)
      for (int i = tid; i < H * H; i += nthreads) u_s[i] = u[i];
  }
  // REG: this thread's column, its row's state and its first xw.
  const int n = tid;
  const bool live = REG && n < H;
  float ur[REG ? KU : 1];
  float h = 0.0f, xn = 0.0f;
  if constexpr (REG) {
#pragma unroll
    for (int k = 0; k < KU; ++k)
      ur[k] = live && k < kh ? u[static_cast<size_t>(k) * H + n] : 0.0f;
    h = live ? h0[row * H + n] : 0.0f;
    xn = live ? xw[row * T * H + n] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* cur = bh + (t & 1) * stride;
    float* next = bh + ((t & 1) ^ 1) * stride;
    if constexpr (REG) {
      // This step's xw, and the next step's loaded a step ahead.
      const float x = xn;
      if (live && t + 1 < T) xn = xw[(row * T + t + 1) * H + n];
      const float acc = row_sum_reg<KU>(cur, ur);
      if (live) {
        h = update(x, acc, h, lam, one_minus_lam, h_all, pre,
                   (row * T + t) * H + n);
        next[n] = __fmul_rn(beta, h);
      }
    } else {
      for (int j = tid; j < H; j += nthreads) {
        const size_t o = (row * T + t) * H + j;
        const float x = xw[o];      // in flight while the sum runs
        const float acc =
            u_in_smem ? row_sum(cur, kh, [&](int k) { return u_s[k * H + j]; })
                      : row_sum(cur, kh, [&](int k) {
                          return __ldg(u + static_cast<size_t>(k) * H + j);
                        });
        const float hn = update(x, acc, h_s[j], lam, one_minus_lam, h_all,
                                pre, o);
        h_s[j] = hn;
        next[j] = __fmul_rn(beta, hn);
      }
    }
    __syncthreads();
  }
}

template <int KU>
cudaError_t launch(const float* xw, const float* u, const float* h0,
                   float* h_all, float* pre, int B, int T, int H, float beta,
                   float lam, float one_minus_lam, int place,
                   cudaStream_t stream) {
  static smem_optin::SmemOptin optin;
  const auto kernel = miru_scan_kernel<KU>;
  int dev = 0, max_smem = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &max_smem);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(H, place);
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(kernel), dev,
                          smem);
  if (err != cudaSuccess) return err;
  const int want = (H + 31) / 32 * 32;
  kernel<<<B, want < kMemThreads ? want : kMemThreads, smem, stream>>>(
      xw, u, h0, h_all, pre, T, H, beta, lam, one_minus_lam,
      place == kSmem ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// xw (B, T, H), u (H, H), h0 (B, H); outputs h_all, pre (B, T, H). All f32,
// contiguous, on the current device. One block a batch row, reading U
// from global memory (u_place 0), shared memory (1) or, each thread its
// column, registers (2: H <= 128), as the wrapper chooses
// (kernels/miru_scan.py :: u_place). Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidValue where the arguments are
// out of range or the block's layout does not fit the device's shared
// memory.
extern "C" int miru_scan_launch(const void* xw, const void* u, const void* h0,
                                void* h_all, void* pre, int B, int T, int H,
                                float beta, float lam, float one_minus_lam,
                                int u_place, void* stream) {
  if (B < 1 || T < 1 || H < 1 || u_place < kGlobal ||
      u_place > kRegisters || (u_place == kRegisters && H > kRegK))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(xw);
  const auto* uu = static_cast<const float*>(u);
  const auto* h = static_cast<const float*>(h0);
  auto* ha = static_cast<float*>(h_all);
  auto* p = static_cast<float*>(pre);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto ku) {
    return launch<decltype(ku)::value>(x, uu, h, ha, p, B, T, H, beta, lam,
                                       one_minus_lam, u_place, s);
  };
  cudaError_t err;
  if (u_place != kRegisters) {
    err = go(std::integral_constant<int, 0>());
  } else {
    switch (chain_length(H)) {
      case 32: err = go(std::integral_constant<int, 32>()); break;
      case 64: err = go(std::integral_constant<int, 64>()); break;
      case 100: err = go(std::integral_constant<int, 100>()); break;
      default: err = go(std::integral_constant<int, 128>());
    }
  }
  return static_cast<int>(err);
}
