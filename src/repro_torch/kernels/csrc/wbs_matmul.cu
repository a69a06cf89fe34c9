// Weighted-bit-streaming crossbar product on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wbs_matmul.py ::
// wbs_matmul_pallas (_wbs_kernel), both branches: wbs_matmul_kernel at
// read_sigma == 0, and with the per-access read noise of read_sigma > 0
// a draw pass (read_noise_weights, further down) before the same kernel:
//
//   out[m, n] = ADC( norm * sum_tiles sum_b gains[b] *
//                    sum_{k in tile} plane_b[m, k] * sign[m, k] * w[k, n] )
//
// with norm = 2^nb / (2^nb - 1) and the ADC optional.
//
// Design. A block of 128 threads owns a slab of kTN = 32 output columns
// and the rows that its threads cover. For each K tile of kBK it stages in
// shared memory the tile's slab of w (kt x 32 floats, by cp.async: every
// copy of a thread in flight at once, 16 bytes each where N allows, zeros
// past N) and the decoded bit planes of its rows (a table of 8 floats per
// input, wbs_common.cuh decode_planes, built once per block and read as a
// broadcast by the threads of a row). Then each thread runs
// wbs_common.cuh :: plane_dots, one pass over k carrying the sums of its
// planes for its columns, and the first thread of an output joins all of
// the output's plane sums in plane order (join_planes). The TPU's
// K-innermost grid and its VMEM scratch accumulator become that loop over
// K tiles, the fp32 sum carried in registers. The kernel masks the ragged
// M and N edges itself (rows past M decode as zeros, columns past N read
// zero weights, neither is stored), so the wrapper pads and slices
// nothing: one launch a product. Shared memory is sized to min(K, kBK).
//
// How the outputs are dealt to threads, from the main paths' two shapes,
// each way tried on the card at both (the others were slower):
//  - the hoisted drive, (896, 28) x (28, 100): 89,600 outputs, enough to
//    fill the card several times over, so a thread owns two neighbouring
//    columns of a row (all eight plane sums of each): the two share each
//    k's load of the planes, and a block covers 8 rows, 448 blocks;
//  - the per-step product, (64, 100) x (100, 100): 6,400 outputs, too few
//    to fill the card, and the time is one thread's chain of 100 k steps,
//    so an output has two threads, each with four planes' sums: the chain
//    a thread issues halves and twice the SMs share it, and a block covers
//    2 rows, 128 blocks.
// The wrapper picks by the number of outputs (32,768 or more: the first).
//
// What bounds it on the H100. By linearity the plane sum is one product of
// the decoded operand: 2*M*K*N + 2*M*K*nb float operations. At the two
// shapes that is 5 and 1.3 MFLOP, and about 0.4 and 0.08 MB to move: a
// fraction of a microsecond either way (bytes), so the launch, the
// latency of the staging loads and the kt-step chain of a thread bound
// it. Bitwise equality with the plain version fixes the order of every
// sum, so K cannot be split and the tensor cores (whose sums keep no fixed
// order) cannot be used.
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "smem_optin.cuh"
#include "wbs_common.cuh"

// A fault planted at build time (nvcc -DREAD_NOISE_FAULT=1, a library of
// its own name) by tools/parity_reach.py, to show what the checks catch:
// the second block of the draw pass draws at counter k * N + n + 1. The
// package's build leaves it 0.
#ifndef READ_NOISE_FAULT
#define READ_NOISE_FAULT 0
#endif

namespace {

constexpr int kTN = 32;  // output columns per block
constexpr int kThreads = 128;

// The block's shape for a thread owning C columns' sums of the planes of
// one of G plane groups: kTN / C * G threads a row, so kTM rows a block.
template <int G, int C>
struct Tile {
  static constexpr int kPB = wbs::kMaxBits / G;          // planes a thread
  static constexpr int kTM = kThreads / (kTN / C * G);   // rows a block
  // Dynamic shared memory for K tiles of up to kmax: the planes table (a
  // row's entries padded by one float4, so the rows of a warp fall in
  // other banks), then the w slab.
  static size_t smem(int kmax) {
    return (static_cast<size_t>(kTM) * (2 * kmax + 1)) * sizeof(float4) +
           static_cast<size_t>(kmax) * kTN * sizeof(float);
  }
};

template <int G, int C>
__global__ void __launch_bounds__(kThreads)
wbs_matmul_kernel(const int8_t* __restrict__ sign,
                  const uint8_t* __restrict__ code,
                  const float* __restrict__ w,
                  const float* __restrict__ gains, float* __restrict__ out,
                  int M, int K, int N, int n_bits, float norm, int use_adc,
                  float step, float lo, float hi) {
  constexpr int PB = Tile<G, C>::kPB, TM = Tile<G, C>::kTM;
  extern __shared__ float4 smem4[];
  const int kmax = K < wbs::kBK ? K : wbs::kBK;
  const int stride = 2 * kmax + 1;                // float4s a table row
  float4* planes = smem4;                         // [TM][stride]
  float* slab = reinterpret_cast<float*>(smem4 + TM * stride);
  const int tid = threadIdx.x;
  float g[wbs::kMaxBits];
#pragma unroll
  for (int b = 0; b < wbs::kMaxBits; ++b) g[b] = b < n_bits ? gains[b] : 0.f;

  // Thread tid: plane group tid % G of the C columns c0 .. c0 + C - 1 of
  // row r (the G threads of an output are neighbouring lanes of a warp).
  const int grp = tid % G, o = tid / G;
  const int r = o / (kTN / C), c0 = C * (o % (kTN / C));
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * kTN;
  const int m = m0 + r;
  // 16-byte copies of w where every slab row starts on 16 bytes.
  const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += wbs::kBK) {
    const int kt = K - k0 < wbs::kBK ? K - k0 : wbs::kBK;
    __syncthreads();  // the previous tile's tables are consumed
    if (vec) {
      for (int i = tid; i < kt * (kTN / 4); i += kThreads) {
        const int k = i / (kTN / 4), cc = 4 * (i % (kTN / 4));
        const int left = N - (n0 + cc);
        const float* src = w + static_cast<size_t>(k0 + k) * N + n0 + cc;
        cp_async16(smem_u32(slab + k * kTN + cc), left > 0 ? src : w,
                   left >= 4 ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kt * kTN; i += kThreads) {
        const int k = i / kTN, cc = i % kTN;
        const bool in = n0 + cc < N;
        cp_async4(smem_u32(slab + i),
                  in ? w + static_cast<size_t>(k0 + k) * N + n0 + cc : w,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < (TM * wbs::kBK + kThreads - 1) / kThreads; ++j) {
      const int i = tid + j * kThreads;
      if (i < TM * kt) {
        const int rr = i / kt, k = i % kt;
        float p[wbs::kMaxBits];
        if (m0 + rr < M) {
          const size_t e = static_cast<size_t>(m0 + rr) * K + k0 + k;
          wbs::decode_planes(sign[e], code[e], n_bits, p);
        } else {
          wbs::decode_planes(0, 0, n_bits, p);
        }
        planes[rr * stride + 2 * k] = make_float4(p[0], p[1], p[2], p[3]);
        planes[rr * stride + 2 * k + 1] = make_float4(p[4], p[5], p[6],
                                                      p[7]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    float dot[C][PB];
    wbs::plane_dots<PB, C>(dot, wbs::TablePlanes{planes + r * stride},
                           grp * PB, slab + c0, kTN, kt, n_bits);
    // The output's first thread gathers every plane's sum and joins them
    // in plane order.
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float all[wbs::kMaxBits];
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int j = 0; j < PB; ++j)
          all[q * PB + j] = q ? __shfl_down_sync(0xffffffffu, dot[c][j], q)
                              : dot[c][j];
      acc[c] = wbs::join_planes(acc[c], all, n_bits, g);
    }
  }
  if (grp != 0 || m >= M) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int n = n0 + c0 + c;
    if (n >= N) continue;
    float y = __fmul_rn(acc[c], norm);
    if (use_adc) y = wbs::adc(y, step, lo, hi);
    out[static_cast<size_t>(m) * N + n] = y;
  }
}

template <int G, int C>
cudaError_t launch_matmul(const void* sign, const void* code, const void* w,
                          const void* gains, void* out, int M, int K, int N,
                          int n_bits, float norm, int use_adc, float step,
                          float lo, float hi, cudaStream_t stream) {
  static smem_optin::SmemOptin optin;
  const auto kernel = wbs_matmul_kernel<G, C>;
  constexpr int TM = Tile<G, C>::kTM;
  if ((M + TM - 1) / TM > 65535) return cudaErrorInvalidValue;
  const size_t smem = Tile<G, C>::smem(K < wbs::kBK ? K : wbs::kBK);
  if (smem > 48 * 1024) {
    int dev = 0, limit = 0;
    cudaError_t err = smem_optin::device_limit(optin, &dev, &limit);
    if (err != cudaSuccess) return err;
    if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
    err = smem_optin::grant(optin, reinterpret_cast<const void*>(kernel),
                            dev, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kTN - 1) / kTN, (M + TM - 1) / TM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(sign), static_cast<const uint8_t*>(code),
      static_cast<const float*>(w), static_cast<const float*>(gains),
      static_cast<float*>(out), M, K, N, n_bits, norm, use_adc, step, lo,
      hi);
  return cudaGetLastError();
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
// as its counter. So each call draws one normal per weight element,
// shared by all rows, for any M (the TPU shares a draw within a 128-row
// block only), and the plain version (kernels/ref.py :: read_noise)
// reproduces it exactly.
//
// z is the TPU kernel's Box-Muller: u = (bits >> 8) * 2^-24 clamped below
// at 2^-24, z = sqrt(-2 ln u1) * cos(2 pi u2), evaluated in double and
// rounded once to float, so libdevice's float logf/cosf play no part and
// the plain version's float64 evaluation gives the same float. The
// perturbation rounds as the plain version writes it, sigma * z, then
// 1 + that, then w * that, with explicit _rn intrinsics so nvcc contracts
// nothing into an FMA.
//
// Design: one C call, two launches. A draw pass (read_noise_weights)
// writes the perturbed weights into a (K, N) scratch the wrapper
// allocates, one thread a normal, on at least 64 blocks; then
// wbs_matmul_kernel contracts the scratch, chosen as wbs_matmul_launch
// chooses. The plain version is defined as exactly that composition
// (ref.wbs_matmul_read_noise_ref: wbs_matmul_ref over w * (1 + sigma z)),
// so the launch is bitwise by construction, and at sigma == 0 the scratch
// is w itself: the same bits as wbs_matmul_kernel. What bounds it: the
// draws, about 50 double operations each for log, cos and sqrt (10,000
// normals at the per-step shape: some 0.015 microseconds at H100's 34
// TFLOP/s of non-tensor fp64, far below a launch), and the product as
// wbs_matmul_kernel's (the launch, its staging loads, one thread's k
// chain); the two launches' fixed costs dominate at the main path's
// shapes.
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

// Draw-pass threads a block: enough blocks to spread the draws over the
// card (at least 64 at the main path's 2,800 and 10,000 normals).
__host__ inline int draw_threads(uint32_t count) {
  const uint32_t per = (count + 131) / 132;
  const uint32_t t = (per + 31) / 32 * 32;
  return static_cast<int>(t < 32 ? 32 : (t > 256 ? 256 : t));
}

// w_noisy[i] = w[i] * (1 + sigma * z_i), z_i the normal of counter i =
// k * N + n, one thread an element.
__global__ void __launch_bounds__(256)
read_noise_weights(const float* __restrict__ w, float* __restrict__ w_noisy,
                   uint32_t count, float sigma, uint32_t key0,
                   uint32_t key1) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t counter = i;
#if READ_NOISE_FAULT
  if (blockIdx.x == 1) counter = i + 1;
#endif
  w_noisy[i] = __fmul_rn(
      w[i], __fadd_rn(1.0f, __fmul_rn(sigma, read_normal(counter, key0,
                                                          key1))));
}

// The product of wbs_matmul_launch: a product with outputs enough to fill
// the card several times over (the drive's 89,600) gives a thread two
// columns, which share its loads of the planes; one with few (the step's
// 6,400) gives an output two threads of four planes each, so that more
// SMs share its k chains.
cudaError_t launch_product(const void* sign, const void* code, const void* w,
                           const void* gains, void* out, int M, int K, int N,
                           int n_bits, float norm, int use_adc, float step,
                           float lo, float hi, cudaStream_t s) {
  return static_cast<long long>(M) * N >= 32768
             ? launch_matmul<1, 2>(sign, code, w, gains, out, M, K, N,
                                   n_bits, norm, use_adc, step, lo, hi, s)
             : launch_matmul<2, 1>(sign, code, w, gains, out, M, K, N,
                                   n_bits, norm, use_adc, step, lo, hi, s);
}

}  // namespace

// sign, code (M, K) int8 / uint8; w (K, N) f32; gains (n_bits,) f32;
// out (M, N) f32. All row-major and contiguous on one device; any M, K, N
// (the kernel masks the ragged edges). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int wbs_matmul_launch(const void* sign, const void* code,
                                 const void* w, const void* gains, void* out,
                                 int M, int K, int N, int n_bits, float norm,
                                 int use_adc, float step, float lo, float hi,
                                 void* stream) {
  if (M < 1 || K < 1 || N < 1 || n_bits < 1 || n_bits > wbs::kMaxBits)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_product(sign, code, w, gains, out, M, K, N,
                                         n_bits, norm, use_adc, step, lo, hi,
                                         static_cast<cudaStream_t>(stream)));
}

// The read-noise variant: as wbs_matmul_launch, plus sigma, the Philox key
// (key0, key1) and w_noisy, a (K, N) f32 scratch for the perturbed
// weights. K * N, the count of normals, must fit in 32 bits.
extern "C" int wbs_matmul_read_noise_launch(
    const void* sign, const void* code, const void* w, const void* gains,
    void* w_noisy, void* out, int M, int K, int N, int n_bits, float norm,
    int use_adc, float step, float lo, float hi, float sigma,
    unsigned int key0, unsigned int key1, void* stream) {
  if (M < 1 || K < 1 || N < 1 || n_bits < 1 || n_bits > wbs::kMaxBits ||
      static_cast<unsigned long long>(K) * N > 0xFFFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t count = static_cast<uint32_t>(K) * static_cast<uint32_t>(N);
  const int threads = draw_threads(count);
  const unsigned int blocks = static_cast<unsigned int>(
      (static_cast<unsigned long long>(count) + threads - 1) / threads);
  read_noise_weights<<<blocks, threads, 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(w_noisy), count,
      sigma, key0, key1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_product(sign, code, w_noisy, gains, out, M,
                                         K, N, n_bits, norm, use_adc, step,
                                         lo, hi, s));
}
