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
// Design. The T steps are serial, so the kernel spreads each step over
// the card instead: a thread block cluster (Hopper) of `cluster` blocks
// owns `rows` batch rows and loops t = 0..T-1 inside the kernel, and each
// block of it owns a slab of ncols (ceil(H / cluster), rounded up to a
// multiple of kC) columns of U's output and so of h:
//  - the block keeps its slab of U (H x ncols floats) in shared memory
//    when it fits the opt-in limit, else reads it from global memory
//    behind L2 (the wrapper decides, and passes ncols; at H = 100 in an
//    8-block cluster the slab is 5 KB);
//  - every block holds the quantized beta*h of its rows for all H inputs,
//    sign and code, in two buffers: the thread that owns an output
//    quantizes its new h and writes the code into that buffer of every
//    block of the cluster with st.async (distributed shared memory), which
//    completes its 4 bytes on the receiving block's mbarrier; a block
//    starts step t + 1 once its barrier has counted the rows * H codes of
//    h_{t+1} in. Nothing else synchronizes the cluster: a block's codes
//    for step t + 1 leave after it has used its table and the buffer that
//    step t + 2's codes overwrite, so no barrier across the cluster, and
//    no fence of global memory, is needed (a cluster barrier's release
//    compiles to a fence of all of the block's memory traffic,
//    MEMBAR.ALL.GPU, every step);
//  - at the start of a step each block decodes the codes once into a
//    table of bit planes (wbs_common.cuh TablePlanes, two float4 an
//    input), which every thread then reads;
//  - outputs go in units of kC = 2 neighbouring columns to kG = 2
//    threads, each thread carrying kPB = 4 planes' sums of both columns
//    over all of k in order, the loads of the next kChunk k in flight
//    while the FMAs of the current kChunk run (PlaneDots below); thread g
//    of the unit then joins all eight plane sums of column g in plane
//    order (wbs_common.cuh join_planes), tile by 128-deep K tile, as
//    wbs_matmul_kernel does at small shapes, runs steps 3-5 for it, sends
//    its code and stores its outputs; the next step's drive is
//    prefetched by cp.async.
// Every sum runs in the order of wbs_matmul.cu's (k ascending in fp32, K
// tiles of 128, planes joined MSB first), so the fused and the per-step
// path give the same bits, and a row's bits do not depend on which rows
// share its cluster. tanh is taken in double and rounded once to float
// (the correctly rounded float tanh), which the plain PyTorch version
// repeats on any device. The wrapper (wbs_miru_scan.py :: geometry)
// chooses the cluster's size from H and its rows from B: at the main
// paths' shapes (B 64 and 32, H 100) clusters of 2 blocks, one row each,
// 128 and 64 blocks (8 rows a block on 8 SMs before).
//
// What bounds it on the H100. The plane sums are B*T*H*H*n_bits fp32
// FMAs (72 M at B 64, T 14, H 100: 0.0021 ms at 67 TFLOP/s), and the
// bits fix their order, so neither K nor the planes' join can be split
// and no tensor core can take them. The T steps are serial: each is at
// least a (kt + n_bits)-long chain of dependent FMAs, a double tanh, the
// ADC's division and the codes' round trip through the cluster, about
// 1,000 cycles, 0.008 ms at T 14. The kernel takes several times that
// floor: most of a step is one thread's pass over k, bound by its
// shared-memory loads and its issue rate (PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "smem_optin.cuh"
#include "wbs_common.cuh"

// A fault planted at build time (nvcc -DWBS_SCAN_FAULT=1, a library of its
// own name) by tools/parity_reach.py, to show what the checks catch: the
// planes of the second block's column slab joined LSB first. The package's
// build leaves it 0.
#ifndef WBS_SCAN_FAULT
#define WBS_SCAN_FAULT 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 8;    // batch rows a cluster
constexpr int kChunk = 8;      // k steps whose loads a thread issues at once
// Outputs go to units of kG = 8 / kPB threads, each thread carrying kPB
// planes of the unit's kC columns: with (4, 2) a thread issues one plane
// load (a float4) and one weight load (a float2) for eight FMAs a k.
constexpr int kPB = 4;         // planes a thread
constexpr int kG = wbs::kMaxBits / kPB;   // threads a unit
constexpr int kC = 2;          // columns a unit (at most kG)

// The mbarriers that count a step's codes in (PTX ISA, "mbarrier"): each
// phase expects rows * H * 4 bytes, written by the cluster's blocks with
// st.async, which completes their bytes on the receiving block's barrier.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// The shared::cluster address of `addr` (this block's shared memory) in
// block `rank` of the cluster.
__device__ __forceinline__ uint32_t in_block(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
// 4 bytes into another block's shared memory, completed on its barrier.
__device__ __forceinline__ void send(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

// beta*h quantized to n_bits, sign-magnitude: the code in the low byte,
// the sign (-1, 0, 1) in the next.
__device__ __forceinline__ uint32_t quantize(float beta, float h, float top) {
  const float bh = __fmul_rn(beta, h);
  const float mag = fminf(fmaxf(rintf(__fmul_rn(fabsf(bh), top)), 0.0f),
                          top);
  const int sign = (bh > 0.0f) - (bh < 0.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(mag)) |
         (static_cast<uint32_t>(static_cast<uint8_t>(sign)) << 8);
}

// decode_planes(sign, code) of a packed code (wbs_common.cuh) with
// selects in place of its conversions and products: p_b = bit_b * sign is
// sign where the bit is set and 0 * sign where it is not, the same floats.
__device__ __forceinline__ void decode(uint32_t c, int n_bits,
                                       float (&p)[wbs::kMaxBits]) {
  const float s = static_cast<float>(static_cast<int8_t>(c >> 8));
  const float z = __fmul_rn(0.0f, s);
  const uint32_t code = c & 0xff;
#pragma unroll
  for (int b = 0; b < wbs::kMaxBits; ++b)
    p[b] = b < n_bits ? (((code >> (n_bits - 1 - b)) & 1) ? s : z) : 0.0f;
}

// The plane table's row stride in float4s: at least 2H, and 4 more than a
// multiple of 8, so that rows r and r + 1 fall 64 bytes apart in the banks
// and a unit's threads (planes 0-3 and 4-7) in neighbouring rows read
// other banks.
__host__ __device__ inline int table_stride(int H) {
  return 2 * H + ((4 - 2 * H % 8) + 8) % 8;
}

// Weights of the kC neighbouring columns at row k of w: one load from
// shared memory (SMEM: w and ldw multiples of kC; the slab is zero past
// H), else up to kC loads from global memory, of the `cols` columns below
// H (the others read as zeros and are never used).
template <bool SMEM>
__device__ __forceinline__ void weights(const float* w, int ldw, int k,
                                        int cols, float (&wk)[kC]) {
  const float* at = w + static_cast<size_t>(k) * ldw;
  if constexpr (SMEM && kC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(at);
    wk[0] = a.x;
    wk[1] = a.y;
  } else {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      wk[c] = SMEM ? at[c] : (c < cols ? __ldg(at + c) : 0.0f);
  }
}

// wbs_common.cuh plane_dots for kC neighbouring columns and kPB planes,
// software-pipelined: the loads of the next kChunk k are in flight while
// the FMAs of the current kChunk run. The same sums, k ascending, in fp32.
// A step's latency is one thread's pass over k, so its loads must not
// wait one by one.
template <bool SMEM>
struct PlaneDots {
  const wbs::TablePlanes& planes;
  int b0;
  const float* w;
  int ldw;
  int cols;        // the unit's columns below H
  int n_bits;

  __device__ __forceinline__ void load(float (&p)[kChunk][kPB],
                                       float (&wk)[kChunk][kC], int k) const {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      planes.get<kPB>(k + i, b0, p[i]);
      weights<SMEM>(w, ldw, k + i, cols, wk[i]);
    }
  }
  __device__ __forceinline__ void step(float (&dot)[kC][kPB],
                                       const float (&p)[kPB],
                                       const float (&wk)[kC]) const {
#pragma unroll
    for (int j = 0; j < kPB; ++j)
      if (b0 + j < n_bits)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          dot[c][j] = __fmaf_rn(p[j], wk[c], dot[c][j]);
  }
  __device__ __forceinline__ void run(float (&dot)[kC][kPB], int kt) const {
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < kPB; ++j) dot[c][j] = 0.0f;
    const int n_chunks = kt / kChunk;
    float pa[kChunk][kPB], pb[kChunk][kPB], wa[kChunk][kC], wb[kChunk][kC];
    if (n_chunks > 0) load(pa, wa, 0);
    for (int c = 0; c < n_chunks; c += 2) {
      if (c + 1 < n_chunks) load(pb, wb, (c + 1) * kChunk);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) step(dot, pa[i], wa[i]);
      if (c + 1 == n_chunks) break;
      if (c + 2 < n_chunks) load(pa, wa, (c + 2) * kChunk);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) step(dot, pb[i], wb[i]);
    }
    for (int k = n_chunks * kChunk; k < kt; ++k) {
      float p[kPB], wk[kC];
      planes.get<kPB>(k, b0, p);
      weights<SMEM>(w, ldw, k, cols, wk);
      step(dot, p, wk);
    }
  }
};

// Shared memory of a block (bytes): the two barriers, the plane table, U's
// slab when it is kept there, three floats an output, two buffers of
// codes. The wrapper (wbs_miru_scan.py :: smem_bytes) counts the same to
// choose where U's slab goes; the launch refuses a layout that does not
// fit the device.
__host__ __device__ inline size_t smem_bytes(int H, int rows, int ncols,
                                             bool with_u) {
  return 16 + static_cast<size_t>(rows) * table_stride(H) * sizeof(float4) +
         (with_u ? static_cast<size_t>(H) * ncols * sizeof(float) : 0) +
         static_cast<size_t>(3) * rows * ncols * sizeof(float) +
         static_cast<size_t>(2) * rows * H * sizeof(uint32_t);
}

// Outputs are dealt in units of kC neighbouring columns (ncols is a
// multiple of kC) to kG neighbouring threads: thread g of a unit carries
// planes kPB g .. kPB g + kPB - 1 of the unit's columns, then thread g < kC
// owns column g: it gathers the unit's plane sums of that column and
// joins all eight in plane order.
__global__ void __launch_bounds__(kMaxThreads)
wbs_miru_scan_kernel(const float* __restrict__ drive,
                     const float* __restrict__ u,
                     const float* __restrict__ h0,
                     const float* __restrict__ b_h,
                     const float* __restrict__ gains,
                     float* __restrict__ h_all, float* __restrict__ h_prev,
                     float* __restrict__ pre, int T, int H, int n_bits,
                     float beta, float lam, float one_minus_lam, float top,
                     float norm, float w_scale, int use_adc, float step,
                     float lo, float hi, int rows, int ncols, int u_in_smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int c0 = static_cast<int>(cluster.block_rank()) * ncols;
  const size_t row0 = static_cast<size_t>(blockIdx.x / n_blocks) * rows;

  extern __shared__ float4 smem4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);   // one a buffer
  const int stride = table_stride(H);            // float4s a table row
  float4* table = smem4 + 1;                     // [rows][stride]
  float* u_s = reinterpret_cast<float*>(table + rows * stride);
  const int n_out = rows * ncols;
  float* h_s = u_s + (u_in_smem ? H * ncols : 0);   // [n_out] each
  float* drive_s = h_s + n_out;
  float* bh_s = drive_s + n_out;
  uint32_t* codes = reinterpret_cast<uint32_t*>(bh_s + n_out);  // [2][rows][H]
  const uint32_t bytes = static_cast<uint32_t>(rows) * H * 4;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid % kG, lane0 = (tid & 31) - g;   // the unit's first lane
  const int per_pass = nthreads / kG * kC;           // outputs a pass
  // Output o = r * ncols + j: row row0 + r, column c0 + j. Unit u computes
  // outputs kC u .. kC u + kC - 1 (then those a pass further on); its
  // thread g owns output kC u + g: its state lives in shared memory, read
  // and written by that thread alone.
  auto real = [&](int o) { return o < n_out && c0 + o % ncols < H; };
  auto index = [&](int o, int t) {
    return ((row0 + o / ncols) * T + t) * H + c0 + o % ncols;
  };

  if (u_in_smem)
    for (int i = tid; i < H * ncols; i += nthreads) {
      const int k = i / ncols, n = c0 + i % ncols;
      cp_async4(smem_u32(u_s + i), n < H ? u + static_cast<size_t>(k) * H + n
                                         : u, n < H ? 4 : 0);
    }
  for (int o = tid; o < n_out; o += nthreads) {
    const bool in = real(o);
    const int n = c0 + o % ncols;
    h_s[o] = in ? h0[(row0 + o / ncols) * H + n] : 0.0f;
    bh_s[o] = in ? b_h[n] : 0.0f;
    cp_async4(smem_u32(drive_s + o), in ? drive + index(o, 0) : drive,
              in ? 4 : 0);
  }
  cp_async_commit();
#pragma unroll 4
  for (int i = tid; i < rows * H; i += nthreads)
    codes[i] = quantize(beta, h0[row0 * H + i], top);
  if (tid == 0) {
    mbar_init(smem_u32(bars));
    mbar_init(smem_u32(bars + 1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (T > 1) mbar_expect(smem_u32(bars + 1), bytes);   // step 1's codes
    if (T > 2) mbar_expect(smem_u32(bars), bytes);       // step 2's
  }
  cp_async_wait<0>();
  cluster.sync();            // every block runs, and step 0's codes are in

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    float gn[wbs::kMaxBits];
#pragma unroll
    for (int b = 0; b < wbs::kMaxBits; ++b)
      gn[b] = b < n_bits ? gains[static_cast<size_t>(t) * n_bits + b] : 0.0f;
    if (t > 0) {
      // Every block's codes of h_t are in. They were sent after each block
      // had used the table and the buffer that step t overwrites.
      mbar_wait(smem_u32(bars + buf), ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 < T) mbar_expect(smem_u32(bars + buf), bytes);
    }
    const uint32_t* cur = codes + buf * rows * H;
    const uint32_t next = smem_u32(codes + (buf ^ 1) * rows * H);
    const uint32_t next_bar = smem_u32(bars + (buf ^ 1));
    // Decode this step's codes once into the plane table, the loads of a
    // column's rows first.
    for (int k = tid; k < H; k += nthreads) {
      uint32_t c[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) c[r] = r < rows ? cur[r * H + k] : 0;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r >= rows) break;
        float p[wbs::kMaxBits];
        decode(c[r], n_bits, p);
        table[r * stride + 2 * k] = make_float4(p[0], p[1], p[2], p[3]);
        table[r * stride + 2 * k + 1] = make_float4(p[4], p[5], p[6], p[7]);
      }
    }
    __syncthreads();

    // Every lane runs every pass (the shuffles take the whole warp).
    for (int base = 0; base < n_out; base += per_pass) {
      const int o0 = base + kC * (tid / kG);     // the unit's first output
      const bool in = o0 < n_out && c0 + o0 % ncols < H;
      const int r = in ? o0 / ncols : 0, j = in ? o0 % ncols : 0;
      float acc = 0.0f;
      for (int k0 = 0; k0 < H; k0 += wbs::kBK) {
        const int kt = in ? (H - k0 < wbs::kBK ? H - k0 : wbs::kBK) : 0;
        const wbs::TablePlanes tp{table + r * stride + 2 * k0};
        float dot[kC][kPB];
        if (u_in_smem)
          PlaneDots<true>{tp, g * kPB, u_s + k0 * ncols + j, ncols, kC,
                          n_bits}
              .run(dot, kt);
        else
          PlaneDots<false>{tp, g * kPB,
                           u + static_cast<size_t>(k0) * H + c0 + j, H,
                           H - (c0 + j), n_bits}
              .run(dot, kt);
        // Thread g gathers column g's plane sums from the unit's threads.
        float all[wbs::kMaxBits];
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int q = 0; q < kG; ++q)
#pragma unroll
            for (int b = 0; b < kPB; ++b) {
              const float x =
                  __shfl_sync(0xffffffffu, dot[c][b], lane0 + q);
              if (c == 0 || g == c) all[q * kPB + b] = x;
            }
#if WBS_SCAN_FAULT
        if (c0 == ncols) {
#pragma unroll
          for (int b = wbs::kMaxBits - 1; b >= 0; --b)
            if (b < n_bits) acc = __fadd_rn(acc, __fmul_rn(gn[b], all[b]));
          continue;
        }
#endif
        acc = wbs::join_planes(acc, all, n_bits, gn);
      }
      const int o = o0 + g;
      if (g >= kC || !real(o)) continue;
      const float y = __fmul_rn(__fmul_rn(acc, norm), w_scale);
      cp_async_wait<0>();                        // this step's drive
      float p = __fadd_rn(__fadd_rn(drive_s[o], y), bh_s[o]);
      if (use_adc) p = wbs::adc(p, step, lo, hi);
      const float h = h_s[o];
      const float th = static_cast<float>(tanh(static_cast<double>(p)));
      const float hn = __fadd_rn(__fmul_rn(lam, h),
                                 __fmul_rn(one_minus_lam, th));
      if (t + 1 < T) {
        const uint32_t c = quantize(beta, hn, top);
        const uint32_t at = next + 4 * (r * H + c0 + j + g);
        for (int q = 0; q < n_blocks; ++q)
          send(in_block(at, q), c, in_block(next_bar, q));
      }
      h_s[o] = hn;
      const size_t i = ((row0 + r) * T + t) * H + c0 + j + g;
      h_all[i] = hn;
      h_prev[i] = h;
      pre[i] = p;
      if (t + 1 < T) {
        cp_async4(smem_u32(drive_s + o), drive + i + H, 4);
        cp_async_commit();
      }
    }
  }
}

cudaError_t launch_scan(const float* drive, const float* u, const float* h0,
                        const float* b_h, const float* gains, float* h_all,
                        float* h_prev, float* pre, int B, int T, int H,
                        int n_bits, float beta, float lam,
                        float one_minus_lam, float norm, float w_scale,
                        int use_adc, float step, float lo, float hi, int rows,
                        int cluster, int ncols, int u_in_smem,
                        cudaStream_t stream) {
  static smem_optin::SmemOptin optin;
  const auto kernel = wbs_miru_scan_kernel;
  int dev = 0, max_smem = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &max_smem);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(H, rows, ncols, u_in_smem != 0);
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(kernel), dev,
                          smem);
  if (err != cudaSuccess) return err;
  // kG threads a unit of kC outputs, and at least 128 for the decode.
  const int want = (rows * ncols / kC * kG + 31) / 32 * 32;
  const int threads = want < 128 ? 128 : (want < kMaxThreads ? want
                                                              : kMaxThreads);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B / rows * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float top = static_cast<float>((1 << n_bits) - 1);
  err = cudaLaunchKernelEx(&cfg, kernel, drive, u, h0, b_h, gains, h_all,
                           h_prev, pre, T, H, n_bits, beta, lam,
                           one_minus_lam, top, norm, w_scale, use_adc, step,
                           lo, hi, rows, ncols, u_in_smem);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// drive (B, T, H), u (H, H), h0 (B, H), b_h (H,), gains (T, n_bits); outputs
// h_all, h_prev, pre (B, T, H). All f32, contiguous, on the current device.
// The launch geometry, chosen by the wrapper (kernels/wbs_miru_scan.py ::
// geometry): clusters of `cluster` blocks (1-8), each owning `rows` batch
// rows (1-8; B a multiple of rows: kernels/ops.py pads), each block
// `ncols` columns (a multiple of kC; the cluster's blocks cover H), with
// its slab of U in shared memory when u_in_smem is 1. Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue where
// the arguments are out of range or the block's layout does not fit the
// device's shared memory.
extern "C" int wbs_miru_scan_launch(
    const void* drive, const void* u, const void* h0, const void* b_h,
    const void* gains, void* h_all, void* h_prev, void* pre, int B, int T,
    int H, int n_bits, float beta, float lam, float one_minus_lam,
    float norm, float w_scale, int use_adc, float step, float lo, float hi,
    int rows, int cluster, int ncols, int u_in_smem, void* stream) {
  if (B < 1 || T < 0 || H < 1 || n_bits < 1 || n_bits > wbs::kMaxBits ||
      rows < 1 || rows > kMaxRows || B % rows != 0 || cluster < 1 ||
      cluster > 8 || B / rows > 2147483647 / 8 || ncols < kC ||
      ncols % kC != 0 || ncols > H + kC ||
      static_cast<long long>(ncols) * cluster < H ||
      (u_in_smem != 0 && u_in_smem != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  return static_cast<int>(launch_scan(
      static_cast<const float*>(drive), static_cast<const float*>(u),
      static_cast<const float*>(h0), static_cast<const float*>(b_h),
      static_cast<const float*>(gains), static_cast<float*>(h_all),
      static_cast<float*>(h_prev), static_cast<float*>(pre), B, T, H, n_bits,
      beta, lam, one_minus_lam, norm, w_scale, use_adc, step, lo, hi, rows,
      cluster, ncols, u_in_smem, static_cast<cudaStream_t>(stream)));
}
