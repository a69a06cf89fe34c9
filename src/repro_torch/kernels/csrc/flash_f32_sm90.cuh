// The fp32 route of the tensor-core flash kernels on Hopper (sm_90a),
// shared by flash_attention_fwd_f32_sm90.cu,
// flash_attention_bwd_dq_f32_sm90.cu and
// flash_attention_bwd_dkv_f32_sm90.cu: fp32 operands carried as sums of
// bf16 terms through the bf16 wgmma of flash_sm90.cuh.
//
// An fp32 value x is kept as kTerms = 3 bf16 terms t0 = bf16(x), t1 =
// bf16(x - t0), t2 = bf16(x - t0 - t1) (each difference exact in fp32):
// about 24 bits of x's significand, the rest at most 2^-27 |x|. A product
// a.b of two such operands is the sum of the cross terms t_i(a).t_j(b);
// those with i + j < 3 (six of nine) carry it to about 2^-24, the three
// left out weigh 2^-24 and less. Products of bf16 values are exact in
// fp32, so the six products summed into an fp32 accumulator give the fp32
// product within that. They are summed lightest first (i + j = 2, then 1,
// then 0): the small terms meet a small partial sum, and the tensor
// cores' fp32 accumulation, which truncates to the accumulator's
// precision, loses the least of them.
//
// The inputs (q, k, v, and dO in the backward) are split once a call by
// split_inputs_kernel into term planes in global memory, which the kernels
// load as bf16 tiles with cp.async, one tile a term; p and ds, which the kernels compute in
// registers, are split there (flash_sm90.cuh split_terms, three terms).
#pragma once

#include "flash_sm90.cuh"

namespace flash_f32_sm90 {

using namespace flash_sm90;

constexpr int kTerms = 3;      // bf16 terms of every fp32 operand
constexpr int kPairs = 6;      // the cross terms (i, j) with i + j < 3

// Cross term n (0 .. 5) in summation order, lightest first: (2, 0),
// (1, 1), (0, 2), (1, 0), (0, 1), (0, 0).
__host__ __device__ constexpr int pair_i(int n) {
  return n < 3 ? 2 - n : (n < 5 ? 4 - n : 0);
}
__host__ __device__ constexpr int pair_j(int n) {
  return n < 3 ? n : (n < 5 ? n - 3 : 0);
}

// The first cross term of q.k^T (S in the forward and dq, S^T in dk/dv):
// with the planted fault kInputFirstTermOnly only t0(q).t0(k), the last
// one.
constexpr int kFirstScorePair =
    (kFault & kInputFirstTermOnly) ? kPairs - 1 : 0;

// A copy of x that the compiler must take as written here, in the tile
// loop: the descriptors below are this plus a constant, so none of them is
// hoisted out of the loop, where the 64-bit descriptors of every term and
// k16 step would each hold two registers across it (at D 128 that spilled).
__device__ __forceinline__ uint64_t pinned(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// d (+)= A B^T over the cross terms from FIRST on: A's terms at a, a +
// TERM, ... (RA rows, K-major) and B's at b, ... (RB rows, K-major), D / 16
// k16 steps a term pair; the first product overwrites d. The caller fences
// before and commits and waits after. A descriptor plus a byte offset / 16
// is the descriptor of the address plus that offset (shared addresses stay
// below 2^18, inside its 14-bit field).
template <int RA, int RB, int D, int TERM, int FIRST>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a,
                                           uint32_t b) {
  const uint64_t da = pinned(descriptor(a)), db = pinned(descriptor(b));
#pragma unroll
  for (int n = FIRST; n < kPairs; ++n)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(d,
               da + ((pair_i(n) * TERM + (kk >> 2) * (RA * kPanelRowBytes) +
                      (kk & 3) * 32) >> 4),
               db + ((pair_j(n) * TERM + (kk >> 2) * (RB * kPanelRowBytes) +
                      (kk & 3) * 32) >> 4),
               n > FIRST || kk > 0);
}

// d = sum of the cross terms t_i . B_j over the 64-deep K of one tile: t
// the register A terms (split_terms), B_j the MN-major panel p of the
// j-th term tile at b + j * TERM (R rows a panel).
template <int R, int TERM>
__device__ __forceinline__ void product_rs(float (&d)[32],
                                           uint32_t (&t)[kTerms][4][4],
                                           uint32_t b, int p) {
  const uint64_t db = pinned(descriptor(b + p * (R * kPanelRowBytes)));
  wgmma_fence();
#pragma unroll
  for (int n = 0; n < kPairs; ++n)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(d, t[pair_i(n)][kk],
               db + ((pair_j(n) * TERM + kk * 16 * kPanelRowBytes) >> 4),
               n | kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
  fence_regs(t);
}

// One fp32 tensor of n floats (n a multiple of 8, 16-byte aligned) and
// its kTerms bf16 planes: plane m at t + m * n.
struct SplitJob {
  const float* x;
  bf16* t;
  size_t n;
};
struct SplitJobs {
  SplitJob job[4];
};

// blockIdx.y picks the tensor (by constant offsets into the parameters:
// an index would copy them to local memory); each thread splits 8 floats
// at a time.
__global__ void __launch_bounds__(256) split_inputs_kernel(SplitJobs jobs) {
  SplitJob j = jobs.job[0];
  if (blockIdx.y == 1) j = jobs.job[1];
  if (blockIdx.y == 2) j = jobs.job[2];
  if (blockIdx.y == 3) j = jobs.job[3];
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x * 8;
  for (size_t e = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x) * 8;
       e < j.n; e += stride) {
    const float4 lo = *reinterpret_cast<const float4*>(j.x + e);
    const float4 hi = *reinterpret_cast<const float4*>(j.x + e + 4);
    float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bf16 a = __float2bfloat16_rn(x[2 * r]);
        const bf16 b = __float2bfloat16_rn(x[2 * r + 1]);
        w[r] = pack_bf16(a, b);
        x[2 * r] -= __bfloat162float(a);
        x[2 * r + 1] -= __bfloat162float(b);
      }
      *reinterpret_cast<uint4*>(j.t + m * j.n + e) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The term planes of q (nq floats), of dO (ndo, the backward only), of k
// (nk) and of v (nv), laid out in `terms` as q's, dO's, k's, v's kTerms
// planes each; the kernels get each plane's pointer (kernel parameters,
// so an address costs no register); with dout null (the forward) q's,
// k's, v's, and the dout planes null. q and k have the query/key head
// dim's columns, dO and v the value head dim's.
struct TermPlanes {
  const bf16 *q[kTerms], *dout[kTerms], *k[kTerms], *v[kTerms];
};

inline cudaError_t split_inputs(const void* q, const void* k, const void* v,
                                const void* dout, void* terms, size_t nq,
                                size_t nk, size_t nv, size_t ndo,
                                TermPlanes* planes, cudaStream_t stream) {
  bf16* t = static_cast<bf16*>(terms);
  SplitJobs jobs = {};
  int n_jobs = 0;
  size_t n = 0;
  auto add = [&](const void* x, size_t nx, const bf16* (&plane)[kTerms]) {
    jobs.job[n_jobs++] = {static_cast<const float*>(x), t, nx};
    for (int m = 0; m < kTerms; ++m) plane[m] = t + m * nx;
    t += kTerms * nx;
    n = nx > n ? nx : n;
  };
  *planes = {};
  add(q, nq, planes->q);
  if (dout) add(dout, ndo, planes->dout);
  add(k, nk, planes->k);
  add(v, nv, planes->v);
  const size_t want = (n / 8 + 255) / 256;
  const dim3 grid(static_cast<unsigned>(want < 2048 ? want : 2048), n_jobs);
  split_inputs_kernel<<<grid, 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace flash_f32_sm90
