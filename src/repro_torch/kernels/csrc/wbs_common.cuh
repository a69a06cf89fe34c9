// Arithmetic shared by the WBS kernels (wbs_matmul.cu's product and its
// read-noise variant, wbs_miru_scan.cu).
//
// All of them evaluate the gain-weighted bit-plane product with the
// routines below (plane_dots, then join_planes; plane_tile is the two
// together), so the fused recurrence and the per-step path (one wbs_matmul
// launch per time step) perform the same float operations in the same
// order: fused and per-step are bitwise equal wherever the ADC
// re-quantizes the integrator every step. The kernels differ only in where
// the routines find each input's decoded bit planes (a table in shared
// memory for wbs_matmul_kernel, whose rows meet every column of the
// block; sign and code bytes decoded on the spot for the read-noise kernel
// and the scan; decode_planes computes the same values for both) and in
// how the work of the outputs is dealt to threads (wbs_matmul_kernel: at
// large shapes a thread owns several columns, at small ones several
// threads share an output, each computing the sums of a group of planes,
// and one joins them all in plane order).
//
// Every float operation is written with an explicit round-to-nearest
// intrinsic. nvcc would otherwise contract a*b+c into one FMA where one
// rounding differs from two, and the plain PyTorch versions
// (kernels/ref.py), which round after every operation, would no longer
// repeat the kernels' arithmetic bit for bit.
#pragma once

#include <cstddef>
#include <cstdint>

namespace wbs {

// Depth of one K tile: the 128-deep block of the Pallas kernels. Sums are
// carried tile by tile, plane by plane, as in _wbs_kernel.
constexpr int kBK = 128;
// Codes are uint8, so at most 8 bit planes.
constexpr int kMaxBits = 8;

// The bit planes of one input, MSB first: p[b] = bit (n_bits-1-b) of code,
// times sign, as floats (0 or +-1); p[b] = 0 for b >= n_bits.
__device__ __forceinline__ void decode_planes(int8_t sign, uint8_t code,
                                              int n_bits,
                                              float (&p)[kMaxBits]) {
  const float s = static_cast<float>(sign);
#pragma unroll
  for (int b = 0; b < kMaxBits; ++b)
    p[b] = b < n_bits
               ? static_cast<float>((code >> (n_bits - 1 - b)) & 1) * s
               : 0.0f;
}

// Planes from a table of decoded inputs: entry k is two float4, planes
// 0-3 and 4-7 (decode_planes' values), in shared memory. get<PB> reads
// planes b0 .. b0 + PB - 1 (PB 8, or 4 with b0 0 or 4: the two layouts
// wbs_matmul_kernel launches) in two vector loads or one.
struct TablePlanes {
  const float4* t;
  template <int PB>
  __device__ __forceinline__ void get(int k, int b0, float (&p)[PB]) const {
    static_assert(PB == 8 || PB == 4, "planes are read 4 or 8 at a time");
    if constexpr (PB == 8) {
      const float4 a = t[2 * k], b = t[2 * k + 1];
      p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
      p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
    } else {
      const float4 a = t[2 * k + b0 / 4];
      p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
    }
  }
};

// Planes decoded on the spot from one input row's sign and code bytes.
struct CodePlanes {
  const int8_t* sign;
  const uint8_t* code;
  int n_bits;
  template <int PB>
  __device__ __forceinline__ void get(int k, int, float (&p)[PB]) const {
    static_assert(PB == kMaxBits, "decoded planes come all at once");
    decode_planes(sign[k], code[k], n_bits, p);
  }
};

// C neighbouring weights w[0 .. C-1] (C 1 or 2) in one load; w is
// aligned to C floats.
template <int C>
__device__ __forceinline__ void load_cols(const float* w, float (&x)[C]) {
  static_assert(C == 1 || C == 2, "1 or 2 columns at a time");
  if constexpr (C == 2) {
    const float2 a = *reinterpret_cast<const float2*>(w);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = w[0];
  }
}

// dot[c][j] = sum_{k < kt} plane_{b0+j}[k] * w[k * ldw + c], k ascending,
// fp32, for the PB planes b0 .. b0 + PB - 1 (those below n_bits) and the C
// columns c. One pass over k carries all C * PB sums in registers: the
// loads of k's planes and weights are shared, and each dot[c][j] is the
// sum it would be on its own. The plane product p * w is exact (p is 0 or
// +-1), so the fused multiply-add rounds once exactly as the product then
// the sum do.
template <int PB, int C, class Planes>
__device__ __forceinline__ void plane_dots(float (&dot)[C][PB],
                                           const Planes& planes, int b0,
                                           const float* w, int ldw, int kt,
                                           int n_bits) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < PB; ++j) dot[c][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < kt; ++k) {
    float p[PB], wk[C];
    planes.template get<PB>(k, b0, p);
    load_cols<C>(w + static_cast<size_t>(k) * ldw, wk);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < PB; ++j)
        if (b0 + j < n_bits) dot[c][j] = __fmaf_rn(p[j], wk[c], dot[c][j]);
  }
}

// acc + sum_b gains[b] * dot[b], b = 0 .. n_bits-1 in order (MSB first):
// a K tile's plane sums joining the running sum. Only the sums round.
__device__ __forceinline__ float join_planes(float acc,
                                             const float (&dot)[kMaxBits],
                                             int n_bits, const float* gains) {
#pragma unroll
  for (int b = 0; b < kMaxBits; ++b)
    if (b < n_bits) acc = __fadd_rn(acc, __fmul_rn(gains[b], dot[b]));
  return acc;
}

// One K tile of the plane product for one output:
// acc + sum_b gains[b] * sum_{k < kt} plane_b[k] * w[k * ldw], all
// n_bits plane sums carried in one pass over k (the dependent chain is
// kt + n_bits steps, not n_bits * kt), then joined in plane order.
template <class Planes>
__device__ __forceinline__ float plane_tile(float acc, const Planes& planes,
                                            const float* w, int ldw, int kt,
                                            int n_bits, const float* gains) {
  float dot[1][kMaxBits];
  plane_dots<kMaxBits, 1>(dot, planes, 0, w, ldw, kt, n_bits);
  return join_planes(acc, dot[0], n_bits, gains);
}

// Mid-rise ADC: clip(rint(y / step), lo, hi) * step. rintf rounds half to
// even like jnp.round and torch.round; the division is IEEE (no fast math).
__device__ __forceinline__ float adc(float y, float step, float lo, float hi) {
  float q = rintf(__fdiv_rn(y, step));
  q = fminf(fmaxf(q, lo), hi);
  return __fmul_rn(q, step);
}

}  // namespace wbs
