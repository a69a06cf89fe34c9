// Arithmetic shared by the two WBS kernels (wbs_matmul.cu, wbs_miru_scan.cu).
//
// Both kernels evaluate the gain-weighted bit-plane product with the one
// routine below, so the fused recurrence and the per-step path (one
// wbs_matmul launch per time step) perform the same float operations in
// the same order: fused and per-step are bitwise equal wherever the ADC
// re-quantizes the integrator every step.
//
// Every float operation is written with an explicit round-to-nearest
// intrinsic. nvcc would otherwise contract a*b+c into one FMA, and the
// plain PyTorch versions (kernels/ref.py), which round after every
// operation, would no longer repeat the kernels' arithmetic bit for bit.
#pragma once

#include <cstddef>
#include <cstdint>

namespace wbs {

// Depth of one K tile: the 128-deep block of the Pallas kernels. Sums are
// carried tile by tile, plane by plane, as in _wbs_kernel.
constexpr int kBK = 128;
// Codes are uint8, so at most 8 bit planes.
constexpr int kMaxBits = 8;

// acc + sum_b gains[b] * sum_{k < kt} plane_b[k] * sign[k] * w[k * ldw],
// MSB first (plane b holds bit n_bits-1-b), k ascending, fp32. The plane
// products are exact (plane * sign is 0 or +-1); only the two sums round.
__device__ __forceinline__ float plane_tile(float acc,
                                            const int8_t* sign,
                                            const uint8_t* code,
                                            const float* w, int ldw, int kt,
                                            int n_bits, const float* gains) {
  for (int b = 0; b < n_bits; ++b) {
    const int shift = n_bits - 1 - b;
    float dot = 0.0f;
    for (int k = 0; k < kt; ++k) {
      const float p = static_cast<float>((code[k] >> shift) & 1) *
                      static_cast<float>(sign[k]);
      dot = __fadd_rn(dot, __fmul_rn(p, w[static_cast<size_t>(k) * ldw]));
    }
    acc = __fadd_rn(acc, __fmul_rn(gains[b], dot));
  }
  return acc;
}

// Mid-rise ADC: clip(rint(y / step), lo, hi) * step. rintf rounds half to
// even like jnp.round and torch.round; the division is IEEE (no fast math).
__device__ __forceinline__ float adc(float y, float step, float lo, float hi) {
  float q = rintf(__fdiv_rn(y, step));
  q = fminf(fmaxf(q, lo), hi);
  return __fmul_rn(q, step);
}

}  // namespace wbs
