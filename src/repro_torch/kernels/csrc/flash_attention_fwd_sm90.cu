// Flash-attention forward for bf16 on Hopper's tensor cores (sm_90a):
// online-softmax attention with a causal mask, a key-padding mask
// (sk_true) and the GQA head fold.
//
// Replaces, for bf16 inputs, the TPU kernel src/repro/kernels/
// flash_attention.py :: flash_attention_fwd_pallas (_flash_fwd_kernel,
// pallas_call :270); fp32 inputs keep flash_attention_fwd.cu. The function
// is that kernel's, scores, probabilities and sums in fp32:
//
//   s_ij  = (q_i . k_j) * scale;  -1e30 where j >= sk_true or, causal, j > i
//   per 64-key tile: m' = max(m, max_j s_ij), corr = exp(m - m'),
//   p_ij = exp(s_ij - m'), l = l * corr + sum_j p_ij,
//   acc = acc * corr + p . v                    (all fp32)
//   out_i = acc / max(l, 1e-30) in bf16,  lse_i = m + log(max(l, 1e-30))
//
// Query head b reads KV head (b / H) * Kh + (b % H) / rep, rep = H / Kh.
//
// Design (flash_sm90.cuh has the tile layout and the wgmma helpers). One
// block per (batch-head, 128 query rows): two warpgroups of 64 rows each,
// 256 threads; no producer warp. The Q tile and a two-stage ring of K/V
// tiles of 64 keys are loaded by cp.async into 128-byte-swizzled bf16
// tiles (rows past Sk, or past Sq, zero-filled), the next tile's load in
// flight while the current one is used. Per tile and warpgroup:
//  - S = Q K^T by wgmma m64n64k16 from shared memory (bf16 products are
//    exact in fp32, the sum is fp32);
//  - the mask (only on a tile that crosses sk_true or the diagonal), the
//    row max and sum over the four lanes of a row, the correction, in
//    registers, with accurate expf as the fp32 kernel;
//  - p (fp32) split into three bf16 terms (flash_sm90.cuh split_terms),
//    and p.V as the sum of their products by wgmma with A from registers
//    and V (MN-major, transposed by the instruction) from shared memory,
//    into a tile accumulator that is then added to the running one
//    (acc * corr + tile): no tensor-core sum runs longer than one tile.
//    Three terms keep p to 2^-27. Two (hi and lo, 2^-18) were measured
//    short on the card: in the first rows under the causal mask, where
//    out sums a few terms of order 1 that nearly cancel, the error of
//    2^-18 |p v| reaches the fp32 tolerance's atol of 2e-6 (rep 1, 130
//    rows, causal: an element of row 14, a sum of 15 keys, 6.7e-9 past
//    testing.bf16_within's bound in 1 of 13 seeded inputs; with three
//    terms every element of the 13 stays 1.9e-6 inside it).
// Key tiles at or past sk_true, and under the causal mask past the block's
// last row, are not loaded; a warpgroup skips a tile wholly above its rows.
// Blocks are issued heaviest first (the last query tiles under the causal
// mask) so the tail of the grid is short.
//
// What bounds it on the H100. 4*B*H*Sq*Sk*dh FLOPs (halved when causal),
// 2x that with p.V in three terms, against q, k, v read once and out, lse
// written once: at the qwen2-0.5B prefill (B 2, H 14, Kh 2, S 2048, dh 64,
// causal) about 15 GFLOP of tensor-core work, 0.015 ms at 989 TFLOP/s
// (0.030 ms with the split), against 0.005 ms for the bytes.
#include "flash_sm90.cuh"
#include "smem_optin.cuh"

namespace {

using namespace flash_sm90;

constexpr int kBQ = 128;                 // query rows a block
constexpr int kBK = 64;                  // keys a tile
constexpr int kThreads = 256;            // two warpgroups
constexpr int kTerms = 3;                // bf16 terms of p in p.V

template <int D>
struct Smem {
  static constexpr int kQ = kBQ * D * 2;          // bytes of the Q tile
  static constexpr int kKV = kBK * D * 2;         // bytes of a K or V tile
  static constexpr int kBytes = kQ + 4 * kKV + 1024;   // + alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int H, int Kh, int Sq, int Sk,
                      int sk_true, int causal, float scale) {
  constexpr int NP = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Smem<D>::kQ;                // two stages
  const uint32_t sV = sK + 2 * Smem<D>::kKV;           // two stages

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int rep = H / Kh;
  const size_t kvb = static_cast<size_t>(b / H) * Kh + (b % H) / rep;
  const bf16* qb = q + static_cast<size_t>(b) * Sq * D;
  const bf16* kb = k + kvb * Sk * D;
  const bf16* vb = v + kvb * Sk * D;

  // Keys past sk_true are masked for every row; under the causal mask so
  // are keys past the block's last row.
  int kend = sk_true;
  if (causal) kend = min(kend, min(q0 + kBQ, Sq));
  const int n_tiles = (kend + kBK - 1) / kBK;

  load_tile<kBQ, D, kThreads>(sQ, qb, q0, Sq, tid);
  load_tile<kBK, D, kThreads>(sK, kb, 0, Sk, tid);
  load_tile<kBK, D, kThreads>(sV, vb, 0, Sk, tid);
  cp_async_commit();

  const int row0 = q0 + wg * 64;                       // warpgroup's rows
  const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int c0 = 2 * (lane & 3);                       // fragment column
  const uint32_t sQw = sQ + wg * 64 * kPanelRowBytes;  // its Q rows

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const uint32_t st = ((t + 1) & 1) * Smem<D>::kKV;
      load_tile<kBK, D, kThreads>(sK + st, kb, (t + 1) * kBK, Sk, tid);
      load_tile<kBK, D, kThreads>(sV + st, vb, (t + 1) * kBK, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    const int k0 = t * kBK;
    const uint32_t sKt = sK + (t & 1) * Smem<D>::kKV;
    const uint32_t sVt = sV + (t & 1) * Smem<D>::kKV;
    if (!causal || k0 <= row0 + 63) {                  // warpgroup-uniform
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_k_major<kBQ>(sQw, kk), desc_k_major<kBK>(sKt, kk),
                 kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      const bool masked = k0 + kBK > sk_true || (causal && k0 + 63 > row0);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + c0 + e;
          float sa = s[4 * j + e] * scale, sb = s[4 * j + 2 + e] * scale;
          if (masked) {
            if (kj >= sk_true || (causal && kj > ra)) sa = kNegInf;
            if (kj >= sk_true || (causal && kj > rb)) sb = kNegInf;
          }
          s[4 * j + e] = sa;
          s[4 * j + 2 + e] = sb;
          mx_a = fmaxf(mx_a, sa);
          mx_b = fmaxf(mx_b, sb);
        }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
      float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = expf(s[4 * j + e] - mn_a);
          s[4 * j + 2 + e] = expf(s[4 * j + 2 + e] - mn_b);
          ps_a += s[4 * j + e];
          ps_b += s[4 * j + 2 + e];
        }
      l_a = l_a * corr_a + quad_sum(ps_a);
      l_b = l_b * corr_b + quad_sum(ps_b);
      m_a = mn_a;
      m_b = mn_b;

      uint32_t pt[kTerms][4][4];
      split_terms(s, pt);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float o[32];
        product_terms<kBK>(o, pt, sVt, p);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[p][i] = acc[p][i] * ((i & 2) ? corr_b : corr_a) + o[i];
      }
    }
    __syncthreads();                     // the stage is free for reuse
  }

  const float lc_a = fmaxf(l_a, 1e-30f), lc_b = fmaxf(l_b, 1e-30f);
  bf16* ob = out + static_cast<size_t>(b) * Sq * D;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + c0;
      if (ra < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(ra) * D +
                                           col) =
            __floats2bfloat162_rn(acc[p][4 * j] / lc_a,
                                  acc[p][4 * j + 1] / lc_a);
      if (rb < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(rb) * D +
                                           col) =
            __floats2bfloat162_rn(acc[p][4 * j + 2] / lc_b,
                                  acc[p][4 * j + 3] / lc_b);
    }
  if ((lane & 3) == 0) {
    float* lb = lse + static_cast<size_t>(b) * Sq;
    if (ra < Sq) lb[ra] = m_a + logf(lc_a);
    if (rb < Sq) lb[rb] = m_b + logf(lc_b);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int H, int Kh, int Sq, int Sk,
                   int sk_true, int causal, float scale,
                   cudaStream_t stream) {
  static smem_optin::SmemOptin optin;
  const auto kernel = flash_fwd_sm90_kernel<D>;
  int dev = 0, limit = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &limit);
  if (err != cudaSuccess) return err;
  if (Smem<D>::kBytes > limit) return cudaErrorInvalidConfiguration;
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(kernel), dev,
                          Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Kh, Sq, Sk, sk_true, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q (BH, Sq, D), k and v (BH / H * Kh, Sk, D), out (BH, Sq, D), all bf16,
// lse (BH, Sq) f32; contiguous on the current device, 16-byte aligned. D is
// 64 or 128 (the wrapper zero-pads smaller head dims; the scale is passed
// in). Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_sm90_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int BH, int H, int Kh, int Sq, int Sk, int sk_true, int D, int causal,
    float scale, void* stream) {
  if (BH < 1 || H < 1 || Kh < 1 || H % Kh != 0 || BH % H != 0 || Sq < 1 ||
      Sk < 1 || sk_true < 1 || sk_true > Sk ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return static_cast<int>(launch<64>(q, k, v, out, lse, BH, H, Kh, Sq, Sk,
                                       sk_true, causal, scale, s));
  if (D == 128)
    return static_cast<int>(launch<128>(q, k, v, out, lse, BH, H, Kh, Sq, Sk,
                                        sk_true, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
