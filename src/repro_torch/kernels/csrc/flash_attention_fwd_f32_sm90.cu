// Flash-attention forward for fp32 on Hopper's tensor cores (sm_90a):
// online-softmax attention with a causal mask, a key-padding mask
// (sk_true) and the GQA head fold.
//
// Replaces, for fp32 inputs, the TPU kernel src/repro/kernels/
// flash_attention.py :: flash_attention_fwd_pallas (_flash_fwd_kernel,
// pallas_call :270); bf16 inputs take flash_attention_fwd_sm90.cu. The
// function is that kernel's, in fp32:
//
//   s_ij  = (q_i . k_j) * scale;  -1e30 where j >= sk_true or, causal, j > i
//   per 64-key tile: m' = max(m, max_j s_ij), corr = exp(m - m'),
//   p_ij = exp(s_ij - m'), l = l * corr + sum_j p_ij,
//   acc = acc * corr + p . v
//   out_i = acc / max(l, 1e-30),  lse_i = m + log(max(l, 1e-30))
//
// with m, l, corr, p, acc and out in fp32. Query head b reads KV head
// (b / H) * Kh + (b % H) / rep, rep = H / Kh.
//
// Design: flash_attention_fwd_sm90.cu's (128 query rows a block in two
// warpgroups, 64-key tiles loaded by cp.async into 128-byte-swizzled bf16
// tiles, heaviest blocks first, masks only on tiles that cross sk_true or
// the diagonal, a warpgroup skipping a tile wholly above its rows), on
// fp32 operands carried as three bf16 terms each (flash_f32_sm90.cuh). One
// C call splits q, k and v into term planes (split_inputs_kernel) and runs
// the forward. Per tile and warpgroup:
//  - S = Q K^T by wgmma from shared memory as the six cross terms i + j <
//    3 of q's and k's terms, lightest first (s feeds exp: two terms of q
//    and k miss the fp32 bounds, tests/test_torch_flash_split.py);
//  - the mask, the row max and sum over the four lanes of a row, the
//    correction, in registers, with accurate expf;
//  - p split into three bf16 terms in registers (split_terms), and p.V as
//    the six cross terms of p's and v's terms by wgmma with A from
//    registers and V's term tiles MN-major, into a tile accumulator that
//    is then added to the running one (acc * corr + tile), as in the bf16
//    kernel.
// Each warpgroup's 64 query rows are a tile of their own (three term tiles
// of 64 x D), so the Q, K and V term tiles share one shape. Shared memory:
// Q's terms 48 KB at D 64 (96 KB at D 128) and 48 KB (96 KB) a K/V stage.
// At D 64 two stages, the next tile's load in flight while the current
// one is used (145 KB, one block an SM); at D 128 one stage (193 KB): the
// next tile loads once the current one is consumed.
//
// What bounds it on the H100. 4*B*H*Sq*Sk*dh FLOPs (halved when causal),
// each product as six bf16 products: at the qwen2-0.5B prefill in fp32 (B
// 2, H 14, Kh 2, S 2048, dh 64, causal) 6 x 15 GFLOP of tensor-core work,
// 0.091 ms at 989 TFLOP/s (the fp32 products on the CUDA cores: 0.224
// ms), beside 0.01 ms for the bytes; the term planes add about 0.02 ms of
// traffic.
#include "flash_f32_sm90.cuh"
#include "smem_optin.cuh"

namespace {

using namespace flash_f32_sm90;

constexpr int kBQ = 128;                 // query rows a block
constexpr int kBK = 64;                  // keys a tile
constexpr int kThreads = 256;            // two warpgroups

template <int D>
struct Cfg {
  static constexpr int kStages = D == 64 ? 2 : 1;
  static constexpr int kTile = 64 * D * 2;          // bytes of a 64 x D tile
  static constexpr int kSet = kTerms * kTile;       // one operand's terms
  // Q's terms (each warpgroup's rows), then K's and V's terms a stage.
  static constexpr int kBytes = 2 * kSet + kStages * 2 * kSet + 1024;
  static constexpr int kMinBlocks = kBytes * 2 <= 227 * 1024 ? 2 : 1;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
flash_fwd_f32_kernel(TermPlanes in, size_t q_plane, size_t kv_plane,
                     float* __restrict__ out, float* __restrict__ lse, int H,
                     int Kh, int Sq, int Sk, int sk_true, int causal,
                     float scale) {
  constexpr int NP = D / 64;
  constexpr int kStages = Cfg<D>::kStages;
  constexpr int kTile = Cfg<D>::kTile, kSet = Cfg<D>::kSet;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + 2 * kSet;       // stage s: K at + 2 s kSet, V next

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int rep = H / Kh;
  const size_t kvb = static_cast<size_t>(b / H) * Kh + (b % H) / rep;
  const size_t qoff = static_cast<size_t>(b) * Sq * D;
  const size_t kvoff = kvb * Sk * D;

  // Keys past sk_true are masked for every row; under the causal mask so
  // are keys past the block's last row.
  int kend = sk_true;
  if (causal) kend = min(kend, min(q0 + kBQ, Sq));
  const int n_tiles = (kend + kBK - 1) / kBK;

  // Key tile t's K and V terms into stage st.
  auto load_keys = [&](int t, uint32_t st) {
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
      load_tile<kBK, D, kThreads>(st + m * kTile,
                                  in.k + m * kv_plane + kvoff, t * kBK, Sk,
                                  tid);
      load_tile<kBK, D, kThreads>(st + kSet + m * kTile,
                                  in.v + m * kv_plane + kvoff, t * kBK, Sk,
                                  tid);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int m = 0; m < kTerms; ++m)
      load_tile<64, D, kThreads>(sQ + w * kSet + m * kTile,
                                 in.q + m * q_plane + qoff, q0 + w * 64, Sq,
                                 tid);
  load_keys(0, sKV);

  const int row0 = q0 + wg * 64;                       // warpgroup's rows
  const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int c0 = 2 * (lane & 3);                       // fragment column
  const uint32_t sQw = sQ + wg * kSet;                 // its Q terms

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (kStages == 2 && t + 1 < n_tiles) {
      load_keys(t + 1, sKV + ((t + 1) & 1) * 2 * kSet);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    const int k0 = t * kBK;
    const uint32_t sKt = sKV + (kStages == 2 ? (t & 1) : 0) * 2 * kSet;
    const uint32_t sVt = sKt + kSet;
    if (!causal || k0 <= row0 + 63) {                  // warpgroup-uniform
      float s[32];
      wgmma_fence();
      product_ss<64, kBK, D, kTile, kFirstScorePair>(s, sQw, sKt);
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
        product_rs<kBK, kTile>(o, pt, sVt, p);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[p][i] = acc[p][i] * ((i & 2) ? corr_b : corr_a) + o[i];
      }
    }
    __syncthreads();                     // the stage is free for reuse
    if (kStages == 1 && t + 1 < n_tiles) load_keys(t + 1, sKV);
  }

  const float lc_a = fmaxf(l_a, 1e-30f), lc_b = fmaxf(l_b, 1e-30f);
  float* ob = out + qoff;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + c0;
      if (ra < Sq)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(ra) * D + col) =
            make_float2(acc[p][4 * j] / lc_a, acc[p][4 * j + 1] / lc_a);
      if (rb < Sq)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(rb) * D + col) =
            make_float2(acc[p][4 * j + 2] / lc_b, acc[p][4 * j + 3] / lc_b);
    }
  if ((lane & 3) == 0) {
    float* lb = lse + static_cast<size_t>(b) * Sq;
    if (ra < Sq) lb[ra] = m_a + logf(lc_a);
    if (rb < Sq) lb[rb] = m_b + logf(lc_b);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* terms,
                   void* out, void* lse, int BH, int H, int Kh, int Sq,
                   int Sk, int sk_true, int causal, float scale,
                   cudaStream_t stream) {
  static smem_optin::SmemOptin optin;
  const auto kernel = flash_fwd_f32_kernel<D>;
  int dev = 0, limit = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &limit);
  if (err != cudaSuccess) return err;
  if (Cfg<D>::kBytes > limit) return cudaErrorInvalidConfiguration;
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(kernel), dev,
                          Cfg<D>::kBytes);
  if (err != cudaSuccess) return err;
  const size_t nq = static_cast<size_t>(BH) * Sq * D;
  const size_t nk = static_cast<size_t>(BH / H) * Kh * Sk * D;
  TermPlanes planes;
  err = split_inputs(q, k, v, nullptr, terms, nq, nk, &planes, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, Cfg<D>::kBytes, stream>>>(
      planes, nq, nk, static_cast<float*>(out), static_cast<float*>(lse), H,
      Kh, Sq, Sk, sk_true, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q (BH, Sq, D), k and v (BH / H * Kh, Sk, D), all f32; terms (3 * (BH *
// Sq * D + 2 * BH / H * Kh * Sk * D)) bf16 scratch for the inputs' term
// planes; out (BH, Sq, D) and lse (BH, Sq) f32. All contiguous on the
// current device, 16-byte aligned. D is 64 or 128 (the wrapper zero-pads
// smaller head dims; the scale is passed in). Launches the split and the
// forward; returns the first cudaError_t (0 on success).
extern "C" int flash_attention_fwd_f32_sm90_launch(
    const void* q, const void* k, const void* v, void* terms, void* out,
    void* lse, int BH, int H, int Kh, int Sq, int Sk, int sk_true, int D,
    int causal, float scale, void* stream) {
  if (BH < 1 || H < 1 || Kh < 1 || H % Kh != 0 || BH % H != 0 || Sq < 1 ||
      Sk < 1 || sk_true < 1 || sk_true > Sk ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return static_cast<int>(launch<64>(q, k, v, terms, out, lse, BH, H, Kh,
                                       Sq, Sk, sk_true, causal, scale, s));
  if (D == 128)
    return static_cast<int>(launch<128>(q, k, v, terms, out, lse, BH, H, Kh,
                                        Sq, Sk, sk_true, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
