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
// (b / H) * Kh + (b % H) / rep, rep = H / Kh. q and k have DQK columns, v
// and out DV: the pairs (64, 64), (128, 128) and MLA's (192, 128) are
// instantiated.
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
// of 64 x DQK), so the Q and K term tiles share one shape. Shared memory:
// Q's terms 48 KB at (64, 64) (96 KB at (128, 128)) and 48 KB (96 KB) a
// K/V stage. At (64, 64) two stages, the next tile's load in flight while
// the current one is used (145 KB, one block an SM); at (128, 128) one
// stage (193 KB): the next tile loads once the current one is consumed.
// At (192, 128) two warpgroups' Q terms (144 KB), a stage of K's (72 KB)
// and of V's (48 KB) come to 264 KB, past the 227 KB a block may hold:
// that instantiation runs one warpgroup, 64 query rows a block (Q's terms
// 72 KB, one stage: 193 KB), and each K/V tile is loaded for 64 query rows
// instead of 128. Re-staging Q's terms (one bf16 plane at a time) would
// keep 128 rows but reorder the six cross terms against the other pairs;
// halving the block changes the grid and nothing of the arithmetic.
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

constexpr int kBK = 64;                  // keys a tile

template <int DQK, int DV>
struct Cfg {
  static constexpr int kWarpgroups = DQK == 192 ? 1 : 2;
  static constexpr int kBQ = 64 * kWarpgroups;      // query rows a block
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kStages = DQK == 64 ? 2 : 1;
  static constexpr int kTileQK = 64 * DQK * 2;      // a 64 x DQK tile
  static constexpr int kTileV = 64 * DV * 2;        // a 64 x DV tile
  static constexpr int kSetQK = kTerms * kTileQK;   // one operand's terms
  static constexpr int kSetV = kTerms * kTileV;
  static constexpr int kStage = kSetQK + kSetV;     // K's terms, then V's
  // Q's terms (each warpgroup's rows), then the stages.
  static constexpr int kBytes =
      kWarpgroups * kSetQK + kStages * kStage + 1024;
  static constexpr int kMinBlocks = kBytes * 2 <= 227 * 1024 ? 2 : 1;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(Cfg<DQK, DV>::kThreads,
                                  Cfg<DQK, DV>::kMinBlocks)
flash_fwd_f32_kernel(TermPlanes in, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Kh, int Sq, int Sk,
                     int sk_true, int causal, float scale) {
  using C = Cfg<DQK, DV>;
  constexpr int NP = DV / 64;                          // panels of out
  constexpr int kBQ = C::kBQ, kThreads = C::kThreads;
  constexpr int kStages = C::kStages;
  constexpr int kTileQK = C::kTileQK, kTileV = C::kTileV;
  constexpr int kSetQK = C::kSetQK;
  constexpr bool kPin = DQK == 192;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::kWarpgroups * kSetQK;   // stage s at s kStage

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int rep = H / Kh;
  const size_t qoff = static_cast<size_t>(b) * Sq * DQK;

  // Keys past sk_true are masked for every row; under the causal mask so
  // are keys past the block's last row.
  int kend = sk_true;
  if (causal) kend = min(kend, min(q0 + kBQ, Sq));
  const int n_tiles = (kend + kBK - 1) / kBK;

  // Key tile t's K and V terms into stage st.
  auto load_keys = [&](int t, uint32_t st) {
    const int lt = pinned_int<kPin>(tid), lb = pinned_int<kPin>(b);
    const size_t kv = static_cast<size_t>(lb / H) * Kh + (lb % H) / rep;
    const size_t koff = kv * Sk * DQK, voff = kv * Sk * DV;
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
      load_tile<kBK, DQK, kThreads>(st + m * kTileQK,
                                    in.k[m] + koff, t * kBK, Sk,
                                    lt);
      load_tile<kBK, DV, kThreads>(st + kSetQK + m * kTileV,
                                   in.v[m] + voff, t * kBK, Sk,
                                   lt);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int w = 0; w < C::kWarpgroups; ++w)
#pragma unroll
    for (int m = 0; m < kTerms; ++m)
      load_tile<64, DQK, kThreads>(sQ + w * kSetQK + m * kTileQK,
                                   in.q[m] + qoff, q0 + w * 64, Sq,
                                   tid);
  load_keys(0, sKV);

  const int row0 = q0 + wg * 64;                       // warpgroup's rows
  const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int c0 = 2 * (lane & 3);                       // fragment column
  const uint32_t sQw = sQ + wg * kSetQK;               // its Q terms

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (kStages == 2 && t + 1 < n_tiles) {
      load_keys(t + 1, sKV + ((t + 1) & 1) * C::kStage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    const int k0 = t * kBK;
    const uint32_t sKt = sKV + (kStages == 2 ? (t & 1) : 0) * C::kStage;
    const uint32_t sVt = sKt + kSetQK;
    if (!causal || k0 <= row0 + 63) {                  // warpgroup-uniform
      float s[32];
      wgmma_fence();
      product_ss<64, kBK, DQK, kTileQK, kFirstScorePair>(s, sQw, sKt);
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
        product_rs<kBK, kTileV>(o, pt, sVt, p);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[p][i] = acc[p][i] * ((i & 2) ? corr_b : corr_a) + o[i];
      }
    }
    __syncthreads();                     // the stage is free for reuse
    if (kStages == 1 && t + 1 < n_tiles) load_keys(t + 1, sKV);
  }

  const float lc_a = fmaxf(l_a, 1e-30f), lc_b = fmaxf(l_b, 1e-30f);
  float* ob = out + static_cast<size_t>(b) * Sq * DV;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + c0;
      if (ra < Sq)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(ra) * DV + col) =
            make_float2(acc[p][4 * j] / lc_a, acc[p][4 * j + 1] / lc_a);
      if (rb < Sq)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(rb) * DV + col) =
            make_float2(acc[p][4 * j + 2] / lc_b, acc[p][4 * j + 3] / lc_b);
    }
  if ((lane & 3) == 0) {
    float* lb = lse + static_cast<size_t>(b) * Sq;
    if (ra < Sq) lb[ra] = m_a + logf(lc_a);
    if (rb < Sq) lb[rb] = m_b + logf(lc_b);
  }
}

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* terms,
                   void* out, void* lse, int BH, int H, int Kh, int Sq,
                   int Sk, int sk_true, int causal, float scale,
                   cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  static smem_optin::SmemOptin optin;
  const auto kernel = flash_fwd_f32_kernel<DQK, DV>;
  int dev = 0, limit = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &limit);
  if (err != cudaSuccess) return err;
  if (C::kBytes > limit) return cudaErrorInvalidConfiguration;
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(kernel), dev,
                          C::kBytes);
  if (err != cudaSuccess) return err;
  if ((Sq + C::kBQ - 1) / C::kBQ > 65535) return cudaErrorInvalidValue;
  const size_t nq = static_cast<size_t>(BH) * Sq * DQK;
  const size_t kv_rows = static_cast<size_t>(BH / H) * Kh * Sk;
  TermPlanes planes;
  err = split_inputs(q, k, v, nullptr, terms, nq, kv_rows * DQK,
                     kv_rows * DV, 0, &planes, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      planes, static_cast<float*>(out), static_cast<float*>(lse), H, Kh, Sq,
      Sk, sk_true, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q (BH, Sq, DQK), k (BH / H * Kh, Sk, DQK), v (BH / H * Kh, Sk, DV), all
// f32; terms (3 * (BH * Sq * DQK + BH / H * Kh * Sk * (DQK + DV))) bf16
// scratch for the inputs' term planes; out (BH, Sq, DV) and lse (BH, Sq)
// f32. All contiguous on the current device, 16-byte aligned. (DQK, DV) is
// (64, 64), (128, 128) or (192, 128) (the wrapper zero-pads smaller head
// dims up to a pair; the scale is passed in). Launches the split and the
// forward; returns the first cudaError_t (0 on success).
extern "C" int flash_attention_fwd_f32_sm90_launch(
    const void* q, const void* k, const void* v, void* terms, void* out,
    void* lse, int BH, int H, int Kh, int Sq, int Sk, int sk_true, int DQK,
    int DV, int causal, float scale, void* stream) {
  if (BH < 1 || H < 1 || Kh < 1 || H % Kh != 0 || BH % H != 0 || Sq < 1 ||
      Sk < 1 || sk_true < 1 || sk_true > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(A, B)                                                          \
  launch<A, B>(q, k, v, terms, out, lse, BH, H, Kh, Sq, Sk, sk_true,       \
               causal, scale, s)
  if (DQK == 64 && DV == 64) return static_cast<int>(FWD(64, 64));
  if (DQK == 128 && DV == 128) return static_cast<int>(FWD(128, 128));
  if (DQK == 192 && DV == 128) return static_cast<int>(FWD(192, 128));
#undef FWD
  return static_cast<int>(cudaErrorInvalidValue);
}
