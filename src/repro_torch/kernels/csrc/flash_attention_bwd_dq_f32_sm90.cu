// Flash-attention backward, dq, for fp32 on Hopper's tensor cores
// (sm_90a), with the causal mask, the key-padding mask (sk_true) and the
// GQA head map.
//
// Replaces, for fp32 inputs, the TPU kernel src/repro/kernels/
// flash_attention.py :: flash_attention_bwd_pallas (_flash_dq_kernel,
// pallas_call :185); bf16 inputs take flash_attention_bwd_dq_sm90.cu. The
// function is that kernel's, in fp32: for query row i of query head b and
// each key j of the KV head it reads,
//
//   s_ij  = (q_i . k_j) * scale;  masked where j >= sk_true or, causal,
//   j > i; p_ij = exp(s_ij - lse_i) (0 where masked; lse from the fp32
//   forward)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j,  written in fp32.
//
// Design: flash_attention_bwd_dq_sm90.cu's, on fp32 operands carried as
// three bf16 terms each (flash_f32_sm90.cuh). One C call splits q, k, v
// and dO into term planes (split_inputs_kernel) and runs the dq kernel.
// One block of one warpgroup (128 threads) per (query head, 64-row query
// tile): it keeps the tile's Q and dO terms in shared memory and its lse
// and delta in registers, accumulates dQ in fp32 registers (32 floats a
// thread at D 64, 64 at D 128), and streams the KV head's K and V term
// tiles of 64 keys through one cp.async stage (two blocks an SM, as in
// dk/dv, where that was faster than two stages in one block), from key
// tile 0 up to sk_true and, under the causal mask, up to the diagonal
// tile. Per key tile:
//  - S = Q K^T and dP = dO V^T by wgmma from shared memory, each the six
//    cross terms of the operands' terms;
//  - P = exp(S scale - lse) and dS = P (dP - delta) in registers (masks
//    only on a tile that crosses the diagonal or sk_true);
//  - dQ += dS K by wgmma with dS split into three terms in registers and
//    K's terms read MN-major from the tiles S read K-major, the six cross
//    terms into a tile sum that is then added to the running one.
// dQ * scale is written in fp32 once, at the end. A block owns its rows
// outright: no atomics and no partials, so the result is the same bits
// from run to run. Blocks are issued heaviest first (the grid's fast
// dimension the query head, its slow one the query tile, descending), as
// in the bf16 kernel, and no loop exits early.
//
// What bounds it on the H100. Three products of 2*Sq*Sk*dh FLOPs a query
// head (halved when causal), each six bf16 products with the split,
// against q, k, v, dO, lse, delta (fp32) read once and dq written once: at
// the qwen2-0.5B training shape (B 2, H 14, Kh 2, S 2048, dh 64, causal)
// 135 GFLOP of bf16 tensor-core work, 0.137 ms at 989 TFLOP/s (the three
// fp32 products on the CUDA cores: 0.337 ms at 67 TFLOP/s), beside 0.02
// ms for the bytes; the term planes add about 0.02 ms of traffic.
#include "flash_f32_sm90.cuh"
#include "smem_optin.cuh"

namespace {

using namespace flash_f32_sm90;

constexpr int kBQ = 64;                  // query rows a block
constexpr int kBK = 64;                  // keys a tile
constexpr int kThreads = 128;            // one warpgroup

template <int D>
struct Cfg {
  static constexpr int kTile = 64 * D * 2;          // bytes of a 64 x D tile
  static constexpr int kSet = kTerms * kTile;       // one operand's terms
  // The terms of Q, dO, K and V.
  static constexpr int kBytes = 4 * kSet + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(TermPlanes in, size_t q_plane, size_t kv_plane,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Kh, int Sq,
                        int Sk, int sk_true, int causal, float scale) {
  constexpr int NP = D / 64;
  constexpr int kTile = Cfg<D>::kTile, kSet = Cfg<D>::kSet;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + kSet;
  const uint32_t sK = sDO + kSet;
  const uint32_t sV = sK + kSet;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bq = blockIdx.x;                           // query batch-head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int rep = H / Kh;
  const size_t kvb = static_cast<size_t>(bq / H) * Kh + (bq % H) / rep;
  const int qa = q0 + warp * 16 + (lane >> 2), qb = qa + 8;   // query rows
  const int c0 = 2 * (lane & 3);

  const size_t rows = static_cast<size_t>(bq) * Sq;
  const float lse_a = qa < Sq ? lse[rows + qa] : 0.0f;
  const float lse_b = qb < Sq ? lse[rows + qb] : 0.0f;
  const float del_a = qa < Sq ? delta[rows + qa] : 0.0f;
  const float del_b = qb < Sq ? delta[rows + qb] : 0.0f;

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;

  // Keys at or past sk_true are masked for every row; under the causal
  // mask so are keys past the tile's last row. sk_true >= 1, so n_k >= 1.
  int kend = sk_true;
  if (causal && q0 + kBQ < kend) kend = q0 + kBQ;
  const int n_k = (kend + kBK - 1) / kBK;
  const size_t kvoff = kvb * Sk * D;

  // Key tile k0's K and V terms.
  auto load_keys = [&](int k0) {
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
      load_tile<kBK, D, kThreads>(sK + m * kTile, in.k + m * kv_plane + kvoff,
                                  k0, Sk, tid);
      load_tile<kBK, D, kThreads>(sV + m * kTile, in.v + m * kv_plane + kvoff,
                                  k0, Sk, tid);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int m = 0; m < kTerms; ++m) {
    load_tile<kBQ, D, kThreads>(sQ + m * kTile, in.q + m * q_plane + rows * D,
                                q0, Sq, tid);
    load_tile<kBQ, D, kThreads>(sDO + m * kTile,
                                in.dout + m * q_plane + rows * D, q0, Sq,
                                tid);
  }
  load_keys(0);

  for (int i = 0; i < n_k; ++i) {
    const int k0 = i * kBK;
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();

    float s[32], ds[32];
    wgmma_fence();
    product_ss<kBQ, kBK, D, kTile, kFirstScorePair>(s, sQ, sK);
    product_ss<kBQ, kBK, D, kTile, 0>(ds, sDO, sV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(ds);

    // Masks: a tile needs them where it crosses sk_true or the diagonal.
    // Rows at or past Sq read zeros and are never written.
    const bool masked = k0 + kBK > sk_true ||
                        (causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + c0 + e;            // key
        float pa = expf(s[4 * j + e] * scale - lse_a);
        float pb = expf(s[4 * j + 2 + e] * scale - lse_b);
        if (masked) {
          const bool k_ok = kj < sk_true;
          if (!(k_ok && (!causal || kj <= qa))) pa = 0.0f;
          if (!(k_ok && (!causal || kj <= qb))) pb = 0.0f;
        }
        ds[4 * j + e] = pa * (ds[4 * j + e] - del_a);
        ds[4 * j + 2 + e] = pb * (ds[4 * j + 2 + e] - del_b);
      }

    uint32_t t[kTerms][4][4];
    split_terms(ds, t);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float o[32];
      product_rs<kBK, kTile>(o, t, sK, p);
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[p][r] += o[r];
    }
    __syncthreads();                     // the stage is free for reuse
    if (i + 1 < n_k) load_keys(k0 + kBK);
  }

  const size_t base = rows * D;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + c0;
      if (qa < Sq)
        *reinterpret_cast<float2*>(dq + base + static_cast<size_t>(qa) * D +
                                   col) =
            make_float2(acc[p][4 * j] * scale, acc[p][4 * j + 1] * scale);
      if (qb < Sq)
        *reinterpret_cast<float2*>(dq + base + static_cast<size_t>(qb) * D +
                                   col) =
            make_float2(acc[p][4 * j + 2] * scale,
                        acc[p][4 * j + 3] * scale);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* terms, void* dq, int BH, int H, int Kh, int Sq,
                   int Sk, int sk_true, int causal, float scale,
                   cudaStream_t stream) {
  static smem_optin::SmemOptin optin;
  const auto kernel = flash_bwd_dq_f32_kernel<D>;
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
  err = split_inputs(q, k, v, dout, terms, nq, nk, &planes, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, Cfg<D>::kBytes, stream>>>(
      planes, nq, nk, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, Kh, Sq,
      Sk, sk_true, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q and dout (BH, Sq, D), k and v (BH / H * Kh, Sk, D), lse and delta
// (BH, Sq), all f32; terms (3 * (2 * BH * Sq * D + 2 * BH / H * Kh * Sk *
// D)) bf16 scratch for the inputs' term planes; dq (BH, Sq, D) f32. All
// contiguous on the current device, 16-byte aligned. D is 64 or 128.
// Launches the split and the dq kernel; returns the first cudaError_t (0
// on success).
extern "C" int flash_attention_bwd_dq_f32_sm90_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* terms, void* dq, int BH, int H,
    int Kh, int Sq, int Sk, int sk_true, int D, int causal, float scale,
    void* stream) {
  if (BH < 1 || H < 1 || Kh < 1 || H % Kh != 0 || BH % H != 0 || Sq < 1 ||
      Sk < 1 || sk_true < 1 || sk_true > Sk || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(DD)                                                             \
  launch<DD>(q, k, v, dout, lse, delta, terms, dq, BH, H, Kh, Sq, Sk,      \
             sk_true, causal, scale, s)
  if (D == 64) return static_cast<int>(DQ(64));
  if (D == 128) return static_cast<int>(DQ(128));
#undef DQ
  return static_cast<int>(cudaErrorInvalidValue);
}
