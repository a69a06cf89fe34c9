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
// q, k and dq have DQK columns, v and dO DV: the pairs (64, 64), (128,
// 128) and MLA's (192, 128) are instantiated.
//
// Design: flash_attention_bwd_dq_sm90.cu's, on fp32 operands carried as
// three bf16 terms each (flash_f32_sm90.cuh). One C call splits q, k, v
// and dO into term planes (split_inputs_kernel) and runs the dq kernel.
// One block of one warpgroup (128 threads) per (query head, 64-row query
// tile): it keeps the tile's Q and dO terms in shared memory and its lse
// and delta in registers, accumulates dQ in fp32 registers (32 floats a
// thread a 64-column panel), and streams the KV head's K and V term
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

template <int DQK, int DV>
struct Cfg {
  static constexpr int kTileQK = 64 * DQK * 2;      // a 64 x DQK tile
  static constexpr int kTileV = 64 * DV * 2;        // a 64 x DV tile
  static constexpr int kSetQK = kTerms * kTileQK;   // one operand's terms
  static constexpr int kSetV = kTerms * kTileV;
  // At (192, 128) the terms of Q, dO, K and V come to 240 KB, past the 227
  // KB a block may hold: K's and V's share one region there, V's terms
  // loaded for dP, then K's over them for S and dS K (193 KB; each load
  // waits for the products before it).
  static constexpr bool kShareKV =
      2 * (kSetQK + kSetV) + 1024 > 227 * 1024;
  static constexpr int kBytes =
      kSetQK + kSetV + (kShareKV ? kSetQK : kSetQK + kSetV) + 1024;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(TermPlanes in, const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Kh, int Sq,
                        int Sk, int sk_true, int causal, float scale) {
  using C = Cfg<DQK, DV>;
  constexpr int NP = DQK / 64;                         // panels of dQ
  constexpr int kTileQK = C::kTileQK, kTileV = C::kTileV;
  constexpr bool kPin = DQK == 192;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + C::kSetQK;
  const uint32_t sK = sDO + C::kSetV;
  const uint32_t sV = C::kShareKV ? sK : sK + C::kSetQK;

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
  const size_t koff = kvb * Sk * DQK, voff = kvb * Sk * DV;

  // Key tile k0's K terms, its V terms.
  auto load_k = [&](int k0) {
    const int lt = pinned_int<kPin>(tid);
#pragma unroll
    for (int m = 0; m < kTerms; ++m)
      load_tile<kBK, DQK, kThreads>(sK + m * kTileQK, in.k[m] + koff, k0,
                                    Sk, lt);
  };
  auto load_v = [&](int k0) {
    const int lt = pinned_int<kPin>(tid);
#pragma unroll
    for (int m = 0; m < kTerms; ++m)
      load_tile<kBK, DV, kThreads>(sV + m * kTileV, in.v[m] + voff, k0, Sk,
                                   lt);
  };

#pragma unroll
  for (int m = 0; m < kTerms; ++m) {
    load_tile<kBQ, DQK, kThreads>(sQ + m * kTileQK, in.q[m] + rows * DQK,
                                  q0, Sq, tid);
    load_tile<kBQ, DV, kThreads>(sDO + m * kTileV, in.dout[m] + rows * DV,
                                 q0, Sq, tid);
  }
  if (!C::kShareKV) load_k(0);
  load_v(0);
  cp_async_commit();

  for (int i = 0; i < n_k; ++i) {
    const int k0 = i * kBK;
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();

    float s[32], ds[32];
    if constexpr (C::kShareKV) {
      // dP from V's terms, then K's terms over them for S.
      wgmma_fence();
      product_ss<kBQ, kBK, DV, kTileV, 0>(ds, sDO, sV);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ds);
      __syncthreads();
      load_k(k0);
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_shared();
      __syncthreads();
      wgmma_fence();
      product_ss<kBQ, kBK, DQK, kTileQK, kFirstScorePair>(s, sQ, sK);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
    } else {
      wgmma_fence();
      product_ss<kBQ, kBK, DQK, kTileQK, kFirstScorePair>(s, sQ, sK);
      product_ss<kBQ, kBK, DV, kTileV, 0>(ds, sDO, sV);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(ds);
    }

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
      product_rs<kBK, kTileQK>(o, t, sK, p);
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[p][r] += o[r];
    }
    __syncthreads();                     // the stage is free for reuse
    if (i + 1 < n_k) {
      if (!C::kShareKV) load_k(k0 + kBK);
      load_v(k0 + kBK);
      cp_async_commit();
    }
  }

  const size_t base = rows * DQK;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + c0;
      if (qa < Sq)
        *reinterpret_cast<float2*>(dq + base + static_cast<size_t>(qa) * DQK +
                                   col) =
            make_float2(acc[p][4 * j] * scale, acc[p][4 * j + 1] * scale);
      if (qb < Sq)
        *reinterpret_cast<float2*>(dq + base + static_cast<size_t>(qb) * DQK +
                                   col) =
            make_float2(acc[p][4 * j + 2] * scale,
                        acc[p][4 * j + 3] * scale);
    }
}

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* terms, void* dq, int BH, int H, int Kh, int Sq,
                   int Sk, int sk_true, int causal, float scale,
                   cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  static smem_optin::SmemOptin optin;
  const auto kernel = flash_bwd_dq_f32_kernel<DQK, DV>;
  int dev = 0, limit = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &limit);
  if (err != cudaSuccess) return err;
  if (C::kBytes > limit) return cudaErrorInvalidConfiguration;
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(kernel), dev,
                          C::kBytes);
  if (err != cudaSuccess) return err;
  const size_t q_rows = static_cast<size_t>(BH) * Sq;
  const size_t kv_rows = static_cast<size_t>(BH / H) * Kh * Sk;
  TermPlanes planes;
  err = split_inputs(q, k, v, dout, terms, q_rows * DQK, kv_rows * DQK,
                     kv_rows * DV, q_rows * DV, &planes, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, C::kBytes, stream>>>(
      planes, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, Kh, Sq,
      Sk, sk_true, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q (BH, Sq, DQK), dout (BH, Sq, DV), k (BH / H * Kh, Sk, DQK), v (BH / H
// * Kh, Sk, DV), lse and delta (BH, Sq), all f32; terms (3 * (BH * Sq *
// (DQK + DV) + BH / H * Kh * Sk * (DQK + DV))) bf16 scratch for the
// inputs' term planes; dq (BH, Sq, DQK) f32. All contiguous on the current
// device, 16-byte aligned. (DQK, DV) is (64, 64), (128, 128) or (192,
// 128). Launches the split and the dq kernel; returns the first
// cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dq_f32_sm90_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* terms, void* dq, int BH, int H,
    int Kh, int Sq, int Sk, int sk_true, int DQK, int DV, int causal,
    float scale, void* stream) {
  if (BH < 1 || H < 1 || Kh < 1 || H % Kh != 0 || BH % H != 0 || Sq < 1 ||
      Sk < 1 || sk_true < 1 || sk_true > Sk || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(A, B)                                                           \
  launch<A, B>(q, k, v, dout, lse, delta, terms, dq, BH, H, Kh, Sq, Sk,    \
               sk_true, causal, scale, s)
  if (DQK == 64 && DV == 64) return static_cast<int>(DQ(64, 64));
  if (DQK == 128 && DV == 128) return static_cast<int>(DQ(128, 128));
  if (DQK == 192 && DV == 128) return static_cast<int>(DQ(192, 128));
#undef DQ
  return static_cast<int>(cudaErrorInvalidValue);
}
