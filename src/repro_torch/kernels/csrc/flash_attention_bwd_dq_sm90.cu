// Flash-attention backward, dq, for bf16 on Hopper's tensor cores
// (sm_90a), with the causal mask, the key-padding mask (sk_true) and the
// GQA head map.
//
// Replaces, for bf16 inputs, the TPU kernel src/repro/kernels/
// flash_attention.py :: flash_attention_bwd_pallas (_flash_dq_kernel,
// pallas_call :185); fp32 inputs take flash_attention_bwd_dq_f32_sm90.cu.
// The function is that kernel's, in fp32: for query row i of query head b
// and each key j of the KV head it reads,
//
//   s_ij  = (q_i . k_j) * scale;  masked where j >= sk_true or, causal,
//   j > i; p_ij = exp(s_ij - lse_i) (0 where masked)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j,  written in bf16.
//
// Design (flash_sm90.cuh has the tile layout and the wgmma helpers). One
// block of one warpgroup (128 threads) per (query head, 64-row query
// tile): it keeps the tile's Q and dO in shared memory and its lse and
// delta in registers, accumulates dQ in fp32 registers (32 floats a thread
// at D 64, 64 at D 128), and streams the KV head's K and V tiles of 64 keys
// through a two-stage cp.async ring, from key tile 0 up to sk_true and,
// under the causal mask, up to the diagonal tile. Per key tile:
//  - S = Q K^T and dP = dO V^T by wgmma from shared memory (A and B
//    K-major);
//  - P = exp(S scale - lse) and dS = P (dP - delta) in registers (masks
//    only on a tile that crosses the diagonal or sk_true);
//  - dQ += dS K by wgmma with A = dS from registers (the accumulator
//    fragment is already in A-fragment order) split in two bf16 terms, hi
//    and lo (flash_sm90.cuh split_terms, ds kept to 2^-18), and B = the
//    same K tile read MN-major; each tile's product is added to the
//    running fp32 sum, as in dk/dv. Two terms, as dk/dv's ds^T: the
//    gradients' bound has an absolute floor of 1e-5 of the largest one.
// dQ * scale is rounded to bf16 once, at the end. A block owns its rows
// outright: no atomics and no partials, so the result is the same bits
// from run to run (FlashAttention-2's dq by atomic adds inside the dk/dv
// kernel would not be).
//
// Balanced causal work. Under the causal mask query tile i meets i + 1 key
// tiles. The grid's fast dimension is the query head and its slow one the
// query tile, descending, so blocks are issued heaviest first and the
// block scheduler fills the card longest-job-first: the last blocks issued
// are the lightest, and the tail is short whatever number of blocks an SM
// holds (dk/dv does the same with key tiles ascending).
//
// What bounds it on the H100. Three products of 2*Sq*Sk*dh FLOPs a query
// head (halved when causal), dS K 2x with the split, against q, k, v, dO
// (bf16), lse, delta read once and dq written once: at the qwen2-0.5B
// training shape (B 2, H 14, Kh 2, S 2048, dh 64, causal) 22.5 GFLOP,
// 0.0228 ms at 989 TFLOP/s (0.0304 ms with the split), beside 0.006 ms for
// the bytes. The design keeps every intermediate (S, P, dP, dS) in
// registers and moves each K/V tile once into shared memory per query
// tile; what it leaves is wgmma issue without a producer warp or TMA.
#include "flash_sm90.cuh"
#include "smem_optin.cuh"

namespace {

using namespace flash_sm90;

constexpr int kBQ = 64;                  // query rows a block
constexpr int kBK = 64;                  // keys a tile
constexpr int kThreads = 128;            // one warpgroup
constexpr int kTerms = 2;                // bf16 terms of ds

template <int D>
struct Smem {
  static constexpr int kTile = 64 * D * 2;          // bytes of a 64 x D tile
  // Q, dO, two stages of K and of V.
  static constexpr int kBytes = 6 * kTile + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_sm90_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int Kh, int Sq,
                         int Sk, int sk_true, int causal, float scale) {
  constexpr int NP = D / 64;
  constexpr int kTile = Smem<D>::kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + kTile;
  const uint32_t sK = sDO + kTile;                     // two stages
  const uint32_t sV = sK + 2 * kTile;                  // two stages

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
  int n_k = (kend + kBK - 1) / kBK;
  if constexpr (kFault & kCausalLoopShort)
    n_k -= causal && n_k > 1 ? 1 : 0;
  const bf16* kb = k + kvb * Sk * D;
  const bf16* vb = v + kvb * Sk * D;

  load_tile<kBQ, D, kThreads>(sQ, q + rows * D, q0, Sq, tid);
  load_tile<kBQ, D, kThreads>(sDO, dout + rows * D, q0, Sq, tid);
  load_tile<kBK, D, kThreads>(sK, kb, 0, Sk, tid);
  load_tile<kBK, D, kThreads>(sV, vb, 0, Sk, tid);
  cp_async_commit();

  for (int i = 0; i < n_k; ++i) {
    const int k0 = i * kBK;
    if (i + 1 < n_k) {
      const int st = (i + 1) & 1;
      load_tile<kBK, D, kThreads>(sK + st * kTile, kb, k0 + kBK, Sk, tid);
      load_tile<kBK, D, kThreads>(sV + st * kTile, vb, k0 + kBK, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    const int st = i & 1;
    const uint32_t sKt = sK + st * kTile, sVt = sV + st * kTile;

    float s[32], ds[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k_major<kBQ>(sQ, kk), desc_k_major<kBK>(sKt, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(ds, desc_k_major<kBQ>(sDO, kk), desc_k_major<kBK>(sVt, kk),
               kk);
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
      product_terms<kBK>(o, t, sKt, p);
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[p][r] += o[r];
    }
    __syncthreads();                     // the stage is free for reuse
  }

  const size_t base = rows * D;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + c0;
      if (qa < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            dq + base + static_cast<size_t>(qa) * D + col) =
            __floats2bfloat162_rn(acc[p][4 * j] * scale,
                                  acc[p][4 * j + 1] * scale);
      if (qb < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            dq + base + static_cast<size_t>(qb) * D + col) =
            __floats2bfloat162_rn(acc[p][4 * j + 2] * scale,
                                  acc[p][4 * j + 3] * scale);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int BH, int H, int Kh, int Sq, int Sk,
                   int sk_true, int causal, float scale,
                   cudaStream_t stream) {
  static smem_optin::SmemOptin optin;
  const auto kernel = flash_bwd_dq_sm90_kernel<D>;
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
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Kh, Sq, Sk, sk_true, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q and dout (BH, Sq, D), k and v (BH / H * Kh, Sk, D), all bf16; lse and
// delta (BH, Sq) f32; dq (BH, Sq, D) bf16. All contiguous on the current
// device, 16-byte aligned. D is 64 or 128. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention_bwd_dq_sm90_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int BH, int H, int Kh,
    int Sq, int Sk, int sk_true, int D, int causal, float scale,
    void* stream) {
  if (BH < 1 || H < 1 || Kh < 1 || H % Kh != 0 || BH % H != 0 || Sq < 1 ||
      Sk < 1 || sk_true < 1 || sk_true > Sk || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(DD)                                                             \
  launch<DD>(q, k, v, dout, lse, delta, dq, BH, H, Kh, Sq, Sk, sk_true,    \
             causal, scale, s)
  if (D == 64) return static_cast<int>(DQ(64));
  if (D == 128) return static_cast<int>(DQ(128));
#undef DQ
  return static_cast<int>(cudaErrorInvalidValue);
}
