// Flash-attention backward, dk and dv, for fp32 on Hopper's tensor cores
// (sm_90a), with the causal mask, the key-padding mask (sk_true) and the
// GQA head fold.
//
// Replaces, for fp32 inputs, the TPU kernel src/repro/kernels/
// flash_attention.py :: flash_attention_bwd_pallas (_flash_dkv_kernel,
// pallas_call :205); bf16 inputs take flash_attention_bwd_dkv_sm90.cu. The
// function is that kernel's, in fp32: for key j of a KV head and each
// query row i of the H / Kh query heads that read it,
//
//   s_ij  = (k_j . q_i) * scale;  masked where j >= sk_true or, causal,
//   j > i; p_ij = exp(s_ij - lse_i) (0 where masked; lse from the fp32
//   forward)
//   ds_ij = p_ij * (v_j . dO_i - delta_i)
//   dv_j  = sum_i p_ij dO_i,   dk_j = scale * sum_i ds_ij q_i
//
// summed over the rep = H / Kh query heads of the group, all in fp32.
//
// Design: flash_attention_bwd_dkv_sm90.cu's, on fp32 operands carried as
// three bf16 terms each (flash_f32_sm90.cuh). One C call splits q, k, v
// and dO into term planes (split_inputs_kernel), runs the dk/dv kernel and
// folds its partials. One block of one warpgroup (128 threads) per (query
// head, 64-key tile): it keeps the tile's K and V terms in shared memory
// and its dK and dV in fp32 registers, and streams the query head's Q and
// dO term tiles of 64 rows, with their lse and delta, through one
// cp.async stage, from the diagonal tile on under the causal mask. One
// stage (98 KB at D 64) lets two blocks share an SM, which hides a
// block's loads behind the other's products: in a trial on the card at
// the training shape that was faster than two stages in one block. Per
// query tile:
//  - S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory, each the
//    six cross terms of the operands' terms (24 m64n64k16 a product at
//    D 64);
//  - P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) in registers
//    (masks only on a tile that crosses the diagonal, sk_true or Sq);
//  - dV += P^T dO and dK += dS^T Q by wgmma with P^T and dS^T split into
//    three terms in registers and dO, Q (MN-major) from shared memory, the
//    six cross terms into a tile sum that is then added to the running
//    one, so no tensor-core sum runs longer than one tile.
// At D 128 each 64-column panel of dK and of dV has blocks of its own
// (two launches, dV's and dK's, each block recomputing S^T, dK's also
// dP^T): the registers of two outputs' sums, the split and the tile sum
// spilled there. Each block writes its query head's partial, dK * scale
// and dV in fp32, to a scratch tensor (B*H, Sk, D); a second kernel sums
// the rep partials of each KV head in a fixed order (query head 0 first)
// in fp32, so the result is the same bits from run to run (no atomics).
// Key tiles at or past sk_true write zeros. Blocks are issued heaviest
// first (the grid's fast dimension the query head and panel, its slow
// one the key tile, ascending), as in the bf16 kernel, and no loop exits
// early (an early exit gave the bf16 kernel a stack frame).
//
// What bounds it on the H100. Four products of 2*Sq*Sk*dh FLOPs a query
// head (halved when causal), each six bf16 products with the split,
// against q, k, v, dO, lse, delta (fp32) read once and dk, dv written
// once: at the qwen2-0.5B training shape (B 2, H 14, Kh 2, S 2048, dh 64,
// causal) 180 GFLOP of bf16 tensor-core work, 0.182 ms at 989 TFLOP/s
// (the four fp32 products on the CUDA cores: 0.449 ms at 67 TFLOP/s),
// beside 0.02 ms for the bytes; the term planes (1.5x the inputs' bytes,
// written once and read per block) and the fp32 partials (2 * 29 MB) add
// traffic of about 0.04 ms.
#include "flash_f32_sm90.cuh"
#include "smem_optin.cuh"

namespace {

using namespace flash_f32_sm90;

constexpr int kBK = 64;                  // keys a block
constexpr int kBQ = 64;                  // query rows a tile
constexpr int kThreads = 128;            // one warpgroup

template <int D>
struct Cfg {
  static constexpr int kTile = 64 * D * 2;          // bytes of a 64 x D tile
  static constexpr int kSet = kTerms * kTile;       // one operand's terms
  // The terms of K, V, Q and dO; lse and delta.
  static constexpr int kBytes = 4 * kSet + 2 * 64 * 4 + 1024;
};

// What a block computes: dK and dV (D 64), or at D 128 one of them, so
// that a thread holds one panel's sum (two panels' and two outputs' sums,
// the split and the tile sum do not fit in 255 registers).
enum Role : int { kBoth = 0, kDV = 1, kDK = 2 };

template <int D, int ROLE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(TermPlanes in, size_t q_plane, size_t kv_plane,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk_part,
                         float* __restrict__ dv_part, int H, int Kh, int Sq,
                         int Sk, int sk_true, int causal, float scale) {
  constexpr bool kWantDV = ROLE != kDK, kWantDK = ROLE != kDV;
  constexpr int kTile = Cfg<D>::kTile, kSet = Cfg<D>::kSet;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + kSet;
  const uint32_t sQ = sV + kSet;
  const uint32_t sDO = sQ + kSet;
  const uint32_t sRow = sDO + kSet;                    // lse[64], delta[64]
  const float* lse_t = reinterpret_cast<const float*>(
      smem_raw + (sRow - smem_u32(smem_raw)));
  const float* del_t = lse_t + 64;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bq = blockIdx.x / (D / 64);                // query batch-head
  const int panel = blockIdx.x % (D / 64);             // columns 64 panel..
  const int k0 = blockIdx.y * kBK;                     // heaviest first
  const int rep = H / Kh;
  const size_t kvb = static_cast<size_t>(bq / H) * Kh + (bq % H) / rep;
  const int ka = k0 + warp * 16 + (lane >> 2), kb = ka + 8;   // key rows
  const int c0 = 2 * (lane & 3);

  float dk[kWantDK ? 32 : 1], dv[kWantDV ? 32 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if constexpr (kWantDK) dk[i] = 0.0f;
    if constexpr (kWantDV) dv[i] = 0.0f;
  }

  // A key tile at or past sk_true is masked for every query: dk = dv = 0.
  // Under the causal mask no query before k0 sees the tile.
  const int qstart = causal ? k0 : 0;
  const int n_q = k0 < sk_true && qstart < Sq ? (Sq - qstart + kBQ - 1) / kBQ
                                               : 0;
  const size_t qoff = static_cast<size_t>(bq) * Sq * D;
  const float* lb = lse + static_cast<size_t>(bq) * Sq;
  const float* deb = delta + static_cast<size_t>(bq) * Sq;

  // Query tile q0's Q and dO terms, lse and delta.
  auto load_queries = [&](int q0) {
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
      load_tile<kBQ, D, kThreads>(sQ + m * kTile, in.q + m * q_plane + qoff,
                                  q0, Sq, tid);
      load_tile<kBQ, D, kThreads>(sDO + m * kTile,
                                  in.dout + m * q_plane + qoff, q0, Sq, tid);
    }
    load_row_values(sRow, lb, q0, Sq, tid);
    load_row_values(sRow + 64 * 4, deb, q0, Sq, tid);
    cp_async_commit();
  };

  if (n_q > 0) {
    const size_t kvoff = kvb * Sk * D;
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
      load_tile<kBK, D, kThreads>(sK + m * kTile, in.k + m * kv_plane + kvoff,
                                  k0, Sk, tid);
      load_tile<kBK, D, kThreads>(sV + m * kTile, in.v + m * kv_plane + kvoff,
                                  k0, Sk, tid);
    }
    load_queries(qstart);
  }
  // Masks: a tile needs them where it crosses the diagonal, sk_true or Sq.
  const bool key_edge = k0 + kBK > sk_true;

  for (int i = 0; i < n_q; ++i) {
    const int q0 = qstart + i * kBQ;
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();

    float s[32], dp[kWantDK ? 32 : 1];
    wgmma_fence();
    product_ss<kBK, kBQ, D, kTile, kFirstScorePair>(s, sK, sQ);
    if constexpr (kWantDK) product_ss<kBK, kBQ, D, kTile, 0>(dp, sV, sDO);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    if constexpr (kWantDK) fence_regs(dp);

    const bool masked = key_edge || q0 + kBQ > Sq ||
                        (causal && q0 < k0 + kBK - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c0 + e;               // query in the tile
        const int qi = q0 + col;
        const float l_i = lse_t[col];
        float pa = expf(s[4 * j + e] * scale - l_i);
        float pb = expf(s[4 * j + 2 + e] * scale - l_i);
        if (masked) {
          const bool q_ok = qi < Sq;
          if (!(q_ok && ka < sk_true && (!causal || ka <= qi))) pa = 0.0f;
          if (!(q_ok && kb < sk_true && (!causal || kb <= qi))) pb = 0.0f;
        }
        s[4 * j + e] = pa;
        s[4 * j + 2 + e] = pb;
        if constexpr (kWantDK) {
          const float d_i = del_t[col];
          dp[4 * j + e] = pa * (dp[4 * j + e] - d_i);
          dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - d_i);
        }
      }

    uint32_t t[kTerms][4][4];
    float o[32];
    if constexpr (kWantDV) {
      split_terms(s, t);
      product_rs<kBQ, kTile>(o, t, sDO, panel);
#pragma unroll
      for (int r = 0; r < 32; ++r) dv[r] += o[r];
    }
    if constexpr (kWantDK) {
      split_terms(dp, t);
      product_rs<kBQ, kTile>(o, t, sQ, panel);
#pragma unroll
      for (int r = 0; r < 32; ++r) dk[r] += o[r];
    }
    __syncthreads();                     // the stage is free for reuse
    if (i + 1 < n_q) load_queries(q0 + kBQ);
  }

  // This query head's partial of the panel, rows below Sk (zeros for a
  // masked tile).
  const size_t base = static_cast<size_t>(bq) * Sk * D;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 64 * panel + 8 * j + c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {                      // rows ka, kb
      const int key = h ? kb : ka;
      if (key >= Sk) continue;
      const size_t o = base + static_cast<size_t>(key) * D + col;
      if constexpr (kWantDK)
        *reinterpret_cast<float2*>(dk_part + o) = make_float2(
            dk[4 * j + 2 * h] * scale, dk[4 * j + 2 * h + 1] * scale);
      if constexpr (kWantDV)
        *reinterpret_cast<float2*>(dv_part + o) =
            make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// dk, dv (B*Kh, Sk, D) fp32 = the sum over the rep query heads of each KV
// head of the partials (B*H, Sk, D), query head 0 first.
__global__ void __launch_bounds__(256)
flash_bwd_dkv_f32_fold_kernel(const float* __restrict__ dk_part,
                              const float* __restrict__ dv_part,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int H, int Kh, size_t per_head, size_t n) {
  const int rep = H / Kh;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t c = e / per_head, r = e % per_head;
    const size_t first = ((c / Kh) * H + (c % Kh) * rep) * per_head + r;
    float a = 0.0f, b = 0.0f;
    for (int i = 0; i < rep; ++i) {
      a += dk_part[first + i * per_head];
      b += dv_part[first + i * per_head];
    }
    dk[e] = a;
    dv[e] = b;
  }
}

template <int D, int ROLE>
cudaError_t launch_role(const TermPlanes& planes, size_t nq, size_t nk,
                        const void* lse, const void* delta, void* dk_part,
                        void* dv_part, int BH, int H, int Kh, int Sq, int Sk,
                        int sk_true, int causal, float scale,
                        cudaStream_t stream) {
  static smem_optin::SmemOptin optin;
  const auto kernel = flash_bwd_dkv_f32_kernel<D, ROLE>;
  int dev = 0, limit = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &limit);
  if (err != cudaSuccess) return err;
  if (Cfg<D>::kBytes > limit) return cudaErrorInvalidConfiguration;
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(kernel), dev,
                          Cfg<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH * (D / 64), (Sk + kBK - 1) / kBK);
  kernel<<<grid, kThreads, Cfg<D>::kBytes, stream>>>(
      planes, nq, nk, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk_part),
      static_cast<float*>(dv_part), H, Kh, Sq, Sk, sk_true, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* terms, void* dk_part, void* dv_part, void* dk,
                   void* dv, int BH, int H, int Kh, int Sq, int Sk,
                   int sk_true, int causal, float scale,
                   cudaStream_t stream) {
  const size_t nq = static_cast<size_t>(BH) * Sq * D;
  const size_t nk = static_cast<size_t>(BH / H) * Kh * Sk * D;
  TermPlanes planes;
  cudaError_t err = split_inputs(q, k, v, dout, terms, nq, nk, &planes,
                                 stream);
  if (err != cudaSuccess) return err;
#define RUN(R)                                                               \
  launch_role<D, R>(planes, nq, nk, lse, delta, dk_part, dv_part, BH, H, Kh, \
                    Sq, Sk, sk_true, causal, scale, stream)
  if constexpr (D == 64) {
    err = RUN(kBoth);
  } else {
    err = RUN(kDV);
    if (err == cudaSuccess) err = RUN(kDK);
  }
#undef RUN
  if (err != cudaSuccess) return err;
  const size_t per_head = static_cast<size_t>(Sk) * D;
  const size_t blocks = (nk + 255) / 256;
  flash_bwd_dkv_f32_fold_kernel<<<static_cast<int>(blocks < 4096 ? blocks
                                                                  : 4096),
                                  256, 0, stream>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Kh, per_head, nk);
  return cudaGetLastError();
}

}  // namespace

// q and dout (BH, Sq, D), k and v (BH / H * Kh, Sk, D), lse and delta
// (BH, Sq), all f32; terms (3 * (2 * BH * Sq * D + 2 * BH / H * Kh * Sk *
// D)) bf16 scratch for the inputs' term planes; dk_part and dv_part (BH,
// Sk, D) f32 scratch; dk and dv (BH / H * Kh, Sk, D) f32, each KV head's
// gradient summed over the rep query heads that read it. All contiguous on
// the current device, 16-byte aligned. D is 64 or 128. Launches the split,
// the dk/dv kernel and the fold; returns the first cudaError_t (0 on
// success).
extern "C" int flash_attention_bwd_dkv_f32_sm90_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* terms, void* dk_part,
    void* dv_part, void* dk, void* dv, int BH, int H, int Kh, int Sq, int Sk,
    int sk_true, int D, int causal, float scale, void* stream) {
  if (BH < 1 || H < 1 || Kh < 1 || H % Kh != 0 || BH % H != 0 || Sq < 1 ||
      Sk < 1 || sk_true < 1 || sk_true > Sk || (Sk + kBK - 1) / kBK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(DD)                                                            \
  launch<DD>(q, k, v, dout, lse, delta, terms, dk_part, dv_part, dk, dv,   \
             BH, H, Kh, Sq, Sk, sk_true, causal, scale, s)
  if (D == 64) return static_cast<int>(DKV(64));
  if (D == 128) return static_cast<int>(DKV(128));
#undef DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
