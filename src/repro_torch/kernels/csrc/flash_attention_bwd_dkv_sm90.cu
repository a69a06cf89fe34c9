// Flash-attention backward, dk and dv, for bf16 on Hopper's tensor cores
// (sm_90a), with the causal mask, the key-padding mask (sk_true) and the
// GQA head fold.
//
// Replaces, for bf16 inputs, the TPU kernel src/repro/kernels/
// flash_attention.py :: flash_attention_bwd_pallas (_flash_dkv_kernel,
// pallas_call :205); fp32 inputs take flash_attention_bwd_dkv_f32_sm90.cu.
// The function is that kernel's, in fp32: for key j of a KV head and each
// query row i of the H / Kh query heads that read it,
//
//   s_ij  = (k_j . q_i) * scale;  masked where j >= sk_true or, causal,
//   j > i; p_ij = exp(s_ij - lse_i) (0 where masked)
//   ds_ij = p_ij * (v_j . dO_i - delta_i)
//   dv_j  = sum_i p_ij dO_i,   dk_j = scale * sum_i ds_ij q_i
//
// summed over the rep = H / Kh query heads of the group.
//
// Design (flash_sm90.cuh has the tile layout and the wgmma helpers). One
// block of one warpgroup (128 threads) per (query head, 64-key tile): it
// keeps the tile's K and V in shared memory and its dK and dV in fp32
// registers, and streams the query head's Q and dO tiles of 64 rows, with
// their lse and delta, through a two-stage cp.async ring, from the
// diagonal tile on under the causal mask. Per query tile:
//  - S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory;
//  - P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) in registers
//    (masks only on a tile that crosses the diagonal, sk_true or Sq);
//  - dV += P^T dO and dK += dS^T Q by wgmma with the fp32 operand split in
//    two bf16 terms, hi and lo (flash_sm90.cuh split_terms; p and ds kept
//    to 2^-18), from registers and dO, Q (MN-major) from shared memory,
//    each tile's product added to the running sum, as in the forward. Two
//    terms suffice here, unlike the forward's out: the gradients' bound
//    has an absolute floor of 1e-5 of the largest gradient.
// Each block writes its query head's dK * scale and dV in fp32 to a scratch
// tensor (B*H, Sk, D); a second kernel folds the rep partials of each KV
// head in a fixed order (query head 0 first) and rounds to bf16, so the
// result is the same bits from run to run (no atomics). Key tiles at or
// past sk_true write zeros.
//
// Balanced causal work. Under the causal mask key tile j meets n - j query
// tiles. The grid's fast dimension is the query head and its slow one the
// key tile, ascending, so blocks are issued heaviest first and the block
// scheduler fills the card longest-job-first: the last blocks issued are
// the lightest and the tail is short, whatever number of blocks an SM
// holds. (Pairing tiles j and n-1-j into equal blocks balances the work
// too, but equal blocks leave a partial last wave when their count is not
// a multiple of the blocks the card holds at once.)
//
// What bounds it on the H100. Four products of 2*Sq*Sk*dh FLOPs a query
// head (halved when causal), two of them 2x with the split in two terms,
// against q, k, v, dO (bf16), lse, delta read once and dk, dv written
// once: at the qwen2-0.5B training shape (B 2, H 14, Kh 2, S 2048, dh 64,
// causal) 30 GFLOP, 0.030 ms at 989 TFLOP/s (0.046 ms with the split),
// beside 0.01 ms for the bytes; the fp32 partials add 2 * 29 MB of
// traffic (0.018 ms).
#include "flash_sm90.cuh"
#include "smem_optin.cuh"

namespace {

using namespace flash_sm90;

constexpr int kBK = 64;                  // keys a block
constexpr int kBQ = 64;                  // query rows a tile
constexpr int kThreads = 128;            // one warpgroup
constexpr int kTerms = 2;                // bf16 terms of p and ds

template <int D>
struct Smem {
  static constexpr int kTile = 64 * D * 2;          // bytes of a 64 x D tile
  // K, V, two stages of Q and of dO, two stages of lse and of delta.
  static constexpr int kBytes = 6 * kTile + 4 * 64 * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_sm90_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk_part,
                          float* __restrict__ dv_part, int H, int Kh, int Sq,
                          int Sk, int sk_true, int causal, float scale) {
  constexpr int NP = D / 64;
  constexpr int kTile = Smem<D>::kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + kTile;
  const uint32_t sQ = sV + kTile;                      // two stages
  const uint32_t sDO = sQ + 2 * kTile;                 // two stages
  const uint32_t sRow = sDO + 2 * kTile;               // lse[2][64], delta[2][64]
  const float* rows = reinterpret_cast<const float*>(
      smem_raw + (sRow - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bq = blockIdx.x;                           // query batch-head
  const int k0 = blockIdx.y * kBK;                     // heaviest first
  const int rep = H / Kh;
  const size_t kvb = static_cast<size_t>(bq / H) * Kh + (bq % H) / rep;
  const int ka = k0 + warp * 16 + (lane >> 2), kb = ka + 8;   // key rows
  const int c0 = 2 * (lane & 3);

  float dk[NP][32], dv[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[p][i] = dv[p][i] = 0.0f;

  // A key tile at or past sk_true is masked for every query: dk = dv = 0.
  // Under the causal mask no query before k0 sees the tile.
  int qstart = causal ? k0 : 0;
  if constexpr (kFault & kCausalStart) qstart += causal ? kBQ : 0;
  const int n_q = k0 < sk_true && qstart < Sq ? (Sq - qstart + kBQ - 1) / kBQ
                                               : 0;
  const bf16* qb = q + static_cast<size_t>(bq) * Sq * D;
  const bf16* db = dout + static_cast<size_t>(bq) * Sq * D;
  const float* lb = lse + static_cast<size_t>(bq) * Sq;
  const float* deb = delta + static_cast<size_t>(bq) * Sq;

  if (n_q > 0) {
    load_tile<kBK, D, kThreads>(sK, k + kvb * Sk * D, k0, Sk, tid);
    load_tile<kBK, D, kThreads>(sV, v + kvb * Sk * D, k0, Sk, tid);
    load_tile<kBQ, D, kThreads>(sQ, qb, qstart, Sq, tid);
    load_tile<kBQ, D, kThreads>(sDO, db, qstart, Sq, tid);
    load_row_values(sRow, lb, qstart, Sq, tid);
    load_row_values(sRow + 2 * 64 * 4, deb, qstart, Sq, tid);
    cp_async_commit();
  }
  // Masks: a tile needs them where it crosses the diagonal, sk_true or Sq.
  const bool key_edge = k0 + kBK > sk_true;

  for (int i = 0; i < n_q; ++i) {
    const int q0 = qstart + i * kBQ;
    if (i + 1 < n_q) {
      const int st = (i + 1) & 1;
      load_tile<kBQ, D, kThreads>(sQ + st * kTile, qb, q0 + kBQ, Sq, tid);
      load_tile<kBQ, D, kThreads>(sDO + st * kTile, db, q0 + kBQ, Sq, tid);
      load_row_values(sRow + st * 64 * 4, lb, q0 + kBQ, Sq, tid);
      load_row_values(sRow + (2 + st) * 64 * 4, deb, q0 + kBQ, Sq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    const int st = i & 1;
    const uint32_t sQt = sQ + st * kTile, sDOt = sDO + st * kTile;
    const float* lse_t = rows + st * 64;
    const float* del_t = rows + (2 + st) * 64;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k_major<kBK>(sK, kk), desc_k_major<kBQ>(sQt, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k_major<kBK>(sV, kk), desc_k_major<kBQ>(sDOt, kk),
               kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = key_edge || q0 + kBQ > Sq ||
                        (causal && q0 < k0 + kBK - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c0 + e;               // query in the tile
        const int qi = q0 + col;
        const float l_i = lse_t[col], d_i = del_t[col];
        float pa = expf(s[4 * j + e] * scale - l_i);
        float pb = expf(s[4 * j + 2 + e] * scale - l_i);
        if (masked) {
          const bool q_ok = qi < Sq;
          if (!(q_ok && ka < sk_true && (!causal || ka <= qi))) pa = 0.0f;
          if (!(q_ok && kb < sk_true && (!causal || kb <= qi))) pb = 0.0f;
        }
        s[4 * j + e] = pa;
        s[4 * j + 2 + e] = pb;
        dp[4 * j + e] = pa * (dp[4 * j + e] - d_i);
        dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - d_i);
      }

    uint32_t t[kTerms][4][4];
    split_terms(s, t);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float o[32];
      product_terms<kBQ>(o, t, sDOt, p);
#pragma unroll
      for (int r = 0; r < 32; ++r) dv[p][r] += o[r];
    }
    split_terms(dp, t);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float o[32];
      product_terms<kBQ>(o, t, sQt, p);
#pragma unroll
      for (int r = 0; r < 32; ++r) dk[p][r] += o[r];
    }
    __syncthreads();                     // the stage is free for reuse
  }

  // This query head's partial, rows below Sk (zeros for a masked tile).
  const size_t base = static_cast<size_t>(bq) * Sk * D;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + c0;
      if (ka < Sk) {
        const size_t o = base + static_cast<size_t>(ka) * D + col;
        *reinterpret_cast<float2*>(dk_part + o) =
            make_float2(dk[p][4 * j] * scale, dk[p][4 * j + 1] * scale);
        *reinterpret_cast<float2*>(dv_part + o) =
            make_float2(dv[p][4 * j], dv[p][4 * j + 1]);
      }
      if (kb < Sk) {
        const size_t o = base + static_cast<size_t>(kb) * D + col;
        *reinterpret_cast<float2*>(dk_part + o) =
            make_float2(dk[p][4 * j + 2] * scale, dk[p][4 * j + 3] * scale);
        *reinterpret_cast<float2*>(dv_part + o) =
            make_float2(dv[p][4 * j + 2], dv[p][4 * j + 3]);
      }
    }
}

// dk, dv (B*Kh, Sk, D) bf16 = the sum over the rep query heads of each KV
// head of the partials (B*H, Sk, D), query head 0 first (with the planted
// kFoldOrder fault, head `start` first).
__global__ void __launch_bounds__(256)
flash_bwd_dkv_fold_kernel(const float* __restrict__ dk_part,
                          const float* __restrict__ dv_part,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int H, int Kh, size_t per_head, size_t n
#if FLASH_SM90_FAULT & 2
                          , int start
#endif
                          ) {
  const int rep = H / Kh;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t c = e / per_head, r = e % per_head;
    const size_t first = ((c / Kh) * H + (c % Kh) * rep) * per_head + r;
    float a = 0.0f, b = 0.0f;
    for (int i = 0; i < rep; ++i) {
#if FLASH_SM90_FAULT & 2
      const size_t o = first + ((i + start) % rep) * per_head;
#else
      const size_t o = first + i * per_head;
#endif
      a += dk_part[o];
      b += dv_part[o];
    }
    dk[e] = __float2bfloat16_rn(a);
    dv[e] = __float2bfloat16_rn(b);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk_part, void* dv_part, void* dk, void* dv, int BH,
                   int H, int Kh, int Sq, int Sk, int sk_true, int causal,
                   float scale, cudaStream_t stream) {
  static smem_optin::SmemOptin optin;
  const auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  int dev = 0, limit = 0;
  cudaError_t err = smem_optin::device_limit(optin, &dev, &limit);
  if (err != cudaSuccess) return err;
  if (Smem<D>::kBytes > limit) return cudaErrorInvalidConfiguration;
  err = smem_optin::grant(optin, reinterpret_cast<const void*>(kernel), dev,
                          Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sk + kBK - 1) / kBK);
  kernel<<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk_part), static_cast<float*>(dv_part), H, Kh, Sq,
      Sk, sk_true, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t per_head = static_cast<size_t>(Sk) * D;
  const size_t n = static_cast<size_t>(BH / H) * Kh * per_head;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096
                                          ? (n + 255) / 256 : 4096);
#if FLASH_SM90_FAULT & 2
  static int calls = 0;                  // the fold starts one head later
  const int start = ++calls % (H / Kh);  // on each call
#endif
  flash_bwd_dkv_fold_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Kh, per_head, n
#if FLASH_SM90_FAULT & 2
      , start
#endif
      );
  return cudaGetLastError();
}

}  // namespace

// q and dout (BH, Sq, D), k and v (BH / H * Kh, Sk, D), all bf16; lse and
// delta (BH, Sq) f32; dk_part and dv_part (BH, Sk, D) f32 scratch; dk and
// dv (BH / H * Kh, Sk, D) bf16, each KV head's gradient summed over the rep
// query heads that read it. All contiguous on the current device, 16-byte
// aligned. D is 64 or 128. Launches the dk/dv kernel and the fold;
// returns the first cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dkv_sm90_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk_part, void* dv_part,
    void* dk, void* dv, int BH, int H, int Kh, int Sq, int Sk, int sk_true,
    int D, int causal, float scale, void* stream) {
  if (BH < 1 || H < 1 || Kh < 1 || H % Kh != 0 || BH % H != 0 || Sq < 1 ||
      Sk < 1 || sk_true < 1 || sk_true > Sk || (Sk + kBK - 1) / kBK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(DD)                                                            \
  launch<DD>(q, k, v, dout, lse, delta, dk_part, dv_part, dk, dv, BH, H,   \
             Kh, Sq, Sk, sk_true, causal, scale, s)
  if (D == 64) return static_cast<int>(DKV(64));
  if (D == 128) return static_cast<int>(DKV(128));
#undef DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
