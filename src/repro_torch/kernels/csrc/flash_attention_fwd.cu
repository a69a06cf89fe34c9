// Flash-attention forward on Hopper (sm_90a): online-softmax attention
// with a causal mask, a key-padding mask (sk_true) and the GQA head fold.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention_fwd_pallas (_flash_fwd_kernel). For each query row i of
// batch-head b and every key j of its KV head:
//
//   s_ij  = (q_i . k_j) * scale,  scale = dh^-0.5 (passed in)
//   valid = j < sk_true  and, when causal, j <= i;  else s_ij = -1e30
//   m, l, acc carried over key tiles in fp32 (running max, denominator,
//   p @ v accumulator), tile by tile as the Pallas kernel does
//   out_i = acc / max(l, 1e-30)          in q's dtype
//   lse_i = m + log(max(l, 1e-30))       fp32
//
// The KV head of batch-head b is (b / H) * Kh + (b % H) / rep with
// rep = H / Kh (any rep, not only powers of two): K and V are read from
// the un-repeated (B*Kh, Sk, D) arrays, as the Pallas index map does.
//
// Design. One block per (batch-head, 64-query tile), two threads per query
// row: each owns the interleaved half of the head dimension (d = 2i + h),
// so a row's dot product is two partial sums joined by one shuffle (a + b
// == b + a, so both threads hold the same bits) and its accumulator
// acc[D/2] stays in registers. K and V tiles of kKT keys are staged in
// shared memory as fp32 (bf16 is widened exactly on load) and read by
// broadcast. Scores of a tile live in registers; the tile's max, exp and
// rescale follow the Pallas kernel's order. Tiles past sk_true, and under
// the causal mask tiles wholly above the block's last row, are skipped:
// key 0 is valid for every row, so m is finite after the first tile, and a
// fully masked tile would give p = exp(-1e30 - m) = 0 and corr = 1, the
// same bits. Keys past the allocated Sk read as zeros and are masked.
// fp32 FMAs with accurate expf/logf; no TF32 and no tensor cores yet.
//
// What bounds it on the H100. 4*B*H*Sq*Sk*dh FLOPs (halved when causal)
// against q, k, v read once and out, lse written once: at the qwen2-0.5B
// prefill (B 1, H 14, Kh 2, S 2048, dh 64, causal, bf16) about 7.5 GFLOP
// and 8.5 MB, so the tensor cores' 989 TFLOP/s bound it (about 7.6 us
// against 2.5 us for the bytes). This
// kernel runs on the CUDA cores in fp32 (67 TFLOP/s at best) with one
// shared-memory load per FMA, so it sits far above that bound: a wgmma
// version with TMA-fed tiles is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kThreads = 2 * kBQ;       // two threads per row
constexpr int kKT = 32;                 // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Kh, int Sq, int Sk,
                 int sk_true, int causal, float scale) {
  constexpr int D2 = D / 2;
  __shared__ float k_s[kKT][D];
  __shared__ float v_s[kKT][D];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 1;                // row within the tile
  const int h = tid & 1;                 // which interleaved half
  const int qi = q0 + r;
  const bool live = qi < Sq;
  const int rep = H / Kh;
  const size_t kvb = static_cast<size_t>(b / H) * Kh + (b % H) / rep;
  const T* kb = k + kvb * Sk * D;
  const T* vb = v + kvb * Sk * D;

  float qr[D2];
  float acc[D2];
  const size_t qrow = (static_cast<size_t>(b) * Sq + qi) * D;
#pragma unroll
  for (int i = 0; i < D2; ++i) {
    qr[i] = live ? load_f(q, qrow + 2 * i + h) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  // Keys past sk_true are masked for every row; under the causal mask so
  // are keys past the block's last row.
  int kend = sk_true < Sk ? sk_true : Sk;
  if (causal && q0 + kBQ < kend) kend = q0 + kBQ;
  const int n_tiles = (kend + kKT - 1) / kKT;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKT;
    __syncthreads();                     // the previous tile is consumed
    for (int e = tid; e < kKT * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < Sk;
      const size_t off = static_cast<size_t>(k0 + j) * D + d;
      k_s[j][d] = in ? load_f(kb, off) : 0.0f;
      v_s[j][d] = in ? load_f(vb, off) : 0.0f;
    }
    __syncthreads();

    float s[kKT];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < D2; ++i) part = fmaf(qr[i], k_s[j][2 * i + h], part);
      const float other = __shfl_xor_sync(0xffffffffu, part, 1);
      const float dot = h ? other + part : part + other;
      const int kj = k0 + j;
      const bool valid = kj < sk_true && (!causal || kj <= qi);
      s[j] = valid ? dot * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < D2; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kKT; ++j) a = fmaf(s[j], v_s[j][2 * i + h], a);
      acc[i] = a;
    }
    m = m_new;
  }

  if (!live) return;
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < D2; ++i) store_f(out, qrow + 2 * i + h, acc[i] / lc);
  if (h == 0) lse[static_cast<size_t>(b) * Sq + qi] = m + logf(lc);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int H, int Kh, int Sq, int Sk,
                   int sk_true, int causal, float scale,
                   cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Kh, Sq, Sk, sk_true, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, void* lse, int BH, int H, int Kh, int Sq,
                     int Sk, int sk_true, int causal, float scale,
                     cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, out, lse, BH, H, Kh, Sq, Sk, sk_true,
                         causal, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, out, lse, BH, H, Kh, Sq, Sk, sk_true,
                          causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (BH, Sq, D), k and v (BH / H * Kh, Sk, D), out (BH, Sq, D) in q's type,
// lse (BH, Sq) f32; all contiguous on the current device. D is 64 or 128
// (the wrapper zero-pads smaller head dims; the scale is passed in).
// bf16 != 0 selects bfloat16 q/k/v/out, else float32. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int BH, int H, int Kh, int Sq, int Sk, int sk_true, int D, int causal,
    float scale, int bf16, void* stream) {
  if (BH < 1 || BH > 65535 || H < 1 || Kh < 1 || H % Kh != 0 ||
      BH % H != 0 || Sq < 1 || Sk < 1 || sk_true < 1 || sk_true > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, out, lse, BH, H, Kh, Sq, Sk,
                                     sk_true, causal, scale, s)
           : launch_d<float>(D, q, k, v, out, lse, BH, H, Kh, Sq, Sk,
                             sk_true, causal, scale, s);
  return static_cast<int>(err);
}
