// Flash-attention backward on Hopper (sm_90a), fp32: dq in one kernel, dk
// and dv in a second, with the causal mask, the key-padding mask (sk_true)
// and the GQA head fold.
//
// Replaces, for fp32 inputs, the TPU kernel src/repro/kernels/
// flash_attention.py :: flash_attention_bwd_pallas (_flash_dq_kernel,
// pallas_call :185; _flash_dkv_kernel, pallas_call :205); bf16 inputs take
// the tensor-core flash_attention_bwd_dq_sm90.cu and
// flash_attention_bwd_dkv_sm90.cu. From the forward's residuals
// (q, k, v, lse), the output gradient dO and delta_i = sum_d dO_id * out_id
// (a torch reduction in the wrapper, as the reference computes it outside
// its kernels), for each query row i of batch-head b and key j of its KV
// head:
//
//   s_ij  = (q_i . k_j) * scale,  scale = dh^-0.5 (passed in)
//   valid = j < sk_true  and, when causal, j <= i;  else s_ij = -1e30
//   p_ij  = exp(s_ij - lse_i)                      (recomputed, fp32)
//   ds_ij = p_ij * (dO_i . v_j - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dv_j  = sum_i p_ij dO_i,   dk_j = scale * sum_i ds_ij q_i
//
// All math in fp32.
//
// GQA. Query head b reads KV head (b / H) * Kh + (b % H) / rep, rep = H / Kh,
// as in the forward. The Pallas backward has no such fold (its K/V batch
// equals q's; the reference's autograd sums the repeated K/V's gradients
// over the rep query heads of a group). Here the dk/dv kernel does that
// sum itself: a block owns one KV head's key tile and loops over the rep
// query heads that read it, so no K/V is repeated and no atomics are
// needed (the result is deterministic).
//
// Design. Both kernels keep the forward's structure: fp32 FMAs on the CUDA
// cores, operand tiles in shared memory read by broadcast, a row's dot
// products split over P neighbouring lanes (interleaved: lane h owns the
// elements d = P*e + h) and joined by a shuffle butterfly (a + b == b + a,
// so every lane of a row holds the same bits).
//  - dq: one block per (batch-head, 64 query rows), P = D / 32 lanes a row
//    holding q, dO and the dq accumulator in registers, K/V tiles of 32 keys
//    staged in shared memory; the key loop stops at sk_true and, causal, at
//    the block's last row (a fully masked key gives p = 0 and adds nothing).
//  - dk/dv: one block per (KV batch-head, 32 key rows), P = D / 16 lanes a
//    key holding k, v and both accumulators in registers; for each of the
//    rep query heads it streams Q/dO tiles of 32 rows (with their lse and
//    delta) through shared memory, from the first tile that can see the key
//    tile under the causal mask. Key tiles at or past sk_true write zeros.
//
// What bounds it on the H100. Seven products of 2*Sq*Sk*dh FLOPs a head
// (halved when causal; dq three, dk/dv four) against q, k, v, dO, lse,
// delta read once and dq, dk, dv written once: at the qwen2-0.5B training
// shape in fp32 (B 2, H 14, Kh 2, S 2048, dh 64, causal) about 52.6 GFLOP
// and 53 MB. fp32 operands have no tensor-core route that keeps fp32, so
// the CUDA cores' 67 TFLOP/s bound it (about 0.79 ms against 0.02 ms for
// the bytes). These kernels issue one shared-memory load per FMA, above
// that bound.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;     // dq: query rows per block
constexpr int kKT = 32;     // dq: keys per shared-memory tile
constexpr int kEq = 32;     // dq: elements of a row per lane
constexpr int kBK = 32;     // dk/dv: key rows per block
constexpr int kQT = 32;     // dk/dv: query rows per shared-memory tile
constexpr int kEk = 16;     // dk/dv: elements of a key row per lane

// Sum over the P neighbouring lanes of a row; every lane gets the same bits.
template <int P>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < P; off <<= 1)
    x = x + __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kBQ * (D / kEq))
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Kh, int Sq, int Sk, int sk_true, int causal,
                    float scale) {
  constexpr int P = D / kEq;
  constexpr int NT = kBQ * P;
  __shared__ float k_s[kKT][D];
  __shared__ float v_s[kKT][D];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / P;                 // row within the tile
  const int h = tid % P;                 // which interleaved part
  const int qi = q0 + r;
  const bool live = qi < Sq;
  const int rep = H / Kh;
  const size_t kvb = static_cast<size_t>(b / H) * Kh + (b % H) / rep;
  const float* kb = k + kvb * Sk * D;
  const float* vb = v + kvb * Sk * D;

  const size_t row = (static_cast<size_t>(b) * Sq + qi) * D;
  float qr[kEq], dor[kEq], acc[kEq];
#pragma unroll
  for (int e = 0; e < kEq; ++e) {
    qr[e] = live ? q[row + P * e + h] : 0.0f;
    dor[e] = live ? dout[row + P * e + h] : 0.0f;
    acc[e] = 0.0f;
  }
  const size_t ri = static_cast<size_t>(b) * Sq + qi;
  const float l = live ? lse[ri] : 0.0f;
  const float dl = live ? delta[ri] : 0.0f;

  // Keys past sk_true are masked for every row; under the causal mask so
  // are keys past the block's last row.
  int kend = sk_true < Sk ? sk_true : Sk;
  if (causal && q0 + kBQ < kend) kend = q0 + kBQ;
  const int n_tiles = (kend + kKT - 1) / kKT;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKT;
    __syncthreads();                     // the previous tile is consumed
    for (int e = tid; e < kKT * D; e += NT) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < Sk;
      const size_t off = static_cast<size_t>(k0 + j) * D + d;
      k_s[j][d] = in ? kb[off] : 0.0f;
      v_s[j][d] = in ? vb[off] : 0.0f;
    }
    __syncthreads();

    float ds[kKT];
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      float sp = 0.0f, dp = 0.0f;
#pragma unroll
      for (int e = 0; e < kEq; ++e) {
        sp = fmaf(qr[e], k_s[j][P * e + h], sp);
        dp = fmaf(dor[e], v_s[j][P * e + h], dp);
      }
      sp = row_sum<P>(sp);
      dp = row_sum<P>(dp);
      const int kj = k0 + j;
      const bool valid = kj < sk_true && (!causal || kj <= qi);
      const float s = valid ? sp * scale : kNegInf;
      ds[j] = expf(s - l) * (dp - dl);
    }
    // Read K again through a volatile view: the compiler may not keep the
    // first pass's kKT * kEq values in registers to reuse here (that
    // spills).
    const volatile float(*kv_s)[D] = k_s;
#pragma unroll
    for (int e = 0; e < kEq; ++e) {
      float a = acc[e];
#pragma unroll
      for (int j = 0; j < kKT; ++j) a = fmaf(ds[j], kv_s[j][P * e + h], a);
      acc[e] = a;
    }
  }

  if (!live) return;
#pragma unroll
  for (int e = 0; e < kEq; ++e) dq[row + P * e + h] = acc[e] * scale;
}

template <int D>
__global__ void __launch_bounds__(kBK * (D / kEk))
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                    const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Kh, int Sq, int Sk,
                     int sk_true, int causal, float scale) {
  constexpr int P = D / kEk;
  constexpr int NT = kBK * P;
  __shared__ float q_s[kQT][D];
  __shared__ float do_s[kQT][D];
  __shared__ float lse_s[kQT];
  __shared__ float delta_s[kQT];

  const int c = blockIdx.y;              // KV batch-head
  const int k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int r = tid / P;                 // key row within the tile
  const int h = tid % P;
  const int kj = k0 + r;
  const bool live = kj < Sk;
  const int rep = H / Kh;
  const int bb = c / Kh, kh = c % Kh;

  const size_t krow = (static_cast<size_t>(c) * Sk + kj) * D;
  float kr[kEk], vr[kEk], dka[kEk], dva[kEk];
#pragma unroll
  for (int e = 0; e < kEk; ++e) {
    kr[e] = live ? k[krow + P * e + h] : 0.0f;
    vr[e] = live ? v[krow + P * e + h] : 0.0f;
    dka[e] = 0.0f;
    dva[e] = 0.0f;
  }

  // A key tile at or past sk_true is masked for every query: dk = dv = 0.
  // Under the causal mask no query before k0 sees the tile.
  const int kvalid = sk_true < Sk ? sk_true : Sk;
  const int qstart = (k0 < kvalid) ? (causal ? (k0 / kQT) * kQT : 0) : Sq;
  for (int g = 0; g < rep; ++g) {
    const size_t bq = static_cast<size_t>(bb) * H + kh * rep + g;
    const float* qb = q + bq * Sq * D;
    const float* db = dout + bq * Sq * D;
    const float* lb = lse + bq * Sq;
    const float* deb = delta + bq * Sq;
    for (int t0 = qstart; t0 < Sq; t0 += kQT) {
      __syncthreads();                   // the previous tile is consumed
      for (int e = tid; e < kQT * D; e += NT) {
        const int i = e / D, d = e % D;
        const bool in = t0 + i < Sq;
        const size_t off = static_cast<size_t>(t0 + i) * D + d;
        q_s[i][d] = in ? qb[off] : 0.0f;
        do_s[i][d] = in ? db[off] : 0.0f;
      }
      for (int i = tid; i < kQT; i += NT) {
        const bool in = t0 + i < Sq;
        lse_s[i] = in ? lb[t0 + i] : 0.0f;
        delta_s[i] = in ? deb[t0 + i] : 0.0f;
      }
      __syncthreads();

      float pv[kQT], ds[kQT];
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        float sp = 0.0f, dp = 0.0f;
#pragma unroll
        for (int e = 0; e < kEk; ++e) {
          sp = fmaf(kr[e], q_s[i][P * e + h], sp);
          dp = fmaf(vr[e], do_s[i][P * e + h], dp);
        }
        sp = row_sum<P>(sp);
        dp = row_sum<P>(dp);
        const int qi = t0 + i;
        const bool valid = qi < Sq && kj < sk_true && (!causal || kj <= qi);
        const float p = valid ? expf(sp * scale - lse_s[i]) : 0.0f;
        pv[i] = p;
        ds[i] = p * (dp - delta_s[i]) * scale;
      }
      // Q and dO again through volatile views, as in the dq kernel.
      const volatile float(*qv_s)[D] = q_s;
      const volatile float(*dov_s)[D] = do_s;
#pragma unroll
      for (int e = 0; e < kEk; ++e) {
        float a = dva[e], bk = dka[e];
#pragma unroll
        for (int i = 0; i < kQT; ++i) {
          a = fmaf(pv[i], dov_s[i][P * e + h], a);
          bk = fmaf(ds[i], qv_s[i][P * e + h], bk);
        }
        dva[e] = a;
        dka[e] = bk;
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int e = 0; e < kEk; ++e) {
    dk[krow + P * e + h] = dka[e];
    dv[krow + P * e + h] = dva[e];
  }
}

bool bad_shape(int BH, int H, int Kh, int Sq, int Sk, int sk_true) {
  return BH < 1 || BH > 65535 || H < 1 || Kh < 1 || H % Kh != 0 ||
         BH % H != 0 || Sq < 1 || Sk < 1 || sk_true < 1 || sk_true > Sk;
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int H, int Kh, int Sq, int Sk,
                      int sk_true, int causal, float scale,
                      cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_bwd_dq_kernel<D><<<grid, kBQ * (D / kEq), 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Kh, Sq, Sk, sk_true, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int H, int Kh, int Sq,
                       int Sk, int sk_true, int causal, float scale,
                       cudaStream_t stream) {
  const dim3 grid((Sk + kBK - 1) / kBK, BH / H * Kh);
  flash_bwd_dkv_kernel<D><<<grid, kBK * (D / kEk), 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Kh, Sq, Sk, sk_true,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q and dout (BH, Sq, D), k and v (BH / H * Kh, Sk, D), lse and delta
// (BH, Sq), dq (BH, Sq, D); all f32, contiguous on the current device. D is
// 64 or 128 (the wrapper zero-pads smaller head dims; the scale is passed
// in). bf16 takes the tensor-core flash_attention_bwd_dq_sm90.cu. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int BH, int H, int Kh,
    int Sq, int Sk, int sk_true, int D, int causal, float scale,
    void* stream) {
  if (bad_shape(BH, H, Kh, Sq, Sk, sk_true))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(DD)                                                            \
  launch_dq<DD>(q, k, v, dout, lse, delta, dq, BH, H, Kh, Sq, Sk,         \
                sk_true, causal, scale, s)
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64) err = DQ(64);
  if (D == 128) err = DQ(128);
#undef DQ
  return static_cast<int>(err);
}

// As above; dk and dv (BH / H * Kh, Sk, D) f32, each KV head's gradient
// summed over the rep query heads that read it (bf16 takes
// flash_attention_bwd_dkv_sm90.cu).
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int BH, int H,
    int Kh, int Sq, int Sk, int sk_true, int D, int causal, float scale,
    void* stream) {
  if (bad_shape(BH, H, Kh, Sq, Sk, sk_true) || BH / H * Kh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(DD)                                                           \
  launch_dkv<DD>(q, k, v, dout, lse, delta, dk, dv, BH, H, Kh, Sq, Sk,    \
                 sk_true, causal, scale, s)
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64) err = DKV(64);
  if (D == 128) err = DKV(128);
#undef DKV
  return static_cast<int>(err);
}
