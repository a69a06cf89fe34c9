"""Plain PyTorch versions of the kernels — the correctness contract.

Counterparts of ``repro/kernels/ref.py``'s ``wbs_matmul_ref`` and
``wbs_miru_scan_ref`` (and of the Pallas ``miru_scan`` and the readout
``h @ w_o + b_o``), with the same inputs, outputs, integer/bit
semantics and fp order of the epilogue, ``(drive + y) + b_h`` and
``acc·norm·w_scale``. Two choices go further than the reference, so that
the plain versions of these four repeat the CUDA kernels bit for bit on
any device:

* The contraction is written out in the kernels' order — K tiles of
  :data:`BK`, inside a tile plane by plane (MSB first), k ascending, fp32
  — where the reference leaves it to an einsum. Summation order is the
  only freedom in these products, and a library matmul picks its own:
  at the serve path's shapes (B = 64, T = 14) that made one or more
  batch rows flip an ADC code on a rounding tie in 15 % (H = 100) and
  35 % (H = 256) of simulated calls.
* tanh is taken in float64 and rounded once to float32 (the correctly
  rounded float tanh), as the scan kernel does: PyTorch's CPU tanh and
  CUDA's ``tanhf`` differ in the last bit on some inputs.

The read-noise variant draws its noise with a counter-based generator,
Philox4x32-10 (:func:`philox4x32_10`), which the reference does not use
(it reseeds the TPU's PRNG per grid cell, or draws threefry normals on
the CPU): against JAX the read noise agrees in distribution only.

Against the JAX reference these functions agree at fp32 tolerance, with
ADC rounding ties handled by :mod:`repro_torch.testing`.

The flash-attention forward's and backward's plain versions
(:func:`flash_attention_fwd_ref`, :func:`flash_attention_bwd_ref`) repeat
the Pallas kernels' semantics, not their order: one tile over all keys,
the products left to ``torch.matmul``; the kernels agree with them at fp32
tolerance. They compute in fp32 (float64 inputs in float64, for
``gradcheck``). The k-WTA bisection (:func:`kwta_bisect_ref`) is all
integer counts and exactly rounded midpoints, so it is bitwise equal to
the kernel and to the reference's; :func:`kwta_ref` is the exact top-k
that the reference falls back to for rows longer than 1 << 20.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.analog.adc import adc_quantize
from repro_torch.analog.wbs import quantize_signed

BK = 128                 # K tile depth of the kernels (wbs_common.cuh)


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 tanh: evaluated in float64, rounded
    once. The scan kernel computes the same value."""
    return torch.tanh(x.double()).float()


def plane_product(sign: torch.Tensor, code: torch.Tensor, w: torch.Tensor,
                  gains: torch.Tensor) -> torch.Tensor:
    """acc (M, N) = Σ_tiles Σ_b gains[b]·Σ_{k∈tile} plane_b[m,k]·sign[m,k]
    ·w[k,n], in the order of ``wbs_common.cuh :: plane_dots`` then
    ``join_planes``. The plane products are exact, so only the two running
    sums round."""
    n_bits = gains.shape[0]
    M, K = sign.shape
    shifts = torch.arange(n_bits - 1, -1, -1, device=code.device)
    planes = ((code.to(torch.int32)[None] >> shifts[:, None, None]) & 1
              ).to(torch.float32) * sign.to(torch.float32)[None]  # (nb, M, K)
    w = w.to(torch.float32)
    g = gains.to(torch.float32)
    acc = torch.zeros((M, w.shape[1]), dtype=torch.float32, device=w.device)
    for k0 in range(0, K, BK):
        dots = torch.zeros((n_bits,) + acc.shape, dtype=torch.float32,
                           device=w.device)
        for k in range(k0, min(k0 + BK, K)):
            dots = dots + planes[:, :, k, None] * w[k]
        for b in range(n_bits):
            acc = acc + g[b] * dots[b]
    return acc


def wbs_matmul_ref(sign: torch.Tensor, code: torch.Tensor, w: torch.Tensor,
                   gains: torch.Tensor, adc_bits: Optional[int] = None,
                   adc_range: float = 4.0) -> torch.Tensor:
    """Weighted-bit-streaming VMM: sign (M, K) int8 ∈ {-1, 0, +1}, code
    (M, K) uint8, w (K, N), gains (n_bits,) MSB first. y = Σ_b gains[b]·
    (plane_b ⊙ sign) @ w, rescaled by 2^nb/(2^nb − 1), then the optional
    ADC."""
    n_bits = gains.shape[0]
    y = plane_product(sign, code, w, gains)
    y = y * (2.0 ** n_bits / (2.0 ** n_bits - 1.0))
    if adc_bits is not None:
        y = adc_quantize(y, adc_bits, adc_range)
    return y


# Philox4x32-10 (Salmon et al., SC'11; Random123's constants).
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a·b for a 32-bit constant ``a`` and int64
    ``b`` in [0, 2^32), in int64 arithmetic: b splits in 16-bit halves so
    no partial product reaches 2^63."""
    p_lo = a * (b & 0xFFFF)                 # < 2^48
    mid = a * (b >> 16) + (p_lo >> 16)      # a·b = mid·2^16 + (p_lo & 0xFFFF)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(counter: tuple[torch.Tensor, ...], key: tuple[int, int]
                  ) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 over four int64 tensors of 32-bit counter words,
    keyed by two 32-bit ints: the four output words, as int64 tensors.
    The kernel's ``philox4x32_10`` computes the same words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _U32, key[1] & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def read_noise(key_words: tuple[int, int], shape: tuple[int, int],
               device=None) -> torch.Tensor:
    """The read-noise normals z (K, N) f32 of the kernel: element (k, n)
    is Box–Muller over the first two Philox words of counter
    (k·N + n, 0, 0, 0) — u = (bits >> 8)·2^-24 clamped below at 2^-24,
    z = √(−2 ln u1)·cos(2π u2), in float64, rounded once."""
    K, N = shape
    idx = torch.arange(K * N, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    b1, b2, _, _ = philox4x32_10((idx, zero, zero, zero), key_words)
    u1 = torch.clamp((b1 >> 8).double() * 2.0 ** -24, min=2.0 ** -24)
    u2 = torch.clamp((b2 >> 8).double() * 2.0 ** -24, min=2.0 ** -24)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.float().reshape(K, N)


def wbs_matmul_read_noise_ref(sign: torch.Tensor, code: torch.Tensor,
                              w: torch.Tensor, gains: torch.Tensor,
                              read_sigma: float, key_words: tuple[int, int],
                              adc_bits: Optional[int] = None,
                              adc_range: float = 4.0) -> torch.Tensor:
    """:func:`wbs_matmul_ref` over the read-noise weights w·(1 + σ·z),
    z = :func:`read_noise` of the weight's shape, rounded as the kernel
    rounds: σ·z, then 1 + that, then w times that (σ in float32)."""
    z = read_noise(key_words, tuple(w.shape), w.device)
    sigma = float(torch.tensor(read_sigma, dtype=torch.float32))
    w_noisy = w.to(torch.float32) * (1.0 + sigma * z)
    return wbs_matmul_ref(sign, code, w_noisy, gains, adc_bits, adc_range)


def wbs_miru_scan_ref(drive: torch.Tensor, u_h: torch.Tensor,
                      h0: torch.Tensor, b_h: torch.Tensor, beta: float,
                      lam: float, n_bits: int, adc_bits: Optional[int] = None,
                      adc_range: float = 4.0, w_scale: float = 1.0,
                      gains: Optional[torch.Tensor] = None,
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device-true fused MiRU recurrence.

    drive (B, T, H) = the hoisted WBS input projection (no bias); u_h
    (H, H) recurrent weights *already divided* by the logical weight
    scale; ``w_scale`` re-applies it after the normalized read. b_h (1, H)
    or (H,). ``gains`` is (T, n_bits) per-step plane gains, or None for
    the ideal ratios 2^-1..2^-nb.

    Returns (h_all, h_prev, pre), each (B, T, H) f32.
    """
    B, T, H = drive.shape
    norm = 2.0 ** n_bits / (2.0 ** n_bits - 1.0)
    if gains is None:
        k = torch.arange(1, n_bits + 1, dtype=torch.float32,
                         device=drive.device)
        gains = torch.pow(2.0, -k).expand(T, n_bits)
    b = b_h.reshape(H).to(torch.float32)
    h = h0.to(torch.float32)
    h_all, h_prev, pre_all = [], [], []
    for t in range(T):
        sign, code = quantize_signed(beta * h, n_bits)
        y = plane_product(sign, code, u_h, gains[t])
        y = y * norm * w_scale
        pre = (drive[:, t].to(torch.float32) + y) + b
        if adc_bits is not None:
            pre = adc_quantize(pre, adc_bits, adc_range)
        h_new = lam * h + (1.0 - lam) * tanh_f32(pre)
        h_all.append(h_new)
        h_prev.append(h)
        pre_all.append(pre)
        h = h_new
    return (torch.stack(h_all, 1), torch.stack(h_prev, 1),
            torch.stack(pre_all, 1))


def miru_scan_ref(xw: torch.Tensor, u_h: torch.Tensor, h0: torch.Tensor,
                  beta: float, lam: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ideal float MiRU recurrence over a precomputed drive, in the order
    of ``csrc/miru_scan.cu``: pre_t = xw_t + Σ_k (β·h)_k·U[k] with k
    ascending, each product and sum rounded to fp32, and h_t = λ·h +
    (1−λ)·tanh(pre_t) with the float64 tanh. xw (B, T, H), u_h (H, H),
    h0 (B, H) → (h_all, pre), each (B, T, H) f32."""
    T, H = xw.shape[1], xw.shape[2]
    u = u_h.to(torch.float32)
    h = h0.to(torch.float32)
    h_all, pre_all = [], []
    for t in range(T):
        bh = beta * h
        acc = torch.zeros_like(h)
        for k in range(H):
            acc = acc + bh[:, k, None] * u[k]
        pre = xw[:, t].to(torch.float32) + acc
        h = lam * h + (1.0 - lam) * tanh_f32(pre)
        h_all.append(h)
        pre_all.append(pre)
    return torch.stack(h_all, 1), torch.stack(pre_all, 1)


def miru_readout_ref(h: torch.Tensor, w_o: torch.Tensor, b_o: torch.Tensor
                     ) -> torch.Tensor:
    """logits = (h @ w_o) + b_o in the order of ``csrc/miru_readout.cu``:
    k ascending, each product and sum rounded to fp32, the bias last.
    Every row's bits depend on that row alone, whatever the number of
    rows. h (M, K), w_o (K, N), b_o (N,) → (M, N) f32."""
    w = w_o.to(torch.float32)
    acc = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float32,
                      device=h.device)
    for k in range(h.shape[1]):
        acc = acc + h[:, k, None].to(torch.float32) * w[k]
    return acc + b_o.to(torch.float32)


NEG_INF = -1e30          # the masked score of the flash kernels


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            sk_true: Optional[int] = None,
                            q_heads: Optional[int] = None,
                            kv_heads: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """What ``flash_attention_fwd_pallas`` computes, in its layout: q
    (B·H, Sq, dh), k/v (B·Kh, Sk, dh|dv), query head b reading KV head
    (b // H)·Kh + (b % H) // rep. s = (q·k)·scale (scale dh^-0.5 unless
    given), −1e30 where key ≥ ``sk_true`` or, causal, key > query; then
    m = max s, l = Σ exp(s − m), out = (exp(s − m) @ v) / max(l, 1e-30) in
    q's dtype and lse = m + log(max(l, 1e-30)) in f32. Returns (out
    (B·H, Sq, dv), lse (B·H, Sq))."""
    k, v = _kv_for_queries(k, v, q.shape[0], q_heads, kv_heads)
    s, _ = _scores(q, k, causal, sk_true, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    out = (torch.matmul(p, _acc(v)) / l).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The flash plain versions' compute dtype: fp32, float64 kept."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _kv_for_queries(k, v, BH, q_heads, kv_heads):
    """K/V repeated to the query heads: query head b reads KV head
    (b // H)·Kh + (b % H) // rep."""
    if q_heads is None or kv_heads is None or q_heads == kv_heads:
        return k, v
    b = torch.arange(BH, device=k.device)
    kvb = (b // q_heads) * kv_heads + (b % q_heads) // (q_heads // kv_heads)
    return k[kvb], v[kvb]


def _scores(q, k, causal, sk_true, scale):
    """(s (B·H, Sq, Sk) with −1e30 where masked, scale)."""
    Sq, dh = q.shape[1:]
    Sk = k.shape[1]
    sk_true = Sk if sk_true is None else sk_true
    scale = dh ** -0.5 if scale is None else scale
    s = torch.matmul(_acc(q), _acc(k).transpose(1, 2)) * scale
    ki = torch.arange(Sk, device=q.device)[None, :]
    valid = ki < sk_true
    if causal:
        valid = valid & (ki <= torch.arange(Sq, device=q.device)[:, None])
    return torch.where(valid, s, NEG_INF), scale


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True,
                            sk_true: Optional[int] = None,
                            q_heads: Optional[int] = None,
                            kv_heads: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """What ``flash_attention_bwd_pallas`` computes, in its layout, with
    the GQA fold: q, out, dout (B·H, Sq, ·), k/v (B·Kh, Sk, ·), lse
    (B·H, Sq). p = exp(s − lse) with the masks of the forward, delta =
    Σ dout·out, ds = p·(dout·vᵀ − delta); dq = scale·ds·k, dv = pᵀ·dout,
    dk = scale·dsᵀ·q. K/V are repeated to the query heads and their
    gradients summed over the rep query heads of each KV head (the
    kernel loops over them instead). Returns (dq, dk, dv) in q's, k's
    and v's dtypes."""
    BH = q.shape[0]
    kr, vr = _kv_for_queries(k, v, BH, q_heads, kv_heads)
    s, scale = _scores(q, kr, causal, sk_true, scale)
    p = torch.exp(s - _acc(lse)[..., None])
    do = _acc(dout)
    delta = torch.sum(do * _acc(out), -1)
    ds = p * (torch.matmul(do, _acc(vr).transpose(1, 2)) - delta[..., None])
    dq = torch.matmul(ds, _acc(kr)) * scale
    dk = torch.matmul(ds.transpose(1, 2), _acc(q)) * scale
    dv = torch.matmul(p.transpose(1, 2), do)
    rep = BH // k.shape[0]
    dk = dk.reshape(k.shape[0], rep, *dk.shape[1:]).sum(1)
    dv = dv.reshape(v.shape[0], rep, *dv.shape[1:]).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kwta_bisect_ref(x: torch.Tensor, k: int, iters: int = 32
                    ) -> torch.Tensor:
    """Per-row approximate k-WTA by magnitude, step for step as
    ``_kwta_kernel`` and ``csrc/kwta.cu``: bisect θ on count(|x| > θ)
    between 0 and max|x| + 1 for ``iters`` rounds, take the upper bound
    if it keeps at least k, and keep x where |x| > θ. x (R, N) f32 or
    bf16 → (R, N) in x's dtype."""
    x32 = x.to(torch.float32)
    mag = x32.abs()
    lo = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=x.device)
    hi = mag.amax(-1, keepdim=True) + 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        gt = (mag > mid).sum(-1, keepdim=True) > k
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    theta = torch.where((mag > hi).sum(-1, keepdim=True) >= k, hi, lo)
    return torch.where(mag > theta, x32, 0.0).to(x.dtype)


def kwta_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-row k-WTA by magnitude (rows = leading dim): keep every
    entry at least as large as the k-th largest magnitude."""
    if k >= x.shape[-1]:
        return x
    mag = x.abs()
    kth = torch.topk(mag, k, dim=-1).values[..., -1:]
    return torch.where(mag >= kth, x, torch.zeros_like(x))
