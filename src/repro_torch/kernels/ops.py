"""Padded, dispatched wrappers around the kernels — counterpart of
``repro/kernels/ops.py`` (the WBS product with and without read noise,
the WBS recurrence, the ideal MiRU scan, the flash-attention forward and
backward, and the k-WTA bisection) plus the row-exact readout.

Dispatch is by device and nothing else: a CUDA tensor goes to the CUDA
kernel (padded here where it needs padded shapes), a CPU tensor to the plain
version in :mod:`repro_torch.kernels.ref`. There is no fallback from one
to the other. The scan kernels compute forward values only: the
straight-through backward of the WBS scan (``_wbs_miru_scan_bwd`` in the
reference) waits for the MiRU's BPTT slice, and the reference cannot
differentiate its fused float scan either, so an input that requires
grad raises. The readout backpropagates as the linear product it is.
The flash forward is differentiable: on inputs that require grad it runs
inside a ``torch.autograd.Function`` whose backward is the dq and dk/dv
kernels (:func:`flash_attention_bwd`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.analog.wbs import ideal_gains, quantize_signed
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import kwta as _kwta_kernel
from repro_torch.kernels import miru_readout as _readout_kernel
from repro_torch.kernels import miru_scan as _miru_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import wbs_matmul as _matmul_kernel
from repro_torch.kernels import wbs_miru_scan as _scan_kernel
from repro_torch.utils import round_up


def _forward_only(*tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the scan kernels compute forward values only; the straight-"
            "through backward waits for the MiRU's BPTT slice (ROADMAP "
            "queue A, slice 6) — call under torch.no_grad()")


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the leading axis to ``rows`` (no copy when it fits)."""
    extra = rows - x.shape[0]
    if extra == 0:
        return x.contiguous()
    return F.pad(x, (0, 0) * (x.ndim - 1) + (0, extra))


def read_key_words(read_key: np.ndarray) -> tuple[int, int]:
    """The read-noise kernel's Philox key: two 32-bit words drawn from a
    :mod:`repro_torch.prng` key."""
    k0, k1 = prng.bits(read_key, (2,))
    return int(k0), int(k1)


def wbs_matmul(sign: torch.Tensor, code: torch.Tensor, w: torch.Tensor,
               gains: torch.Tensor, adc_bits: Optional[int] = None,
               adc_range: float = 4.0, read_sigma: float = 0.0,
               read_key: Optional[np.ndarray] = None) -> torch.Tensor:
    """WBS crossbar product, (M, K) × (K, N) → (M, N) f32.

    ``read_sigma``/``read_key`` model per-access conductance read noise:
    every weight is read as w·(1 + σ·z), with one normal z per weight
    element per call, shared by all rows, drawn from ``read_key`` inside
    the kernel (:func:`read_key_words`; ``ref.read_noise``). The draw
    depends on the key alone, so the CPU and the card read the same
    noise. On the card one kernel launch computes the call: the kernels
    take any M and N, so nothing is padded or sliced."""
    _forward_only(w)
    if read_sigma > 0:
        if read_key is None:
            raise ValueError("read_sigma > 0 requires read_key")
        words = read_key_words(read_key)
        if not sign.is_cuda:
            return ref.wbs_matmul_read_noise_ref(
                sign, code, w, gains, read_sigma, words, adc_bits, adc_range)
    elif not sign.is_cuda:
        return ref.wbs_matmul_ref(sign, code, w, gains, adc_bits, adc_range)
    args = (sign.contiguous(), code.contiguous(),
            w.to(torch.float32).contiguous(),
            gains.to(torch.float32).contiguous())
    if read_sigma > 0:
        return _matmul_kernel.wbs_matmul_read_noise(
            *args, read_sigma, words, adc_bits=adc_bits, adc_range=adc_range)
    return _matmul_kernel.wbs_matmul(*args, adc_bits, adc_range)


def wbs_dense(x: torch.Tensor, w: torch.Tensor, n_bits: int = 8,
              adc_bits: Optional[int] = 8, adc_range: float = 4.0,
              gains: Optional[torch.Tensor] = None,
              read_sigma: float = 0.0,
              read_key: Optional[np.ndarray] = None) -> torch.Tensor:
    """WBS linear layer: float activations → sign-magnitude codes →
    bit-plane crossbar product. x (..., K) @ w (K, N); ``gains``
    (n_bits,) plane gains, None for the ideal ratios; ``read_sigma`` /
    ``read_key`` as in :func:`wbs_matmul`."""
    lead = x.shape[:-1]
    if gains is None:
        gains = ideal_gains(n_bits, device=x.device)
    sign, code = quantize_signed(x.reshape(-1, x.shape[-1]), n_bits)
    y = wbs_matmul(sign, code, w, gains, adc_bits, adc_range,
                   read_sigma=read_sigma, read_key=read_key)
    return y.reshape(*lead, w.shape[-1])


def wbs_input_drive(x_seq: torch.Tensor, w_h: torch.Tensor, n_bits: int,
                    weight_scale: float = 1.0,
                    gains: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hoisted WBS input projection: x@W_h has no sequential
    dependency, so with the ideal plane gains the whole (B, T, K)
    sequence goes through the crossbar as ONE (B·T, K) product instead of
    T per-step calls. ``gains`` (T, n_bits) are per-step plane gains
    (``gain_sigma > 0`` draws a fresh vector every step): then each step
    is its own (B, K) product with its own gains. Either way every row
    has the bits of the per-step ``wbs_matmul``. Returns the drive
    (B, T, H) f32: no bias, no ADC (both are applied inside the scan)."""
    B, T, K = x_seq.shape
    w = (w_h / weight_scale).to(torch.float32)
    if gains is None:
        y = wbs_dense(x_seq.reshape(B * T, K), w, n_bits, adc_bits=None)
        return (y * weight_scale).reshape(B, T, w.shape[-1])
    y = torch.stack([wbs_dense(x_seq[:, t], w, n_bits, adc_bits=None,
                               gains=gains[t]) for t in range(T)], 1)
    return y * weight_scale


def wbs_miru_scan(drive: torch.Tensor, u_h: torch.Tensor,
                  b_h: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                  beta: float, lam: float, n_bits: int,
                  adc_bits: Optional[int] = None, adc_range: float = 4.0,
                  weight_scale: float = 1.0,
                  gains: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused device-true MiRU recurrence over a precomputed drive.

    drive (B, T, H) from :func:`wbs_input_drive`; u_h (H, H) *raw*
    logical recurrent weights (divided by ``weight_scale`` once, here);
    b_h (H,); h0 (B, H) or None for zeros; gains (T, n_bits) or None for
    ideal ratios. Unlike the reference there is no H limit that silently
    switches to the plain version: the kernel takes every H its shared
    memory holds and raises beyond. Returns (h_all, h_prev, pre), each
    (B, T, H) f32.
    """
    _forward_only(drive, u_h, b_h, h0)
    B, T, H = drive.shape
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=torch.float32, device=drive.device)
    u_scaled = (u_h / weight_scale).to(torch.float32)
    kw = dict(beta=beta, lam=lam, adc_bits=adc_bits, adc_range=adc_range,
              w_scale=weight_scale)
    if not drive.is_cuda:
        return ref.wbs_miru_scan_ref(drive, u_scaled, h0, b_h, n_bits=n_bits,
                                     gains=gains, **kw)
    if gains is None:
        gains = ideal_gains(n_bits, device=drive.device).expand(T, n_bits)
    Bp = round_up(B, _scan_kernel.BM)
    h_all, h_prev, pre = _scan_kernel.wbs_miru_scan(
        _pad_rows(drive.to(torch.float32), Bp), u_scaled.contiguous(),
        _pad_rows(h0.to(torch.float32), Bp),
        b_h.reshape(H).to(torch.float32).contiguous(),
        gains.to(torch.float32).contiguous(), **kw)
    return h_all[:B], h_prev[:B], pre[:B]


def miru_scan(xw: torch.Tensor, u_h: torch.Tensor, h0: torch.Tensor,
              beta: float, lam: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ideal MiRU recurrence — counterpart of ``ops.miru_scan`` in
    the reference. xw (B, T, H) = x@W_h + b_h, u_h (H, H), h0 (B, H) →
    (h_all, pre), each (B, T, H) f32. No H limit silently switches to the
    plain version: the kernel takes every H its shared memory holds and
    raises beyond."""
    _forward_only(xw, u_h, h0)
    if not xw.is_cuda:
        return ref.miru_scan_ref(xw, u_h, h0, beta, lam)
    return _miru_kernel.miru_scan(
        xw.to(torch.float32).contiguous(), u_h.to(torch.float32).contiguous(),
        h0.to(torch.float32).contiguous(), beta=beta, lam=lam)


class _Readout(torch.autograd.Function):
    """The readout kernel, differentiable as the linear map it computes
    (the backward is plain PyTorch: the reference has no kernel there)."""

    @staticmethod
    def forward(ctx, h, w_o, b_o):
        ctx.save_for_backward(h, w_o)
        return _readout_kernel.miru_readout(h, w_o, b_o)

    @staticmethod
    def backward(ctx, g):
        h, w_o = ctx.saved_tensors
        return g @ w_o.T, h.T @ g, g.sum(0)


def miru_readout(h: torch.Tensor, w_o: torch.Tensor, b_o: torch.Tensor
                 ) -> torch.Tensor:
    """logits = (h @ w_o) + b_o, row-exact: each row's bits depend on
    that row alone, whatever the number of rows, on the card as on the
    CPU. h (..., K), w_o (K, N), b_o (N,) → (..., N) f32."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if not h.is_cuda:
        y = ref.miru_readout_ref(h2, w_o, b_o)
    else:
        y = _Readout.apply(h2.to(torch.float32).contiguous(),
                           w_o.to(torch.float32).contiguous(),
                           b_o.to(torch.float32).contiguous())
    return y.reshape(*lead, w_o.shape[-1])


# ---------------------------------------------------------------------------
# Flash attention (forward and backward)
# ---------------------------------------------------------------------------

def _head_dim(dh: int, dv: int) -> int:
    """The kernels' head dim that ``dh`` and ``dv`` are zero-padded to."""
    D = next((d for d in _flash_kernel.HEAD_DIMS if d >= max(dh, dv)), None)
    if D is None:
        raise ValueError(f"head dims {dh}/{dv} exceed the kernel's "
                         f"{_flash_kernel.HEAD_DIMS[-1]}")
    return D


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d) → (B·H, S, d), the Pallas kernels' layout."""
    B, S, H, d = t.shape
    return t.transpose(1, 2).reshape(B * H, S, d)


def _heads_back(t: torch.Tensor, B: int) -> torch.Tensor:
    """(B·H, S, d) → (B, S, H, d)."""
    return t.reshape(B, -1, *t.shape[1:]).transpose(1, 2)


def _flash_fwd_kernel(dtype: torch.dtype):
    """The forward kernel for a dtype, a fixed rule: bf16 takes the
    tensor-core kernel (``flash_attention_fwd_sm90``), anything else the
    fp32 kernel (which raises on a dtype other than fp32). The sm90 kernel
    raises on what it cannot take; no call moves to the other kernel."""
    return (_flash_kernel.flash_attention_fwd_sm90
            if dtype == torch.bfloat16 else _flash_kernel.flash_attention_fwd)


def _flash_dq_kernel(dtype: torch.dtype):
    """The dq kernel for a dtype, by the rule of :func:`_flash_fwd_kernel`:
    bf16 the tensor-core ``flash_attention_bwd_dq_sm90``, anything else the
    fp32 tensor-core ``flash_attention_bwd_dq`` (its operands split into
    bf16 terms; it raises on a dtype other than fp32)."""
    return (_flash_kernel.flash_attention_bwd_dq_sm90
            if dtype == torch.bfloat16
            else _flash_kernel.flash_attention_bwd_dq)


def _flash_dkv_kernel(dtype: torch.dtype):
    """The dk/dv kernel for a dtype, by the rule of
    :func:`_flash_fwd_kernel`."""
    return (_flash_kernel.flash_attention_bwd_dkv_sm90
            if dtype == torch.bfloat16
            else _flash_kernel.flash_attention_bwd_dkv)


def _flash_fwd(q, k, v, causal: bool, sk_true: int):
    B, Sq, H, dh = q.shape
    Kh, dv = k.shape[2], v.shape[-1]
    qt, kt, vt = _heads_first(q), _heads_first(k), _heads_first(v)
    if not q.is_cuda:
        out, lse = ref.flash_attention_fwd_ref(qt, kt, vt, causal, sk_true,
                                               H, Kh)
    else:
        D = _head_dim(dh, dv)
        out, lse = _flash_fwd_kernel(q.dtype)(
            F.pad(qt, (0, D - dh)).contiguous(),
            F.pad(kt, (0, D - dh)).contiguous(),
            F.pad(vt, (0, D - dv)).contiguous(), causal=causal,
            sk_true=sk_true, q_heads=H, kv_heads=Kh,
            scale=float(dh) ** -0.5)
        out = out[..., :dv]
    return _heads_back(out, B), lse.reshape(B, H, Sq)


class _FlashAttention(torch.autograd.Function):
    """The flash forward with the flash backward as its gradient. Saves
    (q, k, v, out, lse), the residuals of the reference's ``_flash``
    custom VJP; lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sk_true):
        out, lse = _flash_fwd(q, k, v, causal, sk_true)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sk_true = causal, sk_true
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.sk_true)
        return dq, dk, dv, None, None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, sk_true: Optional[int] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, Sq, H, dh) layout wrapper around the flash-attention forward.

    Masks the keys at or past ``sk_true`` (default: the given Sk). The
    reference pads Sq and Sk to its Pallas blocks (``bq``, ``bk``); the
    kernel here tiles by itself and takes any Sq and Sk, and so does the
    plain version, so nothing is padded. GQA KV heads are not repeated:
    q (B, Sq, H, dh) against k/v (B, Sk, Kh, ·) goes to the kernel as
    (B·H, Sq, ·) and (B·Kh, Sk, ·), the kernel mapping each query head to
    its KV head. On the card the head dim is zero-padded to the kernel's
    64 or 128 (exact: zero terms add nothing to q·k, and padded value
    columns are sliced away; the scale stays dh^-0.5). On inputs that
    require grad the call is differentiable in q, k and v, through
    :func:`flash_attention_bwd`. On the card bf16 inputs take the
    tensor-core kernel and fp32 inputs the fp32 one, a fixed rule by dtype
    (:func:`_flash_fwd_kernel`). Returns (out (B, Sq, H, dv), lse
    (B, H, Sq))."""
    sk_true = k.shape[1] if sk_true is None else sk_true
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, sk_true)
    return _flash_fwd(q, k, v, causal, sk_true)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        sk_true: Optional[int] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, Sq, H, dh) layout wrapper around the flash-attention backward:
    q, out, dout (B, Sq, H, ·), k/v (B, Sk, Kh, ·), lse (B, H, Sq) from
    :func:`flash_attention_fwd` → (dq, dk, dv) in q's, k's and v's
    layouts and dtypes. dk/dv are each KV head's gradient summed over the
    query heads that read it (the GQA fold, in the kernel). On the card
    delta = Σ dout·out is a torch reduction (the reference computes it
    outside its kernels too), the head dims are zero-padded to 64 or 128
    as in the forward and the gradients sliced back; the dq kernel and
    the dk/dv kernel launch once each, both by dtype as the forward (bf16
    the tensor-core dq and dk/dv with its fold, fp32 the fp32 tensor-core
    dq and dk/dv, each with its split of the inputs into bf16 terms and
    dk/dv with its fold)."""
    B, Sq, H, dh = q.shape
    Sk, Kh, dv = k.shape[1], k.shape[2], v.shape[-1]
    sk_true = Sk if sk_true is None else sk_true
    qt, kt, vt = _heads_first(q), _heads_first(k), _heads_first(v)
    ot, dot = _heads_first(out), _heads_first(dout)
    lse = lse.reshape(B * H, Sq)
    if not q.is_cuda:
        dq, dk, dvv = ref.flash_attention_bwd_ref(
            qt, kt, vt, ot, lse, dot, causal, sk_true, H, Kh)
    else:
        delta = torch.sum(dot.to(torch.float32) * ot.to(torch.float32), -1)
        D = _head_dim(dh, dv)
        pad = lambda t, d: F.pad(t, (0, D - d)).contiguous()
        kw = dict(causal=causal, sk_true=sk_true, q_heads=H, kv_heads=Kh,
                  scale=float(dh) ** -0.5)
        args = (pad(qt, dh), pad(kt, dh), pad(vt, dv), pad(dot, dv),
                lse.contiguous(), delta)
        dq = _flash_dq_kernel(q.dtype)(*args, **kw)[..., :dh]
        dk, dvv = _flash_dkv_kernel(q.dtype)(*args, **kw)
        dk, dvv = dk[..., :dh], dvv[..., :dv]
    return _heads_back(dq, B), _heads_back(dk, B), _heads_back(dvv, B)


# ---------------------------------------------------------------------------
# k-WTA
# ---------------------------------------------------------------------------

KWTA_ROW_LIMIT = 1 << 20   # longer rows take the exact top-k, as in the reference


def kwta(x: torch.Tensor, k: int, iters: int = 32) -> torch.Tensor:
    """Per-row approximate k-WTA by magnitude (threshold bisection). 1-D
    input is one row; ``k >= N`` returns ``x``; rows longer than
    :data:`KWTA_ROW_LIMIT` take the exact top-k (``ref.kwta_ref``) on any
    device, as the reference's ``ops.kwta`` does."""
    squeeze = x.ndim == 1
    x2 = x[None, :] if squeeze else x
    N = x2.shape[1]
    if k >= N:
        return x
    if N > KWTA_ROW_LIMIT:
        out = ref.kwta_ref(x2, k)
    elif not x2.is_cuda:
        out = ref.kwta_bisect_ref(x2, k, iters)
    else:
        out = _kwta_kernel.kwta(x2.contiguous(), k, iters)
    return out[0] if squeeze else out
