"""Padded, dispatched wrappers around the kernels — counterpart of
``repro/kernels/ops.py`` (the WBS product with and without read noise,
the WBS recurrence, the ideal MiRU scan) plus the row-exact readout.

Dispatch is by device and nothing else: a CUDA tensor goes to the CUDA
kernel (padded here to the shapes it takes), a CPU tensor to the plain
version in :mod:`repro_torch.kernels.ref`. There is no fallback from one
to the other. The scan kernels compute forward values only: the
straight-through backward of the WBS scan (``_wbs_miru_scan_bwd`` in the
reference) waits for the BPTT slice, and the reference cannot
differentiate its fused float scan either, so an input that requires
grad raises. The readout backpropagates as the linear product it is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.analog.wbs import ideal_gains, quantize_signed
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
            "through backward waits for the BPTT slice (ROADMAP queue A, "
            "slice 4) — call under torch.no_grad()")


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the leading axis to ``rows`` (no copy when it fits)."""
    extra = rows - x.shape[0]
    if extra == 0:
        return x.contiguous()
    return F.pad(x, (0, 0) * (x.ndim - 1) + (0, extra))


def pad_wbs_weights(w: torch.Tensor) -> torch.Tensor:
    """Pad a (K, N) weight tile's columns to the kernel's column tile.
    Zero columns are exact: they only produce output columns that are
    sliced away."""
    N = w.shape[1]
    return F.pad(w, (0, round_up(N, _matmul_kernel.TN) - N)).contiguous()


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
    noise."""
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
    M, N = sign.shape[0], w.shape[1]
    Mp = round_up(M, _matmul_kernel.TM)
    args = (_pad_rows(sign, Mp), _pad_rows(code, Mp),
            pad_wbs_weights(w.to(torch.float32)),
            gains.to(torch.float32).contiguous())
    if read_sigma > 0:
        y = _matmul_kernel.wbs_matmul_read_noise(
            *args, read_sigma, words, n_cols=N, adc_bits=adc_bits,
            adc_range=adc_range)
    else:
        y = _matmul_kernel.wbs_matmul(*args, adc_bits, adc_range)
    return y[:M, :N]


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
