"""Wrappers of the CUDA kernels of ``csrc/wbs_matmul.cu`` — the WBS
crossbar product, replacing ``repro/kernels/wbs_matmul.py ::
wbs_matmul_pallas``: :func:`wbs_matmul` at ``read_sigma == 0``,
:func:`wbs_matmul_read_noise` with the in-kernel read noise of
``read_sigma > 0``.

The wrappers take CUDA tensors only, of any M, K and N (the kernels mask
the ragged edges); ``kernels/ops.py`` dispatches, and the plain versions
are ``kernels/ref.py :: wbs_matmul_ref`` and ``wbs_matmul_read_noise_ref``. :data:`launches` and
:data:`read_noise_launches` count the launches of each kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_BITS = 8            # codes are uint8

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0
#: Launches of the read-noise kernel, likewise.
read_noise_launches = 0

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint


def _fn():
    fn = _build.load("wbs_matmul").wbs_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _F,
                       _F, _P]
        fn.restype = ctypes.c_int
    return fn


def _read_noise_fn():
    fn = _build.load("wbs_matmul").wbs_matmul_read_noise_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F,
                       _F, _F, _F, _U, _U, _P]
        fn.restype = ctypes.c_int
    return fn


def adc_args(adc_bits: Optional[int], adc_range: float
             ) -> tuple[int, float, float, float]:
    """(use_adc, step, lo, hi) of the mid-rise ADC, as the kernels take
    them."""
    if adc_bits is None:
        return 0, 1.0, 0.0, 0.0
    levels = 2 ** adc_bits
    return 1, 2.0 * adc_range / levels, -(levels // 2), levels // 2 - 1


def check_cuda(**tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device and contiguous, else raise."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            "CUDA kernel needs all tensors on one CUDA device, got "
            + ", ".join(f"{k}: {t.device}" for k, t in tensors.items())
            + " (kernels/ops.py dispatches CPU tensors to the plain "
            "version)")
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
    return next(iter(devices))


def _check(sign, code, w, gains) -> tuple[torch.device, int, int, int, int]:
    """Device, dtypes and shapes of the kernels' operands; returns
    (device, M, K, N, n_bits)."""
    dev = check_cuda(sign=sign, code=code, w=w, gains=gains)
    for k, t, dt in (("sign", sign, torch.int8), ("code", code, torch.uint8),
                     ("w", w, torch.float32), ("gains", gains, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{k} must be {dt}, got {t.dtype}")
    M, K = sign.shape
    if code.shape != (M, K) or w.ndim != 2 or w.shape[0] != K \
            or gains.ndim != 1:
        raise ValueError(f"shape mismatch: sign {tuple(sign.shape)}, code "
                         f"{tuple(code.shape)}, w {tuple(w.shape)}, gains "
                         f"{tuple(gains.shape)}")
    N, n_bits = w.shape[1], gains.shape[0]
    if min(M, K, N) < 1:
        raise ValueError(f"empty product: M={M}, K={K}, N={N}")
    if not 1 <= n_bits <= MAX_BITS:
        raise ValueError(f"n_bits={n_bits} outside 1..{MAX_BITS}")
    return dev, M, K, N, n_bits


def wbs_matmul(sign: torch.Tensor, code: torch.Tensor, w: torch.Tensor,
               gains: torch.Tensor, adc_bits: Optional[int] = None,
               adc_range: float = 4.0) -> torch.Tensor:
    """sign (M, K) int8, code (M, K) uint8, w (K, N) f32, gains (n_bits,)
    f32 → (M, N) f32 on the same device."""
    dev, M, K, N, n_bits = _check(sign, code, w, gains)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    use_adc, step, lo, hi = adc_args(adc_bits, adc_range)
    norm = 2.0 ** n_bits / (2.0 ** n_bits - 1.0)
    err = _fn()(sign.data_ptr(), code.data_ptr(), w.data_ptr(),
                gains.data_ptr(), out.data_ptr(), M, K, N, n_bits, norm,
                use_adc, step, lo, hi,
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"wbs_matmul launch failed: cudaError {err}")
    global launches
    launches += 1
    return out


def wbs_matmul_read_noise(sign: torch.Tensor, code: torch.Tensor,
                          w: torch.Tensor, gains: torch.Tensor,
                          read_sigma: float, key_words: tuple[int, int],
                          adc_bits: Optional[int] = None,
                          adc_range: float = 4.0) -> torch.Tensor:
    """:func:`wbs_matmul` with each weight read as w·(1 + σ·z), z the
    Philox4x32-10 normal of (``key_words``, k, n) — one draw per weight
    element per call, shared by all rows (the counter is k·N + n).
    ``read_sigma`` is rounded to float32. One C call: a draw pass writes
    the perturbed weights into a (K, N) scratch, then the product of
    :func:`wbs_matmul` contracts it."""
    dev, M, K, N, n_bits = _check(sign, code, w, gains)
    if K * N >= 2 ** 32:
        raise ValueError(f"K·N = {K * N} normals: the counter has 32 bits")
    k0, k1 = (int(k) & 0xFFFFFFFF for k in key_words)
    w_noisy = torch.empty((K, N), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    use_adc, step, lo, hi = adc_args(adc_bits, adc_range)
    norm = 2.0 ** n_bits / (2.0 ** n_bits - 1.0)
    err = _read_noise_fn()(
        sign.data_ptr(), code.data_ptr(), w.data_ptr(), gains.data_ptr(),
        w_noisy.data_ptr(), out.data_ptr(), M, K, N, n_bits, norm, use_adc,
        step, lo, hi, read_sigma, k0, k1,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"wbs_matmul_read_noise launch failed: "
                           f"cudaError {err}")
    global read_noise_launches
    read_noise_launches += 1
    return out
