"""Wrapper of the CUDA kernel ``csrc/wbs_miru_scan.cu`` — the fused
WBS×MiRU recurrence, replacing ``repro/kernels/wbs_miru_scan.py ::
wbs_miru_scan_pallas``.

The wrapper takes CUDA tensors only, with B a multiple of :data:`BM`;
``kernels/ops.py`` pads and dispatches, and its plain version is
``kernels/ref.py :: wbs_miru_scan_ref``. Any H the block's shared memory
holds is taken (H ≤ 4842 on an H100): U sits in shared memory where it
fits and is read from global memory otherwise. :data:`launches` counts
the launches of the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import MAX_BITS, adc_args, check_cuda

BM = 8                  # batch rows per block

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = _build.load("wbs_miru_scan").wbs_miru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 4 + [_F] * 5 + [_I, _F, _F, _F, _P]
        fn.restype = ctypes.c_int
    return fn


def wbs_miru_scan(drive: torch.Tensor, u_scaled: torch.Tensor,
                  h0: torch.Tensor, b_h: torch.Tensor, gains: torch.Tensor,
                  *, beta: float, lam: float, adc_bits: Optional[int] = None,
                  adc_range: float = 4.0, w_scale: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """drive (B, T, H), u_scaled (H, H) weights already divided by the
    logical scale, h0 (B, H), b_h (H,), gains (T, n_bits), all f32 →
    (h_all, h_prev, pre), each (B, T, H) f32."""
    dev = check_cuda(drive=drive, u_scaled=u_scaled, h0=h0, b_h=b_h,
                     gains=gains)
    for k, t in (("drive", drive), ("u_scaled", u_scaled), ("h0", h0),
                 ("b_h", b_h), ("gains", gains)):
        if t.dtype != torch.float32:
            raise TypeError(f"{k} must be float32, got {t.dtype}")
    B, T, H = drive.shape
    n_bits = gains.shape[-1]
    if u_scaled.shape != (H, H) or h0.shape != (B, H) or b_h.shape != (H,) \
            or gains.shape != (T, n_bits):
        raise ValueError(f"shape mismatch: drive {tuple(drive.shape)}, u "
                         f"{tuple(u_scaled.shape)}, h0 {tuple(h0.shape)}, "
                         f"b_h {tuple(b_h.shape)}, gains {tuple(gains.shape)}")
    if B % BM:
        raise ValueError(f"B={B} must be a multiple of {BM} "
                         "(kernels/ops.py pads)")
    if not 1 <= n_bits <= MAX_BITS:
        raise ValueError(f"n_bits={n_bits} outside 1..{MAX_BITS}")
    outs = [torch.empty((B, T, H), dtype=torch.float32, device=dev)
            for _ in range(3)]
    use_adc, step, lo, hi = adc_args(adc_bits, adc_range)
    norm = 2.0 ** n_bits / (2.0 ** n_bits - 1.0)
    err = _fn()(
        drive.data_ptr(), u_scaled.data_ptr(), h0.data_ptr(), b_h.data_ptr(),
        gains.data_ptr(), *(o.data_ptr() for o in outs), B, T, H, n_bits,
        beta, lam, 1.0 - lam, norm, w_scale, use_adc, step, lo, hi,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"wbs_miru_scan launch failed: cudaError {err} "
                           f"(B={B}, T={T}, H={H})")
    global launches
    launches += 1
    return outs[0], outs[1], outs[2]
