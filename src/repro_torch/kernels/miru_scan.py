"""Wrapper of the CUDA kernel ``csrc/miru_scan.cu`` — the ideal float MiRU
recurrence, replacing ``repro/kernels/miru_scan.py :: miru_scan_pallas``.

The wrapper takes CUDA tensors only; ``kernels/ops.py`` dispatches, and
its plain version is ``kernels/ref.py :: miru_scan_ref``. Any B is taken
(the last block masks its rows) and any H the block's shared memory
holds (H ≤ 3632 on an H100): U sits in shared memory where it fits and is
read from global memory otherwise. :data:`launches` counts the launches
of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import check_cuda

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = _build.load("miru_scan").miru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 3 + [_F] * 3 + [_P]
        fn.restype = ctypes.c_int
    return fn


def miru_scan(xw: torch.Tensor, u_h: torch.Tensor, h0: torch.Tensor, *,
              beta: float, lam: float) -> tuple[torch.Tensor, torch.Tensor]:
    """xw (B, T, H), u_h (H, H), h0 (B, H), all f32 → (h_all, pre), each
    (B, T, H) f32."""
    dev = check_cuda(xw=xw, u_h=u_h, h0=h0)
    for k, t in (("xw", xw), ("u_h", u_h), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{k} must be float32, got {t.dtype}")
    if xw.ndim != 3:
        raise ValueError(f"xw must be (B, T, H), got {tuple(xw.shape)}")
    B, T, H = xw.shape
    if u_h.shape != (H, H) or h0.shape != (B, H):
        raise ValueError(f"shape mismatch: xw {tuple(xw.shape)}, u_h "
                         f"{tuple(u_h.shape)}, h0 {tuple(h0.shape)}")
    h_all, pre = (torch.empty((B, T, H), dtype=torch.float32, device=dev)
                  for _ in range(2))
    err = _fn()(xw.data_ptr(), u_h.data_ptr(), h0.data_ptr(),
                h_all.data_ptr(), pre.data_ptr(), B, T, H, beta, lam,
                1.0 - lam, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"miru_scan launch failed: cudaError {err} "
                           f"(B={B}, T={T}, H={H})")
    global launches
    launches += 1
    return h_all, pre
