"""Wrapper of the CUDA kernel ``csrc/kwta.cu`` — per-row approximate
k-WTA by threshold bisection, replacing ``repro/kernels/kwta.py ::
kwta_pallas``.

The wrapper takes CUDA tensors only, (R, N) rows; ``kernels/ops.py``
dispatches, and the plain version is ``kernels/ref.py ::
kwta_bisect_ref`` (bit for bit). :data:`launches` counts the launches of
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import check_cuda

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn():
    fn = _build.load("kwta").kwta_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P] + [_I] * 5 + [_P]
        fn.restype = ctypes.c_int
    return fn


def kwta(x: torch.Tensor, k: int, iters: int = 32) -> torch.Tensor:
    """x (R, N) f32 or bf16 → (R, N), x where |x| is above the row's
    bisected threshold, else 0."""
    dev = check_cuda(x=x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 2 or k < 0 or iters < 0:
        raise ValueError(f"x must be (R, N) with k, iters >= 0; got "
                         f"{tuple(x.shape)}, k {k}, iters {iters}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _fn()(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], k,
                iters, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"kwta launch failed: cudaError {err} "
                           f"(x {tuple(x.shape)}, k {k})")
    global launches
    launches += 1
    return out
