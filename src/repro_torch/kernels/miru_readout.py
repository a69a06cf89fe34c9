"""Wrapper of the CUDA kernel ``csrc/miru_readout.cu`` — the row-exact
readout ``h @ w_o + b_o``, in place of a library GEMM whose summation
order depends on the number of rows (``repro/core/miru.py ::
miru_apply_readout`` leaves the product to XLA).

The wrapper takes CUDA tensors only; ``kernels/ops.py`` dispatches, and
its plain version is ``kernels/ref.py :: miru_readout_ref``.
:data:`launches` counts the launches of the kernel.
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
    fn = _build.load("miru_readout").miru_readout_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        fn.restype = ctypes.c_int
    return fn


def miru_readout(h: torch.Tensor, w_o: torch.Tensor, b_o: torch.Tensor
                 ) -> torch.Tensor:
    """h (M, K), w_o (K, N), b_o (N,), all f32 → (M, N) f32."""
    dev = check_cuda(h=h, w_o=w_o, b_o=b_o)
    for k, t in (("h", h), ("w_o", w_o), ("b_o", b_o)):
        if t.dtype != torch.float32:
            raise TypeError(f"{k} must be float32, got {t.dtype}")
    if h.ndim != 2 or w_o.ndim != 2 or w_o.shape[0] != h.shape[1] \
            or b_o.shape != (w_o.shape[1],):
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, w_o "
                         f"{tuple(w_o.shape)}, b_o {tuple(b_o.shape)}")
    (M, K), N = h.shape, w_o.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    err = _fn()(h.data_ptr(), w_o.data_ptr(), b_o.data_ptr(), out.data_ptr(),
                M, K, N, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"miru_readout launch failed: cudaError {err} "
                           f"(M={M}, K={K}, N={N})")
    global launches
    launches += 1
    return out
