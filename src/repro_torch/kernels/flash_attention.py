"""Wrapper of the CUDA kernel ``csrc/flash_attention_fwd.cu`` — the
flash-attention forward, replacing ``repro/kernels/flash_attention.py ::
flash_attention_fwd_pallas``.

The wrapper takes CUDA tensors only, in the Pallas kernel's layout: q
(B·H, Sq, D), k and v (B·Kh, Sk, D) with D 64 or 128;
``kernels/ops.py`` transposes, pads and dispatches, and the plain version
is ``kernels/ref.py :: flash_attention_fwd_ref``. :data:`launches` counts
the launches of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import check_cuda

#: The head dims the kernel is built for; ops.py zero-pads up to one.
HEAD_DIMS = (64, 128)

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = _build.load("flash_attention_fwd").flash_attention_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 8 + [_F, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, sk_true: int, q_heads: int,
                        kv_heads: int, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B·H, Sq, D), k/v (B·Kh, Sk, D), f32 or bf16 → (out (B·H, Sq, D)
    in q's dtype, lse (B·H, Sq) f32). Query head b reads KV head
    (b // H)·Kh + (b % H) // (H // Kh); keys at or past ``sk_true`` are
    masked."""
    dev = check_cuda(q=q, k=k, v=v)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    BH, Sq, D = q.shape
    H, Kh = q_heads, kv_heads
    if D not in HEAD_DIMS or k.shape[2] != D or v.shape != k.shape or \
            H % Kh or BH % H or k.shape[0] != BH // H * Kh or \
            not 1 <= sk_true <= k.shape[1]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, heads {H}/{Kh}, sk_true {sk_true} (D must "
            f"be one of {HEAD_DIMS})")
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=dev)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), BH, H, Kh, Sq, k.shape[1], sk_true, D,
                int(causal), scale, int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)})")
    global launches
    launches += 1
    return out, lse
