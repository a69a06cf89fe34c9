"""Wrappers of the CUDA kernels ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` — the flash-attention forward and its
backward (dq; dk and dv), replacing ``repro/kernels/flash_attention.py ::
flash_attention_fwd_pallas`` and ``flash_attention_bwd_pallas``.

The wrappers take CUDA tensors only, in the Pallas kernels' layout: q (and
out, dO) (B·H, Sq, D), k and v (B·Kh, Sk, D) with D 64 or 128;
``kernels/ops.py`` transposes, pads and dispatches, and the plain versions
are ``kernels/ref.py :: flash_attention_fwd_ref`` and
``flash_attention_bwd_ref``. :data:`launches`, :data:`dq_launches` and
:data:`dkv_launches` count the launches of the three kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import check_cuda

#: The head dims the kernels are built for; ops.py zero-pads up to one.
HEAD_DIMS = (64, 128)

#: Kernel launches since import (or since a caller reset them to 0): the
#: forward, the backward's dq kernel and its dk/dv kernel.
launches = 0
dq_launches = 0
dkv_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = _build.load("flash_attention_fwd").flash_attention_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 8 + [_F, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn(name: str, n_ptrs: int):
    fn = getattr(_build.load("flash_attention_bwd"), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptrs + [_I] * 8 + [_F, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, H, Kh, sk_true, **more) -> torch.device:
    dev = check_cuda(q=q, k=k, v=v, **more)
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in (k, v, *more.values())):
        raise TypeError(f"q, k, v (and dO) must all be float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    BH, Sq, D = q.shape
    if D not in HEAD_DIMS or k.shape[2] != D or v.shape != k.shape or \
            H % Kh or BH % H or k.shape[0] != BH // H * Kh or \
            not 1 <= sk_true <= k.shape[1] or \
            any(t.shape != q.shape for t in more.values()):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, heads {H}/{Kh}, sk_true {sk_true} (D must "
            f"be one of {HEAD_DIMS})")
    return dev


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, sk_true: int, q_heads: int,
                        kv_heads: int, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B·H, Sq, D), k/v (B·Kh, Sk, D), f32 or bf16 → (out (B·H, Sq, D)
    in q's dtype, lse (B·H, Sq) f32). Query head b reads KV head
    (b // H)·Kh + (b % H) // (H // Kh); keys at or past ``sk_true`` are
    masked."""
    dev = _check(q, k, v, q_heads, kv_heads, sk_true)
    BH, Sq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=dev)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), BH, q_heads, kv_heads, Sq, k.shape[1],
                sk_true, D, int(causal), scale,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)})")
    global launches
    launches += 1
    return out, lse


def _lse_delta(lse, delta, q) -> None:
    BH, Sq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (BH, Sq) or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({BH}, "
                             f"{Sq}) tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, lse: torch.Tensor,
                           delta: torch.Tensor, *, causal: bool,
                           sk_true: int, q_heads: int, kv_heads: int,
                           scale: float) -> torch.Tensor:
    """The dq kernel: q, dout (B·H, Sq, D), k/v (B·Kh, Sk, D), lse and
    delta = Σ dout·out (B·H, Sq) f32 → dq (B·H, Sq, D) in q's dtype."""
    dev = _check(q, k, v, q_heads, kv_heads, sk_true, dout=dout)
    _lse_delta(lse, delta, q)
    BH, Sq, D = q.shape
    dq = torch.empty_like(q)
    err = _bwd_fn("flash_attention_bwd_dq_launch", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, q_heads,
        kv_heads, Sq, k.shape[1], sk_true, D, int(causal), scale,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: cudaError "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)})")
    global dq_launches
    dq_launches += 1
    return dq


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, *,
                            causal: bool, sk_true: int, q_heads: int,
                            kv_heads: int, scale: float
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel, inputs as :func:`flash_attention_bwd_dq` →
    (dk, dv), each (B·Kh, Sk, D) in k's dtype: each KV head's gradient
    summed over the H // Kh query heads that read it."""
    dev = _check(q, k, v, q_heads, kv_heads, sk_true, dout=dout)
    _lse_delta(lse, delta, q)
    BH, Sq, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _bwd_fn("flash_attention_bwd_dkv_launch", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
        q_heads, kv_heads, Sq, k.shape[1], sk_true, D, int(causal), scale,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: "
                           f"cudaError {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    global dkv_launches
    dkv_launches += 1
    return dk, dv
