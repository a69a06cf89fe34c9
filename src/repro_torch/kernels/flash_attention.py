"""Wrappers of the CUDA kernels of the flash-attention forward and its
backward (dq; dk and dv), replacing ``repro/kernels/flash_attention.py ::
flash_attention_fwd_pallas`` and ``flash_attention_bwd_pallas``: for
fp32 the tensor-core ``csrc/flash_attention_fwd_f32_sm90.cu``,
``csrc/flash_attention_bwd_dq_f32_sm90.cu`` and
``csrc/flash_attention_bwd_dkv_f32_sm90.cu`` (fp32 operands as sums of
three bf16 terms; ``csrc/flash_f32_sm90.cuh``); for bf16 the tensor-core
``csrc/flash_attention_fwd_sm90.cu``, ``csrc/flash_attention_bwd_dq_
sm90.cu`` and ``csrc/flash_attention_bwd_dkv_sm90.cu`` (wgmma on 128-
byte-swizzled bf16 tiles; ``csrc/flash_sm90.cuh``).

The wrappers take CUDA tensors only, in the Pallas kernels' layout: q
(B·H, Sq, DQK), k (B·Kh, Sk, DQK), v (B·Kh, Sk, DV), out and dO (B·H,
Sq, DV), with (DQK, DV) one of :data:`HEAD_DIM_PAIRS`; the fp32 kernels
take float32 only and the ``_sm90`` ones bfloat16 only, and each raises on
the other dtype. ``kernels/ops.py`` transposes, pads and
dispatches by dtype, and the plain versions are ``kernels/ref.py ::
flash_attention_fwd_ref`` and ``flash_attention_bwd_ref``.
:data:`fwd_f32_sm90_launches`, :data:`dq_launches`, :data:`dkv_launches`,
:data:`fwd_sm90_launches`, :data:`dq_sm90_launches` and
:data:`dkv_sm90_launches` count the launches of the six kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import check_cuda

#: The (query/key, value) head dims the kernels are built for: equal
#: pairs, and MLA's 192 / 128 (deepseek-v3: 128 + 64 rope, 128). ops.py
#: zero-pads (dh, dv) up to the first pair that holds both.
HEAD_DIM_PAIRS = ((64, 64), (128, 128), (192, 128))

#: Kernel launches since import (or since a caller reset them to 0): the
#: fp32 forward (with its split), the fp32 backward's dq (with its split)
#: and its dk/dv (with its split and fold).
fwd_f32_sm90_launches = 0
dq_launches = 0
dkv_launches = 0
#: Launches of the bf16 tensor-core forward, dq and dk/dv (with its fold).
fwd_sm90_launches = 0
dq_sm90_launches = 0
dkv_sm90_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _launcher(lib: str, name: str, n_ptrs: int):
    """``lib``'s C function ``name``: n_ptrs pointers, 9 ints, the scale,
    the stream."""
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptrs + [_I] * 9 + [_F, _P]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, H, Kh, sk_true, **more) -> torch.device:
    dev = check_cuda(q=q, k=k, v=v, **more)
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in (k, v, *more.values())):
        raise TypeError(f"q, k, v (and dO) must all be float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    BH, Sq, DQK = q.shape
    DV = v.shape[2]
    if (DQK, DV) not in HEAD_DIM_PAIRS or k.shape[2] != DQK or \
            v.shape[:2] != k.shape[:2] or \
            H % Kh or BH % H or k.shape[0] != BH // H * Kh or \
            not 1 <= sk_true <= k.shape[1] or \
            any(t.shape != (BH, Sq, DV) for t in more.values()):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, heads {H}/{Kh}, sk_true {sk_true} (the head "
            f"dims (q/k, v) must be one of {HEAD_DIM_PAIRS})")
    return dev


def _check_fp32(*tensors) -> None:
    """The fp32 kernels take float32 only (bf16 has the ``_sm90`` ones)."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the fp32 flash kernels take float32 only (bf16 "
                        f"goes to the sm90 kernels), got "
                        f"{[t.dtype for t in tensors]}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, sk_true: int, q_heads: int,
                        kv_heads: int, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 tensor-core forward: q (B·H, Sq, DQK), k (B·Kh, Sk, DQK),
    v (B·Kh, Sk, DV), f32 → (out (B·H, Sq, DV) f32, lse (B·H, Sq) f32).
    Query head b reads KV head (b // H)·Kh + (b % H) // (H // Kh); keys
    at or past ``sk_true`` are masked. One launch splits the inputs into
    bf16 term planes (scratch, allocated here) and runs the forward."""
    dev = _check(q, k, v, q_heads, kv_heads, sk_true)
    _check_fp32_aligned(q, k, v)
    BH, Sq, DQK = q.shape
    DV = v.shape[2]
    out = q.new_empty((BH, Sq, DV))
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=dev)
    terms = torch.empty(3 * (q.numel() + k.numel() + v.numel()),
                        dtype=torch.bfloat16, device=dev)
    err = _launcher("flash_attention_fwd_f32_sm90",
                    "flash_attention_fwd_f32_sm90_launch", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), terms.data_ptr(),
        out.data_ptr(), lse.data_ptr(), BH, q_heads, kv_heads, Sq,
        k.shape[1], sk_true, DQK, DV, int(causal), scale,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)})")
    global fwd_f32_sm90_launches
    fwd_f32_sm90_launches += 1
    return out, lse


def _lse_delta(lse, delta, q) -> None:
    BH, Sq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (BH, Sq) or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({BH}, "
                             f"{Sq}) tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _term_planes(q, k, v, dout) -> torch.Tensor:
    """Scratch for the fp32 backward's bf16 term planes: three of q's,
    dO's, k's and v's size each."""
    return torch.empty(3 * (q.numel() + dout.numel() + k.numel()
                            + v.numel()),
                       dtype=torch.bfloat16, device=q.device)


def _check_fp32_aligned(*tensors) -> None:
    """The fp32 kernels take float32 only, 16-byte aligned (their split
    reads 16 bytes at a time)."""
    _check_fp32(*tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the fp32 flash kernels need 16-byte aligned "
                         "tensors")


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, lse: torch.Tensor,
                           delta: torch.Tensor, *, causal: bool,
                           sk_true: int, q_heads: int, kv_heads: int,
                           scale: float) -> torch.Tensor:
    """The fp32 tensor-core dq: q (B·H, Sq, DQK), dout (B·H, Sq, DV), k
    (B·Kh, Sk, DQK), v (B·Kh, Sk, DV), all f32, lse and delta = Σ dout·out
    (B·H, Sq) f32 → dq (B·H, Sq, DQK) f32. One launch splits the inputs
    into bf16 term planes (scratch, allocated here) and runs the dq
    kernel."""
    dev = _check(q, k, v, q_heads, kv_heads, sk_true, dout=dout)
    _check_fp32_aligned(q, k, v, dout)
    _lse_delta(lse, delta, q)
    BH, Sq, DQK = q.shape
    dq = torch.empty_like(q)
    terms = _term_planes(q, k, v, dout)
    err = _launcher("flash_attention_bwd_dq_f32_sm90",
                    "flash_attention_bwd_dq_f32_sm90_launch", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), terms.data_ptr(), dq.data_ptr(),
        BH, q_heads, kv_heads, Sq, k.shape[1], sk_true, DQK, v.shape[2],
        int(causal), scale, torch.cuda.current_stream(dev).cuda_stream)
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
    """The fp32 tensor-core dk/dv, inputs as :func:`flash_attention_bwd_dq`
    → (dk (B·Kh, Sk, DQK), dv (B·Kh, Sk, DV)) f32: each KV head's gradient
    summed over the H // Kh query heads that read it. One launch runs the
    split into term planes, the dk/dv kernel, which writes each query
    head's partials into scratch (B·H·Sk·(DQK + DV) floats), and the
    fold that sums each KV head's partials in a fixed order in fp32; the
    scratch is allocated here."""
    dev = _check(q, k, v, q_heads, kv_heads, sk_true, dout=dout)
    _check_fp32_aligned(q, k, v, dout)
    _lse_delta(lse, delta, q)
    BH, Sq, DQK = q.shape
    Sk, DV = k.shape[1], v.shape[2]
    dk_part = torch.empty((BH, Sk, DQK), dtype=torch.float32, device=dev)
    dv_part = torch.empty((BH, Sk, DV), dtype=torch.float32, device=dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    terms = _term_planes(q, k, v, dout)
    err = _launcher("flash_attention_bwd_dkv_f32_sm90",
                    "flash_attention_bwd_dkv_f32_sm90_launch", 11)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), terms.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        BH, q_heads, kv_heads, Sq, Sk, sk_true, DQK, DV, int(causal), scale,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: "
                           f"cudaError {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    global dkv_launches
    dkv_launches += 1
    return dk, dv


def _check_sm90(*tensors) -> None:
    """The tensor-core kernels take bf16 only, 16-byte aligned (their tile
    loads copy 16 bytes at a time)."""
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"the sm90 flash kernels take bfloat16 only, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the sm90 flash kernels need 16-byte aligned "
                         "tensors")


def flash_attention_fwd_sm90(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool, sk_true: int,
                             q_heads: int, kv_heads: int, scale: float
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 tensor-core forward, arguments and result as
    :func:`flash_attention_fwd`: q (B·H, Sq, DQK), k (B·Kh, Sk, DQK), v
    (B·Kh, Sk, DV), bf16 → (out (B·H, Sq, DV) bf16, lse (B·H, Sq) f32).
    Raises on any other dtype (it never hands a call to the fp32
    kernel)."""
    dev = _check(q, k, v, q_heads, kv_heads, sk_true)
    _check_sm90(q, k, v)
    BH, Sq, DQK = q.shape
    DV = v.shape[2]
    out = q.new_empty((BH, Sq, DV))
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=dev)
    err = _launcher("flash_attention_fwd_sm90",
                    "flash_attention_fwd_sm90_launch", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), BH, q_heads, kv_heads, Sq, k.shape[1], sk_true, DQK,
        DV, int(causal), scale, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd_sm90 launch failed: "
                           f"cudaError {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    global fwd_sm90_launches
    fwd_sm90_launches += 1
    return out, lse


def flash_attention_bwd_dq_sm90(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, dout: torch.Tensor,
                                lse: torch.Tensor, delta: torch.Tensor, *,
                                causal: bool, sk_true: int, q_heads: int,
                                kv_heads: int, scale: float) -> torch.Tensor:
    """The bf16 tensor-core dq, arguments as :func:`flash_attention_bwd_dq`,
    bf16 only → dq (B·H, Sq, DQK) bf16. Raises on any other dtype (it never
    hands a call to the fp32 kernel)."""
    dev = _check(q, k, v, q_heads, kv_heads, sk_true, dout=dout)
    _check_sm90(q, k, v, dout)
    _lse_delta(lse, delta, q)
    BH, Sq, DQK = q.shape
    dq = torch.empty_like(q)
    err = _launcher("flash_attention_bwd_dq_sm90",
                    "flash_attention_bwd_dq_sm90_launch", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, q_heads,
        kv_heads, Sq, k.shape[1], sk_true, DQK, v.shape[2], int(causal),
        scale, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_dq_sm90 launch failed: "
                           f"cudaError {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    global dq_sm90_launches
    dq_sm90_launches += 1
    return dq


def flash_attention_bwd_dkv_sm90(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, dout: torch.Tensor,
                                 lse: torch.Tensor, delta: torch.Tensor, *,
                                 causal: bool, sk_true: int, q_heads: int,
                                 kv_heads: int, scale: float
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 tensor-core dk/dv, arguments and result as
    :func:`flash_attention_bwd_dkv`, bf16 only. One launch runs the dk/dv
    kernel, which writes each query head's fp32 partials into scratch
    (B·H·Sk·(DQK + DV) floats, allocated here), and the fold that sums
    each KV head's partials in a fixed order and rounds to bf16."""
    dev = _check(q, k, v, q_heads, kv_heads, sk_true, dout=dout)
    _check_sm90(q, k, v, dout)
    _lse_delta(lse, delta, q)
    BH, Sq, DQK = q.shape
    Sk, DV = k.shape[1], v.shape[2]
    dk_part = torch.empty((BH, Sk, DQK), dtype=torch.float32, device=dev)
    dv_part = torch.empty((BH, Sk, DV), dtype=torch.float32, device=dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _launcher("flash_attention_bwd_dkv_sm90",
                    "flash_attention_bwd_dkv_sm90_launch", 10)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk_part.data_ptr(),
        dv_part.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, q_heads,
        kv_heads, Sq, Sk, sk_true, DQK, DV, int(causal), scale,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_dkv_sm90 launch failed: "
                           f"cudaError {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    global dkv_sm90_launches
    dkv_sm90_launches += 1
    return dk, dv
