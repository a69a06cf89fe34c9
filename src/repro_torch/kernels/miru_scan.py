"""Wrapper of the CUDA kernel ``csrc/miru_scan.cu`` — the ideal float MiRU
recurrence, replacing ``repro/kernels/miru_scan.py :: miru_scan_pallas``.

The kernel spreads the batch rows over the card, one block a row, each
thread one output column at a time, with U's column in registers where H
allows (H ≤ :data:`REG_H`), else U in shared memory where it fits, else
in global memory. :func:`u_place` makes that choice from H (the C launch
only checks that the layout it is given fits the device); the wrapper
takes CUDA tensors only, any B, and any H up to :data:`MAX_H`. The plain
version is ``kernels/ref.py :: miru_scan_ref``. :data:`launches` counts
the launches of the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import check_cuda

# The chain lengths of a thread that keeps U's column in registers
# (``csrc/miru_scan.cu :: chain_length``): the shortest that holds H runs.
REG_CHAINS = (32, 64, 100, 128)
REG_H = REG_CHAINS[-1]  # H up to which a thread keeps U's column in registers
MAX_H = 3632            # the widest H the scan takes
SMEM_LIMIT = 232_448    # a block's opt-in shared memory on an H100 (bytes)
PLACES = ("global", "smem", "registers")   # where U is read from

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def smem_bytes(H: int, place: str) -> int:
    """A block's shared memory in ``csrc/miru_scan.cu``'s layout (its
    ``smem_bytes``, which refuses a launch that does not fit): two
    buffers of β·h (H floats rounded up to 4, or the chain's length of
    :data:`REG_CHAINS` where U's column is in registers), U when kept
    there, and h of the row unless it is in registers."""
    stride = -(-H // 4) * 4
    if place == "registers":
        stride = next((c for c in REG_CHAINS if H <= c), REG_H)
    return (8 * stride + (4 * H * H if place == "smem" else 0)
            + (4 * H if place != "registers" else 0))


def u_place(H: int) -> str:
    """Where the kernel reads U from at width H (one of :data:`PLACES`):
    registers up to :data:`REG_H`, else shared memory where a block's
    layout fits :data:`SMEM_LIMIT`, else global memory. A row's bits do
    not depend on it. Raises past :data:`MAX_H`."""
    if not 1 <= H <= MAX_H:
        raise ValueError(f"H={H} outside the scan kernel's 1..{MAX_H}")
    if H <= REG_H:
        return "registers"
    return "smem" if smem_bytes(H, "smem") <= SMEM_LIMIT else "global"


def check_place(H: int, place: str) -> None:
    """Raises ``ValueError`` unless the kernel can read U from ``place``
    at width H."""
    if place not in PLACES or not 1 <= H <= MAX_H \
            or (place == "registers" and H > REG_H) \
            or smem_bytes(H, place) > SMEM_LIMIT:
        raise ValueError(f"U cannot be read from {place!r} at H={H} "
                         f"(registers hold H ≤ {REG_H}; a block's shared "
                         f"memory {SMEM_LIMIT} bytes; H ≤ {MAX_H})")


def _fn():
    fn = _build.load("miru_scan").miru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 3 + [_F] * 3 + [_I, _P]
        fn.restype = ctypes.c_int
    return fn


def miru_scan(xw: torch.Tensor, u_h: torch.Tensor, h0: torch.Tensor, *,
              beta: float, lam: float, place: Optional[str] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """xw (B, T, H), u_h (H, H), h0 (B, H), all f32 → (h_all, pre), each
    (B, T, H) f32. ``place`` is where U is read from (:data:`PLACES`),
    :func:`u_place`'s choice by default."""
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
    place = u_place(H) if place is None else place
    check_place(H, place)
    h_all, pre = (torch.empty((B, T, H), dtype=torch.float32, device=dev)
                  for _ in range(2))
    err = _fn()(xw.data_ptr(), u_h.data_ptr(), h0.data_ptr(),
                h_all.data_ptr(), pre.data_ptr(), B, T, H, beta, lam,
                1.0 - lam, PLACES.index(place),
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"miru_scan launch failed: cudaError {err} "
                           f"(B={B}, T={T}, H={H}, U from {place})")
    global launches
    launches += 1
    return h_all, pre
