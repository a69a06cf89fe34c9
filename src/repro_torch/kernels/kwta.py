"""Wrapper of the CUDA kernel ``csrc/kwta.cu`` — per-row approximate
k-WTA by threshold bisection, replacing ``repro/kernels/kwta.py ::
kwta_pallas``.

:func:`plan` picks the kernel's path from the row length N: a warp a
row with the row in registers up to :data:`WARP_N`, a block of 2-32
warps a row with the row in registers up to :data:`BLOCK_N`, else a
block a row that reads the row from global memory each round (the C
launch only checks that the plan holds the row). No path changes a
row's result. The wrapper takes CUDA tensors only, (R, N) rows; ``kernels/ops.py``
dispatches, and the plain version is ``kernels/ref.py ::
kwta_bisect_ref`` (bit for bit). :data:`launches` counts the launches of
the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import check_cuda

PATHS = ("warp", "block", "stream")   # csrc/kwta.cu's Path, in order
# The plan (tools/kernel_times.py, PERF.md): a warp a row up to WARP_N,
# past that the fewest warps a row that hold it at PLAN_V values a thread.
WARP_V = (1, 2, 4, 8, 16)             # values a lane holds, path "warp"
PLAN_V = 16                           # values a thread holds, "block"
BLOCK_WARPS = 32                      # the most warps a row: 1,024 threads
ROW_WARPS = 4                         # rows (a warp each) a block, "warp"
WARP_N = 32 * WARP_V[-1]              # 512: a warp's registers
BLOCK_N = 32 * BLOCK_WARPS * PLAN_V   # 16,384: a block's registers

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


class Plan(NamedTuple):
    """How the kernel spreads a row: its path (one of :data:`PATHS`), the
    warps a row, and the values a thread holds in registers (0 where the
    row is read from global memory)."""
    path: str
    warps: int
    v: int


def plan(N: int, dtype: torch.dtype = torch.float32) -> Plan:
    """The path for rows of length N, the fastest of those timed on an
    H100 (PERF.md): a warp a row up to :data:`WARP_N`, each lane the
    fewest values (a power of two) that hold the row; a block a row up to
    :data:`BLOCK_N`, the fewest warps (a power of two) that hold it at
    :data:`PLAN_V` values a thread; else the row read from global memory
    each round. Both dtypes plan alike: a thread holds its values as
    fp32 bits."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    if N < 1:
        raise ValueError(f"empty rows: N={N}")
    if N <= WARP_N:
        return Plan("warp", 1, next(v for v in WARP_V if 32 * v >= N))
    if N <= BLOCK_N:
        warps = next(w for w in (2, 4, 8, 16, BLOCK_WARPS)
                     if 32 * w * PLAN_V >= N)
        return Plan("block", warps, PLAN_V)
    return Plan("stream", BLOCK_WARPS, 0)


def launch_shape(R: int, p: Plan) -> tuple[int, int]:
    """(blocks, threads a block) of the launch for R rows under ``p``."""
    if p.path == "warp":
        return -(-R // ROW_WARPS), 32 * ROW_WARPS
    return R, 32 * p.warps


def _fn():
    fn = _build.load("kwta").kwta_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P] + [_I] * 8 + [_P]
        fn.restype = ctypes.c_int
    return fn


def kwta(x: torch.Tensor, k: int, iters: int = 32) -> torch.Tensor:
    """x (R, N) f32 or bf16 → (R, N), x where |x| is above the row's
    bisected threshold, else 0, launched under :func:`plan`'s
    :class:`Plan`."""
    dev = check_cuda(x=x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 2 or k < 0 or iters < 0:
        raise ValueError(f"x must be (R, N) with k, iters >= 0; got "
                         f"{tuple(x.shape)}, k {k}, iters {iters}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    N = x.shape[1]
    p = plan(N, x.dtype)
    err = _fn()(x.data_ptr(), out.data_ptr(), x.shape[0], N, k, iters,
                int(x.dtype == torch.bfloat16), PATHS.index(p.path), p.warps,
                p.v, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"kwta launch failed: cudaError {err} "
                           f"(x {tuple(x.shape)}, k {k})")
    global launches
    launches += 1
    return out
