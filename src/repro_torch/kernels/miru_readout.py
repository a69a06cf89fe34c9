"""Wrapper of the CUDA kernel ``csrc/miru_readout.cu`` — the row-exact
readout ``h @ w_o + b_o``, in place of a library GEMM whose summation
order depends on the number of rows (``repro/core/miru.py ::
miru_apply_readout`` leaves the product to XLA).

A block owns :attr:`Geometry.rows` rows of h and :attr:`Geometry.cols`
output columns, one thread an output, and stages its operands in shared
memory :attr:`Geometry.k_tile` inputs at a time; :func:`geometry` makes
that choice from the shape and the card's SMs (the C launch only checks
that it fits). No
geometry changes a row's arithmetic: every output sums k = 0..K-1
ascending across the tiles. The wrapper takes CUDA tensors only;
``kernels/ops.py`` dispatches, and its plain version is ``kernels/ref.py
:: miru_readout_ref``. :data:`launches` counts the launches of the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import check_cuda

H100_SMS = 132         # an H100's SMs: geometry's default card
MAX_THREADS = 256      # outputs (threads) a block
SMEM_FLOATS = 12_288   # a block's shared memory (48 KB, no opt-in)
PAD = 4                # h's rows in shared memory are k_tile + PAD apart

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


class Geometry(NamedTuple):
    """A block's share of the product: ``rows`` rows of h, ``cols``
    output columns, ``k_tile`` inputs staged at a time (a multiple of
    4)."""
    rows: int
    cols: int
    k_tile: int

    def grid(self, M: int, N: int) -> tuple[int, int]:
        """(row groups, column groups) of the launch."""
        return -(-M // self.rows), -(-N // self.cols)

    @property
    def threads(self) -> int:
        """Threads a block: one an output, in whole warps."""
        return -(-self.rows * self.cols // 32) * 32


def smem_floats(g: Geometry) -> int:
    """A block's shared memory in floats, as ``csrc/miru_readout.cu ::
    smem_floats`` lays it out: rows of h, the tile of w_o, the bias."""
    return g.rows * (g.k_tile + PAD) + g.k_tile * g.cols + g.cols


def geometry(M: int, K: int, N: int, sms: int = H100_SMS) -> Geometry:
    """All of N up to :data:`MAX_THREADS` columns a block; enough rows a
    block to cover the card's ``sms`` SMs at M = sms·rows (on an H100 7
    rows, 128 blocks at the serve shape's 896), one row a block up to M =
    sms (32 and 64 rows run on 32 and 64 blocks); and the longest K-tile,
    a multiple of 4, that fits :data:`SMEM_FLOATS` (the whole K where it
    fits)."""
    if min(M, K, N) < 1:
        raise ValueError(f"empty readout: M={M}, K={K}, N={N}")
    cols = min(N, MAX_THREADS)
    rows = max(1, min(-(-M // sms), MAX_THREADS // cols))
    fit = (SMEM_FLOATS - cols - PAD * rows) // (rows + cols) // 4 * 4
    return Geometry(rows, cols, min(-(-K // 4) * 4, fit))


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The SMs of CUDA device ``dev``, read once."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _fn():
    fn = _build.load("miru_readout").miru_readout_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 6 + [_P]
        fn.restype = ctypes.c_int
    return fn


def miru_readout(h: torch.Tensor, w_o: torch.Tensor, b_o: torch.Tensor
                 ) -> torch.Tensor:
    """h (M, K), w_o (K, N), b_o (N,), all f32 → (M, N) f32, launched
    with :func:`geometry`'s :class:`Geometry` for the device's SMs."""
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
                M, K, N, *geometry(M, K, N, sm_count(dev)),
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"miru_readout launch failed: cudaError {err} "
                           f"(M={M}, K={K}, N={N})")
    global launches
    launches += 1
    return out
