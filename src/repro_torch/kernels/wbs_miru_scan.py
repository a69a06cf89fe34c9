"""Wrapper of the CUDA kernel ``csrc/wbs_miru_scan.cu`` — the fused
WBS×MiRU recurrence, replacing ``repro/kernels/wbs_miru_scan.py ::
wbs_miru_scan_pallas``.

The kernel spreads each time step over thread block clusters: a cluster
of 2-8 blocks (:func:`cluster_size`) owns ``rows`` batch rows, each block
a slab of ``ncols`` of U's output columns, kept in shared memory where it
fits and read from global memory otherwise. :func:`geometry` makes every
choice of the launch from the shape (the C launch only checks that the
layout it is given fits the device); ``kernels/ops.py`` pads B to whole
clusters of that geometry and hands it to the wrapper, which takes CUDA
tensors only. Any H whose plane table fits a block's shared memory is
taken (H ≤ 5,598 on an H100). The plain version is ``kernels/ref.py ::
wbs_miru_scan_ref``. :data:`launches` counts the launches of the kernel.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wbs_matmul import MAX_BITS, adc_args, check_cuda

TARGET_BLOCKS = 128     # of the H100's 132 SMs
MAX_ROWS = 8            # batch rows a cluster
SMEM_LIMIT = 232_448    # a block's opt-in shared memory on an H100 (bytes)

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclass(frozen=True)
class Geometry:
    """A launch: clusters of ``cluster`` blocks, each cluster owning
    ``rows`` batch rows and each block ``ncols`` columns of H (even: a
    pair of threads computes a pair of columns), with its slab of U in
    shared memory when ``u_in_smem``."""
    rows: int
    cluster: int
    ncols: int
    u_in_smem: bool

    @classmethod
    def of(cls, rows: int, cluster: int, H: int) -> "Geometry":
        """The slabs for ``rows`` and ``cluster`` at H: U's slab kept in
        shared memory where the block's whole layout fits
        :data:`SMEM_LIMIT`."""
        ncols = 2 * -(-H // (2 * cluster))
        return cls(rows, cluster, ncols,
                   smem_bytes(H, rows, ncols, True) <= SMEM_LIMIT)

    def padded(self, B: int) -> int:
        """B rounded up to whole clusters."""
        return -(-B // self.rows) * self.rows

    def blocks(self, B: int) -> int:
        return self.padded(B) // self.rows * self.cluster


def smem_bytes(H: int, rows: int, ncols: int, with_u: bool) -> int:
    """A block's shared memory in ``csrc/wbs_miru_scan.cu``'s layout (its
    ``smem_bytes``, which refuses a launch that does not fit): two
    mbarriers, the plane table of its rows (a row 2H float4s, padded to 4
    more than a multiple of 8), U's slab when kept there, three floats an
    output and two buffers of codes."""
    stride = 2 * H + (4 - 2 * H % 8) % 8
    return (16 + 16 * rows * stride + (4 * H * ncols if with_u else 0)
            + 12 * rows * ncols + 8 * rows * H)


def cluster_size(H: int) -> int:
    """Blocks a cluster: 2 up to H 128, 4 up to 256, else 8 (the portable
    maximum). Each block sends each of its codes to every block of its
    cluster every step, so small clusters are faster where a block's
    slab of columns stays short (``tools/kernel_times.py --old-scan``
    times the alternatives)."""
    return 2 if H <= 128 else (4 if H <= 256 else 8)


def geometry(B: int, H: int) -> Geometry:
    """The launch for (B, H): the cluster from H, rows a cluster from B so
    that about :data:`TARGET_BLOCKS` blocks run (H 100: one row, so B 64
    runs 128 blocks and B 32 64), fewer rows where the plane table would
    not fit. A row's bits do not depend on the geometry. Raises where one
    row's table does not fit."""
    cluster = cluster_size(H)
    rows = min(MAX_ROWS, max(1, -(-B * cluster // TARGET_BLOCKS)))
    g = Geometry.of(rows, cluster, H)
    while g.rows > 1 and smem_bytes(H, g.rows, g.ncols, False) > SMEM_LIMIT:
        g = Geometry.of(g.rows - 1, cluster, H)
    if smem_bytes(H, g.rows, g.ncols, False) > SMEM_LIMIT:
        raise ValueError(f"H={H} too wide for the scan kernel: one row's "
                         f"plane table needs "
                         f"{smem_bytes(H, 1, g.ncols, False)} bytes of "
                         f"shared memory, above {SMEM_LIMIT}")
    return g


def _fn():
    fn = _build.load("wbs_miru_scan").wbs_miru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 4 + [_F] * 5 + [_I, _F, _F, _F] \
            + [_I] * 4 + [_P]
        fn.restype = ctypes.c_int
    return fn


def wbs_miru_scan(drive: torch.Tensor, u_scaled: torch.Tensor,
                  h0: torch.Tensor, b_h: torch.Tensor, gains: torch.Tensor,
                  *, beta: float, lam: float, adc_bits: Optional[int] = None,
                  adc_range: float = 4.0, w_scale: float = 1.0,
                  geom: Geometry
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """drive (B, T, H), u_scaled (H, H) weights already divided by the
    logical scale, h0 (B, H), b_h (H,), gains (T, n_bits), all f32 →
    (h_all, h_prev, pre), each (B, T, H) f32. ``geom`` is the launch
    (``ops.wbs_miru_scan`` passes :func:`geometry`'s for (B, H), whose
    rows it padded B to); B must be a multiple of its rows."""
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
    if B % geom.rows:
        raise ValueError(f"B={B} must be a multiple of the geometry's "
                         f"{geom.rows} rows a cluster (kernels/ops.py pads)")
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
        geom.rows, geom.cluster, geom.ncols, int(geom.u_in_smem),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"wbs_miru_scan launch failed: cudaError {err} "
                           f"(B={B}, T={T}, H={H}, {geom})")
    global launches
    launches += 1
    return outs[0], outs[1], outs[2]
