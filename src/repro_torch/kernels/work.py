"""The work of one call of each hand-written kernel, from its shapes and
dtype: the FLOPs it must do and the bytes it must move (each input read
once, each output written once), whatever implements it.

One formula a kernel, read by two callers: ``chip_smoke.py``'s bound
columns (the least time for the work at the card's peaks,
``launch/roofline.py``) and the dispatch-level analysis of a step
(``launch/hlo_analysis.py``), where a kernel's launch counts as one event
carrying this work in place of the aten ops of its wrapper's body.

  flash forward   2·B·H·Sq·Sk·(dh + dv), halved when causal
  flash dq        2·B·H·Sq·Sk·(2dh + dv), halved when causal
  flash dk/dv     2·B·H·Sq·Sk·(2dh + 2dv), halved when causal
  WBS product     2·M·K·N + 2·M·K·nb (by linearity: one product of the
                  decoded operand, plus an nb-term decode an input);
                  with read noise 3·K·N more, and 8 fp64 operations a
                  normal (``flops64``)
  WBS scan        2·B·T·H·H·nb (the plane sums' fp32 FMAs the bits fix)
  ideal scan      2·B·T·H·H
  readout         2·M·K·N + M·N
  k-WTA           (iters + 3)·R·N

:data:`recorder` is the analysis that the wrappers in ``kernels/ops.py``
report their launches to, None when no analysis is active; each
wrapper's body that launches a kernel reports through :func:`launches`.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple


class Work(NamedTuple):
    flops: float
    bytes: float
    flops64: float = 0.0     # fp64 operations besides ``flops`` (read noise)


#: The active analysis (``launch.hlo_analysis``), or None.
recorder = None


def launches(events: Callable, meta: Callable) -> Callable:
    """Decorator of a wrapper's body that launches a kernel. With no
    analysis active the body runs, at the cost of one None check. Under
    one, ``events(*args)`` ([(kernel name, :class:`Work`)]) counts as one
    launch each and the body runs uncounted; where the first argument
    lies on ``meta``, ``meta(*args)`` makes the outputs the card's wrapper
    returns (shapes and strides) and the plain version does not run."""
    def wrap(body: Callable) -> Callable:
        @functools.wraps(body)
        def launched(*args):
            rec = recorder
            if rec is None:
                return body(*args)
            return rec.kernel(events(*args), lambda: body(*args),
                              (lambda: meta(*args)) if args[0].is_meta
                              else None)
        return launched
    return wrap


def _causal(flops: float, causal: bool) -> float:
    return flops / 2 if causal else flops


def flash_fwd(B: int, H: int, Kh: int, Sq: int, Sk: int, dh: int, dv: int,
              causal: bool, itemsize: int) -> Work:
    """q (B, Sq, H, dh) against k (B, Sk, Kh, dh) and v (B, Sk, Kh, dv):
    out (B, Sq, H, dv) in q's dtype and the fp32 lse (B, H, Sq)."""
    flops = _causal(2.0 * B * H * Sq * Sk * (dh + dv), causal)
    n_bytes = itemsize * (B * H * Sq * (dh + dv) + B * Kh * Sk * (dh + dv)) \
        + 4 * B * H * Sq
    return Work(flops, n_bytes)


def _flash_bwd_reads(B, H, Kh, Sq, Sk, dh, dv, itemsize) -> float:
    """q and dO, k and v in the inputs' dtype; lse and delta in fp32."""
    return itemsize * (B * H * Sq * (dh + dv) + B * Kh * Sk * (dh + dv)) \
        + 2 * 4 * B * H * Sq


def flash_bwd_dq(B: int, H: int, Kh: int, Sq: int, Sk: int, dh: int,
                 dv: int, causal: bool, itemsize: int) -> Work:
    """The dq kernel: s, dO·vᵀ and ds·k, writing dq (B, Sq, H, dh)."""
    flops = _causal(2.0 * B * H * Sq * Sk * (2 * dh + dv), causal)
    return Work(flops, _flash_bwd_reads(B, H, Kh, Sq, Sk, dh, dv, itemsize)
                + itemsize * B * H * Sq * dh)


def flash_bwd_dkv(B: int, H: int, Kh: int, Sq: int, Sk: int, dh: int,
                  dv: int, causal: bool, itemsize: int) -> Work:
    """The dk/dv kernel: s, dO·vᵀ, pᵀ·dO and dsᵀ·q, writing dk and dv
    (B, Sk, Kh, ·)."""
    flops = _causal(2.0 * B * H * Sq * Sk * (2 * dh + 2 * dv), causal)
    return Work(flops, _flash_bwd_reads(B, H, Kh, Sq, Sk, dh, dv, itemsize)
                + itemsize * B * Kh * Sk * (dh + dv))


def flash_bwd(B: int, H: int, Kh: int, Sq: int, Sk: int, dh: int,
              dv: int, causal: bool, itemsize: int) -> Work:
    """The whole backward, dq and dk/dv on one read of their inputs."""
    dq = flash_bwd_dq(B, H, Kh, Sq, Sk, dh, dv, causal, itemsize)
    dkv = flash_bwd_dkv(B, H, Kh, Sq, Sk, dh, dv, causal, itemsize)
    return Work(dq.flops + dkv.flops, dq.bytes + dkv.bytes
                - _flash_bwd_reads(B, H, Kh, Sq, Sk, dh, dv, itemsize))


def wbs_matmul(M: int, K: int, N: int, n_bits: int, code_bytes: int = 2,
               read_noise: bool = False) -> Work:
    """(M, K) sign and code planes (``code_bytes`` an input element, the
    two together) × (K, N) fp32 weights with n_bits fp32 gains → (M, N)
    fp32. With read noise, per weight one Box–Muller normal (8 fp64
    operations: two scalings, log, ×−2, sqrt, ×2π, cos, the product;
    Philox's integer rounds are not counted) and the perturbation's 3
    fp32 operations."""
    flops = 2.0 * M * K * N + 2.0 * M * K * n_bits
    n_bytes = code_bytes * M * K + 4 * K * N + 4 * n_bits + 4 * M * N
    if read_noise:
        return Work(flops + 3.0 * K * N, n_bytes, 8.0 * K * N)
    return Work(flops, n_bytes)


def wbs_miru_scan(B: int, T: int, H: int, n_bits: int) -> Work:
    """The fused WBS recurrence: drive (B, T, H), U (H, H), h0 (B, H),
    bias (H,) and gains (T, n_bits) in, h_all, h_prev and pre out, all
    fp32."""
    flops = 2.0 * B * T * H * H * n_bits
    n_bytes = 4 * (B * T * H + H * H + B * H + H + T * n_bits) \
        + 3 * 4 * B * T * H
    return Work(flops, n_bytes)


def miru_scan(B: int, T: int, H: int) -> Work:
    """The ideal recurrence: xw (B, T, H), U and h0 in, h_all and pre
    out, fp32."""
    return Work(2.0 * B * T * H * H, 4 * (3 * B * T * H + H * H + B * H))


def miru_readout(M: int, K: int, N: int) -> Work:
    """(M, K) @ (K, N) + (N,), fp32."""
    return Work(2.0 * M * K * N + M * N, 4 * (M * K + K * N + N + M * N))


def kwta(R: int, N: int, iters: int, itemsize: int) -> Work:
    """The bisection's |x| and iters + 2 comparisons an element, x read
    and the masked x written once."""
    return Work(R * N * (iters + 3.0), 2 * itemsize * R * N)
