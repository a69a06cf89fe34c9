"""8-bit block-quantized Adam moments — counterpart of
``repro/optim/qstate.py``.

The moments (m, v) are stored as int8 codes with one fp32 absmax scale
per block of 128 along the last dim, about 8× smaller than fp32 moments:
the optimizer deepseek-v3's config names. The codes keep the parameter's
rank (last dim padded to the block multiple), as the reference keeps
them for its sharding. States live on the parameters' device.

The arithmetic is the reference's, in its order: a code is
``round(block / absmax · 127)`` clipped to ±127, ``torch.round`` and
``jnp.round`` both rounding half to even, so on the same fp32 moments the
codes and scales are the reference's bit for bit. The blocks are views
of the last dim (``context.split_dim``, ``merge_last``), so a sharded
moment whose block count does not divide its shards is gathered first.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.distributed.context import merge_last, split_dim
from repro_torch.optim.optimizers import (Optimizer, _count,
                                          add_decayed_weights, chain,
                                          clip_by_global_norm, scale,
                                          scale_by_schedule)
from repro_torch.utils import tree_map

PyTree = Any
_BLOCK = 128


def _padded(n: int) -> int:
    return n + (-n) % _BLOCK


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float (..., N) → (int8 codes (..., Np), fp32 scales (..., Np/B))."""
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, _padded(n) - n))
    blocks = split_dim(xp, -1, xp.shape[-1] // _BLOCK)
    scales = torch.amax(torch.abs(blocks), dim=-1)
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)[..., None]
    codes = torch.clamp(torch.round(blocks / safe * 127.0), -127, 127
                        ).to(torch.int8)
    return merge_last(codes), scales


def _dequantize(codes: torch.Tensor, scales: torch.Tensor, n: int
                ) -> torch.Tensor:
    blocks = split_dim(codes, -1, codes.shape[-1] // _BLOCK)
    # A tensor divisor: CUDA turns division by a Python scalar into a
    # product with its reciprocal, which is not the reference's rounding.
    x = blocks.to(torch.float32) * (scales / torch.full_like(
        scales, 127.0))[..., None]
    return merge_last(x)[..., :n]


class QMoment(NamedTuple):
    codes: torch.Tensor   # int8, param shape with padded last dim
    scales: torch.Tensor  # fp32, (..., padded/_BLOCK)


class Adam8bitState(NamedTuple):
    count: torch.Tensor
    mu: PyTree   # of QMoment
    nu: PyTree   # of QMoment


def _qzeros(p: torch.Tensor) -> QMoment:
    shp = tuple(p.shape) if p.ndim else (1,)
    padded = shp[:-1] + (_padded(shp[-1]),)
    return QMoment(
        torch.zeros(padded, dtype=torch.int8, device=p.device),
        torch.zeros(padded[:-1] + (padded[-1] // _BLOCK,),
                    dtype=torch.float32, device=p.device))


def scale_by_adam_8bit(b1: float = 0.9, b2: float = 0.95,
                       eps: float = 1e-8) -> Optimizer:
    def init(params):
        return Adam8bitState(_count(params), tree_map(_qzeros, params),
                             tree_map(_qzeros, params))

    def update(grads, state, params=None):
        count = state.count + 1
        bc1 = 1 - torch.pow(b1, count.to(torch.float32))
        bc2 = 1 - torch.pow(b2, count.to(torch.float32))
        # |m̂/√v̂| ≤ 1/√(1−b2) for stationary gradients; block-quantized v
        # can round small entries to 0 while m keeps quantization noise:
        # the update is clipped element-wise at 1.5 times that bound, as
        # the reference does (the bitsandbytes recipe).
        u_clip = 1.5 / float(math.sqrt(1.0 - b2))

        def upd(g, qm, qv):
            shp = tuple(g.shape) if g.ndim else (1,)
            n = shp[-1]
            gf = g.reshape(shp).to(torch.float32)
            m = _dequantize(qm.codes, qm.scales, n)
            v = _dequantize(qv.codes, qv.scales, n)
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * torch.square(gf)
            u = ((m / bc1) / (torch.sqrt(v / bc2) + eps)).reshape(g.shape)
            u = torch.clamp(u, -u_clip, u_clip)
            return u, QMoment(*_quantize(m)), QMoment(*_quantize(v))

        outs = tree_map(upd, grads, state.mu, state.nu)
        part = lambda i: tree_map(lambda g, o: o[i], grads, outs)
        return part(0), Adam8bitState(count, part(1), part(2))

    return Optimizer(init, update)


def adam_8bit(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
              weight_decay: float = 0.1,
              max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    """clip → 8-bit Adam → weight decay → lr, chained as the reference
    chains it; ``lr`` a float or a schedule ``count tensor -> lr``."""
    parts = []
    if max_grad_norm is not None:
        parts.append(clip_by_global_norm(max_grad_norm))
    parts.append(scale_by_adam_8bit(b1, b2, eps))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(scale(-lr) if not callable(lr) else _schedule_scale(lr))
    return chain(*parts)


def _schedule_scale(lr_fn):
    return scale_by_schedule(lr_fn)
