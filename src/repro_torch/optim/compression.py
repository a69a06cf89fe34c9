"""Top-k gradient compression with error feedback — counterpart of
``repro/optim/compression.py``.

Before a data-parallel gradient exchange, keep only the top-k fraction of
each gradient tensor (ζ, :func:`repro_torch.core.kwta.kwta_global`) and
carry the residual locally (error feedback), so the compression is
unbiased over time. The compressed gradient stays a dense tensor of
mostly zeros.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.kwta import kwta_global
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils import tree_map

PyTree = Any


class EFState(NamedTuple):
    residual: PyTree
    inner: Any


def topk_compress_error_feedback(inner: Optimizer, keep_frac: float = 0.1,
                                 min_size: int = 4096) -> Optimizer:
    """g' = ζ(g + e);  e ← (g + e) − g';  inner.update(g')."""

    def init(params):
        residual = tree_map(
            lambda p: torch.zeros(p.shape if p.numel() > min_size else (),
                                  dtype=torch.float32, device=p.device),
            params)
        return EFState(residual, inner.init(params))

    def update(grads, state, params=None):
        def compress(g, e):
            if g.numel() <= min_size or g.ndim < 2:
                return g, e
            acc = g.to(torch.float32) + e
            sent = kwta_global(acc, keep_frac)
            return sent.to(g.dtype), acc - sent

        outs = tree_map(compress, grads, state.residual)
        # Mapped over the grads' structure, each (sent, residual) pair is a
        # leaf of ``outs``.
        sent = tree_map(lambda g, o: o[0], grads, outs)
        residual = tree_map(lambda g, o: o[1], grads, outs)
        updates, inner_state = inner.update(sent, state.inner, params)
        return updates, EFState(residual, inner_state)

    return Optimizer(init, update)
