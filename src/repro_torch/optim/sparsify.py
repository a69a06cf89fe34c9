"""K-WTA gradient sparsification as an optimizer transform — the paper's
ζ; counterpart of ``repro/optim/sparsify.py``.

Wraps any optimizer: gradients are sparsified (per-tensor global top-k by
magnitude, the exact :func:`repro_torch.core.kwta.kwta_global`) *before*
the inner update, exactly as Algorithm 1 lines 19-21 apply ζ before the
SGD write.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.kwta import kwta_global
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils import tree_map

PyTree = Any


def kwta_sparsify(inner: Optimizer, keep_frac: float = 0.57,
                  min_size: int = 64) -> Optimizer:
    """Apply ζ(·) with ``keep_frac`` to every gradient tensor with more than
    ``min_size`` elements and at least two dims (scalars and biases pass
    through untouched, as the hardware only sparsifies crossbar writes)."""
    if not (0.0 < keep_frac <= 1.0):
        raise ValueError("keep_frac in (0,1]")

    def init(params):
        return inner.init(params)

    def update(grads, state, params=None):
        def zeta(g):
            if g.numel() <= min_size or g.ndim < 2:
                return g
            return kwta_global(g, keep_frac)

        return inner.update(tree_map(zeta, grads), state, params)

    return Optimizer(init, update)


def write_masks(updates: PyTree) -> PyTree:
    """Which synapses receive a write this step (for EnduranceTracker)."""
    return tree_map(lambda u: u != 0, updates)
