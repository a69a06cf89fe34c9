"""K-winner-take-all — the paper's ζ sparsifier and softmax approximation.

Counterpart of ``repro/core/kwta.py``. Two uses in M2RU:

  1. Gradient sparsification (Algorithm 1, lines 19-21): ζ(∇W) keeps only
     the top-k entries by magnitude (:func:`kwta_global`, the training ζ).
  2. The voltage-mode k-WTA readout circuit that approximates softmax by
     letting only the k largest logits through (:func:`kwta_softmax`, and
     ``readout_k`` in the MiRU readout).

Both are exact top-k with a positional tie-break. The reference's Pallas
``kwta_pallas`` is another function — approximate k by bisection on the
threshold — reached only through its ``ops.kwta``; it is not on this
path and keeps its own semantics (ROADMAP queue B4).
"""
from __future__ import annotations

from typing import Optional

import torch


def kwta_mask(x: torch.Tensor, k: int, by_magnitude: bool = True,
              axis: int = -1) -> torch.Tensor:
    """Boolean mask of the k winners along ``axis``. Ties at the
    threshold are broken by position (earlier index wins)."""
    if k <= 0:
        return torch.zeros_like(x, dtype=torch.bool)
    n = x.shape[axis]
    if k >= n:
        return torch.ones_like(x, dtype=torch.bool)
    score = torch.abs(x) if by_magnitude else x
    score = torch.movedim(score, axis, -1)
    # Threshold = the k-th largest score per row; only its value matters,
    # so topk's own tie order cannot leak into the mask.
    kth = torch.topk(score, k, dim=-1).values[..., -1:]
    above = score > kth
    n_above = above.sum(dim=-1, keepdim=True)
    at = score == kth
    rank_at = torch.cumsum(at.to(torch.int64), dim=-1)
    mask = above | (at & (rank_at <= (k - n_above)))
    return torch.movedim(mask, -1, axis)


def kwta(x: torch.Tensor, k: Optional[int] = None,
         keep_frac: Optional[float] = None, by_magnitude: bool = True,
         axis: int = -1) -> torch.Tensor:
    """ζ: zero all but the k (or round(``keep_frac``·n), at least 1)
    winners along ``axis``. Exactly one of ``k`` / ``keep_frac``."""
    if (k is None) == (keep_frac is None):
        raise ValueError("pass exactly one of k / keep_frac")
    n = x.shape[axis]
    if k is None:
        k = max(1, int(round(keep_frac * n)))
    return torch.where(kwta_mask(x, k, by_magnitude, axis), x,
                       torch.zeros_like(x))


def kwta_global(x: torch.Tensor, keep_frac: float) -> torch.Tensor:
    """ζ over the whole tensor (the per-matrix form Algorithm 1 applies to
    gradient matrices)."""
    out = kwta(x.reshape(-1), keep_frac=keep_frac, by_magnitude=True, axis=0)
    return out.reshape(x.shape)


def kwta_softmax(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Voltage-mode k-WTA softmax approximation: the probability mass
    restricted to the k winning logits."""
    mask = kwta_mask(logits, k, by_magnitude=False)
    masked = torch.where(mask, logits, torch.full_like(logits, -torch.inf))
    return torch.softmax(masked, dim=-1)
