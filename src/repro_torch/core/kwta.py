"""k-winner-take-all mask — counterpart of ``repro/core/kwta.py``'s
``kwta_mask``, which the MiRU readout uses when ``readout_k`` is set.
The rest of the module (ζ gradient sparsification) belongs to the DFA
training slice."""
from __future__ import annotations

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
