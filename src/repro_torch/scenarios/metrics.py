"""Standard continual-learning metrics from the accuracy matrix —
counterpart of ``repro/scenarios/metrics.py``, a verbatim copy of its
numpy.

``R[t, i]`` is accuracy on task i after training through task t (the
Fig. 4 protocol's matrix; eq. 20's MA is the mean of the final row).
The sweep runner evaluates *every* task after every task, so its
``R_full`` also populates the upper triangle (accuracy on not-yet-seen
tasks), which is what forward transfer needs. The lower-triangular
metrics (average accuracy, forgetting, BWT) are defined on either form.

Definitions (Lopez-Paz & Ranzato, 2017; Chaudhry et al., 2018):

  average accuracy  ACC  = mean_i R[T-1, i]
  backward transfer BWT  = mean_{i<T-1} (R[T-1, i] − R[i, i])
  forgetting        F    = mean_{i<T-1} (max_{t∈[i,T-2]} R[t, i] − R[T-1, i])
  forward transfer  FWT  = mean_{i≥1} (R[i-1, i] − b[i])

where b[i] is the accuracy of the untrained (initialization) model on
task i. BWT ≤ 0 means forgetting; F is its nonnegative max-referenced
form; FWT > 0 means earlier tasks prime later ones.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _as_matrix(R) -> np.ndarray:
    R = np.asarray(R, dtype=np.float64)
    if R.ndim != 2 or R.shape[0] != R.shape[1]:
        raise ValueError(f"R must be a square (n_tasks, n_tasks) matrix, "
                         f"got shape {R.shape}")
    return R


def average_accuracy(R) -> float:
    """Mean final-row accuracy (eq. 20's MA)."""
    return float(_as_matrix(R)[-1].mean())


def backward_transfer(R) -> float:
    """BWT: how training on later tasks changed earlier-task accuracy.
    0 for a single task."""
    R = _as_matrix(R)
    n = R.shape[0]
    if n < 2:
        return 0.0
    return float(np.mean([R[-1, i] - R[i, i] for i in range(n - 1)]))


def forgetting(R) -> float:
    """Average forgetting: drop from each task's best-ever accuracy
    (while it was still being revisited) to its final accuracy.
    0 for a single task; ≥ max(0, −BWT)."""
    R = _as_matrix(R)
    n = R.shape[0]
    if n < 2:
        return 0.0
    return float(np.mean([R[i:n - 1, i].max() - R[-1, i]
                          for i in range(n - 1)]))


def forward_transfer(R_full, baseline) -> float:
    """FWT from a fully-populated R (upper triangle = accuracy on unseen
    tasks) against the untrained-model baseline accuracies b[i]."""
    R = _as_matrix(R_full)
    b = np.asarray(baseline, dtype=np.float64)
    n = R.shape[0]
    if n < 2:
        return 0.0
    if b.shape != (n,):
        raise ValueError(f"baseline must have shape ({n},), got {b.shape}")
    return float(np.mean([R[i - 1, i] - b[i] for i in range(1, n)]))


def continual_metrics(R, baseline: Optional[np.ndarray] = None) -> dict:
    """All metrics for one run. ``forward_transfer`` is included only when
    the untrained-model ``baseline`` row is supplied (and R's upper
    triangle is populated — the compiled sweep does both)."""
    out = {
        "average_accuracy": average_accuracy(R),
        "backward_transfer": backward_transfer(R),
        "forgetting": forgetting(R),
    }
    if baseline is not None:
        out["forward_transfer"] = forward_transfer(R, baseline)
    return out
