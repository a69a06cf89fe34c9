"""Streaming histogram — the latency distribution primitive.

Counterpart of ``repro/obs/hist.py``. The serve engine records
per-request wall-clock times into these and reads out p50/p99. Values
are stored exactly up to ``max_samples`` and reservoir-sampled past that
(bounded memory under millions-of-requests load), with a deterministic
counter-hash replacement so two runs of the same request stream produce
the same percentiles.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Histogram"]


def _mix(n: int) -> int:
    # splitmix64 finalizer — deterministic per-sample hash for the
    # reservoir replacement draw (no global RNG state involved).
    z = (n + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


class Histogram:
    """Bounded-memory value recorder with exact percentiles while under
    ``max_samples`` and reservoir-sampled ones past it."""

    def __init__(self, max_samples: int = 65536):
        self.max_samples = int(max_samples)
        self._values: list[float] = []
        self.count = 0
        self._sum = 0.0

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self._sum += v
        if len(self._values) < self.max_samples:
            self._values.append(v)
            return
        j = _mix(self.count) % self.count
        if j < self.max_samples:
            self._values[j] = v

    def extend(self, values) -> None:
        for v in values:
            self.add(v)

    @property
    def mean(self) -> float:
        return self._sum / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        if not self._values:
            return float("nan")
        return float(np.percentile(np.asarray(self._values), q))

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "p50": self.p50, "p95": self.p95, "p99": self.p99,
                "min": min(self._values) if self._values else float("nan"),
                "max": max(self._values) if self._values else float("nan")}

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"<Histogram n={self.count} mean={self.mean:.4g} "
                f"p50={self.p50:.4g} p99={self.p99:.4g}>")
