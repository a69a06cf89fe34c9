"""Fault tolerance: preemption handling, failure detection, stragglers —
counterpart of ``repro/train/faults.py`` (host code, the same here).

On a real fleet these hook SIGTERM (preemption notice), per-step
all-reduce health checks, and the coordinator's slow-worker detector.
Here the mechanisms are implemented host-side and driven by the trainer;
tests inject failures deterministically.

  * PreemptionGuard — converts SIGTERM/SIGINT into a "checkpoint at the
    next step boundary, then exit cleanly" request (no torn steps).
  * HealthMonitor   — step-duration EWMA; a step slower than
    ``straggler_factor``× the EWMA flags a straggler (the remedy on a
    fleet is re-sharding around the slow host; here we surface the event
    and the trainer records it).
  * retry           — bounded-retry wrapper for transient infra errors.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional


class PreemptionGuard:
    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:           # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


class HealthMonitor:
    def __init__(self, straggler_factor: float = 3.0, ewma: float = 0.9):
        self.factor = straggler_factor
        self.ewma_coef = ewma
        self.mean_step_s: Optional[float] = None
        self.straggler_events: list[tuple[int, float]] = []

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is a straggler.

        Flagged steps are excluded from the EWMA: folding a straggler's
        duration into the very baseline it was judged against inflates
        the mean, so a run of moderate stragglers would progressively
        raise the bar and mask later ones.
        """
        is_straggler = (self.mean_step_s is not None
                        and duration_s > self.factor * self.mean_step_s)
        if is_straggler:
            self.straggler_events.append((step, duration_s))
            return True
        if self.mean_step_s is None:
            self.mean_step_s = duration_s
        else:
            self.mean_step_s = (self.ewma_coef * self.mean_step_s
                                + (1 - self.ewma_coef) * duration_s)
        return is_straggler


def retry(fn: Callable, attempts: int = 3, backoff_s: float = 0.1,
          retriable=(OSError, RuntimeError)):
    """Bounded retry for transient failures (I/O, collectives timeouts)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for i in range(attempts):
        try:
            return fn()
        except retriable as e:
            last = e
            if i + 1 >= attempts:
                break               # exhausted: re-raise without sleeping
            time.sleep(backoff_s * (2 ** i))
    raise last
