"""Deterministic synthetic traffic for the recurrent serve engine.

A copy of ``repro/serve/loadgen.py`` (numpy only): the same
:class:`TrafficSpec` yields bitwise-equal arrays in both packages.

The traffic pattern ReckOn/Chameleon (PAPERS.md) anchor on: many short,
bursty, *stateful* streams — each request is a burst of feature frames
from one user session, arrivals are Poisson, and a fraction of requests
come from returning users (whose slab state must be reloaded).

Everything is derived from a seeded ``numpy`` PCG64 generator, so two
runs of the same :class:`TrafficSpec` produce bit-identical frames and
arrival times on every platform — the serve bench's bitwise invariance
gate replays the same traffic through differently-composed batches.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

__all__ = ["TrafficSpec", "Arrival", "make_arrivals", "request_frames",
           "replay"]


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """One reproducible traffic trace.

    rate_hz        mean Poisson arrival rate (requests/s). ``None``
                   collapses every arrival to t=0 (a burst — the
                   saturation/throughput measurement mode).
    n_requests     total requests in the trace.
    n_users        distinct user sessions the requests are drawn from;
                   fewer users than requests means returning users whose
                   spilled slab state gets reloaded.
    frames_min/max uniform range of frames per request burst.
    n_x            feature width of each frame.
    seed           master seed for arrivals, user draws and frames.
    """
    n_requests: int = 64
    rate_hz: Optional[float] = None
    n_users: Optional[int] = None
    frames_min: int = 8
    frames_max: int = 28
    n_x: int = 28
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: who, when, and how many frames."""
    rid: int
    uid: int
    t: float            # seconds from trace start
    n_frames: int


def make_arrivals(spec: TrafficSpec) -> list[Arrival]:
    """The full trace, sorted by arrival time (stable in rid)."""
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, 0]))
    n_users = spec.n_users or spec.n_requests
    if spec.rate_hz is None:
        times = np.zeros(spec.n_requests)
    else:
        gaps = rng.exponential(1.0 / spec.rate_hz, size=spec.n_requests)
        times = np.cumsum(gaps)
    uids = rng.integers(0, n_users, size=spec.n_requests)
    lens = rng.integers(spec.frames_min, spec.frames_max + 1,
                        size=spec.n_requests)
    return [Arrival(rid=i, uid=int(uids[i]), t=float(times[i]),
                    n_frames=int(lens[i]))
            for i in range(spec.n_requests)]


def request_frames(spec: TrafficSpec, rid: int,
                   n_frames: Optional[int] = None) -> np.ndarray:
    """The (n_frames, n_x) float32 feature burst of request ``rid`` —
    a pure function of (seed, rid), independent of arrival order, so the
    same request replays bit-identically in any serving schedule."""
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, 1, rid]))
    if n_frames is None:
        n_frames = int(rng.integers(spec.frames_min, spec.frames_max + 1))
    # Bounded drive: the sign-magnitude quantizer saturates past ±1.
    x = rng.uniform(-1.0, 1.0, size=(n_frames, spec.n_x))
    return x.astype(np.float32)


def replay(spec: TrafficSpec) -> Iterator[tuple[Arrival, np.ndarray]]:
    """(arrival, frames) pairs in arrival order."""
    for a in make_arrivals(spec):
        yield a, request_frames(spec, a.rid, a.n_frames)
