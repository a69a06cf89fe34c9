"""Host-side span tracing with Chrome/Perfetto ``trace.json`` export.

Counterpart of ``repro/obs/tracer.py``. A :class:`Tracer` records nested
wall-clock spans (``with tracer.span("compile"): ...``) and exports them
in the Chrome trace-event format, so one run's structure — schedule
materialization vs upload vs execute, per-cell sweep
work, per-step serve work — opens directly in ``chrome://tracing`` /
Perfetto. Without a tracer the runners open no span: tracing is strictly
opt-in.

Spans passed a ``step=`` also enter ``torch.profiler.record_function``
under the span's name, so a ``torch.profiler`` trace captured around the
same region (the device's kernels and copies) lines up with the host
spans.

Everything is wall-clock host timing (``time.perf_counter_ns``), threads
separated by ``tid``; nesting inside a thread is expressed the Chrome
way — containment of ``[ts, ts+dur]`` intervals of ``ph: "X"`` complete
events.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["Tracer"]


class Tracer:
    """Collects trace events; thread-safe; negligible cost per span
    (two clock reads and a dict append)."""

    def __init__(self, process_name: str = "repro"):
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter_ns()
        self._depth = threading.local()
        self._events.append({
            "name": "process_name", "ph": "M", "pid": os.getpid(),
            "tid": 0, "args": {"name": process_name}})

    # ------------------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    @contextlib.contextmanager
    def span(self, name: str, step: Optional[int] = None, **args):
        """Record a nested wall-clock span. ``step`` additionally opens a
        ``torch.profiler.record_function(name)`` range, which a profiler
        trace shows beside the device's work; remaining kwargs land in
        the event's ``args``."""
        depth = getattr(self._depth, "n", 0)
        self._depth.n = depth + 1
        t0 = self._now_us()
        ann = contextlib.nullcontext()
        if step is not None:
            from torch.profiler import record_function
            ann = record_function(name)
        try:
            with ann:
                yield self
        finally:
            dur = self._now_us() - t0
            self._depth.n = depth
            ev_args = dict(args)
            if step is not None:
                ev_args["step"] = step
            with self._lock:
                self._events.append({
                    "name": name, "ph": "X", "ts": t0, "dur": dur,
                    "pid": os.getpid(), "tid": threading.get_ident(),
                    "args": ev_args, "_depth": depth})

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (Chrome ``ph: "i"``)."""
        with self._lock:
            self._events.append({
                "name": name, "ph": "i", "ts": self._now_us(), "s": "t",
                "pid": os.getpid(), "tid": threading.get_ident(),
                "args": dict(args)})

    def counter(self, name: str, **values) -> None:
        """A counter sample (Chrome ``ph: "C"``) — e.g. queue depth or
        active serve slots over time."""
        with self._lock:
            self._events.append({
                "name": name, "ph": "C", "ts": self._now_us(),
                "pid": os.getpid(), "tid": 0,
                "args": {k: float(v) for k, v in values.items()}})

    # ------------------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def summary(self) -> dict[str, dict]:
        """Per-name totals over *top-level occurrences* of each span name
        (re-entrant spans only count their outermost instance, so a
        recursive span's total is wall time, not a multiple of it)."""
        out: dict[str, dict] = {}
        spans = [e for e in self.events() if e["ph"] == "X"]
        spans.sort(key=lambda e: e["ts"])
        open_until: dict[str, float] = {}
        for e in spans:
            name = e["name"]
            agg = out.setdefault(name, {"count": 0, "total_s": 0.0})
            if e["ts"] < open_until.get(name, -1.0):
                continue  # nested inside an outer span of the same name
            open_until[name] = e["ts"] + e["dur"]
            agg["count"] += 1
            agg["total_s"] += e["dur"] / 1e6
        return out

    def total_s(self, name: str) -> float:
        return self.summary().get(name, {}).get("total_s", 0.0)

    def export_chrome(self, path) -> Path:
        """Write the Chrome trace-event JSON. Open in chrome://tracing or
        https://ui.perfetto.dev."""
        path = Path(path)
        events = []
        for e in self.events():
            e.pop("_depth", None)
            events.append(e)
        path.write_text(json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"}, indent=None))
        return path
