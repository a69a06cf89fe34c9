"""``repro_torch.obs`` — time-resolved observability; counterpart of
``repro/obs``.

  * **Metric streams** (:mod:`repro_torch.obs.runlog`): per-step scalars
    (loss, write pulses, ΔG magnitude, replay occupancy, drift ticks)
    kept on the device through a run and windowed into a
    :class:`RunLog` at a configurable cadence. Disabled (the default)
    costs nothing; enabled leaves the results bit for bit as they were.
  * **Span tracing** (:mod:`repro_torch.obs.tracer`): host-side nested
    spans separating schedule / upload / execute,
    exported as Chrome/Perfetto ``trace.json``.
  * **Sinks** (:mod:`repro_torch.obs.sinks`, :mod:`repro_torch.obs.hist`):
    schema-versioned JSONL run records and the streaming
    :class:`Histogram` behind the serve engines' p50/p99.
"""
from repro_torch.obs.hist import Histogram
from repro_torch.obs.runlog import (ObsSpec, RunLog, build_runlog,
                                    drift_stream, sparkline, step_stats,
                                    timeline)
from repro_torch.obs.sinks import RUN_RECORD_SCHEMA, JsonlSink, run_record
from repro_torch.obs.tracer import Tracer

__all__ = [
    "ObsSpec", "RunLog", "build_runlog", "drift_stream", "step_stats",
    "timeline", "sparkline",
    "Tracer", "Histogram",
    "JsonlSink", "run_record", "RUN_RECORD_SCHEMA",
]
