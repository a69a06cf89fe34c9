"""Event/run-record sinks — JSONL emission with a stable schema.

Counterpart of ``repro/obs/sinks.py``. An instrumented run can emit a
*run record*: one JSON object per run with a pinned ``schema`` version,
enough environment fingerprint to compare runs across commits, and the
run's headline metrics. Appended to a JSONL file, records make a
queryable history (``jq`` over it answers "when did this figure move").

Schema (version 1) — stable keys, additive evolution only:

  schema      int, bumped only on breaking changes
  kind        "bench" | "run" | "serve" | "fleet"
  name        the record family (e.g. "obs_bench", "continual")
  ts          ISO-8601 UTC wall time of record creation
  git_sha     current commit (best effort; absent outside a checkout)
  torch       {"version", "cuda", "device"}: PyTorch's version, the CUDA
              it was built for (None on a CPU build) and the card's name
              (``torch.cuda.get_device_name(0)``), or "cpu" where no card
              is present. The reference's record carries a ``jax``
              block in this place.
  metrics     flat dict of the run's headline numbers
  gates       pass/fail booleans (benches only)
  counters    telemetry counter snapshot (optional)
  timeline    thinned RunLog view (optional; see RunLog.as_dict)
"""
from __future__ import annotations

import json
import subprocess
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

import torch

__all__ = ["RUN_RECORD_SCHEMA", "JsonlSink", "run_record"]

RUN_RECORD_SCHEMA = 1


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=Path(__file__).resolve().parent)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_record(kind: str, name: str, metrics: dict, *,
               gates: Optional[dict] = None,
               counters: Optional[dict] = None,
               timeline: Optional[dict] = None,
               extra: Optional[dict] = None) -> dict:
    """Build a schema-versioned run record. ``metrics`` should be flat
    name → number; nested payloads go in ``extra``."""
    rec: dict = {
        "schema": RUN_RECORD_SCHEMA,
        "kind": kind,
        "name": name,
        "ts": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "metrics": {k: (float(v) if isinstance(v, (int, float)) else v)
                    for k, v in metrics.items()},
    }
    sha = _git_sha()
    if sha:
        rec["git_sha"] = sha
    rec["torch"] = {"version": torch.__version__,
                    "cuda": torch.version.cuda,
                    "device": (torch.cuda.get_device_name(0)
                               if torch.cuda.is_available() else "cpu")}
    if gates is not None:
        rec["gates"] = {k: bool(v) for k, v in gates.items()}
    if counters is not None:
        rec["counters"] = {k: int(v) for k, v in counters.items()}
    if timeline is not None:
        rec["timeline"] = timeline
    if extra:
        rec["extra"] = extra
    return rec


class JsonlSink:
    """Append-only JSONL file — one JSON object per line. Creation is
    lazy (parent directories made on first emit) so a sink can be
    constructed unconditionally and never touch disk unless used."""

    def __init__(self, path):
        self.path = Path(path)

    def emit(self, record: dict) -> Path:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a") as f:
            f.write(json.dumps(record, default=float) + "\n")
        return self.path

    def read(self) -> list[dict]:
        if not self.path.exists():
            return []
        return [json.loads(line) for line in
                self.path.read_text().splitlines() if line.strip()]
