"""Time-resolved metric streams — the :class:`RunLog` and its builder.

Counterpart of ``repro/obs/runlog.py``. Telemetry answers *how much*
(whole-run aggregate counters); this module answers *when*: write pulses
burst at task boundaries, forgetting lands at specific transitions. The
runners (:func:`repro_torch.core.continual.run_continual`,
:func:`repro_torch.scenarios.sweep.run_compiled`) compute one
:func:`step_stats` per training step, keep the scalars on the step's
device, read them back once at the end, and assemble them into a
:class:`RunLog` at a configurable cadence.

The contract, in order of importance:

  disabled is free   With no :class:`ObsSpec` (the default) the runners
                     do no extra work: no stats, no extra host reads.
  enabled is inert   The streams are pure *reads* of values the training
                     step already computes (the loss, the applied update,
                     the replay-buffer fill), so R / params / losses stay
                     bitwise equal with obs on.
  loop ≡ compiled    Both runners call the same :func:`step_stats` on the
                     same tensors and feed the same numpy windowing, so
                     every stream — the float ones too — is equal bit for
                     bit between the loop and the compiled run.
  streams sum exact  Window *sums* (``write_pulses``, ``drift_ticks``)
                     total exactly to the aggregate telemetry counters of
                     the same run — the time series is a lossless
                     disaggregation, not a sampled estimate.

Cadence semantics: the run's ``total_steps`` training steps are split
into ``ceil(total/cadence)`` contiguous windows; window ``i`` covers
steps ``[i·c, min((i+1)·c, total))`` (the last window may be partial —
its sums still count every step, which is what keeps the totals exact).
Counter streams are summed over the window; gauge streams
(``loss`` excepted — it is the window *mean*) sample the window's first
step. The windowing and reporting below are the reference's numpy,
verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["ObsSpec", "RunLog", "step_stats", "build_runlog",
           "drift_stream", "timeline", "sparkline"]


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """What to observe. Passed as ``obs=`` to the runners.

    metrics   record the per-step metric streams into a :class:`RunLog`
              (result key ``"runlog"``).
    cadence   window length in training steps (1 = every step), applied
              host-side after the run.
    tracer    a :class:`repro_torch.obs.Tracer`; the compiled run opens
              ``schedule`` / ``compile`` / ``execute`` spans on it, and
              the sweep and serve layers add their own.
    """
    metrics: bool = True
    cadence: int = 1
    tracer: Optional[object] = None

    def __post_init__(self):
        if self.cadence < 1:
            raise ValueError(f"cadence must be ≥ 1, got {self.cadence}")


def step_stats(applied: dict, rstate) -> tuple[torch.Tensor, ...]:
    """Per-step observability scalars from values the train step already
    produced: (write_pulses int32, dg_mag float32, occupancy int32), 0-d
    tensors on the step's device (nothing is read back to the host).

    ``write_pulses`` counts the nonzero entries of the applied update
    across the ≥2-D parameter tiles — the same device set the aggregate
    ``write_pulses`` telemetry counter and the endurance write maps use,
    so the stream sums exactly to the counter. ``dg_mag`` is Σ|ΔG| over
    the same tiles (the applied-update magnitude, post noise/levels/
    clip). ``occupancy`` reads the in-graph replay buffer's fill
    (``rstate["size"]``); host-materialized policies report 0 here and
    the runner substitutes the schedule-derived stream instead.

    The tiles are taken in sorted-name order. The loop
    (:func:`repro_torch.core.continual.run_continual`) and the compiled
    run (:func:`repro_torch.scenarios.sweep.run_compiled`) both call this
    one definition on the same device, so their reductions run in the
    same order and the two streams are equal bit for bit.
    """
    mats = [v for _, v in sorted(applied.items()) if v.ndim >= 2]
    dev = mats[0].device if mats else None
    pulses = torch.zeros((), dtype=torch.int32, device=dev)
    dg = torch.zeros((), dtype=torch.float32, device=dev)
    for m in mats:
        pulses = pulses + (m != 0).sum(dtype=torch.int32)
        dg = dg + m.abs().to(torch.float32).sum()
    if isinstance(rstate, dict) and "size" in rstate:
        occ = rstate["size"].to(torch.int32)
    else:
        occ = torch.zeros((), dtype=torch.int32, device=dev)
    return pulses, dg, occ


# ---------------------------------------------------------------------------
# Windowing (host-side, numpy — shared verbatim by loop and compiled)
# ---------------------------------------------------------------------------

def _window_starts(n_steps: int, cadence: int) -> np.ndarray:
    return np.arange(0, n_steps, cadence)


def _window_sum(a: np.ndarray, cadence: int) -> np.ndarray:
    if a.shape[-1] == 0:
        return a[..., :0]
    return np.add.reduceat(a, _window_starts(a.shape[-1], cadence),
                           axis=-1)


def _window_mean(a: np.ndarray, cadence: int) -> np.ndarray:
    n = a.shape[-1]
    if n == 0:
        return a[..., :0]
    starts = _window_starts(n, cadence)
    counts = np.diff(np.append(starts, n))
    return np.add.reduceat(a, starts, axis=-1) / counts


def _window_first(a: np.ndarray, cadence: int) -> np.ndarray:
    return a[..., ::cadence]


@dataclasses.dataclass
class RunLog:
    """Time-resolved metric streams for one run (or one fleet).

    Stream arrays share a trailing ``(n_windows,)`` axis; fleet /
    multi-seed runs carry a leading per-chip (per-seed) axis — shapes
    below write it as ``(...,)``. Everything is numpy, host-side.

      cadence           window length in training steps
      n_steps           total training steps covered
      steps             (n_windows,) global step index of each window start
      loss              (..., n_windows) window-mean training loss
      write_pulses      (..., n_windows) window-sum nonzero programmed
                        synapses — sums exactly to the telemetry counter
      dg_mag            (..., n_windows) window-sum Σ|ΔG| applied
      replay_occupancy  (..., n_windows) replay-buffer fill, gauge at the
                        window's first step
      drift_ticks       (..., n_windows) window-sum retention-drift ticks
      eval_steps        (n_tasks,) global step after which task t's eval
                        row was taken (the task boundary)
      task_acc          (..., n_tasks, n_tasks) per-task eval accuracy
                        after each task — R_full from the compiled
                        run, the lower-triangular R from the loop
    """
    cadence: int
    n_steps: int
    steps: np.ndarray
    loss: np.ndarray
    write_pulses: np.ndarray
    dg_mag: np.ndarray
    replay_occupancy: np.ndarray
    drift_ticks: np.ndarray
    eval_steps: np.ndarray
    task_acc: np.ndarray

    @property
    def n_windows(self) -> int:
        return int(self.steps.shape[0])

    @property
    def total_write_pulses(self) -> int:
        """Exact aggregate — equals the run's ``write_pulses`` telemetry
        counter total (asserted in tests/test_obs.py)."""
        return int(self.write_pulses.sum())

    @property
    def total_drift_ticks(self) -> int:
        return int(self.drift_ticks.sum())

    def forgetting_after_task(self) -> np.ndarray:
        """(..., n_tasks) mean forgetting after each task boundary:
        ``f[t] = mean_{i<t}(max_{k≤t} A[k,i] − A[t,i])`` (0 at t=0) —
        the *when* of forgetting, per transition, not just the final
        scalar."""
        A = np.asarray(self.task_acc, np.float64)
        n = A.shape[-1]
        out = np.zeros(A.shape[:-1])
        run_max = A[..., 0, :].copy()
        for t in range(1, n):
            run_max = np.maximum(run_max, A[..., t, :])
            out[..., t] = (run_max[..., :t] - A[..., t, :t]).mean(axis=-1)
        return out

    def as_dict(self, max_points: Optional[int] = None) -> dict:
        """JSON-serializable view (leading axes reduced: sums for
        counters, means for gauges). ``max_points`` thins the streams by
        striding for compact run records."""
        tl = timeline(self)
        if max_points is not None and len(tl["steps"]) > max_points:
            stride = -(-len(tl["steps"]) // max_points)
            for k in ("steps", "loss", "write_pulses", "dg_mag",
                      "replay_occupancy", "drift_ticks"):
                tl[k] = tl[k][::stride]
            tl["thinned_stride"] = stride
        return tl


def drift_stream(total_steps: int, *, drifting: bool) -> np.ndarray:
    """Per-step retention-drift ticks. The ``analog_state`` backend
    meters exactly one (cadence-amortized) tick per weight update when
    drift is active, so the per-step series is the unit ramp — included
    so the stream's sum stays an exact disaggregation of the
    ``drift_ticks`` counter (stateless substrates never tick)."""
    return (np.ones(total_steps, np.int32) if drifting
            else np.zeros(total_steps, np.int32))


def build_runlog(*, cadence: int, steps_per_task, loss, write_pulses,
                 dg_mag, replay_occupancy, drift_ticks,
                 task_acc) -> RunLog:
    """Assemble a :class:`RunLog` from per-step arrays shaped
    ``(..., total_steps)`` (leading axes ride through — the fleet's
    per-chip axis, the sweep's per-seed axis). One definition consumed
    by every runner, which is what keeps the loop and compiled RunLogs
    directly comparable."""
    steps_per_task = [int(s) for s in steps_per_task]
    total = sum(steps_per_task)

    def _flat(a, dtype):
        a = np.asarray(a)
        if a.shape[-1] != total:
            a = a.reshape(*a.shape[:a.ndim - 2], -1)
        if a.shape[-1] != total:
            raise ValueError(f"per-step stream has {a.shape[-1]} steps, "
                             f"schedule has {total}")
        return np.asarray(a, dtype)

    loss_f = _flat(loss, np.float32)
    pulses_f = _flat(write_pulses, np.int64)
    dg_f = _flat(dg_mag, np.float32)
    occ_f = _flat(replay_occupancy, np.int32)
    drift_f = _flat(drift_ticks, np.int64)
    return RunLog(
        cadence=int(cadence),
        n_steps=total,
        steps=_window_starts(total, cadence),
        loss=_window_mean(loss_f, cadence),
        write_pulses=_window_sum(pulses_f, cadence),
        dg_mag=_window_sum(dg_f, cadence),
        replay_occupancy=_window_first(occ_f, cadence),
        drift_ticks=_window_sum(drift_f, cadence),
        eval_steps=np.cumsum(steps_per_task) - 1,
        task_acc=np.asarray(task_acc, np.float64),
    )


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 48) -> str:
    """Eight-level unicode sparkline, down-sampled to ``width`` by
    window-maxima (bursts — the interesting part — survive thinning)."""
    v = np.asarray(values, np.float64).reshape(-1)
    if v.size == 0:
        return ""
    if v.size > width:
        pad = (-v.size) % width
        v = np.pad(v, (0, pad), constant_values=v.min())
        v = v.reshape(width, -1).max(axis=1)
    lo, hi = float(v.min()), float(v.max())
    if hi <= lo:
        return _SPARK[0] * v.size
    idx = ((v - lo) / (hi - lo) * (len(_SPARK) - 1)).round().astype(int)
    return "".join(_SPARK[i] for i in idx)


def timeline(log: RunLog) -> dict:
    """The report-facing view of a RunLog: leading (chip/seed) axes
    reduced — counters summed across the population, gauges averaged —
    plus the per-task forgetting series. Rendered by
    :func:`repro_torch.telemetry.format_report`."""
    def _lead_sum(a):
        return a.reshape(-1, a.shape[-1]).sum(axis=0) if a.ndim > 1 else a

    def _lead_mean(a):
        return a.reshape(-1, a.shape[-1]).mean(axis=0) if a.ndim > 1 else a

    fg = log.forgetting_after_task()
    fg = fg.reshape(-1, fg.shape[-1]).mean(axis=0) if fg.ndim > 1 else fg
    return {
        "cadence": log.cadence,
        "n_steps": log.n_steps,
        "steps": log.steps.tolist(),
        "loss": _lead_mean(log.loss).tolist(),
        "write_pulses": _lead_sum(log.write_pulses).tolist(),
        "dg_mag": _lead_sum(log.dg_mag).tolist(),
        "replay_occupancy": _lead_mean(log.replay_occupancy).tolist(),
        "drift_ticks": _lead_sum(log.drift_ticks).tolist(),
        "eval_steps": log.eval_steps.tolist(),
        "forgetting_after_task": fg.tolist(),
        "total_write_pulses": log.total_write_pulses,
    }
