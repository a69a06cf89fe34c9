"""The fleet runner: a population of chips through one task stream —
counterpart of ``repro/fleet/run.py``.

The reference vmaps its compiled per-seed program over a device axis
and shards that axis across the host's accelerators with ``shard_map``.
Here the chips run one after another on one card, each through the loop
that :func:`repro_torch.scenarios.run_compiled` runs
(``core/continual.py``: ``_prepare_run``, ``_upload``, ``_execute``).
Each chip gets:

  * its own data-stream seed (``device_seeds``, a Xorshift32 chain),
  * its own crossbar draw (``draw_heterogeneity`` → the ``"_het"``
    overlay of the ``analog_state`` backend), with its G⁺/G⁻ pairs
    re-programmed under its own ``prog_sigma`` from a chip-local key,
  * with a :class:`~repro_torch.faults.FaultSpec` that has a fleet-level
    spread, its own fault masks (``draw_fleet_faults``: a rate multiplier
    and a dead-chip flag), re-sampled from a chip-local key,
  * with ``shard_data``, its own strided shard of the training rows.

Counters: every chip meters its own forwards and writes into the
backend's telemetry, so the totals are the reference's (the forward's
counters D times one chip's, the write pulses the per-chip maps'), and
each chip's write-count map comes back in ``wcounts``. With
``het_profile="none"`` and no fault spread nothing is attached: each
chip's run is ``run_compiled(seeds=device_seeds(fleet))``'s, bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.analog.endurance import EnduranceTracker
from repro_torch.backends import DeviceBackend, get_backend
from repro_torch.core.continual import (ReplaySpec, TrainerSpec, _execute,
                                        _obs_stream_args, _upload)
from repro_torch.data.pipeline import shard_tasks
from repro_torch.data.synthetic import TaskData
from repro_torch.fleet.heterogeneity import (FleetSpec, chip_device_state,
                                             chip_fault_state, device_seeds,
                                             draw_fleet_faults,
                                             draw_heterogeneity)
from repro_torch.scenarios.sweep import (_aggregate_seeds,
                                         _build_seed_inputs, _summarize_run)
from repro_torch.utils import resolve_device

__all__ = ["run_fleet", "fleet_shard_count"]


def fleet_shard_count(n_devices: int,
                      max_shards: Optional[int] = None) -> int:
    """Shards for a fleet of ``n_devices``: the reference's largest
    divisor of the fleet size that fits the accelerators the fleet runs
    on, capped at ``max_shards``. The port runs the whole fleet on one
    torch device, so it is 1 for any fleet and cap; no result depends
    on it."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return 1


def run_fleet(cfg, spec: TrainerSpec, tasks: list[TaskData],
              fleet: FleetSpec,
              replay: Optional[ReplaySpec] = None,
              device: Union[str, DeviceBackend, None] = None,
              *, baseline: bool = True,
              max_shards: Optional[int] = None,
              shard_data: bool = False,
              obs: Optional[Any] = None,
              torch_device: Union[str, torch.device] = "cuda"
              ) -> dict[str, Any]:
    """Train ``fleet.n_devices`` heterogeneous chips through the task
    sequence on ``torch_device``.

    Each chip's cell in ``per_device`` has the R matrix, metrics and
    losses ``run_compiled`` reports for its seed, plus the fleet frame:

      per_device        one summary dict per chip (R_full, MA, metrics)
      device_seeds      the Xorshift32-derived data-stream seeds
      het               the per-chip crossbar draws (None for "none")
      wcounts           per-chip write-count maps, name → (n_devices,
                        *w.shape) int32 (when writes are tracked:
                        telemetry on or an endurance tracker)
      n_shards/n_local  1 and n_devices (one card)
      params/params_fleet  chip 0's final params; every chip's, stacked
                        on a leading (n_devices,) axis
      faults            {"spec", "rate_scale", "dead_chips"} under a
                        FaultSpec
      metrics/metrics_std  the fleet's mean and std

    ``shard_data=True`` makes the fleet a data-parallel consumer of one
    stream: chip ``d`` trains on :func:`~repro_torch.data.shard_tasks`'s
    shard ``d`` while every chip evaluates the full test sets.

    ``obs`` (a :class:`repro_torch.obs.ObsSpec`) adds ``"runlog"`` with a
    leading (n_devices,) chip axis, and a tracer records ``schedule``,
    ``compile`` (the uploads) and ``execute`` spans, also reported as
    ``compile_s``/``execute_s``.

    Raises on ragged task streams and on heterogeneity profiles with a
    backend that has no conductance-domain state."""
    trainer = spec
    if not isinstance(trainer, TrainerSpec):
        raise TypeError("run_fleet takes a TrainerSpec")
    rspec = replay if replay is not None else ReplaySpec()
    backend = get_backend(device if device is not None else "ideal")
    tele = backend.telemetry
    dev = resolve_device(torch_device)
    obs_on = obs is not None and getattr(obs, "metrics", False)
    tracer = getattr(obs, "tracer", None) if obs is not None else None
    D = fleet.n_devices
    seeds = device_seeds(fleet)

    test_shapes = {(t.x_test.shape, t.y_test.shape) for t in tasks}
    if len(test_shapes) != 1:
        raise ValueError("run_fleet needs shape-uniform eval sets")
    het = draw_heterogeneity(fleet)
    fspec = backend.spec.faults
    fault_scale, dead_chips = draw_fleet_faults(fleet, fspec)

    def span(name, **args):
        return tracer.span(name, **args) if tracer is not None \
            else contextlib.nullcontext()

    runs, chip_tasks = [], []
    with span("schedule", n_devices=D):
        for d, s in enumerate(seeds):
            tsp = dataclasses.replace(trainer, seed=int(s))
            # Per-chip data shard: disjoint strided training slices of the
            # one stream, of one size.
            chip_tasks.append(shard_tasks(tasks, D, d) if shard_data
                              else tasks)
            run, _ = _build_seed_inputs(cfg, tsp, rspec, backend,
                                        chip_tasks[d], torch_device=dev)
            if run is None:
                raise ValueError("run_fleet needs a shape-uniform task "
                                 "stream")
            if het is not None:
                # The chip's pairs re-programmed under its own draw.
                run.dev_state = chip_device_state(
                    backend, run.params, s, {k: v[d] for k, v in het.items()})
            if fault_scale is not None:
                run.dev_state = {**run.dev_state, "_faults": chip_fault_state(
                    backend, run.params, s, fault_scale[d], dead_chips[d],
                    fspec)}
            runs.append(run)
    if tele.enabled:
        # The replay DRAM traffic of every chip's schedule, once.
        for r in runs:
            if r.replay_traffic:
                tele.record(r.replay_traffic)

    n_tasks = len(tasks)
    steps = runs[0].schedule.steps_per_task
    S = max(steps) if steps else 0
    track_writes = backend.tracker is not None or tele.enabled
    t0 = time.perf_counter()
    with span("compile", backend=backend.name, n_devices=D, n_shards=1):
        uploads = [_upload(r, t, dev) for r, t in zip(runs, chip_tasks)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    raw, wmaps = [], []
    fleet_tracker = backend.tracker
    with span("execute", backend=backend.name, n_devices=D):
        try:
            for r, data in zip(runs, uploads):
                if track_writes:
                    # Each chip's write map: its own tracker for its run.
                    backend.tracker = EnduranceTracker()
                raw.append(_execute(r, data, backend, all_tasks=True,
                                    baseline=baseline, obs_on=obs_on))
                if track_writes:
                    wmaps.append(backend.tracker)
        finally:
            backend.tracker = fleet_tracker
    t2 = time.perf_counter()

    wcounts = None
    if track_writes:
        wcounts = {name: np.stack([
            m._counts[name].cpu().numpy().astype(np.int32) for m in wmaps])
            for name in wmaps[0]._counts}
        if fleet_tracker is not None:
            for m in wmaps:
                fleet_tracker.record_counts(m._counts, m.updates_applied)

    per_device = [_summarize_run(
        r["R"], r["baseline_row"] if baseline
        else np.zeros(n_tasks, np.float32), r["losses"], baseline)
        for r in raw]
    out: dict[str, Any] = dict(per_device[0])
    out.update(_aggregate_seeds(per_device, seeds))
    out["per_device"] = out.pop("per_seed")
    out["device_seeds"] = out.pop("seeds")
    out.update({
        "compiled": True,
        "fleet": fleet,
        "n_devices": D,
        "n_shards": fleet_shard_count(D, max_shards),
        "n_local": D,
        "wall_s": t2 - t0,
        "steps_per_task": S,
        "updates_per_device": sum(steps),
        "het": het,
        "wcounts": wcounts,
        "params": raw[0]["params"],
        "params_fleet": {k: torch.stack([r["params"][k] for r in raw])
                         for k in raw[0]["params"]},
    })
    if fspec is not None:
        out["faults"] = {"spec": fspec, "rate_scale": fault_scale,
                         "dead_chips": dead_chips}
    if tracer is not None:
        out["compile_s"] = t1 - t0
        out["execute_s"] = t2 - t1
    if obs_on:
        from repro_torch.obs import build_runlog
        streams = [_obs_stream_args(r, rw, backend)
                   for r, rw in zip(runs, raw)]
        out["runlog"] = build_runlog(
            cadence=obs.cadence, steps_per_task=steps,
            task_acc=np.stack([p["R_full"] for p in per_device]),
            **{k: np.stack([s[k] for s in streams]) for k in streams[0]})
    if backend.tracker is not None:
        out["endurance"] = backend.tracker
    if tele.enabled:
        out["telemetry"] = tele
    return out
